// Device helpers shared by the sweep kernels (K1 and K8 csrc/sweep.cu, K5
// csrc/sweep_batch.cu, K9 csrc/sweep_tiled.cu): the proxes and a warp sum
// in a fixed order.
#pragma once

namespace {

// The separable proxes: kind 0 = l1 (soft threshold at tl), 1 = nonneg_l1
// (shift by tl and clip at 0).  group_l2 scales whole groups instead.
__device__ __forceinline__ float prox(float v, float tl, int kind) {
  if (kind == 0) {
    const float a = fmaxf(fabsf(v) - tl, 0.0f);
    return v > 0.0f ? a : (v < 0.0f ? -a : 0.0f);
  }
  return fmaxf(v - tl, 0.0f);
}

// Sum over the warp in a fixed xor-shuffle order: every lane gets the same
// bits, and so does every CTA that sums the same values.
__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

}  // namespace
