// Device helpers shared by the sweep kernels (K1 csrc/sweep.cu, K5
// csrc/sweep_batch.cu, K8 csrc/sweep_slab.cu, K9 csrc/sweep_tiled.cu):
// the proxes, a warp sum in a fixed order, and cp.async (K5, K9).
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

// Copy V floats global -> shared without a register stop: V = 4 (16
// bytes, both addresses 16-byte aligned; L2 only) or 1.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
