// Device helpers shared by the sweep kernels (K1 and K8 csrc/sweep.cu, K5
// csrc/sweep_batch.cu, K9 csrc/sweep_tiled.cu): the proxes, phase 1's
// register-blocked dot of two tile rows against r (K1, K9) and a warp sum
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

// Phase 1 of one unit: (acc0, acc1) = the sums over the CTA's row chunks
// k = s, s + S1, ... < nk (of 4 floats when VEC) of tile rows a0 and a1
// against r.
template <bool VEC>
__device__ __forceinline__ void dot_rows(const float* a0, const float* a1,
                                         const float* r_s, int nk, int s,
                                         int S1, float& acc0, float& acc1) {
  acc0 = acc1 = 0.0f;
  for (int k = s; k < nk; k += S1) {
    if constexpr (VEC) {
      const float4 t0 = *reinterpret_cast<const float4*>(a0 + 4 * k);
      const float4 t1 = *reinterpret_cast<const float4*>(a1 + 4 * k);
      const float4 r = *reinterpret_cast<const float4*>(r_s + 4 * k);
      acc0 = fmaf(t0.x, r.x, acc0);
      acc1 = fmaf(t1.x, r.x, acc1);
      acc0 = fmaf(t0.y, r.y, acc0);
      acc1 = fmaf(t1.y, r.y, acc1);
      acc0 = fmaf(t0.z, r.z, acc0);
      acc1 = fmaf(t1.z, r.z, acc1);
      acc0 = fmaf(t0.w, r.w, acc0);
      acc1 = fmaf(t1.w, r.w, acc1);
    } else {
      const float r = r_s[k];
      acc0 = fmaf(a0[k], r, acc0);
      acc1 = fmaf(a1[k], r, acc1);
    }
  }
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
