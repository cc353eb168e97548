// Streamed loads of A shared by the matvec kernels (K2, K3 csrc/matvec.cu;
// K6, K7 csrc/matvec_batch.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Four consecutive floats of a row of A2, read once (streamed: evict
// first, so that x, r and the partials keep their L2 lines).  `left` >= 1
// is how many floats the row still has from p; the scalar instance masks
// past it.
template <bool kVec>
__device__ __forceinline__ float4 load_a(const float* p, int left) {
  if (kVec) return __ldcs(reinterpret_cast<const float4*>(p));
  float4 a;
  a.x = __ldcs(p);
  a.y = left > 1 ? __ldcs(p + 1) : 0.0f;
  a.z = left > 2 ? __ldcs(p + 2) : 0.0f;
  a.w = left > 3 ? __ldcs(p + 3) : 0.0f;
  return a;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace
