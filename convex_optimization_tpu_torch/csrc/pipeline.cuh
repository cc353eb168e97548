// The copy pipeline and the grid barrier shared by the persistent sweep
// kernels (K1 and K8 csrc/sweep.cu, K5 csrc/sweep_batch.cu, K9
// csrc/sweep_tiled.cu): cp.async of 16 or 4 bytes, bulk copies (1-D TMA)
// on mbarriers, an integer arrival-counter grid barrier, and W-float
// shared-memory accesses.
#pragma once

#include <cuda_runtime.h>

namespace {

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

// The bulk-copy engine (1-D TMA, sm_90): one instruction copies `bytes`
// (a multiple of 16; both addresses 16-byte aligned) global -> shared and
// reports them on an mbarrier, whose phase completes once its expected
// arrivals and bytes are in.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more to come.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__host__ __device__ inline int up4(int v, bool vec) {
  return vec ? (v + 3) & ~3 : v;
}

// Grid barrier on an arrival counter in global memory (zero at launch; the
// cooperative launch guarantees that all G CTAs are resident): after
// __syncthreads, thread 0 adds 1 with release semantics (ordering its CTA's
// writes before it) and spins with acquire loads until the count reaches
// `target` (G per barrier so far); __syncthreads then releases the CTA.
// Integer counting only: no float atomics.
__device__ __forceinline__ void counter_barrier(unsigned* count,
                                                unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count),
                 "r"(1u)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(count)
                   : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// W consecutive floats in shared memory (16-byte aligned when W = 4):
// load into v, add to v, store v.
template <int W>
__device__ __forceinline__ void ld_w(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int W>
__device__ __forceinline__ void add_w(const float* p, float (&v)[W]) {
  float t[W];
  ld_w<W>(p, t);
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] += t[i];
}

template <int W>
__device__ __forceinline__ void st_w(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

}  // namespace
