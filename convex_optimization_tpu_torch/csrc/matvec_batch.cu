// K6, K7 — the batched refresh and witness for L <= 16 lambda values over
// the transposed block-major layout A_t (n_blocks, B, m), float32.  Viewed
// flat, A_t is A^T as a row-major (n, m) array A2: row k is column k of A.
// X (n_blocks, L, B) holds the L iterates: x_l[k] for k = j*B + b is
// X[(j*L + l)*B + b].  R (L, m) holds the L residual rows.
//
// Replace the Pallas kernels of convex_optimization_tpu/ops/
// bcd_sweep_vpu_batch.py:
//   K6 `_ax_batch_kernel`  (wrapper ax_minus_b_batch_t): R = A X - b
//   K7 `_atr_batch_kernel` (wrapper neg_at_r_batch_t):  Z = -A^T R - lam2 X
//
// What bounds them on the H100: each streams A once (4 m n bytes, 1 GB at
// 5k x 50k: 0.3 ms at 3.35 TB/s) and does 2 L flops per 4 bytes, still far
// below the card's f32 rate at L = 16, so they are bandwidth-bound like K2
// and K3; every element of A read from HBM serves all L rows, which sit in
// registers (K6: X from the read-only cache) or shared memory (K7: R).
//
// No kernel uses atomics: every sum is in a fixed order, so results are
// reproducible run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 16;

// ---------------------------------------------------------------- K6 ----
// K2's design (csrc/matvec.cu) with L accumulators per thread: threads own
// rows i, so a warp's reads of A2[k, i..i+31] are one coalesced line, and
// the L values x_l[k] a thread needs are the same for the whole CTA
// (broadcast loads).  The n columns are split into S slices (grid.y) that
// write partial sums (S, L, m); a second pass adds the slices in slice
// order and subtracts b.
constexpr int kAxThreads = 256;

__global__ void __launch_bounds__(kAxThreads)
ax_batch_partial_kernel(const float* __restrict__ A2,
                        const float* __restrict__ X,
                        float* __restrict__ partials, int n, int B, int m,
                        int L, int per_slice) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int k0 = s * per_slice;
  const int k1 = min(n, k0 + per_slice);
  if (i >= m) return;
  float acc[kMaxL];
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) acc[l] = 0.0f;
  int j = k0 / B;
  int b = k0 - j * B;
  for (int k = k0; k < k1; ++k) {
    const float a = A2[(size_t)k * m + i];
    const float* xk = X + (size_t)j * L * B + b;
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      if (l < L) acc[l] = fmaf(a, __ldg(xk + l * B), acc[l]);
    }
    if (++b == B) {
      b = 0;
      ++j;
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) {
    if (l < L) partials[((size_t)s * L + l) * m + i] = acc[l];
  }
}

__global__ void __launch_bounds__(kAxThreads)
ax_batch_finish_kernel(const float* __restrict__ partials,
                       const float* __restrict__ b, float* __restrict__ R,
                       int S, int L, int m) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;   // p = l * m + i
  if (p >= L * m) return;
  const int i = p % m;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partials[(size_t)s * L * m + p];
  R[p] = acc - b[i];
}

// ---------------------------------------------------------------- K7 ----
// K3's design (a fixed-order dot over the contiguous row A2[k, :]) for L
// rows of R.  A CTA owns 32 consecutive columns, four per warp.  R is
// staged in shared memory in chunks of kChunk rows (L * kChunk floats) and
// each chunk serves all 32 columns, so R is read from L2 once per CTA,
// not once per column.  Lane t accumulates, for each of its warp's four
// columns and each row l, the products of rows t, t + 32, ... in row
// order; a shuffle tree over the warp finishes each dot.
//
// SUMMATION DEPTH: every product passes through at most ceil(m / 32)
// (the lane's chain) + 5 (warp tree) roundings.  No certificate rests on
// it: the batched path certifies in f32 only, as the JAX package's does.
constexpr int kAtrThreads = 256;
constexpr int kAtrCols = 4;                               // per warp
constexpr int kAtrColsPerCta = kAtrCols * kAtrThreads / 32;
constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kAtrThreads)
neg_at_r_batch_kernel(const float* __restrict__ A2,
                      const float* __restrict__ R,
                      const float* __restrict__ X, float* __restrict__ Z,
                      int n, int B, int m, int L, float lam2) {
  extern __shared__ float r_s[];                          // (L, kChunk)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = blockIdx.x * kAtrColsPerCta + warp * kAtrCols;
  float acc[kAtrCols][kMaxL];
#pragma unroll
  for (int q = 0; q < kAtrCols; ++q) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) acc[q][l] = 0.0f;
  }
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int cl = min(kChunk, m - c0);
    __syncthreads();   // previous chunk consumed
    for (int p = tid; p < L * kChunk; p += blockDim.x) {
      const int l = p / kChunk, i = p - l * kChunk;
      r_s[p] = i < cl ? R[(size_t)l * m + c0 + i] : 0.0f;
    }
    __syncthreads();
    for (int i = lane; i < cl; i += 32) {
      float a[kAtrCols];
#pragma unroll
      for (int q = 0; q < kAtrCols; ++q) {
        const int k = kw + q;
        a[q] = k < n ? __ldg(A2 + (size_t)k * m + c0 + i) : 0.0f;
      }
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) {
        if (l < L) {
          const float r = r_s[l * kChunk + i];
#pragma unroll
          for (int q = 0; q < kAtrCols; ++q) {
            acc[q][l] = fmaf(a[q], r, acc[q][l]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kAtrCols; ++q) {
    const int k = kw + q;
    const int j = k / B, b = k - (k / B) * B;
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      if (l < L) {
        float v = acc[q][l];
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        if (lane == 0 && k < n) {
          const size_t o = ((size_t)j * L + l) * B + b;
          Z[o] = -v - lam2 * X[o];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// R = A X - b for L rows.  partials holds S * L * m floats.
int cot_ax_minus_b_batch_t(const float* A2, const float* X, const float* b,
                           float* R, float* partials, int n_blocks, int B,
                           int m, int L, int S, cudaStream_t stream) {
  if (L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  const int n = n_blocks * B;
  const int per_slice = (n + S - 1) / S;
  const int tiles = (m + kAxThreads - 1) / kAxThreads;
  ax_batch_partial_kernel<<<dim3(tiles, S), kAxThreads, 0, stream>>>(
      A2, X, partials, n, B, m, L, per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fin = (L * m + kAxThreads - 1) / kAxThreads;
  ax_batch_finish_kernel<<<fin, kAxThreads, 0, stream>>>(partials, b, R, S,
                                                         L, m);
  return (int)cudaGetLastError();
}

// Z = -A^T R - lam2 X for L rows.
int cot_neg_at_r_batch_t(const float* A2, const float* R, const float* X,
                         float* Z, int n_blocks, int B, int m, int L,
                         float lam2, cudaStream_t stream) {
  if (L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  const int n = n_blocks * B;
  const size_t smem = sizeof(float) * (size_t)L * kChunk;
  cudaError_t err = cudaFuncSetAttribute(
      neg_at_r_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kAtrColsPerCta - 1) / kAtrColsPerCta;
  neg_at_r_batch_kernel<<<grid, kAtrThreads, smem, stream>>>(A2, R, X, Z, n,
                                                             B, m, L, lam2);
  return (int)cudaGetLastError();
}

}  // extern "C"
