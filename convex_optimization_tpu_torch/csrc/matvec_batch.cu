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
// 5k x 50k: 0.30 ms at 3.35 TB/s) and does 2 L flops per 4 bytes of A, at
// L = 16 0.12 ms of the f32 rate: both are bandwidth-bound.  No tensor
// cores: TF32 would break the 1e-5 tolerances, and the CUDA cores keep up.
//
// The design is about bytes in flight and load instructions per element of
// A.  Little's law at 3.35 TB/s wants ~32 KB of loads in flight per SM:
//   * A is read with 16-byte loads (float4), several issued before their
//     FMAs, from CTAs that fill every SM;
//   * the kernels are templated on Lp = L rounded up to 4 (4, 8, 12, 16;
//     L itself is a run-time argument, the lanes l >= L of the last
//     float4 masked), so the accumulators take about 4 L registers, not
//     4 * 16, and 16 instances cover every L;
//   * the operand that every element of A meets (X for K6, R for K7) is
//     staged once per CTA in shared memory and read there as float4
//     broadcasts, so an element of A costs a quarter of a load instruction
//     instead of L + 1 global loads (K6's first design) or 1 (K7's);
//   * when m % 4 != 0 (or a pointer is not 16-byte aligned) the rows of A2
//     are not 16-byte aligned: the same kernels load A as scalars (the
//     `kVec = false` instances).
//
// No kernel uses atomics: every sum is in a fixed order that depends only
// on (n, m, L) and the card's SM count, so two launches on the same inputs
// give bit-identical results.
//
// The tiling constants below are the variants that were fastest on an
// H100 at config 2's shape (5k x 50k); PERF.md has the table.

#include <cuda_runtime.h>

#include <type_traits>

#include "loads.cuh"

namespace {

constexpr int kMaxL = 16;

__host__ __device__ constexpr int pad4(int L) { return (L + 3) & ~3; }

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Whether lane l < Lp of an instance for Lp = pad4(L) is one of the run's
// L: only the last float4's lanes past its first can be padding.
template <int Lp>
__device__ __forceinline__ bool live(int l, int L) {
  return l < Lp - 3 || l < L;
}

// ---------------------------------------------------------------- K6 ----
// Thread t of CTA (x, s) owns the 4 consecutive columns i0 = 4 (x * 256 +
// t) .. i0 + 3 of R and the rows k of slice s; a warp's float4 loads of
// A2[k, i0..] are 512 contiguous bytes.  The slice's X values are staged
// k-major in shared memory, xs[k_local * Lp + l] (Lp = L rounded up to 4),
// kAxChunk rows at a time: for each row k a thread reads its L values as
// ceil(L / 4) float4 broadcasts.  Each (l, i) accumulates the slice's rows
// in order; the slices' partials (S, L, m) are added in slice order by a
// second pass, which subtracts b.  The partials are 2 S L m 4 bytes of
// traffic beside A's 4 m n.
constexpr int kAxThreads = 256;
constexpr int kAxCols = 4 * kAxThreads;            // columns per CTA
constexpr int kAxChunk = 256;                      // rows of X staged at once
constexpr int kAxUnroll = 4;           // rows k of A loaded before their FMAs
constexpr int kAxMinBlocks = 2;        // CTAs per SM the registers must allow

template <int Lp>
__device__ __forceinline__ void fma_x(float (&acc)[Lp][4], const float4& a,
                                      const float* xk, int L) {
#pragma unroll
  for (int g = 0; g < Lp / 4; ++g) {
    // lanes l >= L of the last float4 are padding, loaded and not used
    const float4 x = *reinterpret_cast<const float4*>(xk + 4 * g);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int l = 4 * g + c;
      if (live<Lp>(l, L)) {
        const float xv = comp(x, c);
        acc[l][0] = fmaf(a.x, xv, acc[l][0]);
        acc[l][1] = fmaf(a.y, xv, acc[l][1]);
        acc[l][2] = fmaf(a.z, xv, acc[l][2]);
        acc[l][3] = fmaf(a.w, xv, acc[l][3]);
      }
    }
  }
}

template <int Lp, bool kVec>
__global__ void __launch_bounds__(kAxThreads, kAxMinBlocks)
ax_batch_partial_kernel(const float* __restrict__ A2,
                        const float* __restrict__ X,
                        float* __restrict__ partials, int n, int B, int m,
                        int L, int per_slice) {
  __shared__ __align__(16) float xs[kAxChunk * Lp];
  const int i0 = blockIdx.x * kAxCols + 4 * threadIdx.x;
  const bool active = i0 < m;
  const int left = m - i0;
  const int k_begin = blockIdx.y * per_slice;
  const int k_end = min(n, k_begin + per_slice);
  float acc[Lp][4];
#pragma unroll
  for (int l = 0; l < Lp; ++l) {
    acc[l][0] = acc[l][1] = acc[l][2] = acc[l][3] = 0.0f;
  }
  for (int c0 = k_begin; c0 < k_end; c0 += kAxChunk) {
    const int ck = min(kAxChunk, k_end - c0);
    __syncthreads();                                  // last chunk consumed
    for (int p = threadIdx.x; p < ck * L; p += kAxThreads) {
      const int l = p / ck, kk = p - l * ck;          // kk fastest: coalesced
      const int k = c0 + kk, j = k / B;
      xs[kk * Lp + l] = X[((size_t)j * L + l) * B + (k - j * B)];
    }
    __syncthreads();
    if (!active) continue;
    const float* a_row = A2 + (size_t)c0 * m + i0;
    int kk = 0;
    for (; kk + kAxUnroll <= ck; kk += kAxUnroll) {
      float4 a[kAxUnroll];
#pragma unroll
      for (int u = 0; u < kAxUnroll; ++u) {
        a[u] = load_a<kVec>(a_row + (size_t)(kk + u) * m, left);
      }
#pragma unroll
      for (int u = 0; u < kAxUnroll; ++u) {
        fma_x<Lp>(acc, a[u], xs + (kk + u) * Lp, L);
      }
    }
    for (; kk < ck; ++kk) {
      fma_x<Lp>(acc, load_a<kVec>(a_row + (size_t)kk * m, left),
                xs + kk * Lp, L);
    }
  }
  if (!active) return;
#pragma unroll
  for (int l = 0; l < Lp; ++l) {
    if (!live<Lp>(l, L)) break;
    float* out = partials + ((size_t)blockIdx.y * L + l) * m + i0;
    if (kVec) {
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[l][0], acc[l][1], acc[l][2], acc[l][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < left) out[c] = acc[l][c];
      }
    }
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
// CTA (g, c) keeps chunk c of R, the columns [c W, c W + W), resident in
// shared memory (L W floats, zero past m; W <= 2560, up to 200 KB): R is
// read from L2 once per CTA, not once per 32 rows of A2 as in the first
// design (312 MB of L2 traffic at config 2).  Its 16 warps then stream
// the CTA's rows k of A2, kAtrRows rows at a time: lane t loads float4s
// of each row at columns 4 t, 4 t + 128, ..., kAtrUnroll steps (2 KB of
// each row per warp) before their FMAs, and each float4 of R it reads
// from shared memory serves all kAtrRows rows in registers.  One CTA of
// 512 threads fills an SM's registers (16 warps), so the chunk can be
// wide: the wider the chunk, the fewer shuffle trees and partials per
// element of A (on an H100 at config 2's shape and L = 16, 2560 columns
// took 0.46 ms where 1280 took 0.58), up to 2560 columns (5120 at L = 10
// took 0.386 ms against 2560's 0.375).  Each lane accumulates its
// columns in order, four products per float4; the fixed xor-shuffle tree
// of the warp finishes each dot over the chunk.  With one chunk (C = 1)
// the warp writes Z; else it writes partials (C, n_blocks, L, B) in Z's
// layout, which a second pass adds in chunk order before it forms
// -v - lam2 x.
//
// SUMMATION DEPTH: every product passes through at most W / 32 (the
// lane's chain over a chunk: 4 products per 128-column step) + 5 (warp
// tree) + (C - 1) (the chunk sums) roundings, and one more for - lam2 x.
// W is a multiple of 128, at most 2560, and C = ceil(m / W)
// (matvec_batch_plan below), so the depth is at most 85 + C: at m = 5000
// W = 2560 and C = 2 at every L, 87 in all (the first design's
// ceil(m / 32) + 5 was 162, and 318 at m = 10000, where this is 89).  No
// certificate rests on it: the batched path certifies in f32 only, as the
// JAX package's does.  A change that lets K7 feed the f64 polish must
// check this depth against ops/matvec witness_gamma.
constexpr int kAtrThreads = 512;
constexpr int kAtrWarps = kAtrThreads / 32;
constexpr int kAtrRows = 2;            // rows of A2 a warp dots at once
constexpr int kAtrUnroll = 4;          // 128-column steps loaded before FMAs
constexpr int kAtrStep = 128;          // columns per warp step
constexpr int kAtrSmemBytes = 200 * 1024;          // one chunk of R
constexpr int kAtrMaxCols = 2560;                  // widest chunk

template <int Lp, bool kVec>
__global__ void __launch_bounds__(kAtrThreads, 1)
atr_batch_kernel(const float* __restrict__ A2, const float* __restrict__ R,
                 const float* __restrict__ X, float* __restrict__ out,
                 int n, int B, int m, int L, int W, int rows_per_cta,
                 float lam2) {
  extern __shared__ float4 r_s4[];
  float* r_s = reinterpret_cast<float*>(r_s4);            // (L, W)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.y * W;
  const int cw = min(W, m - c0);
  if (kVec) {                       // W % 128 == 0 and m % 4 == 0
    const int W4 = W / 4;
    for (int p = tid; p < L * W4; p += kAtrThreads) {
      const int l = p / W4, i = 4 * (p - l * W4);
      r_s4[p] = i < cw ? *reinterpret_cast<const float4*>(
                             R + (size_t)l * m + c0 + i)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int p = tid; p < L * W; p += kAtrThreads) {
      const int l = p / W, i = p - l * W;
      r_s[p] = i < cw ? R[(size_t)l * m + c0 + i] : 0.0f;
    }
  }
  __syncthreads();
  const int k_begin = blockIdx.x * rows_per_cta;
  const int k_end = min(n, k_begin + rows_per_cta);
  const bool direct = gridDim.y == 1;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = k_begin + warp * kAtrRows; k0 < k_end;
       k0 += kAtrWarps * kAtrRows) {
    const int rows = min(kAtrRows, k_end - k0);           // warp-uniform
    const float* a0 = A2 + (size_t)k0 * m + c0;
    float acc[kAtrRows][Lp];
#pragma unroll
    for (int q = 0; q < kAtrRows; ++q) {
#pragma unroll
      for (int l = 0; l < Lp; ++l) acc[q][l] = 0.0f;
    }
    for (int i = 4 * lane; i < cw; i += kAtrStep * kAtrUnroll) {
      float4 a[kAtrUnroll][kAtrRows];
#pragma unroll
      for (int u = 0; u < kAtrUnroll; ++u) {
        const int iu = i + u * kAtrStep;
#pragma unroll
        for (int q = 0; q < kAtrRows; ++q) {
          a[u][q] = iu < cw && q < rows
                        ? load_a<kVec>(a0 + (size_t)q * m + iu, cw - iu)
                        : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < kAtrUnroll; ++u) {
        const int iu = i + u * kAtrStep;
        if (iu >= cw) break;
#pragma unroll
        for (int l = 0; l < Lp; ++l) {
          if (!live<Lp>(l, L)) break;
          const float4 r = r_s4[(l * W + iu) / 4];
#pragma unroll
          for (int q = 0; q < kAtrRows; ++q) {
            acc[q][l] = fmaf(a[u][q].x, r.x, acc[q][l]);
            acc[q][l] = fmaf(a[u][q].y, r.y, acc[q][l]);
            acc[q][l] = fmaf(a[u][q].z, r.z, acc[q][l]);
            acc[q][l] = fmaf(a[u][q].w, r.w, acc[q][l]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kAtrRows; ++q) {
      if (q >= rows) break;
      const int k = k0 + q;
      const int j = k / B, b = k - j * B;
#pragma unroll
      for (int l = 0; l < Lp; ++l) {
        if (!live<Lp>(l, L)) break;
        float v = acc[q][l];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        // every lane holds the same v; one lane per (q, l) writes it
        if (lane == ((q * L + l) & 31)) {
          const size_t o = ((size_t)j * L + l) * B + b;
          if (direct) {
            out[o] = -v - lam2 * X[o];
          } else {
            out[(size_t)blockIdx.y * n * L + o] = v;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(256)
atr_batch_finish_kernel(const float* __restrict__ partials,
                        const float* __restrict__ X, float* __restrict__ Z,
                        int C, int total, float lam2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;   // Z's layout
  if (p >= total) return;
  float v = partials[p];
  for (int c = 1; c < C; ++c) v += partials[(size_t)c * total + p];
  Z[p] = -v - lam2 * X[p];
}

// ------------------------------------------------------------ dispatch ----

// fn(std::integral_constant<int, pad4(L)>{}) for the run-time L in
// 1..kMaxL: the instance whose bucket holds L
template <typename Fn>
int with_bucket(int L, Fn&& fn) {
  switch (L < 1 || L > kMaxL ? 0 : pad4(L)) {
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 12: return fn(std::integral_constant<int, 12>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int Lp>
void* ax_kernel(bool vec) {
  return vec ? (void*)ax_batch_partial_kernel<Lp, true>
             : (void*)ax_batch_partial_kernel<Lp, false>;
}

template <int Lp>
void* atr_kernel(bool vec) {
  return vec ? (void*)atr_batch_kernel<Lp, true>
             : (void*)atr_batch_kernel<Lp, false>;
}

}  // namespace

extern "C" {

// Launch plan of K6 and K7 at (n, m, L) on the current device: plan = {K6
// slices S, K7 chunk width W, K7 chunks C, K7 CTAs per chunk G}.  S fills
// the SMs' co-resident CTA slots with ceil(m / 1024) column tiles; W is
// the widest multiple of 128 columns, at most kAtrMaxCols, whose L W
// floats fit kAtrSmemBytes, evened out over C = ceil(m / W) chunks; G
// fills the slots with C chunks.
// Returns a cudaError_t.
int cot_matvec_batch_plan(int n, int m, int L, int* plan) {
  plan[0] = plan[1] = plan[2] = plan[3] = 0;
  if (L < 1 || L > kMaxL || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const bool vec = m % 4 == 0;
  int W = kAtrSmemBytes / (int)(sizeof(float) * L);
  W = (W < kAtrMaxCols ? W : kAtrMaxCols) / kAtrStep * kAtrStep;
  W = W < kAtrStep ? kAtrStep : W;
  int C = (m + W - 1) / W;
  W = ((m + C - 1) / C + kAtrStep - 1) / kAtrStep * kAtrStep;
  C = (m + W - 1) / W;                                  // no empty chunk
  const size_t smem = sizeof(float) * (size_t)L * W;
  int ax_per_sm = 0, atr_per_sm = 0;
  err = (cudaError_t)with_bucket(L, [&](auto Lc) {
    constexpr int Lp = decltype(Lc)::value;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ax_per_sm, ax_kernel<Lp>(vec), kAxThreads, 0);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(atr_kernel<Lp>(vec),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &atr_per_sm, atr_kernel<Lp>(vec), kAtrThreads, smem);
    }
    return (int)e;
  });
  if (err != cudaSuccess) return (int)err;
  if (ax_per_sm < 1 || atr_per_sm < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int tiles = (m + kAxCols - 1) / kAxCols;
  int S = ax_per_sm * sms / tiles;
  S = S < 1 ? 1 : (S > n ? n : S);
  int G = atr_per_sm * sms / C;
  const int max_G = (n + kAtrWarps * kAtrRows - 1) / (kAtrWarps * kAtrRows);
  G = G < 1 ? 1 : (G > max_G ? max_G : G);
  plan[0] = S;
  plan[1] = W;
  plan[2] = C;
  plan[3] = G;
  return (int)cudaSuccess;
}

// R = A X - b for L rows.  partials holds S * L * m floats.
int cot_ax_minus_b_batch_t(const float* A2, const float* X, const float* b,
                           float* R, float* partials, int n_blocks, int B,
                           int m, int L, int S, cudaStream_t stream) {
  if (L < 1 || L > kMaxL || S < 1) return (int)cudaErrorInvalidValue;
  const int n = n_blocks * B;
  const int per_slice = (n + S - 1) / S;
  const bool vec = m % 4 == 0 && aligned16(A2) && aligned16(partials);
  const dim3 grid((m + kAxCols - 1) / kAxCols, S);
  int err = with_bucket(L, [&](auto Lc) {
    constexpr int Lp = decltype(Lc)::value;
    if (vec) {
      ax_batch_partial_kernel<Lp, true><<<grid, kAxThreads, 0, stream>>>(
          A2, X, partials, n, B, m, L, per_slice);
    } else {
      ax_batch_partial_kernel<Lp, false><<<grid, kAxThreads, 0, stream>>>(
          A2, X, partials, n, B, m, L, per_slice);
    }
    return (int)cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const int fin = (L * m + kAxThreads - 1) / kAxThreads;
  ax_batch_finish_kernel<<<fin, kAxThreads, 0, stream>>>(partials, b, R, S,
                                                         L, m);
  return (int)cudaGetLastError();
}

// Z = -A^T R - lam2 X for L rows, with the plan's chunk width W, C chunks
// and G CTAs per chunk.  partials holds C * n * L floats when C > 1 (it
// may be null when C == 1).
int cot_neg_at_r_batch_t(const float* A2, const float* R, const float* X,
                         float* Z, float* partials, int n_blocks, int B,
                         int m, int L, int W, int C, int G, float lam2,
                         cudaStream_t stream) {
  if (L < 1 || L > kMaxL || W < kAtrStep || W % kAtrStep != 0 || C < 1
      || G < 1 || (long long)W * C < m || (C > 1 && partials == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = n_blocks * B;
  const bool vec = m % 4 == 0 && aligned16(A2) && aligned16(R);
  const size_t smem = sizeof(float) * (size_t)L * W;
  const int rows_per_cta = (n + G - 1) / G;
  float* out = C == 1 ? Z : partials;
  int err = with_bucket(L, [&](auto Lc) {
    constexpr int Lp = decltype(Lc)::value;
    cudaError_t e = cudaFuncSetAttribute(
        atr_kernel<Lp>(vec), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (vec) {
      atr_batch_kernel<Lp, true><<<dim3(G, C), kAtrThreads, smem, stream>>>(
          A2, R, X, out, n, B, m, L, W, rows_per_cta, lam2);
    } else {
      atr_batch_kernel<Lp, false><<<dim3(G, C), kAtrThreads, smem, stream>>>(
          A2, R, X, out, n, B, m, L, W, rows_per_cta, lam2);
    }
    return (int)cudaGetLastError();
  });
  if (err != cudaSuccess || C == 1) return err;
  const int total = n * L;
  atr_batch_finish_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partials, X, Z, C, total, lam2);
  return (int)cudaGetLastError();
}

}  // extern "C"
