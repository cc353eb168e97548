// K2, K3, K4 — one-pass matvecs and the per-block power iteration over the
// transposed block-major layout A_t (n_blocks, B, m), float32.  Viewed
// flat, A_t is A^T as a row-major (n, m) array A2: row k is column k of A.
//
// Replace the Pallas kernels of convex_optimization_tpu/ops/matvec_pallas.py:
//   K2 `_ax_kernel`    (wrapper ax_minus_b_t):  r = A x - b
//   K3 `_atr_kernel`   (wrapper neg_at_r_t):    z = -A^T r - lam2 x
//   K4 `_power_kernel` (wrapper block_power_t): ||A_j||_2^2 per block
//
// What bounds them on the H100: K2 and K3 stream A once (4 m n bytes,
// 4 GB at 10k x 100k: 1.19 ms at 3.35 TB/s; 1 GB at config 2's 5k x 50k:
// 0.30 ms) with 2 flops per 4 bytes, so they are bandwidth-bound.  Little's
// law at 3.35 TB/s wants ~32 KB of loads in flight per SM, so both read A
// with 16-byte streamed loads (float4 `__ldcs`), many issued before their
// FMAs, from grids sized to one wave of co-resident CTAs
// (ops/matvec.matvec_plan asks the occupancy of the C side below).  When
// m % 4 != 0 or a pointer is not 16-byte aligned (slab and slice views of
// A_t reach these kernels), the `kVec = false` instances load A as
// scalars.  K4 runs once per solve; its 49 passes over each 3.2 MB block
// do not fit L2 when 132 blocks run at once, so it re-reads A from HBM
// each iteration (~100 passes over A in all) — set-up work, recorded
// rather than tuned.
//
// No kernel uses atomics: every sum is in a fixed order that depends only
// on (n, m) and the card's SM count, so two launches on the same inputs
// give bit-identical results.

#include <cuda_runtime.h>

#include "loads.cuh"
#include "prox.cuh"

namespace {

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------- K2 ----
// A column sum: r_i = sum_k A2[k, i] x_k.  A CTA owns a tile of 1024
// consecutive columns; lane t of each of its 8 warps owns the float4
// columns 4 t + 128 s (s < 8) of the tile, so a warp reads 4 KB of one
// row at once, 512 contiguous bytes per load instruction, as K3 reads its
// rows.  The CTA's warps take the rows of its slice in turn (warp w: rows
// w, w + 8, ...), each into its own 32 accumulators; the grid is (column
// tiles, S slices of the n rows), S chosen so that the grid is one wave of
// co-resident CTAs (never rounded up past it: a tail of CTAs would run
// alone after the wave).  The slice's x is staged in shared memory
// kAxChunk rows at a time.  Each column accumulates its warp's rows in
// order, the CTA adds its warps' sums in warp order, and a second pass
// adds the slices' partials (S, m) in a fixed order (slices s = y mod 8
// chained by 8 thread rows, then the 8 sums in order) and subtracts b.
// (A layout with one float4 per thread per row, a warp reading 512 bytes
// of each row, was 3 % slower on an H100 at the headline's A_t: PERF.md.)
constexpr int kAxThreads = 256;
constexpr int kAxWarps = kAxThreads / 32;
constexpr int kAxStripes = 8;          // float4 columns per lane
constexpr int kAxCols4 = 32 * kAxStripes;          // float4s per tile
constexpr int kAxChunk = 1024;         // rows of x staged at once

__device__ __forceinline__ void fma4(float4& acc, const float4& a, float x) {
  acc.x = fmaf(a.x, x, acc.x);
  acc.y = fmaf(a.y, x, acc.y);
  acc.z = fmaf(a.z, x, acc.z);
  acc.w = fmaf(a.w, x, acc.w);
}

template <bool kVec>
__global__ void __launch_bounds__(kAxThreads, 2)
ax_partial_kernel(const float* __restrict__ A2, const float* __restrict__ x,
                  float* __restrict__ partials, int n, int m,
                  int per_slice) {
  __shared__ __align__(16) float xs[kAxChunk];
  __shared__ float4 red[kAxWarps - 1][kAxCols4];               // 28 KB
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i_base = 4 * (blockIdx.x * kAxCols4 + lane);  // + 128 s
  const int k_begin = blockIdx.y * per_slice;
  const int k_end = min(n, k_begin + per_slice);
  float4 acc[kAxStripes];
#pragma unroll
  for (int s = 0; s < kAxStripes; ++s) acc[s] = zero4();
  for (int c0 = k_begin; c0 < k_end; c0 += kAxChunk) {
    const int ck = min(kAxChunk, k_end - c0);
    __syncthreads();                                  // last chunk consumed
    for (int p = threadIdx.x; p < ck; p += kAxThreads) xs[p] = x[c0 + p];
    __syncthreads();
    for (int kk = warp; kk < ck; kk += kAxWarps) {
      const float* a_row = A2 + (size_t)(c0 + kk) * m;
      float4 a[kAxStripes];
#pragma unroll
      for (int s = 0; s < kAxStripes; ++s) {
        const int i = i_base + 128 * s;
        a[s] = i < m ? load_a<kVec>(a_row + i, m - i) : zero4();
      }
      const float xv = xs[kk];
#pragma unroll
      for (int s = 0; s < kAxStripes; ++s) fma4(acc[s], a[s], xv);
    }
  }
  if (warp > 0) {
#pragma unroll
    for (int s = 0; s < kAxStripes; ++s) red[warp - 1][32 * s + lane] = acc[s];
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int s = 0; s < kAxStripes; ++s) {
    for (int w = 0; w < kAxWarps - 1; ++w) {
      const float4 v = red[w][32 * s + lane];
      acc[s].x += v.x;
      acc[s].y += v.y;
      acc[s].z += v.z;
      acc[s].w += v.w;
    }
    const int i = i_base + 128 * s;
    if (i >= m) continue;
    float* out = partials + (size_t)blockIdx.y * m + i;
    if (kVec) {
      *reinterpret_cast<float4*>(out) = acc[s];
    } else {
      out[0] = acc[s].x;
      if (m - i > 1) out[1] = acc[s].y;
      if (m - i > 2) out[2] = acc[s].z;
      if (m - i > 3) out[3] = acc[s].w;
    }
  }
}

constexpr int kFinRows = 8;            // slice chains per column

__global__ void __launch_bounds__(32 * kFinRows)
ax_finish_kernel(const float* __restrict__ partials,
                 const float* __restrict__ b, float* __restrict__ r, int S,
                 int m) {
  __shared__ float part[kFinRows][32];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + tx;
  float acc = 0.0f;
  if (i < m) {
    for (int s = ty; s < S; s += kFinRows) acc += partials[(size_t)s * m + i];
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty != 0 || i >= m) return;
#pragma unroll
  for (int y = 1; y < kFinRows; ++y) acc += part[y][tx];
  r[i] = acc - b[i];
}

// ---------------------------------------------------------------- K3 ----
// Row dots: z_k = -(A2[k, :] . r) - lam2 x_k.  A persistent grid of G CTAs
// per chunk of r fills the SMs (one wave); warp w of CTA g takes the rows
// k = 16 g + w, k + 16 G, ... (one warp per row; the order in which rows
// are taken does not touch any row's sum).  Each CTA first stages its
// chunk of r, W floats zero-padded (W a multiple of 1024, at most
// kAtrMaxCols: 112 KB, so two 512-thread CTAs share an SM), in shared
// memory: r crosses L2 once per CTA, not once per row.  Lane t of a warp
// reads float4s of its row at columns 4 t + 128 u; a GROUP is 8 such
// steps (1024 columns, 4 KB of the row per warp loaded before any FMA).
//
// SUMMATION ORDER AND DEPTH (the f64 polish's certificate margin rests on
// it).  Per lane, the 4 products of a float4 are summed as a tree
// (fma(a.x, r.x, a.y r.y) + fma(a.z, r.z, a.w r.w)), the group's 8 float4
// sums as a pairwise tree, the group sums chained K at a time into a
// supergroup sum, and the supergroup sums chained; then the fixed
// xor-shuffle tree of the warp; with C > 1 chunks a second pass adds the
// chunk sums in chunk order.  With g = W / 1024 groups per chunk, K =
// ceil(sqrt(g)) and S = ceil(g / K) supergroups, every product passes
// through at most
//     D(m) = 1 (product) + 2 (float4 tree) + 3 (group tree)
//            + (K - 1) + (S - 1) (the two chains) + 5 (warp tree)
//            + (C - 1) (chunk sums)
// roundings, so |z32 - A^T r| <= gamma_D ||A_k|| ||r|| with gamma_D = D u
// / (1 - D u), u = 2^-24 (fused multiply-adds only remove roundings; the
// - lam2 x term adds none when lam2 = 0, as the witness calls it).  D is
// 14 at m = 5000, 16 at 10000, 18 at 20000 and 20 at 50000 (C = 2), at
// most 2 ceil(log2 m) from m = 2048 to 50000 and never above the first
// design's ceil(m / 2048) + 11 (ops/matvec.py: k3_chunking, k3_depth,
// witness_gamma).
constexpr int kAtrThreads = 512;
constexpr int kAtrWarps = kAtrThreads / 32;
constexpr int kAtrStep = 128;                      // columns per warp step
constexpr int kAtrGroup = 8;                       // steps per group
constexpr int kAtrGroupCols = kAtrStep * kAtrGroup;
constexpr int kAtrMaxCols = 28 * kAtrGroupCols;    // widest chunk of r
constexpr int kAtrMinBlocks = 2;

template <bool kVec>
__global__ void __launch_bounds__(kAtrThreads, kAtrMinBlocks)
neg_at_r_kernel(const float* __restrict__ A2, const float* __restrict__ r,
                const float* __restrict__ x, float* __restrict__ out, int n,
                int m, int W, int K, float lam2) {
  extern __shared__ float4 r_s4[];
  float* r_s = reinterpret_cast<float*>(r_s4);                 // (W,)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.y * W;
  const int cw = min(W, m - c0);
  if (kVec) {                            // m % 4 == 0: cw % 4 == 0
    for (int p = tid; p < W / 4; p += kAtrThreads) {
      r_s4[p] = 4 * p < cw ? *reinterpret_cast<const float4*>(r + c0 + 4 * p)
                           : zero4();
    }
  } else {
    for (int p = tid; p < W; p += kAtrThreads) {
      r_s[p] = p < cw ? r[c0 + p] : 0.0f;
    }
  }
  __syncthreads();
  const bool direct = gridDim.y == 1;
  for (int k = blockIdx.x * kAtrWarps + warp; k < n;
       k += gridDim.x * kAtrWarps) {
    const float* a = A2 + (size_t)k * m + c0;
    float chain = 0.0f;                  // the open supergroup's sum
    float total = 0.0f;                  // the closed supergroups' sum
    int in_super = 0;
    for (int g0 = 0; g0 < cw; g0 += kAtrGroupCols) {
      float4 av[kAtrGroup];
#pragma unroll
      for (int u = 0; u < kAtrGroup; ++u) {
        const int iu = g0 + u * kAtrStep + 4 * lane;
        av[u] = iu < cw ? load_a<kVec>(a + iu, cw - iu) : zero4();
      }
      float p[kAtrGroup];
#pragma unroll
      for (int u = 0; u < kAtrGroup; ++u) {
        const float4 rv = r_s4[(g0 + u * kAtrStep) / 4 + lane];
        p[u] = fmaf(av[u].x, rv.x, av[u].y * rv.y)
               + fmaf(av[u].z, rv.z, av[u].w * rv.w);
      }
      chain += ((p[0] + p[1]) + (p[2] + p[3]))
               + ((p[4] + p[5]) + (p[6] + p[7]));
      if (++in_super == K) {
        total += chain;
        chain = 0.0f;
        in_super = 0;
      }
    }
    const float v = warp_sum(total + chain);
    if (lane == 0) {
      if (direct) {
        out[k] = -v - lam2 * x[k];
      } else {
        out[(size_t)blockIdx.y * n + k] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(256)
atr_finish_kernel(const float* __restrict__ partials,
                  const float* __restrict__ x, float* __restrict__ z, int C,
                  int n, float lam2) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float v = partials[k];
  for (int c = 1; c < C; ++c) v += partials[(size_t)c * n + k];
  z[k] = -v - lam2 * x[k];
}

// ---------------------------------------------------------------- K4 ----
// One CTA per block j runs the whole power iteration on A_j^T = A_t[j]
// (B, m), read from global memory (L2 where it still holds the block):
//   v0 = 1 + 0.01 b / B  (the TPU kernel's tilted ones vector)
//   repeat iters times:  u = A_j v (m,);  w = A_j^T u (B,);  v = w / ||w||
//   out[j] = safety * ||A_j v||^2 / ||v||^2
// u lives in shared memory (4 m bytes), v and w beside it.
constexpr int kPowThreads = 256;

__global__ void __launch_bounds__(kPowThreads)
block_power_kernel(const float* __restrict__ A_t, float* __restrict__ out,
                   int B, int m, int iters, float safety) {
  extern __shared__ float sm[];
  float* u = sm;          // (m,)
  float* v = u + m;       // (B,)
  float* w = v + B;       // (B,)
  float* red = w + B;     // (32,)
  const float* Aj = A_t + (size_t)blockIdx.x * B * m;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int b = tid; b < B; b += blockDim.x) {
    v[b] = 1.0f + (0.01f * (float)b) / (float)B;
  }
  __syncthreads();
  for (int it = 0; it <= iters; ++it) {
    for (int i = tid; i < m; i += blockDim.x) {   // u = A_j v
      float s = 0.0f;
      for (int b = 0; b < B; ++b) s = fmaf(Aj[(size_t)b * m + i], v[b], s);
      u[i] = s;
    }
    __syncthreads();
    if (it == iters) break;
    for (int b = warp; b < B; b += nwarps) {      // w = A_j^T u
      float s = 0.0f;
      for (int i = lane; i < m; i += 32) {
        s = fmaf(Aj[(size_t)b * m + i], u[i], s);
      }
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) w[b] = s;
    }
    __syncthreads();
    if (warp == 0) {                               // v = w / ||w||
      float s = 0.0f;
      for (int b = lane; b < B; b += 32) s = fmaf(w[b], w[b], s);
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      const float nrm = fmaxf(sqrtf(s), 1e-30f);
      for (int b = lane; b < B; b += 32) v[b] = w[b] / nrm;
    }
    __syncthreads();
  }
  // Rayleigh quotient ||A_j v||^2 / ||v||^2
  float s = 0.0f;
  for (int i = tid; i < m; i += blockDim.x) s = fmaf(u[i], u[i], s);
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      t += __shfl_xor_sync(0xffffffffu, t, off);
    }
    if (lane == 0) {
      float d = 0.0f;
      for (int b = 0; b < B; ++b) d = fmaf(v[b], v[b], d);
      out[blockIdx.x] = safety * t / fmaxf(d, 1e-30f);
    }
  }
}


void* ax_kernel(bool vec) {
  return vec ? (void*)ax_partial_kernel<true>
             : (void*)ax_partial_kernel<false>;
}

void* atr_kernel(bool vec) {
  return vec ? (void*)neg_at_r_kernel<true> : (void*)neg_at_r_kernel<false>;
}

}  // namespace

extern "C" {

const char* cot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Co-resident CTAs per SM on the current device, the fewer of each
// kernel's two instances: out = {K2, K3 with k3_smem bytes of r}.
// ops/matvec.matvec_tiling sizes the grids from them.  Returns a
// cudaError_t.
int cot_matvec_occupancy(int k3_smem, int* out) {
  out[0] = out[1] = 0;
  if (k3_smem < 0 || k3_smem > (int)sizeof(float) * kAtrMaxCols) {
    return (int)cudaErrorInvalidValue;
  }
  for (int v = 0; v < 2; ++v) {
    int k2 = 0, k3 = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k2, ax_kernel(v == 1), kAxThreads, 0);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(atr_kernel(v == 1),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 k3_smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &k3, atr_kernel(v == 1), kAtrThreads, k3_smem);
    }
    if (err != cudaSuccess) return (int)err;
    out[0] = v == 0 || k2 < out[0] ? k2 : out[0];
    out[1] = v == 0 || k3 < out[1] ? k3 : out[1];
  }
  return (int)cudaSuccess;
}

// r = A x - b on a grid of (ceil(m / 1024) column tiles, S slices).
// partials holds S * m floats.  vec: the float4 instance, which needs
// m % 4 == 0 and A2 and partials 16-byte aligned.
int cot_ax_minus_b_t(const float* A2, const float* x, const float* b,
                     float* r, float* partials, int n, int m, int S, int vec,
                     cudaStream_t stream) {
  if (S < 1 || S > n
      || (vec && (m % 4 != 0 || !aligned16(A2) || !aligned16(partials)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int per_slice = (n + S - 1) / S;
  const dim3 grid((m + 4 * kAxCols4 - 1) / (4 * kAxCols4), S);
  if (vec) {
    ax_partial_kernel<true><<<grid, kAxThreads, 0, stream>>>(
        A2, x, partials, n, m, per_slice);
  } else {
    ax_partial_kernel<false><<<grid, kAxThreads, 0, stream>>>(
        A2, x, partials, n, m, per_slice);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ax_finish_kernel<<<(m + 31) / 32, 32 * kFinRows, 0, stream>>>(partials, b,
                                                                r, S, m);
  return (int)cudaGetLastError();
}

// z = -A^T r - lam2 x on a grid of (G CTAs, C chunks of W columns of r),
// the group sums chained K at a time (the K3 note).  partials holds C * n
// floats when C > 1 (it may be null when C == 1).  vec: the float4
// instance, which needs m % 4 == 0 and A2 and r 16-byte aligned.
int cot_neg_at_r_t(const float* A2, const float* r, const float* x, float* z,
                   float* partials, int n, int m, int W, int C, int G, int K,
                   int vec, float lam2, cudaStream_t stream) {
  if (W < kAtrGroupCols || W % kAtrGroupCols != 0 || W > kAtrMaxCols
      || C < 1 || (long long)W * C < m || (long long)W * (C - 1) >= m
      || G < 1 || K < 1 || (C > 1 && partials == nullptr)
      || (vec && (m % 4 != 0 || !aligned16(A2) || !aligned16(r)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)sizeof(float) * W;
  void* kernel = atr_kernel(vec != 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  float* out = C == 1 ? z : partials;
  void* args[] = {(void*)&A2, (void*)&r, (void*)&x, (void*)&out, (void*)&n,
                  (void*)&m, (void*)&W, (void*)&K, (void*)&lam2};
  err = cudaLaunchKernel(kernel, dim3(G, C), dim3(kAtrThreads), args,
                         (size_t)smem, stream);
  if (err != cudaSuccess || C == 1) return (int)err;
  atr_finish_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partials, x, z, C,
                                                         n, lam2);
  return (int)cudaGetLastError();
}

// out[j] = safety * ||A_j||_2^2 estimate, j < n_blocks.
int cot_block_power_t(const float* A_t, float* out, int n_blocks, int B,
                      int m, int iters, float safety, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)m + 2 * (size_t)B + 32);
  cudaError_t err = cudaFuncSetAttribute(
      block_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_power_kernel<<<n_blocks, kPowThreads, smem, stream>>>(
      A_t, out, B, m, iters, safety);
  return (int)cudaGetLastError();
}

}  // extern "C"
