// K2, K3, K4 — one-pass matvecs and the per-block power iteration over the
// transposed block-major layout A_t (n_blocks, B, m), float32.  Viewed
// flat, A_t is A^T as a row-major (n, m) array A2: row k is column k of A.
//
// Replace the Pallas kernels of convex_optimization_tpu/ops/matvec_pallas.py:
//   K2 `_ax_kernel`    (wrapper ax_minus_b_t):  r = A x - b
//   K3 `_atr_kernel`   (wrapper neg_at_r_t):    z = -A^T r - lam2 x
//   K4 `_power_kernel` (wrapper block_power_t): ||A_j||_2^2 per block,
//      also as its two stages (block_gram_t: the Gram matrices;
//      block_power_gram_t: the iteration on them), so that the row- and
//      grid-sharded solvers sum the Grams of their row slabs in between
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
// scalars.  K4 runs once per solve, path or rank.  The TPU kernel's 48
// power iterations only ever apply A_j^T A_j, so K4 forms each block's
// Gram matrix G_j = A_t[j] A_t[j]^T (B x B) in one pass over A, then
// iterates on G_j, which is B / m of the block's size: it is bound by
// one read of A or by the Gram's f32 multiply-adds (one triangle: B^2 m
// per block), whichever is larger (the K4 note).
//
// No kernel uses atomics: every sum is in a fixed order that depends only
// on (n, m) and the card's SM count, so two launches on the same inputs
// give bit-identical results.

#include <cuda_runtime.h>

#include "loads.cuh"
#include "pipeline.cuh"
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
// The TPU kernel runs, on the VMEM-resident block A_j^T = A_t[j] (B, m):
//   v0 = 1 + 0.01 b / B;
//   iters times: w = A_j^T (A_j v), v = w / max(||w||, 1e-30)
//   out[j] = safety * ||A_j v||^2 / max(||v||^2, 1e-30)
// Here the same iterates run on G_j = A_t[j] A_t[j]^T: w = G_j v, and
// ||A_j v||^2 = v^T G_j v (equal in exact arithmetic; the CPU tests hold
// this reassociation to the JAX kernel).
//
// Gram phase (gram_kernel): a CTA of D x D threads forms one (D T) x
// (D T) tile (I, J), I <= J, of the upper triangle of G_j's tiles, over
// one slice of the m columns; thread (ty, tx) owns rows ty + D t and
// columns tx + D u (t, u < T) in registers.  A_t[j]'s rows stream along m
// through a kGramStages ring of cp.async copies (16 bytes where m % 4 ==
// 0 and A_t is 16-byte aligned, else 4), kGramBK columns per stage, each
// row padded to kGramLd floats so that the float4 reads along m are free
// of bank conflicts; a diagonal tile loads one operand and forms only
// the pairs u >= t (55 of 100 at T = 10, 36 of 64 at T = 8).  Each sum
// runs along m in order; an off-diagonal tile is stored twice (mirrored),
// so G_j is exactly symmetric.  Where the tiles cannot fill the card the
// m columns are cut into S slices (grid.y) whose partial Grams
// gram_sum_kernel adds in slice order.  Tiles (ops/matvec.power_tiling):
// one per block for B <= 80 (80: D 8, T 10) and B <= 200 (200: D 20, T
// 10), else the triangle of 128-tiles (D 16, T 8).  The shared-memory
// reads bound the FMAs here (a float4 read feeds 2 T or, on a diagonal
// tile, T + 1 of them): on an H100 the T = 5 tiles of the first build
// took 3.56 ms at the headline and 38.4 ms at config 4's B = 200 against
// 2.52 and 29.8 for T = 10 (PERF.md).
//
// Iteration phase, by shape (ops/matvec.power_tiling):
//   route 0, G_j fits shared memory (4 (B^2 + 2 B) bytes, B <= 240):
//     power_smem_kernel, one CTA per block, loads G_j once and runs every
//     step on chip: thread i forms w_i = sum_k G[k, i] v_k in k order
//     (G symmetric: a column, read without bank conflicts); every warp
//     sums ||w||^2 in the same order;
//   route 1, larger B: G stays in global memory and each step is one
//     launch of power_step_kernel over all blocks (32 columns of G_j per
//     CTA, its 8 warps taking every 8th row, the warps' sums added in
//     warp order); each CTA normalises the last step's w itself, all in
//     the same order, and power_finish_kernel forms the Rayleigh quotient.
//
// What bounds K4 on the H100: one read of A (4 n m bytes) against the
// triangle's B m n f32 flops (B (B + 1) / 2 sums of m multiply-adds a
// block) at 67 TFLOP/s: 1.19 ms against 1.2 ms at
// the headline (1250 x 80 x 10000), 4.8 against 12 at config 4's B =
// 200, 4.8 against 120 at B = 2000; the iterations read G (4 B n bytes,
// from L2 or shared memory on route 0, 48 times from HBM on route 1).
// No atomics: two launches give the same bits.
constexpr int kGramBK = 32;                // columns of A_t per stage
constexpr int kGramLd = kGramBK + 4;       // padded row of a stage (floats)
constexpr int kGramStages = 3;
constexpr int kPowThreads = 256;
constexpr int kPowWarps = kPowThreads / 32;
constexpr int kStepCols = 32;              // columns of G_j per step CTA
constexpr size_t kPowMaxSmem = 227 * 1024;  // route 0's G_j, v and w

__host__ __device__ inline int tri_tiles(int nt) { return nt * (nt + 1) / 2; }

// Tile p of the upper triangle of an nt x nt grid, in row order.
__device__ __forceinline__ void tri_tile(int p, int nt, int& I, int& J) {
  int i = 0;
  while (p >= nt - i) {
    p -= nt - i;
    ++i;
  }
  I = i;
  J = i + p;
}

// Stage the kTile rows row0.. of A_j, columns [kc, kc + kGramBK), into
// dst (zeros past B rows or past k_end).
template <int kTile, int kThreads, int V>
__device__ __forceinline__ void gram_stage(float* dst, const float* Aj,
                                           int row0, int B, int m, int kc,
                                           int k_end) {
  constexpr int kPer = kGramBK / V;
  for (int e = threadIdx.x; e < kTile * kPer; e += kThreads) {
    const int r = e / kPer;
    const int q = (e - r * kPer) * V;
    float* d = dst + r * kGramLd + q;
    if (row0 + r < B && kc + q < k_end) {
      cp_async<V>(d, Aj + (size_t)(row0 + r) * m + kc + q);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] = 0.0f;
    }
  }
}

// acc[t][u] += sum over one stage of rows (ty + D t) of As times rows
// (tx + D u) of Bs; kTri: only u >= t.
template <int D, int T, bool kTri>
__device__ __forceinline__ void gram_mac(const float* As, const float* Bs,
                                         int tx, int ty,
                                         float (&acc)[T][T]) {
#pragma unroll
  for (int kk = 0; kk < kGramBK; kk += 4) {
    float4 a[T], b[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      a[t] = *reinterpret_cast<const float4*>(As + (ty + D * t) * kGramLd
                                              + kk);
    }
#pragma unroll
    for (int u = 0; u < T; ++u) {
      b[u] = *reinterpret_cast<const float4*>(Bs + (tx + D * u) * kGramLd
                                              + kk);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int u = 0; u < T; ++u) {
        if (kTri && u < t) continue;
        float s = acc[t][u];
        s = fmaf(a[t].x, b[u].x, s);
        s = fmaf(a[t].y, b[u].y, s);
        s = fmaf(a[t].z, b[u].z, s);
        s = fmaf(a[t].w, b[u].w, s);
        acc[t][u] = s;
      }
    }
  }
}

// grid (n_blocks x tiles, S): out (S, n_blocks, B, B), slice s of the m
// columns [s per_slice, (s + 1) per_slice).  kOne: one tile covers G_j
// (nt = 1), so every CTA is diagonal and only the pairs u >= t hold
// registers.
template <int D, int T, bool kVec, bool kOne>
__global__ void __launch_bounds__(D * D)
gram_kernel(const float* __restrict__ A_t, float* __restrict__ out, int B,
            int m, int per_slice, int nt) {
  constexpr int kTile = D * T;
  constexpr int kThreads = D * D;
  constexpr int kOp = kTile * kGramLd;          // floats of one operand
  constexpr int V = kVec ? 4 : 1;
  extern __shared__ float4 gram_smem4[];
  float* ring = reinterpret_cast<float*>(gram_smem4);
  const int tiles = tri_tiles(nt);
  const int j = blockIdx.x / tiles;
  int I = 0, J = 0;
  if (!kOne) tri_tile(blockIdx.x - j * tiles, nt, I, J);
  const bool diag = kOne || I == J;
  const int stage = (kOne ? 1 : 2) * kOp;
  const float* Aj = A_t + (size_t)j * B * m;
  const int k_begin = blockIdx.y * per_slice;
  const int k_end = min(m, k_begin + per_slice);
  const int nk = (k_end - k_begin + kGramBK - 1) / kGramBK;
  const int tx = threadIdx.x % D;
  const int ty = threadIdx.x / D;

  float acc[T][T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int u = 0; u < T; ++u) acc[t][u] = 0.0f;
  }
  auto issue = [&](int c) {
    float* st = ring + (c % kGramStages) * stage;
    const int kc = k_begin + c * kGramBK;
    gram_stage<kTile, kThreads, V>(st, Aj, I * kTile, B, m, kc, k_end);
    if (!diag) {
      gram_stage<kTile, kThreads, V>(st + kOp, Aj, J * kTile, B, m, kc,
                                     k_end);
    }
  };
#pragma unroll
  for (int c = 0; c < kGramStages - 1; ++c) {
    if (c < nk) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kGramStages - 2>();
    __syncthreads();                  // stage c in; stage c - 1 consumed
    if (c + kGramStages - 1 < nk) issue(c + kGramStages - 1);
    cp_async_commit();
    const float* As = ring + (c % kGramStages) * stage;
    if (diag) {
      gram_mac<D, T, true>(As, As, tx, ty, acc);
    } else {
      gram_mac<D, T, false>(As, As + kOp, tx, ty, acc);
    }
  }
  float* Gj = out + ((size_t)blockIdx.y * (gridDim.x / tiles) + j) * B * B;
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (diag && u < t) continue;
      const int r = I * kTile + ty + D * t;
      const int c = J * kTile + tx + D * u;
      if (r >= B || c >= B) continue;
      Gj[(size_t)r * B + c] = acc[t][u];
      if (!diag || u > t) Gj[(size_t)c * B + r] = acc[t][u];
    }
  }
}

// G[e] = sum of the S partial Grams P[s][e], in slice order.
__global__ void __launch_bounds__(256)
gram_sum_kernel(const float* __restrict__ P, float* __restrict__ G,
                size_t count, int S) {
  for (size_t e = (size_t)blockIdx.x * 256 + threadIdx.x; e < count;
       e += (size_t)gridDim.x * 256) {
    float s = P[e];
    for (int q = 1; q < S; ++q) s += P[(size_t)q * count + e];
    G[e] = s;
  }
}

__device__ __forceinline__ float power_start(int b, int B) {
  return 1.0f + (0.01f * (float)b) / (float)B;
}

// Route 0: one CTA per block, G_j in shared memory for every step.
__global__ void __launch_bounds__(kPowThreads)
power_smem_kernel(const float* __restrict__ G, float* __restrict__ out,
                  int B, int iters, float safety) {
  extern __shared__ float4 pow_smem4[];
  float* Gs = reinterpret_cast<float*>(pow_smem4);     // (B, B)
  float* v = Gs + (size_t)B * B;                       // (B,)
  float* w = v + B;                                    // (B,)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* Gj = G + (size_t)blockIdx.x * B * B;
  for (int e = tid; e < B * B; e += kPowThreads) Gs[e] = Gj[e];
  for (int b = tid; b < B; b += kPowThreads) v[b] = power_start(b, B);
  __syncthreads();
  for (int it = 0;; ++it) {
    for (int i = tid; i < B; i += kPowThreads) {        // w = G_j v
      float s = 0.0f;
      for (int k = 0; k < B; ++k) s = fmaf(Gs[k * B + i], v[k], s);
      w[i] = s;
    }
    __syncthreads();
    if (it == iters) break;
    float s = 0.0f;                                     // every warp alike
    for (int b = lane; b < B; b += 32) s = fmaf(w[b], w[b], s);
    const float nrm = fmaxf(sqrtf(warp_sum(s)), 1e-30f);
    for (int b = tid; b < B; b += kPowThreads) v[b] = w[b] / nrm;
    __syncthreads();
  }
  if (tid < 32) {                     // v^T G_j v / v^T v
    float num = 0.0f, den = 0.0f;
    for (int b = lane; b < B; b += 32) {
      num = fmaf(v[b], w[b], num);
      den = fmaf(v[b], v[b], den);
    }
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) out[blockIdx.x] = safety * num / fmaxf(den, 1e-30f);
  }
}

// Route 1's v for block j into shared memory: the start vector when
// w_prev is null, else w_prev / max(||w_prev||, 1e-30), the norm summed in
// one fixed order (every CTA of the block, and power_finish_kernel, get
// the same bits).
__device__ void power_v(const float* __restrict__ w_prev, float* v,
                        float* red, int B) {
  const int tid = threadIdx.x;
  if (w_prev == nullptr) {
    for (int b = tid; b < B; b += kPowThreads) v[b] = power_start(b, B);
    __syncthreads();
    return;
  }
  float s = 0.0f;
  for (int b = tid; b < B; b += kPowThreads) s = fmaf(w_prev[b], w_prev[b], s);
  s = warp_sum(s);
  if ((tid & 31) == 0) red[tid >> 5] = s;
  __syncthreads();
  float t = 0.0f;
  for (int q = 0; q < kPowWarps; ++q) t += red[q];
  const float nrm = fmaxf(sqrtf(t), 1e-30f);
  for (int b = tid; b < B; b += kPowThreads) v[b] = w_prev[b] / nrm;
  __syncthreads();
}

// Route 1, one step: w_out = G_j v for every block (grid: ceil(B / 32)
// column groups, n_blocks).
__global__ void __launch_bounds__(kPowThreads)
power_step_kernel(const float* __restrict__ G,
                  const float* __restrict__ w_prev, float* __restrict__ w_out,
                  int B) {
  extern __shared__ float4 step_smem4[];
  float* v = reinterpret_cast<float*>(step_smem4);     // (B,)
  __shared__ float red[kPowWarps];
  __shared__ float part[kPowWarps][kStepCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.y;
  power_v(w_prev == nullptr ? nullptr : w_prev + (size_t)j * B, v, red, B);
  const int col = blockIdx.x * kStepCols + lane;
  const float* Gj = G + (size_t)j * B * B;
  float s = 0.0f;
  if (col < B) {
#pragma unroll 8
    for (int k = warp; k < B; k += kPowWarps) {
      s = fmaf(Gj[(size_t)k * B + col], v[k], s);
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < B) {
    float t = part[0][lane];
    for (int q = 1; q < kPowWarps; ++q) t += part[q][lane];
    w_out[(size_t)j * B + col] = t;
  }
}

// Route 1's Rayleigh quotient: v from the last step's input, u = G_j v
// its output; out[j] = safety v^T u / max(v^T v, 1e-30).
__global__ void __launch_bounds__(kPowThreads)
power_finish_kernel(const float* __restrict__ w_prev,
                    const float* __restrict__ u, float* __restrict__ out,
                    int B, float safety) {
  extern __shared__ float4 fin_smem4[];
  float* v = reinterpret_cast<float*>(fin_smem4);      // (B,)
  __shared__ float red[kPowWarps];
  __shared__ float rn[kPowWarps], rd[kPowWarps];
  const int tid = threadIdx.x;
  const int j = blockIdx.x;
  power_v(w_prev == nullptr ? nullptr : w_prev + (size_t)j * B, v, red, B);
  const float* uj = u + (size_t)j * B;
  float num = 0.0f, den = 0.0f;
  for (int b = tid; b < B; b += kPowThreads) {
    num = fmaf(v[b], uj[b], num);
    den = fmaf(v[b], v[b], den);
  }
  num = warp_sum(num);
  den = warp_sum(den);
  if ((tid & 31) == 0) {
    rn[tid >> 5] = num;
    rd[tid >> 5] = den;
  }
  __syncthreads();
  if (tid == 0) {
    float N = 0.0f, Dn = 0.0f;
    for (int q = 0; q < kPowWarps; ++q) {
      N += rn[q];
      Dn += rd[q];
    }
    out[j] = safety * N / fmaxf(Dn, 1e-30f);
  }
}

// The Gram instance for a tile edge: 80 (D 8, T 10) and 200 (D 20, T
// 10), one tile per block; 128 (D 16, T 8), the upper triangle of tiles;
// its threads per CTA in *threads; null for another edge.
template <bool kVec>
void* gram_instance(int tile, int* threads) {
  switch (tile) {
    case 80: *threads = 64; return (void*)gram_kernel<8, 10, kVec, true>;
    case 200: *threads = 400; return (void*)gram_kernel<20, 10, kVec, true>;
    case 128:
      *threads = 256;
      return (void*)gram_kernel<16, 8, kVec, false>;
    default: return nullptr;
  }
}

bool gram_one_tile(int tile) { return tile != 128; }

size_t gram_smem(int tile) {
  return sizeof(float) * kGramStages * (gram_one_tile(tile) ? 1 : 2) * tile
         * kGramLd;
}

size_t power_smem(int B) {
  return sizeof(float) * ((size_t)B * B + 2 * (size_t)B);
}

void* ax_kernel(bool vec) {
  return vec ? (void*)ax_partial_kernel<true>
             : (void*)ax_partial_kernel<false>;
}

void* atr_kernel(bool vec) {
  return vec ? (void*)neg_at_r_kernel<true> : (void*)neg_at_r_kernel<false>;
}

// The Gram stage's argument rules (cot_block_gram_t); sets the kernel's
// instance, its threads and the tiles per side of a block.
bool gram_args_ok(const float* A_t, const float* partials, int n_blocks,
                  int B, int m, int tile, int S, int per_slice, int vec,
                  void** gram, int* threads, int* nt) {
  *gram = vec ? gram_instance<true>(tile, threads)
              : gram_instance<false>(tile, threads);
  *nt = B > 0 && tile > 0 ? (B + tile - 1) / tile : 0;
  return !(*gram == nullptr || (gram_one_tile(tile) && *nt != 1)
           || n_blocks < 1 || B < 1 || m < 1
           || S < 1 || S > 65535 || per_slice < 1
           || per_slice % kGramBK != 0
           || (long long)per_slice * (S - 1) >= m
           || (long long)per_slice * S < m || (S > 1 && partials == nullptr)
           || (long long)n_blocks * tri_tiles(*nt) > 0x7fffffffLL
           || (vec && (m % 4 != 0 || !aligned16(A_t))));
}

// The iteration stage's argument rules (cot_block_power_gram_t).
bool power_args_ok(const float* w, int n_blocks, int B, int route,
                   int iters) {
  return !(n_blocks < 1 || B < 1 || iters < 0
           || (route == 0 && power_smem(B) > kPowMaxSmem)
           || (route == 1 && (w == nullptr || n_blocks > 65535))
           || (route != 0 && route != 1));
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

// K4's Gram stage: G (n_blocks, B, B) = A_t[j] A_t[j]^T for every block
// (the K4 note).  partials holds S times as many floats when S > 1 (else
// it may be null).  tile: 80, 200 or 128; the m columns in S slices of
// per_slice (a multiple of 32), none empty; vec: 16-byte copies, which
// need m % 4 == 0 and A_t 16-byte aligned.
int cot_block_gram_t(const float* A_t, float* G, float* partials,
                     int n_blocks, int B, int m, int tile, int S,
                     int per_slice, int vec, cudaStream_t stream) {
  void* gram = nullptr;
  int threads = 0, nt = 0;
  if (!gram_args_ok(A_t, partials, n_blocks, B, m, tile, S, per_slice, vec,
                    &gram, &threads, &nt)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = gram_smem(tile);
  cudaError_t err = cudaFuncSetAttribute(
      gram, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* g_out = S > 1 ? partials : G;
  void* args[] = {(void*)&A_t, (void*)&g_out, (void*)&B, (void*)&m,
                  (void*)&per_slice, (void*)&nt};
  err = cudaLaunchKernel(gram, dim3(n_blocks * tri_tiles(nt), S),
                         dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  if (S > 1) {
    const size_t count = (size_t)n_blocks * B * B;
    const size_t grid = (count + 255) / 256;
    gram_sum_kernel<<<(unsigned)(grid < 4096 ? grid : 4096), 256, 0,
                      stream>>>(partials, G, count, S);
  }
  return (int)cudaGetLastError();
}

// K4's iteration stage: out[j] = safety * the top eigenvalue estimate of
// G_j (n_blocks B x B, symmetric) after iters steps from the tilted ones
// vector (the K4 note).  route 0: G_j in shared memory (B <= 240); route
// 1: one launch a step over G in global memory, w 2 n_blocks B floats
// (else null).
int cot_block_power_gram_t(const float* G, float* out, float* w,
                           int n_blocks, int B, int route, int iters,
                           float safety, cudaStream_t stream) {
  if (!power_args_ok(w, n_blocks, B, route, iters)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (route == 0) {
    const size_t psmem = power_smem(B);
    err = cudaFuncSetAttribute(power_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)psmem);
    if (err != cudaSuccess) return (int)err;
    power_smem_kernel<<<n_blocks, kPowThreads, psmem, stream>>>(
        G, out, B, iters, safety);
    return (int)cudaGetLastError();
  }
  const size_t vsmem = sizeof(float) * (size_t)B;
  err = cudaFuncSetAttribute(power_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)vsmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(power_finish_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)vsmem);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 step_grid((B + kStepCols - 1) / kStepCols, n_blocks);
  float* w_buf[2] = {w, w + (size_t)n_blocks * B};
  for (int it = 0; it <= iters; ++it) {
    const float* w_prev = it == 0 ? nullptr : w_buf[(it - 1) & 1];
    power_step_kernel<<<step_grid, kPowThreads, vsmem, stream>>>(
        G, w_prev, w_buf[it & 1], B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  power_finish_kernel<<<n_blocks, kPowThreads, vsmem, stream>>>(
      iters == 0 ? nullptr : w_buf[(iters - 1) & 1], w_buf[iters & 1], out,
      B, safety);
  return (int)cudaGetLastError();
}

// out[j] = safety * ||A_j||_2^2 estimate, j < n_blocks (the K4 note): the
// Gram stage, then the iteration stage on it.  G holds n_blocks B x B
// floats; partials and w as the two stages take them.  The arguments are
// checked whole before anything is launched.
int cot_block_power_t(const float* A_t, float* out, float* G,
                      float* partials, float* w, int n_blocks, int B, int m,
                      int tile, int S, int per_slice, int route, int vec,
                      int iters, float safety, cudaStream_t stream) {
  void* gram = nullptr;
  int threads = 0, nt = 0;
  if (!gram_args_ok(A_t, partials, n_blocks, B, m, tile, S, per_slice, vec,
                    &gram, &threads, &nt)
      || !power_args_ok(w, n_blocks, B, route, iters)) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = cot_block_gram_t(A_t, G, partials, n_blocks, B, m, tile,
                                   S, per_slice, vec, stream);
  if (err != (int)cudaSuccess) return err;
  return cot_block_power_gram_t(G, out, w, n_blocks, B, route, iters, safety,
                                stream);
}

}  // extern "C"
