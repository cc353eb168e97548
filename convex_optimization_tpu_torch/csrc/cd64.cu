// K10 — the f64 polish's cyclic coordinate descent on the card: the sweeps
// of solvers/polish._cd64 (on the host, native/co_native.cpp
// co_cd64_sweeps) over the support's columns gathered on the card.  It
// replaces no TPU kernel: the JAX package runs this descent on the host
// because f64 on the TPU is emulated, and the H100 has f64 units.
//
//   As      (k, m) f32, row j = column S_j of A (the layout of A_t); k a
//           multiple of B, pad rows zero
//   x       (k,) f64, updated in place (pad entries 0, and they stay 0)
//   r       (m,) f64 = A_S x - b, updated in place
//   coef    (3, k): col_sq = ||a_j||^2 + lam2 (pad entries 1), 1 / col_sq
//           and lam1 / col_sq
//   gram    (k / B, B, B) f64: block C's G_C = A_C A_C^T
//
// Per block C of B consecutive coordinates, in order:
//
//   g_C = A_C r                                          (at the block start)
//   for i in C, in order:
//     g    = g_i + sum over l < i in C of G_il d_l + lam2 x_i
//     x_i' = prox(x_i - g / col_sq_i, lam1 / col_sq_i),  d_i = x_i' - x_i
//   r  += A_C^T d_C
//
// In exact arithmetic this is _cd64's cyclic order, with its prox (l1 or
// nonneg_l1), its col_sq and its skip of a zero step: the order in which
// the f64 sums are taken differs, and the quotient g / col_sq_i is taken
// from the reciprocal with one FMA correction (Markstein's; the IEEE
// quotient but in rare last-bit cases).  Every product is of an f32 value
// of A (exact in f64) and an f64 value.
//
// Design: K1's body (csrc/sweep.cu) in f64, with one exchange per block.
// One cooperative launch runs `sweeps` sweeps, one CTA of 384 threads per
// SM; CTA c owns rows [c*rows, c*rows + rows) of r in shared memory (f64)
// for the whole launch.  Its (B x rows) f32 tile of A_C is prefetched by
// cp.async into a double buffer one block ahead, across the exchange, so
// As is read from HBM once per sweep.
//   * Phase 1: unit (b, s) sums tile row b against r over the s-th of S1
//     interleaved segments of the CTA's rows (16-byte tile reads when m %
//     4 == 0, ld = 4 mod 8: conflict-free); the segments are added in order
//     through shared memory and the CTA's partial g_C goes to a global
//     (G, B) f64 buffer.  Thread 0 then adds 1 to an arrival counter with
//     release semantics; no CTA but the leader waits for the others.
//   * The leader (CTA 0) waits for the G - 1 arrivals, sums the partials of
//     each coordinate in a fixed order (QR contiguous runs of CTAs, each in
//     order, then the runs in order), and its warp 0 runs the block's
//     coordinates one after another.  Every lane runs every coordinate
//     (the same bits), so no step waits on a shuffle: lane i % 32 keeps
//     coordinate i's running sum, adds G_il d_l as each d_l comes, and
//     passes the sum through d_{i-2} to every lane by shuffle two steps
//     ahead; step i adds G_{i-1,i} d_{i-1} itself.  The chain of a step is
//     one FMA, the prox and the division.  G_C reaches shared memory by
//     cp.async issued at the block's start, beside the next tile, with the
//     block's x and coefficients.  The leader writes
//     d_C and x_C and releases a flag with the block's number.
//   * Phase 2: every other CTA waits for the flag (thread 0, acquire
//     loads), reads d_C, and adds A_C^T d_C to its rows: unit (s, q) owns W
//     rows over the s-th of S2 contiguous b-segments; the segments are
//     added in order, then to r.
// The arrivals need one buffer of partials and one of d_C: a CTA writes
// block t + 1's partials only after the flag of block t, which the leader
// raises after it has read block t's partials; the leader writes d of
// block t + 1 only after every CTA has arrived there, so after each has
// read d of block t.  The counter and the flag are zeroed by the wrapper
// per launch; the cooperative launch guarantees that every CTA is
// resident.
//
// Determinism: no float atomics; every sum runs in an order fixed by the
// shape, the block width and the SM count, so two launches give the same
// bits.
//
// What bounds it on the H100: the chain of k exact coordinate updates
// (about ten dependent f64 operations each) and one exchange per block.
// The bytes of As, 4 k m a sweep (0.28 GB at k = 7000, m = 10 000:
// 84 us at 3.35 TB/s), lie far below both.
//
// The polish's check runs on the card too, in two more entry points:
// cot_cd64_residual (r = A_S x - b over the nonzero x, the columns in S
// segments, each summed in order, then the segments in order) and
// cot_cd64_atr (z_j = -(a_{idx_j} . r) - lam2 x_j, one warp per j, the
// lanes' sums added in a fixed xor-shuffle order).

#include <cuda_runtime.h>

#include <cstdint>

#include "pipeline.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kMaxB = 128;  // the serial warp holds 4 coordinates a lane
constexpr int kMaxS2 = 8;
constexpr int kMaxSmemBytes = 227 * 1024;

// The launch plan at (B, m) on a card of `sms` SMs; the Python side reads
// B, grid, rows and the shared-memory bytes through cot_cd64_plan.
struct Plan {
  int B, grid, rows, ld, S1, S2, QR, vec;
  size_t smem;
};

// Byte offsets of the shared regions, and their total.
struct Layout {
  size_t ring, gram, r, d, co, red, total;
};

__host__ __device__ inline Layout layout(int B, int rows, int ld, int S1,
                                         int S2, int QR) {
  Layout o;
  size_t off = 0;
  o.ring = off;                                   // 2 tiles (B, ld) f32
  off += (size_t)2 * B * ld * sizeof(float);
  off = (off + 15) & ~(size_t)15;
  o.gram = off;                                   // (B, B) f64
  off += (size_t)B * B * sizeof(double);
  o.r = off;                                      // (rows,) f64
  off += (size_t)(rows + 1) / 2 * 2 * sizeof(double);
  o.d = off;                                      // (B,) f64
  off += (size_t)B * sizeof(double);
  o.co = off;                                     // (4, B) f64
  off += (size_t)4 * B * sizeof(double);
  o.red = off;                                    // the segment sums
  int nred = S1 * B;
  if (S2 * rows > nred) nred = S2 * rows;
  if (QR * B > nred) nred = QR * B;
  off += (size_t)nred * sizeof(double);
  o.total = off;
  return o;
}

// rows a CTA owns, its tile's row stride ld (4 mod 8 for the 16-byte
// instance, odd for the scalar one), the segment counts; false when B is
// out of range or the layout exceeds shared memory.
bool make_plan(int B, int m, int sms, int vec, Plan* p) {
  if (B < 4 || B > kMaxB || B % 4 != 0 || m < 1 || sms < 1) return false;
  int rows = (m + sms - 1) / sms;
  if (vec) rows = (rows + 3) & ~3;
  const int W = vec ? 4 : 1;
  p->B = B;
  p->vec = vec;
  p->rows = rows;
  p->grid = (m + rows - 1) / rows;
  p->ld = vec ? ((rows & 7) == 4 ? rows : rows + 4) : (rows | 1);
  const int Q = rows / W;
  int S1 = kThreads / B;
  if (S1 > Q) S1 = Q;
  p->S1 = S1 < 1 ? 1 : S1;
  int S2 = Q >= kThreads ? 1 : kThreads / Q;
  if (S2 > kMaxS2) S2 = kMaxS2;
  if (S2 > B) S2 = B;
  p->S2 = S2;
  p->QR = kThreads / B;
  p->smem = layout(B, rows, p->ld, p->S1, p->S2, p->QR).total;
  return p->smem <= (size_t)kMaxSmemBytes;
}

__device__ __forceinline__ void arrive(unsigned* count) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void wait_at_least(const unsigned* word,
                                              unsigned target) {
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(word)
                 : "memory");
  } while (v < target);
}

__device__ __forceinline__ void release_store(unsigned* word, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(word), "r"(v)
               : "memory");
}

__device__ __forceinline__ double warp_sum64(double s) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

template <bool VEC, bool NONNEG>
__global__ void __launch_bounds__(kThreads, 1)
cd64_kernel(const float* __restrict__ As, double* x, double* r,
            const double* __restrict__ coef,
            const double* __restrict__ gram, double* partials, double* d_g,
            unsigned* bar, int nblk, int B, int m, int rows, int ld, int S1,
            int S2, int QR, double lam2, int sweeps) {
  constexpr int W = VEC ? 4 : 1;  // rows per phase-2 unit and tile read
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout o = layout(B, rows, ld, S1, S2, QR);
  float* ring = reinterpret_cast<float*>(smem + o.ring);
  double* gram_s = reinterpret_cast<double*>(smem + o.gram);
  double* r_s = reinterpret_cast<double*>(smem + o.r);
  double* d_s = reinterpret_cast<double*>(smem + o.d);
  double* red = reinterpret_cast<double*>(smem + o.red);
  // the leader's coordinates of the block: x, col_sq, 1 / col_sq and
  // lam1 / col_sq
  double* x_s = reinterpret_cast<double*>(smem + o.co);
  double* cs_s = x_s + B;
  double* y_s = cs_s + B;
  double* tl_s = y_s + B;

  const int G = gridDim.x;
  const int c = blockIdx.x;
  const bool leader = c == 0;
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nk = cnt / W;  // phase-1 chunks of this CTA's rows
  const int Q = rows / W;  // phase-2 row units
  const size_t kk = (size_t)nblk * B;
  unsigned* arrivals = bar;
  unsigned* flag = bar + 1;

  // tile jj (B rows of As, this CTA's columns) into ring slot buf: one
  // cp.async group of 16-byte (VEC) or 4-byte copies by every thread
  auto issue_tile = [&](int jj, int buf) {
    const float* Aj = As + (size_t)jj * B * m + i0;
    float* dst = ring + (size_t)buf * B * ld;
    const int per = cnt / W;
    for (int p = tid; p < B * per; p += kThreads) {
      const int b = p / per;
      const int k = (p - b * per) * W;
      cp_async<W>(dst + b * ld + k, Aj + (size_t)b * m + k);
    }
    cp_async_commit();
  };
  // block jj's G_C into gram_s, its x into x_s and its col_sq, 1 /
  // col_sq and lam1 / col_sq into cs_s, y_s and tl_s: one cp.async group
  // of 16-byte copies (B is a multiple of 4)
  auto issue_block = [&](int jj) {
    auto copy = [&](double* dst, const double* src, int n) {
      for (int p = tid; p < n / 2; p += kThreads) {
        cp_async<4>(reinterpret_cast<float*>(dst + 2 * p),
                    reinterpret_cast<const float*>(src + 2 * p));
      }
    };
    const size_t b0 = (size_t)jj * B;
    copy(gram_s, gram + b0 * B, B * B);
    copy(x_s, x + b0, B);
    for (int q = 0; q < 3; ++q) copy(cs_s + q * B, coef + q * kk + b0, B);
    cp_async_commit();
  };

  for (int i = tid; i < rows; i += kThreads) {
    r_s[i] = i < cnt ? r[i0 + i] : 0.0;
  }
  issue_tile(0, 0);
  const int total = sweeps * nblk;

  for (int t = 0, j = 0; t < total; ++t) {
    const float* tile = ring + (size_t)(t & 1) * B * ld;
    const bool next = t + 1 < total;
    cp_async_wait<0>();
    __syncthreads();  // tile t resident; block t - 1 done with the ring
    if (leader) issue_block(j);
    if (next) issue_tile(j + 1 < nblk ? j + 1 : 0, (t + 1) & 1);
    const size_t j0 = (size_t)j * B;

    // phase 1: this CTA's partial g_C, units (b, s)
    {
      const int s = tid / B, b = tid - s * B;
      if (s < S1) {
        const float* a = tile + b * ld;
        double acc = 0.0;
        for (int k = s; k < nk; k += S1) {
          if constexpr (VEC) {
            const float4 v = *reinterpret_cast<const float4*>(a + 4 * k);
            const double* rk = r_s + 4 * k;
            acc = fma((double)v.x, rk[0], acc);
            acc = fma((double)v.y, rk[1], acc);
            acc = fma((double)v.z, rk[2], acc);
            acc = fma((double)v.w, rk[3], acc);
          } else {
            acc = fma((double)a[k], r_s[k], acc);
          }
        }
        red[s * B + b] = acc;
      }
      __syncthreads();
      if (tid < B) {
        double g = red[tid];
        for (int u = 1; u < S1; ++u) g += red[u * B + tid];
        __stcg(partials + (size_t)c * B + tid, g);
      }
    }
    __syncthreads();  // the partials stored; red free again

    if (leader) {
      if (tid == 0) wait_at_least(arrivals, (unsigned)(G - 1) * (t + 1));
      __syncthreads();
      // the partials of coordinate b over CTAs [q G / QR, (q + 1) G / QR),
      // in order, 16 loads in flight
      {
        const int q = tid / B, b = tid - q * B;
        if (q < QR) {
          const int ca = q * G / QR, cb = (q + 1) * G / QR;
          double g = 0.0;
          for (int c0 = ca; c0 < cb; c0 += 16) {
            double v[16];
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              v[u] = c0 + u < cb ? __ldcg(partials + (size_t)(c0 + u) * B + b)
                                 : 0.0;
            }
#pragma unroll
            for (int u = 0; u < 16; ++u) g += v[u];
          }
          red[q * B + b] = g;
        }
      }
      if (next) {
        cp_async_wait<1>();  // the block's copies in; the next tile may not be
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (warp == 0) {
        // lane owns the running sums of coordinates lane + 32 u, u < 4, and
        // keeps their d and new x
        double ga[4], dv[4], xo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int b = lane + 32 * u;
          ga[u] = dv[u] = xo[u] = 0.0;
          if (b < B) {
            double g = red[b];
            for (int q = 1; q < QR; ++q) g += red[q * B + b];
            ga[u] = g;
          }
        }
        // every lane runs every coordinate (the same bits): p_cur holds
        // coordinate i's sum through d_{i-2}, p_nxt coordinate i + 1's;
        // step i + 1's operands are loaded during step i
        double p_cur = __shfl_sync(0xffffffffu, ga[0], 0);
        double p_nxt = __shfl_sync(0xffffffffu, ga[0], 1);
        double d_prev = 0.0;
        double n_pre = 0.0, n_x = x_s[0], n_c = cs_s[0], n_y = y_s[0];
        double n_t = tl_s[0], n_g[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) n_g[w] = gram_s[lane + 32 * w];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (32 * u < B) {
            const int ie = min(32, B - 32 * u);
#pragma unroll 3
            for (int ii = 0; ii < ie; ++ii) {
              const int i = 32 * u + ii;
              const double pre = n_pre, xi = n_x, ci = n_c, yi = n_y;
              const double ti = n_t;
              double gl[4];
#pragma unroll
              for (int w = 0; w < 4; ++w) gl[w] = n_g[w];
              {
                // G_{i,i+1} and row i + 1 (row i again past the end: not
                // used); lanes past B read the following rows, not used
                const int i1 = i + 1 < B ? i + 1 : i;
                const double* G1 = gram_s + (size_t)i1 * B;
                n_pre = gram_s[(size_t)i * B + i1];
                n_x = x_s[i1];
                n_c = cs_s[i1];
                n_y = y_s[i1];
                n_t = tl_s[i1];
#pragma unroll
                for (int w = 0; w < 4; ++w) n_g[w] = G1[lane + 32 * w];
              }
              // g / col_sq_i by the reciprocal and one FMA correction
              const double h = fma(lam2, xi, fma(pre, d_prev, p_cur));
              const double q0 = h * yi;
              const double v = xi - fma(fma(-q0, ci, h), yi, q0);
              double xn;
              if constexpr (NONNEG) {
                xn = v > ti ? v - ti : 0.0;
              } else {
                xn = v > ti ? v - ti : (v < -ti ? v + ti : 0.0);
              }
              const double d = xn - xi;
#pragma unroll
              for (int w = u; w < 4; ++w) {
                const int l = lane + 32 * w;
                if (l > i && l < B) ga[w] = fma(gl[w], d, ga[w]);
              }
              if (lane == ii) {
                dv[u] = d;
                xo[u] = d != 0.0 ? xn : xi;
              }
              // coordinate i + 2's sum through d_i, from its owner to every
              // lane
              const double sel =
                  ii + 2 < 32 ? ga[u] : ga[u < 3 ? u + 1 : 3];
              const double p2 = __shfl_sync(0xffffffffu, sel, (i + 2) & 31);
              p_cur = p_nxt;
              p_nxt = p2;
              d_prev = d;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int b = lane + 32 * u;
          if (b < B) {
            d_s[b] = dv[u];
            __stcg(d_g + b, dv[u]);
            __stcg(x + j0 + b, xo[u]);
          }
        }
      }
      __syncthreads();  // d_C and x_C written
      if (tid == 0) release_store(flag, (unsigned)(t + 1));
    } else {
      if (tid == 0) {
        arrive(arrivals);
        wait_at_least(flag, (unsigned)(t + 1));
      }
      __syncthreads();
      for (int b = tid; b < B; b += kThreads) d_s[b] = __ldcg(d_g + b);
      __syncthreads();
    }

    // phase 2: r += A_C^T d_C over this CTA's rows, units (s, q)
    for (int p = tid; p < S2 * Q; p += kThreads) {
      const int s = p / Q, q = p - s * Q;
      if (W * q >= cnt) continue;
      const int b0 = s * B / S2, b1 = (s + 1) * B / S2;
      double acc[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = 0.0;
      for (int b = b0; b < b1; ++b) {
        const double d = d_s[b];
        if constexpr (VEC) {
          const float4 v =
              *reinterpret_cast<const float4*>(tile + b * ld + 4 * q);
          acc[0] = fma((double)v.x, d, acc[0]);
          acc[1] = fma((double)v.y, d, acc[1]);
          acc[2] = fma((double)v.z, d, acc[2]);
          acc[3] = fma((double)v.w, d, acc[3]);
        } else {
          acc[0] = fma((double)tile[b * ld + q], d, acc[0]);
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        if (S2 == 1) {
          r_s[W * q + e] += acc[e];
        } else {
          red[s * rows + W * q + e] = acc[e];
        }
      }
    }
    if (S2 > 1) {
      __syncthreads();
      for (int i = tid; i < cnt; i += kThreads) {
        double a = red[i];
        for (int s = 1; s < S2; ++s) a += red[s * rows + i];
        r_s[i] += a;
      }
    }
    j = j + 1 < nblk ? j + 1 : 0;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < cnt; i += kThreads) r[i0 + i] = r_s[i];
}

using Kernel = void (*)(const float*, double*, double*, const double*,
                        const double*, double*, double*, unsigned*, int, int,
                        int, int, int, int, int, int, double, int);

// The instance for the read width and the prox (nonneg_l1 or l1).
Kernel kernel_for(int vec, int nonneg) {
  if (nonneg) return vec ? cd64_kernel<true, true> : cd64_kernel<false, true>;
  return vec ? cd64_kernel<true, false> : cd64_kernel<false, false>;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return (int)err;
}

// r partials: part[s][i] = sum over the nonzero x_j, j in segment s, in
// order, of x_j As[j][i]
__global__ void residual_partial_kernel(const float* __restrict__ As,
                                        const double* __restrict__ x,
                                        double* __restrict__ part, int k,
                                        int m, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (i >= m) return;
  const int ja = (int)((long long)s * k / S);
  const int jb = (int)((long long)(s + 1) * k / S);
  double acc = 0.0;
#pragma unroll 4
  for (int j = ja; j < jb; ++j) {
    const double xj = x[j];
    if (xj != 0.0) acc = fma((double)As[(size_t)j * m + i], xj, acc);
  }
  part[(size_t)s * m + i] = acc;
}

__global__ void residual_final_kernel(const double* __restrict__ part,
                                      const double* __restrict__ b,
                                      double* __restrict__ r, int m, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  double acc = -b[i];
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * m + i];
  r[i] = acc;
}

// z_j = -(row idx_j of A . r) - lam2 x_j (x null: no lam2 term), one warp
// per j
template <bool VEC>
__global__ void atr_kernel(const float* __restrict__ A,
                           const int64_t* __restrict__ idx,
                           const double* __restrict__ r,
                           const double* __restrict__ x, double lam2,
                           double* __restrict__ z, int count, int m) {
  const int j = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= count) return;  // the whole warp
  const int64_t row = idx != nullptr ? idx[j] : j;
  const float* a = A + (size_t)row * m;
  double acc = 0.0;
  if constexpr (VEC) {
    for (int k = lane; 4 * k < m; k += 32) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(a) + k);
      const double* rk = r + 4 * k;
      acc = fma((double)v.x, rk[0], acc);
      acc = fma((double)v.y, rk[1], acc);
      acc = fma((double)v.z, rk[2], acc);
      acc = fma((double)v.w, rk[3], acc);
    }
  } else {
    for (int k = lane; k < m; k += 32) {
      acc = fma((double)__ldg(a + k), r[k], acc);
    }
  }
  acc = warp_sum64(acc);
  if (lane == 0) z[j] = -acc - (x != nullptr ? lam2 * x[j] : 0.0);
}

}  // namespace

extern "C" {

// The plan at m on the current device: the widest block B <= Bmax (a
// multiple of 4) whose layout fits shared memory.  out[0] = B (0 when none
// fits), out[1] = grid, out[2] = rows, out[3] = shared-memory bytes.
// Returns a cudaError_t (cudaErrorNotSupported without cooperative
// launch).
int cot_cd64_plan(int m, int vec, int Bmax, int* out) {
  out[0] = out[1] = out[2] = out[3] = 0;
  int dev = 0, coop = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  for (int B = (Bmax < kMaxB ? Bmax : kMaxB) & ~3; B >= 4; B -= 4) {
    Plan p;
    if (make_plan(B, m, sms, vec, &p)) {
      out[0] = B;
      out[1] = p.grid;
      out[2] = p.rows;
      out[3] = (int)p.smem;
      return (int)cudaSuccess;
    }
  }
  return (int)cudaSuccess;
}

// `sweeps` sweeps of K10 over As (k, m) in place on x and r.  coef (3, k):
// col_sq, 1 / col_sq and lam1 / col_sq; As, x, coef and gram 16-byte
// aligned; k a multiple of B; vec (the 16-byte tile copies) needs m % 4 ==
// 0.  partials holds grid * B f64, d_g B f64; bar two unsigned, zero at
// the launch.  nonneg: 0 = l1, 1 = nonneg_l1.
int cot_cd64_sweeps(const float* As, double* x, double* r,
                    const double* coef, const double* gram,
                    double* partials, double* d_g, unsigned* bar, int k,
                    int B, int m, double lam2, int nonneg,
                    int sweeps, int vec, cudaStream_t stream) {
  int sms = 0;
  int e = sm_count(&sms);
  if (e != 0) return e;
  Plan p;
  if (!make_plan(B, m, sms, vec, &p) || k < B || k % B != 0 || sweeps < 1 ||
      (vec && m % 4 != 0) || bar == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  int nblk = k / B;
  const Kernel kern = kernel_for(vec, nonneg);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int rows = p.rows, ld = p.ld, S1 = p.S1, S2 = p.S2, QR = p.QR;
  void* args[] = {(void*)&As,       (void*)&x,      (void*)&r,
                  (void*)&coef,     (void*)&gram,   (void*)&partials,
                  (void*)&d_g,      (void*)&bar,    (void*)&nblk,
                  (void*)&B,        (void*)&m,      (void*)&rows,
                  (void*)&ld,       (void*)&S1,     (void*)&S2,
                  (void*)&QR,       (void*)&lam2,   (void*)&sweeps};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(p.grid), dim3(kThreads),
                                    args, p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The column segments of cot_cd64_residual at (k, m) on the current
// device (the partials it needs: S * m f64), into *S.
int cot_cd64_residual_segments(int k, int m, int* S) {
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const int gx = (m + 255) / 256;
  int s = 8 * sms / gx;
  if (s > k) s = k;
  *S = s < 1 ? 1 : s;
  return (int)cudaSuccess;
}

// r = As^T x - b in f64, As (k, m); part holds S * m f64 (S from
// cot_cd64_residual_segments).
int cot_cd64_residual(const float* As, const double* x, const double* b,
                      double* r, double* part, int k, int m, int S,
                      cudaStream_t stream) {
  if (k < 1 || m < 1 || S < 1 || S > k) return (int)cudaErrorInvalidValue;
  const int gx = (m + 255) / 256;
  residual_partial_kernel<<<dim3(gx, S), 256, 0, stream>>>(As, x, part, k, m,
                                                           S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  residual_final_kernel<<<gx, 256, 0, stream>>>(part, b, r, m, S);
  return (int)cudaGetLastError();
}

// z_j = -(A[idx_j] . r) - lam2 x_j for j < count, A (rows, m) f32 row-major;
// idx null: row j; x null: no lam2 term.  vec needs m % 4 == 0 and A
// 16-byte aligned.
int cot_cd64_atr(const float* A, const int64_t* idx, const double* r,
                 const double* x, double lam2, double* z, int count, int m,
                 int vec, cudaStream_t stream) {
  if (count < 1 || m < 1 || (vec && m % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const long long grid = ((long long)count * 32 + threads - 1) / threads;
  if (vec) {
    atr_kernel<true><<<(unsigned)grid, threads, 0, stream>>>(A, idx, r, x,
                                                             lam2, z, count, m);
  } else {
    atr_kernel<false><<<(unsigned)grid, threads, 0, stream>>>(
        A, idx, r, x, lam2, z, count, m);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
