// K1 — one cyclic Gauss-Seidel block-coordinate sweep over the transposed
// block-major layout A_t (n_blocks, B, m), float32.
//
// Replaces the Pallas kernel convex_optimization_tpu/ops/bcd_sweep_vpu.py
// `_kernel` (wrapper `bcd_sweep_vpu`).  Per block j, in order:
//
//   g     = A_t[j] r + lam2 x_j                   (B dots of length m)
//   x_j'  = prox(x_j - t_j g, t_j lam1), 0 where the keep mask is 0
//   r    += A_t[j]^T (x_j' - x_j)                 (m axpys of length B)
//
// The TPU kernel's MXU dots and one-hot group matmuls are not copied: f32
// FMAs, fixed-order reductions, no float atomics.
//
// K8 — the column-sharded solver's slab sweep — is the payload instance of
// the same body (PAY): one rank's slab of A_t (nb_loc, B, m) from the
// replicated consensus residual r_in, with the merge's payload written for
// the one all-reduce of a sharded BCD step.  It replaces the Pallas kernel
// convex_optimization_tpu/ops/bcd_sweep_pallas.py `_sweep_kernel`
// (wrapper `bcd_sweep_pallas`; the merge is parallel/sharded.py
// `sharded_bcd` there):
//
//   payload[0:m]   = r_out - r_in                (the consensus payload dr)
//   payload[m]     = <x, dx>,  payload[m + 1] = <dx, dx>,
//   payload[m + 2] = g(x + dx) - g(x)            (Penalty.value_diff)
//
// After barrier 2 every CTA holds the same bits of dx, so CTA 0 adds each
// block's terms to three running sums, in block order, beside its phase 2:
// its last warp (kPayWarp) keeps them, and that warp holds no phase-2 unit
// wherever the split phase 2 leaves a warp free (the headline's rank slab:
// 152 of 384 threads), so the sums cost CTA 0 no time there.  At the end
// every CTA writes dr for its own rows.  The payload adds no
// barrier and changes no sum of x or r: K8's x_out and r_out are K1's, bit
// for bit, on the same slab and plan.
//
// Design: K5's pipeline (csrc/sweep_batch.cu) at one lambda.  One
// cooperative launch per sweep, one CTA of 384 threads per SM, two grid
// barriers per block.  The launch plan (grid, rows, the tile's row stride
// ld, the prefetch depth P, the segment counts S1 and S2, the reducing
// warps RW, the float4 instance) comes from ops/bcd_sweep.sweep_tiling;
// `layout` below is the shared-memory map both sides compute.
//   * CTA c owns rows [c*rows, c*rows + rows) of r in shared memory for the
//     whole sweep.  Its (B x rows) tile of A_t[j] serves both phases, so A
//     is read from HBM once per sweep.
//   * Tile j + 1 is PREFETCHED across the grid barriers into a ring of B + P
//     tile-row slots: b-rows [0, P) as soon as tile j is resident, into the
//     P free slots, and b-rows [P, B) once phase 2 of block j has released
//     tile j's slots.  P = B (a double buffer) for the 24 KB tile of the
//     headline and config 3 (B = 80, rows = 76); at config
//     4's group tile (B = 200, rows = 152: 122 KB) P is what the spare
//     shared memory holds.  Copies: 16-byte cp.async (m % 4 == 0, A_t
//     16-byte aligned), else 4-byte cp.async; K5's bulk copies (1-D TMA)
//     were slower here even on config 4's 608-byte rows (PERF.md §6).
//     A is read-only, so a copy may cross a grid barrier.
//   * Phase 1 (register-blocked): a unit (s, h) keeps the sums of tile rows
//     h and h + ceil(B/2) over the s-th of S1 interleaved segments of the
//     CTA's rows: float4 tile reads (conflict-free: ld = 4 mod 8, odd for
//     the scalar instance) against a broadcast float4 of r.  Segments are
//     summed in order through shared memory; the CTA's partial g goes to a
//     global (G, B) buffer.  Barrier 1.
//   * Split reduction (K5's): CTA c sums chunks c, c + G, ... of 32
//     consecutive coordinates, lane i the coordinate 32 ch + i, the G
//     partials split over the RW warps (coalesced, 16 loads in flight) and
//     added in warp order; the reducing warp proxes and writes dx (the
//     group's v) to a global (B,) buffer and x_out.  Barrier 2; every CTA
//     reads dx.  For group_l2 every CTA then forms the group scales (one
//     warp per group, ||v_g||^2 in a fixed order) and dx itself, and CTA 0
//     writes x_out.  So every CTA holds the same bits of dx.  One buffer of
//     partials and of dx suffices (csrc/sweep_batch.cu says why).  A
//     one-barrier reduce in which every CTA sums every coordinate was
//     slower on the H100 at every shape measured (PERF.md §6).
//   * Phase 2 (register-blocked): a unit (s, q) owns float4 q of the CTA's
//     rows (one row for the scalar instance) over the s-th of S2 contiguous
//     b-segments, each tile float4 against a broadcast dx; segments summed
//     in order through shared memory, then r += acc.
//   * Grid barriers on an integer arrival counter (`counter_barrier`,
//     csrc/pipeline.cuh), zeroed by the wrapper per launch; the cooperative
//     launch guarantees that every CTA is resident.  Cooperative groups'
//     grid.sync() in their place was slower (PERF.md §6).
//
// Determinism: no float atomics; every sum runs in an order fixed by the
// shape, the SM count and the plan, so two launches give the same bits.
//
// What bounds it on the H100: the bytes of A, 4 m n per sweep (4 GB at
// 10k x 100k: 1.19 ms at 3.35 TB/s).  With the tile load hidden, each block
// pays its two grid barriers, the partials' and dx's round trips through
// L2 and the two phases' latency chains (PERF.md).
//
// Penalties: 0 = l1 (soft threshold), 1 = nonneg_l1 (shift and clip),
// 2 = group_l2 over contiguous groups of gsize coordinates (gsize divides
// B), weights w (n / gsize,) or null for ones: v = x_j - t_j g is scaled by
// max(0, 1 - t_j lam1 w_g / max(||v_g||, 1e-30)).  The payload's
// value_diff is cancellation-free: |a + d| - |a| = sign(a) d where the sign
// does not flip, and per group ||a + d|| - ||a|| = (2 <a, d> + ||d||^2) /
// (||a + d|| + ||a||).
//
// Blocks whose tile does not fit even the plainest layout (the first
// design's, ops/bcd_sweep.k1_smem_bytes) go to K9 (csrc/sweep_tiled.cu).

#include <cuda_runtime.h>

#include <cstdint>

#include "pipeline.cuh"
#include "prox.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kPayWarp = kWarps - 1;  // K8: the warp that keeps the sums
constexpr int kMaxSmemBytes = 227 * 1024;

// Offsets in floats of the shared regions, and their total; the Python
// plan (ops/bcd_sweep.SweepPlan.smem_bytes) mirrors it.
struct Layout {
  int r, dx, sc, red, gs, total;
};

__host__ __device__ inline Layout layout(int B, int rows, int ld, int P,
                                         int S1, int S2, int RW, bool vec) {
  Layout o;
  const int red1 = (S1 - 1) * 2 * ((B + 1) / 2);
  const int red2 = (S2 - 1) * rows;
  o.r = (B + P) * ld;                          // the ring comes first
  o.dx = o.r + up4(rows, vec);
  o.sc = o.dx + up4(B, vec);
  o.red = o.sc + up4(B, vec);                 // room for B / gsize scales
  o.gs = o.red + up4(red1 > red2 ? red1 : red2, vec);
  o.total = o.gs + (RW > 1 ? 32 * RW : 0);
  return o;
}

// Phase 2 of one unit: acc[ii] = sum over b in [b0, b1) of
// tile[b][W q + ii] dx[b]; `sl` is b0's ring slot.
template <bool VEC>
__device__ __forceinline__ void dot_cols(const float* ring, const float* dx_s,
                                         int ld, int BP, int sl, int b0,
                                         int b1, int q,
                                         float (&acc)[VEC ? 4 : 1]) {
#pragma unroll
  for (int ii = 0; ii < (VEC ? 4 : 1); ++ii) acc[ii] = 0.0f;
#pragma unroll 4
  for (int b = b0; b < b1; ++b) {
    const float d = dx_s[b];
    if constexpr (VEC) {
      const float4 t = *reinterpret_cast<const float4*>(ring + sl * ld + 4 * q);
      acc[0] = fmaf(t.x, d, acc[0]);
      acc[1] = fmaf(t.y, d, acc[1]);
      acc[2] = fmaf(t.z, d, acc[2]);
      acc[3] = fmaf(t.w, d, acc[3]);
    } else {
      acc[0] = fmaf(ring[sl * ld + q], d, acc[0]);
    }
    if (++sl == BP) sl = 0;
  }
}

// K8's terms of block j, added by CTA 0's warp kPayWarp alone to its
// running sums in a fixed order (every lane the same bits): the sums of
// x_j dx_j, dx_j^2 and the value_diff terms over the block.  For group_l2
// the warp forms the groups' terms one group after another from x_j and
// the dx the group prox wrote; no other warp waits for it.
__device__ __forceinline__ void payload_terms(
    const float* xj_g, const float* dx_s, const float* w_j, int B, int gsize,
    int gpb, bool group, int lane, float (&acc)[3]) {
  float s_xd = 0.0f, s_dd = 0.0f, s_g = 0.0f;
  if (group) {
    for (int q = 0; q < gpb; ++q) {
      float no = 0.0f, nn = 0.0f, ad = 0.0f, dd = 0.0f;
      for (int i = lane; i < gsize; i += 32) {
        const float a = xj_g[q * gsize + i];
        const float d = dx_s[q * gsize + i];
        const float an = a + d;
        no = fmaf(a, a, no);
        nn = fmaf(an, an, nn);
        ad = fmaf(a, d, ad);
        dd = fmaf(d, d, dd);
      }
      no = warp_sum(no);
      nn = warp_sum(nn);
      ad = warp_sum(ad);
      dd = warp_sum(dd);
      const float wq = w_j != nullptr ? w_j[q] : 1.0f;
      s_xd += ad;
      s_dd += dd;
      s_g += wq * (2.0f * ad + dd) / fmaxf(sqrtf(nn) + sqrtf(no), 1e-30f);
    }
  } else {
#pragma unroll 4
    for (int b = lane; b < B; b += 32) {
      const float a = xj_g[b];
      const float d = dx_s[b];
      const float an = a + d;
      s_xd = fmaf(a, d, s_xd);
      s_dd = fmaf(d, d, s_dd);
      s_g += an * a > 0.0f ? (a > 0.0f ? d : -d) : fabsf(an) - fabsf(a);
    }
    s_xd = warp_sum(s_xd);
    s_dd = warp_sum(s_dd);
    s_g = warp_sum(s_g);
  }
  acc[0] += s_xd;
  acc[1] += s_dd;
  acc[2] += s_g;
}

template <bool VEC, bool PAY>
__global__ void __launch_bounds__(kThreads, 1)
sweep_kernel(const float* __restrict__ A_t, const float* __restrict__ x_in,
             const float* __restrict__ r_in,
             const float* __restrict__ steps,
             const uint8_t* __restrict__ mask, const float* __restrict__ w,
             float* __restrict__ x_out, float* __restrict__ r_out,
             float* __restrict__ payload, float* partials, unsigned* bar,
             int n_blocks, int B, int m, int rows, int ld, int P, int S1,
             int S2, int RW, int gsize, float lam1, float lam2, int kind,
             int copy) {
  constexpr int W = VEC ? 4 : 1;    // rows per phase-2 unit and tile read
  unsigned arrivals = 0;  // on `bar` after this CTA's latest grid barrier
  auto grid_sync = [&]() {
    arrivals += gridDim.x;
    counter_barrier(bar, arrivals);
  };
  extern __shared__ __align__(16) float smem[];
  const Layout o = layout(B, rows, ld, P, S1, S2, RW, VEC);
  float* ring = smem;                 // (B + P, ld) b-row slots
  float* r_s = smem + o.r;            // (rows,)
  float* dx_s = smem + o.dx;          // (B,): group v, then dx
  float* sc_s = smem + o.sc;          // (B / gsize,) group scales
  float* red = smem + o.red;          // segment sums of phases 1 and 2
  float* gs_s = smem + o.gs;          // (RW, 32) the reduce's warp sums

  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int BP = B + P;
  const int Bh = (B + 1) / 2;
  const int nk = cnt / W;             // phase-1 chunks of this CTA's rows
  const int Q = rows / W;             // phase-2 row units
  const bool group = kind == 2;
  const int gpb = group ? B / gsize : 0;
  float* dx_g = partials + (size_t)G * B;  // partials (G, B), dx (B)
  float pay[3] = {0.0f, 0.0f, 0.0f};  // K8: CTA 0's running sums

  // b-rows [b0, b1) of tile jj into their ring slots (row 0 at slot base):
  // one cp.async group of 16-byte (copy 1) or 4-byte copies by every thread
  auto issue = [&](int jj, int base, int b0, int b1) {
    const float* Aj = A_t + (size_t)jj * B * m + i0;
    if (copy == 1) {
      const int per = cnt >> 2;
      for (int p = tid; p < (b1 - b0) * per; p += kThreads) {
        const int q = p / per;
        const int k = (p - q * per) << 2;
        int sl = base + b0 + q;
        if (sl >= BP) sl -= BP;
        cp_async<4>(ring + sl * ld + k, Aj + (size_t)(b0 + q) * m + k);
      }
      cp_async_commit();
    } else {
      for (int p = tid; p < (b1 - b0) * cnt; p += kThreads) {
        const int q = p / cnt;
        const int k = p - q * cnt;
        int sl = base + b0 + q;
        if (sl >= BP) sl -= BP;
        cp_async<1>(ring + sl * ld + k, Aj + (size_t)(b0 + q) * m + k);
      }
      cp_async_commit();
    }
  };

  for (int i = tid; i < rows; i += kThreads) {
    r_s[i] = i < cnt ? r_in[i0 + i] : 0.0f;
  }
  int base = 0;
  issue(0, 0, 0, B);

  for (int j = 0; j < n_blocks; ++j) {
    const int nbase = base + B < BP ? base + B : base + B - BP;
    const bool next = j + 1 < n_blocks;
    const float* xj_g = x_in + (size_t)j * B;
    const uint8_t* keep_j = mask != nullptr ? mask + (size_t)j * B : nullptr;
    const float t = steps[j];
    cp_async_wait<0>();
    __syncthreads();  // tile j resident; block j - 1 done with the ring
    if (next) issue(j + 1, nbase, 0, P);

    // phase 1: partial g over this CTA's rows, units (s, h) of tile rows
    // h and h + Bh
    float* part = partials + (size_t)c * B;
    auto unit_rows = [&](int h, const float*& a0, const float*& a1) {
      int s0 = base + h, s1 = base + h + Bh;
      if (s0 >= BP) s0 -= BP;
      if (s1 >= BP) s1 -= BP;
      a0 = ring + s0 * ld;
      a1 = h + Bh < B ? ring + s1 * ld : a0;  // odd B: a dropped twin
    };
    auto store_partials = [&](int h, float acc0, float acc1) {
      part[h] = acc0;
      if (h + Bh < B) part[h + Bh] = acc1;
    };
    if (S1 == 1) {
      for (int h = tid; h < Bh; h += kThreads) {
        const float *a0, *a1;
        unit_rows(h, a0, a1);
        float acc0, acc1;
        dot_rows<VEC>(a0, a1, r_s, nk, 0, 1, acc0, acc1);
        store_partials(h, acc0, acc1);
      }
    } else {  // S1 * Bh <= kThreads: one unit per thread
      const int s = tid / Bh, h = tid - s * Bh;
      const bool act = s < S1;
      float acc0 = 0.0f, acc1 = 0.0f;
      if (act) {
        const float *a0, *a1;
        unit_rows(h, a0, a1);
        dot_rows<VEC>(a0, a1, r_s, nk, s, S1, acc0, acc1);
        if (s > 0) {
          red[(s - 1) * 2 * Bh + h] = acc0;
          red[(s - 1) * 2 * Bh + Bh + h] = acc1;
        }
      }
      __syncthreads();
      if (act && s == 0) {
        for (int u = 1; u < S1; ++u) {
          acc0 += red[(u - 1) * 2 * Bh + h];
          acc1 += red[(u - 1) * 2 * Bh + Bh + h];
        }
        store_partials(h, acc0, acc1);
      }
    }
    grid_sync();

    // reduce and prox this CTA's chunks of 32 consecutive coordinates:
    // lane i of warp w < RW sums, in order, the partials q in
    // [w QW, (w + 1) QW) of coordinate 32 ch + i (up to 16 loads in
    // flight); warp 0 adds the RW warp sums in order and proxes
    const int QW = (G + RW - 1) / RW;
    for (int ch = c; 32 * ch < B; ch += G) {
      const int b = 32 * ch + lane;
      const bool in = b < B;
      const float xj = warp == 0 && in ? xj_g[b] : 0.0f;
      const bool kept =
          !(warp == 0 && in && keep_j != nullptr && keep_j[b] == 0);
      float g = 0.0f;
      if (warp < RW) {
        const int qa = warp * QW, qb = min(G, qa + QW);
        for (int q0 = qa; q0 < qb; q0 += 16) {
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int q = q0 + u;
            v[u] = q < qb && in ? __ldcg(partials + (size_t)q * B + b)
                                : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) g += v[u];
        }
      }
      if (RW > 1) {
        if (warp < RW) gs_s[warp * 32 + lane] = g;
        __syncthreads();
        if (warp == 0) {
          g = 0.0f;
          for (int w2 = 0; w2 < RW; ++w2) g += gs_s[w2 * 32 + lane];
        }
      }
      if (warp == 0 && in) {
        const float v = xj - t * (g + lam2 * xj);
        if (group) {
          dx_g[b] = v;  // the group prox needs the whole group
        } else {
          float xn = prox(v, t * lam1, kind);
          if (!kept) xn = 0.0f;
          dx_g[b] = xn - xj;
          x_out[(size_t)j * B + b] = xn;
        }
      }
      if (RW > 1) __syncthreads();  // warp 0 done with gs_s
    }
    grid_sync();
    for (int b = tid; b < B; b += kThreads) dx_s[b] = __ldcg(dx_g + b);
    __syncthreads();

    if (group) {
      // one warp per group: ||v_g||^2 in a fixed order, then the scale
      for (int q = warp; q < gpb; q += kWarps) {
        float s = 0.0f;
        for (int i = lane; i < gsize; i += 32) {
          const float v = dx_s[q * gsize + i];
          s = fmaf(v, v, s);
        }
        s = warp_sum(s);
        if (lane == 0) {
          const float wq = w != nullptr ? w[(size_t)j * gpb + q] : 1.0f;
          sc_s[q] = fmaxf(0.0f,
                          1.0f - t * lam1 * wq / fmaxf(sqrtf(s), 1e-30f));
        }
      }
      __syncthreads();
      for (int b = tid; b < B; b += kThreads) {
        float xn = dx_s[b] * sc_s[b / gsize];
        if (keep_j != nullptr && keep_j[b] == 0) xn = 0.0f;
        dx_s[b] = xn - xj_g[b];
        if (c == 0) x_out[(size_t)j * B + b] = xn;
      }
      __syncthreads();
    }
    if (PAY && c == 0 && warp == kPayWarp) {
      payload_terms(xj_g, dx_s, w != nullptr ? w + (size_t)j * gpb : nullptr,
                    B, gsize, gpb, group, lane, pay);
    }

    // phase 2: r += A_t[j]^T dx over this CTA's rows, units (s, q) (all W
    // rows of a unit exist: cnt % W == 0 when VEC, and units past cnt skip)
    auto apply = [&](int q, float (&acc)[W]) {
      add_w<W>(r_s + W * q, acc);
      st_w<W>(r_s + W * q, acc);
    };
    if (S2 == 1) {
      for (int q = tid; q < Q; q += kThreads) {
        if (W * q >= cnt) continue;
        float acc[W];
        dot_cols<VEC>(ring, dx_s, ld, BP, base, 0, B, q, acc);
        apply(q, acc);
      }
    } else {  // S2 * Q <= kThreads: one unit per thread
      const int s = tid / Q, q = tid - s * Q;
      const bool act = s < S2 && W * q < cnt;
      float acc[W];
      if (act) {
        const int b0 = s * B / S2, b1 = (s + 1) * B / S2;
        int sl = base + b0;
        if (sl >= BP) sl -= BP;
        dot_cols<VEC>(ring, dx_s, ld, BP, sl, b0, b1, q, acc);
        if (s > 0) st_w<W>(red + (s - 1) * rows + W * q, acc);
      }
      __syncthreads();
      if (act && s == 0) {
        for (int u = 1; u < S2; ++u) add_w<W>(red + (u - 1) * rows + W * q, acc);
        apply(q, acc);
      }
    }
    if (next) {
      if (P < B) __syncthreads();  // phase 2 done with tile j's slots
      issue(j + 1, nbase, P, B);
    }
    base = nbase;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < cnt; i += kThreads) {
    r_out[i0 + i] = r_s[i];
    if (PAY) payload[i0 + i] = r_s[i] - r_in[i0 + i];
  }
  if (PAY && c == 0 && warp == kPayWarp && lane == 0) {
    payload[m] = pay[0];
    payload[m + 1] = pay[1];
    payload[m + 2] = lam1 * pay[2];
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const uint8_t*, const float*, float*,
                        float*, float*, float*, unsigned*, int, int, int,
                        int, int, int, int, int, int, int, float, float, int,
                        int);

// The instance for the read width, K1's or K8's (with the payload).
Kernel kernel_for(bool vec, bool pay) {
  if (pay) return vec ? sweep_kernel<true, true> : sweep_kernel<false, true>;
  return vec ? sweep_kernel<true, false> : sweep_kernel<false, false>;
}

size_t smem_of(int B, int rows, int ld, int P, int S1, int S2, int RW,
               int vec) {
  return sizeof(float) *
         (size_t)layout(B, rows, ld, P, S1, S2, RW, vec != 0).total;
}

// The plan's invariants (ops/bcd_sweep.sweep_tiling): the kernel relies on
// each of them.
bool plan_ok(int B, int m, int gsize, int grid, int rows, int ld, int P,
             int S1, int S2, int RW, int vec) {
  const int Q = vec ? rows / 4 : rows;
  return B >= 1 && rows >= 1 && ld >= rows && P >= 0 && P <= B && S1 >= 1 &&
         S2 >= 1 && (RW == 1 || RW == kWarps) &&
         (S1 == 1 || S1 * ((B + 1) / 2) <= kThreads) &&
         (S2 == 1 || (S2 <= B && S2 * Q <= kThreads)) &&
         (gsize == 0 || B % gsize == 0) &&
         (!vec || (m % 4 == 0 && rows % 4 == 0 && ld % 8 == 4)) &&
         (grid >= 1 && (long long)grid * rows >= m &&
          (long long)(grid - 1) * rows < m);
}

// One sweep of K1 (payload null) or K8 on a checked plan.
int launch(const float* A_t, const float* x_in, const float* r_in,
           const float* steps, const uint8_t* mask, const float* w,
           float* x_out, float* r_out, float* payload, float* partials,
           unsigned* bar, int n_blocks, int B, int m, int gsize, float lam1,
           float lam2, int kind, int grid, int rows, int ld, int P, int S1,
           int S2, int RW, int vec, int copy, cudaStream_t stream) {
  if (kind != 2) gsize = 0;
  if (!plan_ok(B, m, gsize, grid, rows, ld, P, S1, S2, RW, vec) ||
      n_blocks < 1 || copy < 0 || copy > 1 || (copy == 1 && !vec) ||
      bar == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_of(B, rows, ld, P, S1, S2, RW, vec);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const Kernel k = kernel_for(vec != 0, payload != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&A_t,      (void*)&x_in,   (void*)&r_in,
                  (void*)&steps,    (void*)&mask,   (void*)&w,
                  (void*)&x_out,    (void*)&r_out,  (void*)&payload,
                  (void*)&partials, (void*)&bar,    (void*)&n_blocks,
                  (void*)&B,        (void*)&m,      (void*)&rows,
                  (void*)&ld,       (void*)&P,      (void*)&S1,
                  (void*)&S2,       (void*)&RW,     (void*)&gsize,
                  (void*)&lam1,     (void*)&lam2,   (void*)&kind,
                  (void*)&copy};
  err = cudaLaunchCooperativeKernel((void*)k, dim3(grid), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Check a plan of K1 and K8 on the current device: out[0] = the
// shared-memory bytes of its layout, out[1] = CTAs that fit on one SM, the
// fewer of the two instances (0 when the layout exceeds shared memory).
// Returns a cudaError_t (cudaErrorNotSupported without cooperative
// launch).
int cot_sweep_check(int B, int rows, int ld, int P, int S1, int S2,
                    int RW, int vec, int* out) {
  out[0] = out[1] = 0;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = smem_of(B, rows, ld, P, S1, S2, RW, vec);
  out[0] = (int)smem;
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaSuccess;
  int fit[2] = {0, 0};
  for (int pay = 0; pay < 2; ++pay) {
    const Kernel k = kernel_for(vec != 0, pay != 0);
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[pay], k,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
  }
  out[1] = fit[0] < fit[1] ? fit[0] : fit[1];
  return (int)cudaSuccess;
}

// One sweep of K1 on the plan (grid, rows, ld, P, S1, S2, RW, vec); copy:
// how the tile is loaded, 1 16-byte cp.async (needs vec and A_t 16-byte
// aligned), 0 4-byte cp.async.  x_out / r_out must not alias the inputs;
// partials holds (grid + 1) B floats; bar is one unsigned, zero at the
// launch (the grid barriers' arrival counter).  mask (n,) and the group
// weights w (n / gsize,) may be null; gsize is read for kind 2 only.
int cot_sweep_t(const float* A_t, const float* x_in, const float* r_in,
                const float* steps, const uint8_t* mask, const float* w,
                float* x_out, float* r_out, float* partials, unsigned* bar,
                int n_blocks, int B, int m, int gsize, float lam1,
                float lam2, int kind, int grid, int rows, int ld, int P,
                int S1, int S2, int RW, int vec, int copy,
                cudaStream_t stream) {
  return launch(A_t, x_in, r_in, steps, mask, w, x_out, r_out, nullptr,
                partials, bar, n_blocks, B, m, gsize, lam1, lam2, kind, grid,
                rows, ld, P, S1, S2, RW, vec, copy, stream);
}

// One slab sweep of K8: K1's sweep on the same plan and operands, and the
// merge's payload (m + 3 floats, not aliasing the inputs).
int cot_sweep_slab_t(const float* A_t, const float* x_in, const float* r_in,
                     const float* steps, const uint8_t* mask, const float* w,
                     float* x_out, float* r_out, float* payload,
                     float* partials, unsigned* bar, int n_blocks, int B,
                     int m, int gsize, float lam1, float lam2, int kind,
                     int grid, int rows, int ld, int P, int S1, int S2,
                     int RW, int vec, int copy, cudaStream_t stream) {
  if (payload == nullptr) return (int)cudaErrorInvalidValue;
  return launch(A_t, x_in, r_in, steps, mask, w, x_out, r_out, payload,
                partials, bar, n_blocks, B, m, gsize, lam1, lam2, kind, grid,
                rows, ld, P, S1, S2, RW, vec, copy, stream);
}

}  // extern "C"
