// K5 — one cyclic Gauss-Seidel block-coordinate sweep for L <= 16 lambda
// values at once, over the transposed block-major layout A_t
// (n_blocks, B, m), float32.
//
// Replaces the Pallas kernel convex_optimization_tpu/ops/
// bcd_sweep_vpu_batch.py `_batch_kernel` (wrapper `batch_sweep_vpu`).
// X (n_blocks, L, B) holds the L iterates, R (L, m) their residuals.  Per
// block j, in order, for every row l:
//
//   g_l    = A_t[j] r_l + lam2 x_{j,l}              (B dots of length m)
//   x_jl'  = prox(x_{j,l} - t_j g_l, t_j lam1_l), 0 where the keep mask is 0
//   r_l   += rm * (A_t[j]^T (x_jl' - x_{j,l}))      (rm = 1 without a mask)
//
// Design: one cooperative launch per sweep of G = cs * NC CTAs of 384
// threads, one per SM, in NC thread block clusters of cs CTAs; per block,
// one exchange between the clusters through global memory, and no grid or
// cluster barrier (the data's own arrival orders the CTAs).  The launch
// plan (cs, NC, rows, the tile's row stride ld, the prefetch depth P, the
// segment counts S1 and S2, the float4 instance, bulk copies) comes from
// ops/bcd_sweep_batch.batch_sweep_tiling; `layout` below is the
// shared-memory map both sides compute.
//   * CTA c owns rows [c*rows, c*rows + rows) of all L residual rows and of
//     the row mask, in shared memory for the whole sweep (CTAs past
//     ceil(m / rows) own none: their phases run empty, their partials are
//     exact zeros).  Its (B x rows) tile of A_t[j] serves phase 1 and phase
//     2 of all L rows, so A is read from HBM once per sweep whatever L is.
//   * The tile is PREFETCHED across the exchange.  The shared tile store
//     is a ring of B + P b-row slots: tile j holds B consecutive slots from
//     `base`, and the P slots after them are free.  Once tile j is resident
//     the CTA issues b-rows [0, P) of tile j + 1 into the free slots, so they
//     fly across phase 1, the exchange and phase 2; b-rows [P, B) go into
//     tile j's first B - P slots once phase 2 of block j has released them.
//     Where two tiles fit (config 2, the 10k CV shape) P = B, a plain double
//     buffer.  Where they do not (config 4's group tile, B = 200) P is what
//     the spare shared memory holds and the rest is loaded after phase 2 --
//     chosen over a streaming ring because phase 1 and phase 2 each read the
//     whole tile.  A is read-only, so a copy may cross any barrier.
//   * The copies: with m % 4 == 0 and A_t 16-byte aligned (rows % 4 == 0
//     keeps every CTA's i0 aligned), one bulk copy (1-D TMA) per tile row
//     issued by the last warp, completing on an mbarrier per part (rows
//     [0, P) and [P, B), one phase per tile), where rows are long (>= 512
//     bytes: config 4), else 16-byte cp.async by every thread (config 2's
//     short rows, where bulk copies lost); 4-byte cp.async otherwise.
//   * Phase 1 (register-blocked): a unit (s, h) keeps the L sums of tile rows
//     h and h + ceil(B/2) in registers over the s-th of S1 interleaved
//     segments of the CTA's rows, so each float4 of r read from shared
//     memory feeds 8 FMAs and each tile float4 L.  Lanes take consecutive h:
//     the r reads are broadcasts and the tile reads conflict-free (ld = 4 mod
//     8 floats; odd for the scalar instance).  Rows l >= L read row L - 1 and
//     are dropped, so no branch splits a chunk's loads.  Segments are summed
//     in order 0, 1, .., S1 - 1 through shared memory.
//   * The exchange.  Rank k of a cluster owns the b's [k Bs, k Bs + Bs)
//     (Bs = B / cs) at every l: SL = Bs L pairs (b, l), which the exchange
//     keeps in the b-major order b L + l.  Four mbarriers per CTA: the
//     tile's two parts, rv (this block's partials of the CTA's slice) and dx.
//       1. Phase 1 stores the LP partials of each tile row b, by 16-byte
//          st.async, into the shared memory of b's owner in this cluster,
//          in the row of this CTA's rank; each reports its bytes to the
//          owner's rv mbarrier.
//       2. The owner waits on rv (all cs rows in), sums its pairs over the
//          rows in rank order, and stores each cluster sum into copy j % 2
//          of a global (2, NC, B, L) buffer of epoch-tagged words (the float
//          and j + 1 in one 8-byte word; the wrapper zeroes the buffer).
//       3. It loads the NC clusters' words of each of its pairs (all in
//          flight), loads again each one whose epoch is not yet j + 1, and
//          adds the values in cluster order: g.  Every cluster thus
//          computes the same bits of every pair.
//       4. It applies the prox (group_l2: forms v) and stores the result
//          (dx, or v) by st.async into the dx_s of every CTA of its cluster,
//          transposed to (B, DS), reporting to their dx mbarriers; cluster
//          0 writes X_out.  Each CTA waits on dx: it holds the whole dx.
//     A cluster of one CTA (cs = 1) stores its partials as its cluster's
//     sums at step 1, and its dx into its own dx_s, behind a __syncthreads;
//     it has no rows of partials and, in the scalar instance, no
//     mbarriers: its layout is the first K5 design's.  X, the keep flag
//     and t lam1 of the first pairs of the CTA's slice are loaded at the
//     top of the block, under phase 1.
//   * Phase 2 (register-blocked): a unit (s, l-quad, q) owns four residual
//     rows l and the rows i of float4 q (one row for the scalar instance)
//     over the s-th of S2 contiguous b-segments: each tile float4 feeds 16
//     FMAs against a broadcast float4 of dx.  Segments are summed in order
//     through shared memory, then r += rm * acc.
//   * Why the buffers suffice with no barrier.  A peer stores block j + 1's
//     partials into an owner's rows only after it has waited for block j's
//     whole dx, which includes the owner's dx of block j, which the owner
//     computes from its sums of block j's rows: so the owner has read them.
//     An owner stores block j + 1's dx into a CTA's dx_s only once that
//     CTA's partials of block j + 1 are in, which the CTA stores after the
//     __syncthreads at the top of block j + 1: so its phase 2 of block j,
//     and its group scale step, are done with dx_s.  For the same reasons
//     no bytes of block j + 1 reach an rv or dx mbarrier before its phase
//     of block j has completed.  Within a CTA, phase 2 of block j (which
//     writes r_s and red) starts only after the whole dx is in, which
//     needs every pair's partial, which every thread stores after its
//     phase-1 reads of r_s and red.  Two global copies suffice: a CTA
//     writes block j + 2's sums into copy j % 2 only after it has read
//     block j + 1's words of every CTA of its rank, each of which wrote
//     them only after it had read its block j words of copy j % 2.  A
//     cluster barrier at the start makes sure every peer runs, with its
//     mbarriers initialised and its dx_s zeroed, before the first remote
//     store, and one at the end that no CTA leaves while its stores into
//     a peer may be in flight.  The prefetch touches no exchange buffer:
//     it writes only ring slots that no thread reads before the wait at the
//     top of the next block, and that no thread reads after the
//     __syncthreads that precedes each issue.
//
// Determinism: every sum runs in an order fixed by the shape and the plan
// (units, segments, then a pair's partials in cluster rank order and the
// clusters' sums in cluster order); no float atomics, so two launches
// on the same inputs give the same bits.  The plan's cs and NC come from
// the card's cluster occupancy, so another card may sum in another order.
//
// Row mask: the 0/1 mask multiplies the phase-2 update.  With residual rows
// that come in masked this equals, bit for bit, the same sweep on a masked
// copy of A: phase 1 multiplies by the masked r (0 at masked rows either
// way) and phase 2 adds rm * s, which is the copy's own sum s or 0.
//
// What bounds it on the H100: the bytes of A are the same as one K1 sweep
// (4 m n bytes, 1 GB at 5k x 50k: 0.3 ms at 3.35 TB/s), but a block's bytes
// take well under a microsecond at config 2.  With the tile load hidden,
// each block pays the latency chains of the two phases, two hops through
// the cluster's shared memory, and one trip through L2 between the
// clusters, whose slowest CTA sets the pace.  The per-block cost of each
// design is in PERF.md (scripts/time_sweep_batch.py times config 2 at 125
// and at 625 blocks, whose difference is the cost per block).
//
// Penalties: 0 = l1 (soft threshold), 1 = nonneg_l1 (shift and clip),
// 2 = group_l2 over contiguous groups of gsize coordinates (gsize divides
// B), weights w (n / gsize,) or null for ones.  The group prox needs a
// whole group's v before any coordinate is final, so for kind 2 the owners
// store v_l = x_l - t (g_l + lam2 x_l) into dx_s instead of dx; once it is
// in, every CTA holds v and X_in's (L, B) slice (loaded after phase 1) in
// shared memory and computes each (l, group) scale
// max(0, 1 - t lam1_l w_g / max(||v_g||, 1e-30)), one warp per (l, group)
// with ||v_g||^2 summed in one fixed order (lane stride, then warp_sum),
// then the keep mask and dx.  Every CTA thus holds the same bits of dx
// (the row-mask identity above still holds exactly); CTA 0 writes X_out.

#include <cuda_runtime.h>

#include <cstdint>

#include "pipeline.cuh"
#include "prox.cuh"

namespace {

// 384 threads: 170 registers each under one CTA per SM; 256 and 512 (128
// registers) were slower at config 2 and config 4 (PERF.md)
constexpr int kThreads = 384;
constexpr int kMaxSmemBytes = 227 * 1024;

// Offsets in floats of the shared regions, and their total; the Python
// plan (ops/bcd_sweep_batch.BatchSweepPlan.smem_bytes) mirrors it.
struct Layout {
  int r, rm, dx, red, rv, xj, sc, mb, total;
};

__host__ __device__ inline Layout layout(int B, int L, int LP, int gsize,
                                         int rows, int ld, int P, int S1,
                                         int S2, int cs, bool vec) {
  Layout o;
  const int red1 = (S1 - 1) * 2 * LP * ((B + 1) / 2);
  const int red2 = (S2 - 1) * LP * rows;
  o.r = (B + P) * ld;                          // the ring comes first
  o.rm = o.r + up4(L * rows, vec);
  o.dx = o.rm + up4(rows, vec);
  o.red = o.dx + up4(B * (vec ? LP : L), vec);
  o.rv = o.red + up4(red1 > red2 ? red1 : red2, vec);
  if (cs > 1) o.rv = up4(o.rv, true);         // 16-byte rows of 4 l's
  o.xj = o.rv + (cs > 1 ? B * LP : 0);
  o.sc = o.xj + (gsize > 0 ? L * B : 0);
  o.mb = o.sc + (gsize > 0 ? L * (B / gsize) : 0);
  // four mbarriers (the tile's two parts, rv, dx) where bulk copies or a
  // cluster may use them
  const bool bars = vec || cs > 1;
  if (bars) o.mb = up4(o.mb, true);
  o.total = o.mb + (bars ? 8 : 0);
  return o;
}

// Phase 1 of one unit: acc0[l] (acc1[l]) = sum over the CTA's row chunks
// k = s, s + S1, ... of tile row a0 (a1) against r_s row l, in chunks of 4
// floats when VEC.  Rows l >= L read row L - 1 (no branches, so the loads
// of a chunk issue together); the caller drops their sums.
template <int LP, bool VEC>
__device__ __forceinline__ void dot_rows(const float* a0, const float* a1,
                                         const float* r_s, int rows, int L,
                                         int nk, int s, int S1,
                                         float (&acc0)[LP],
                                         float (&acc1)[LP]) {
#pragma unroll
  for (int l = 0; l < LP; ++l) acc0[l] = acc1[l] = 0.0f;
  for (int k = s; k < nk; k += S1) {
    if constexpr (VEC) {
      const float4 t0 = *reinterpret_cast<const float4*>(a0 + 4 * k);
      const float4 t1 = *reinterpret_cast<const float4*>(a1 + 4 * k);
#pragma unroll
      for (int l = 0; l < LP; ++l) {
        const float4 r = *reinterpret_cast<const float4*>(
            r_s + (l < L ? l : L - 1) * rows + 4 * k);
        acc0[l] = fmaf(t0.x, r.x, acc0[l]);
        acc1[l] = fmaf(t1.x, r.x, acc1[l]);
        acc0[l] = fmaf(t0.y, r.y, acc0[l]);
        acc1[l] = fmaf(t1.y, r.y, acc1[l]);
        acc0[l] = fmaf(t0.z, r.z, acc0[l]);
        acc1[l] = fmaf(t1.z, r.z, acc1[l]);
        acc0[l] = fmaf(t0.w, r.w, acc0[l]);
        acc1[l] = fmaf(t1.w, r.w, acc1[l]);
      }
    } else {
      const float t0 = a0[k], t1 = a1[k];
#pragma unroll
      for (int l = 0; l < LP; ++l) {
        const float r = r_s[(l < L ? l : L - 1) * rows + k];
        acc0[l] = fmaf(t0, r, acc0[l]);
        acc1[l] = fmaf(t1, r, acc1[l]);
      }
    }
  }
}

// Phase 2 of one unit: acc[li][ii] = sum over b in [b0, b1) of
// tile[b][W q + ii] dx[b][4 lq + li]; `sl` is b0's ring slot, dx_s has row
// stride ds (LP when VEC, its rows past L zero; L otherwise).
template <bool VEC>
__device__ __forceinline__ void dot_cols(const float* ring, const float* dx_s,
                                         int ld, int BP, int sl, int b0,
                                         int b1, int lq, int q, int L, int ds,
                                         float (&acc)[4][VEC ? 4 : 1]) {
  constexpr int W = VEC ? 4 : 1;
#pragma unroll
  for (int li = 0; li < 4; ++li) {
#pragma unroll
    for (int ii = 0; ii < W; ++ii) acc[li][ii] = 0.0f;
  }
#pragma unroll 4
  for (int b = b0; b < b1; ++b) {
    if constexpr (VEC) {
      const float4 t = *reinterpret_cast<const float4*>(ring + sl * ld + 4 * q);
      const float4 d =
          *reinterpret_cast<const float4*>(dx_s + b * ds + 4 * lq);
      const float tv[4] = {t.x, t.y, t.z, t.w};
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int li = 0; li < 4; ++li) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          acc[li][ii] = fmaf(tv[ii], dv[li], acc[li][ii]);
        }
      }
    } else {
      const float t = ring[sl * ld + q];
#pragma unroll
      for (int li = 0; li < 4; ++li) {
        const int l = 4 * lq + li;  // l >= L reads row L - 1, dropped later
        acc[li][0] = fmaf(t, dx_s[b * ds + (l < L ? l : L - 1)], acc[li][0]);
      }
    }
    if (++sl == BP) sl = 0;
  }
}

template <int LP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
batch_sweep_kernel(const float* __restrict__ A_t,
                   const float* __restrict__ X_in,
                   const float* __restrict__ R_in,
                   const float* __restrict__ steps,
                   const float* __restrict__ lam1s,
                   const uint8_t* __restrict__ keep,
                   const float* __restrict__ row_mask,
                   const float* __restrict__ w,
                   float* __restrict__ X_out, float* __restrict__ R_out,
                   unsigned long long* xch, int n_blocks, int B, int m,
                   int L, int rows, int ld, int P, int S1, int S2, int cs,
                   int gsize, float lam2, int kind, int copy) {
  constexpr int W = VEC ? 4 : 1;    // rows per phase-2 unit and tile read
  constexpr int NL = LP / 4;        // l-quads
  constexpr int nwarps = kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const Layout o = layout(B, L, LP, gsize, rows, ld, P, S1, S2, cs, VEC);
  float* ring = smem;                 // (B + P, ld) b-row slots
  float* r_s = smem + o.r;            // (L, rows)
  float* rm_s = smem + o.rm;          // (rows,)
  float* dx_s = smem + o.dx;          // (B, DS): group v, then dx
  float* red = smem + o.red;          // segment sums of phases 1 and 2
  float* rv_s = smem + o.rv;          // (cs, Bs, LP) the cluster's partials
  float* xj_s = smem + o.xj;          // (L, B) X_in of block j (group_l2)
  float* sc_s = smem + o.sc;          // (L, B / gsize) group scales
  // bulk copies: tile rows [0, P) complete on mbar[0], rows [P, B) on
  // mbar[1], each once per tile; the cluster's partials of this CTA's
  // slice on mbar[2], the whole dx (group: v) on mbar[3], once per block
  auto* mbar = reinterpret_cast<unsigned long long*>(smem + o.mb);
  const int DS = VEC ? LP : L;

  const int G = gridDim.x;
  const int NC = G / cs;
  const int c = blockIdx.x;
  const unsigned k = cluster_rank();
  const int ci = (int)cluster_id();
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int LB = L * B;
  const int BP = B + P;
  const int Q = rows / W;             // phase-2 row units
  const bool masked = row_mask != nullptr;
  const bool group = kind == 2;
  const int gpb = group ? B / gsize : 0;
  const int Bs = B / cs;              // b's of a slice
  const int SL = Bs * L;              // its pairs, (b, l) at (b - bk) L + l
  const int bk = (int)k * Bs;         // this CTA's slice: b in [bk, bk + Bs)

  // b-rows [b0, b1) of tile jj into their ring slots (row 0 at slot base):
  // copy 2, bulk copies by the last warp completing on mbar[part]; copy 1
  // or 0, one cp.async group of 16- or 4-byte copies by every thread
  auto issue = [&](int jj, int base, int b0, int b1, int part) {
    const float* Aj = A_t + (size_t)jj * B * m + i0;
    if (copy == 2) {
      if (warp == kThreads / 32 - 1) {
        if (lane == 0) mbar_expect(mbar + part, 4u * (b1 - b0) * cnt);
        __syncwarp();
        for (int b = b0 + lane; cnt > 0 && b < b1; b += 32) {
          int sl = base + b;
          if (sl >= BP) sl -= BP;
          bulk_copy(ring + sl * ld, Aj + (size_t)b * m, 4u * cnt,
                    mbar + part);
        }
      }
    } else if (copy == 1) {
      const int per = cnt >> 2;
      for (int p = tid; p < (b1 - b0) * per; p += kThreads) {
        const int q = p / per;
        const int kk = (p - q * per) << 2;
        int sl = base + b0 + q;
        if (sl >= BP) sl -= BP;
        cp_async<4>(ring + sl * ld + kk, Aj + (size_t)(b0 + q) * m + kk);
      }
      cp_async_commit();
    } else {
      for (int p = tid; p < (b1 - b0) * cnt; p += kThreads) {
        const int q = p / cnt;
        const int kk = p - q * cnt;
        int sl = base + b0 + q;
        if (sl >= BP) sl -= BP;
        cp_async<1>(ring + sl * ld + kk, Aj + (size_t)(b0 + q) * m + kk);
      }
      cp_async_commit();
    }
  };

  for (int p = tid; p < L * rows; p += kThreads) {
    const int l = p / rows, i = p - l * rows;
    r_s[p] = i < cnt ? R_in[(size_t)l * m + i0 + i] : 0.0f;
  }
  if (masked) {
    for (int i = tid; i < rows; i += kThreads) {
      rm_s[i] = i < cnt ? row_mask[i0 + i] : 0.0f;
    }
  }
  for (int p = tid; p < B * DS; p += kThreads) dx_s[p] = 0.0f;
  if (tid == 0 && (VEC || cs > 1)) {
    for (int i = 0; i < 4; ++i) mbar_init(mbar + i, 1);
  }
  cluster_sync();  // every peer runs, its dx_s zeroed, before any store
  int base = 0;
  issue(0, 0, 0, P, 0);
  issue(0, 0, P, B, 1);

  for (int j = 0; j < n_blocks; ++j) {
    const int nbase = base + B < BP ? base + B : base + B - BP;
    const bool next = j + 1 < n_blocks;
    // copy j % 2 of the exchange: (NC, B, L), epoch j + 1
    unsigned long long* xg = xch + (size_t)(j & 1) * NC * LB;
    const unsigned ep = (unsigned)(j + 1);
    if (copy == 2) {
      mbar_wait(mbar, j & 1);
      mbar_wait(mbar + 1, j & 1);
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j resident; block j - 1 done with the ring
    if (next) issue(j + 1, nbase, 0, P, 0);
    if (cs > 1 && tid == 0) {  // this block's bytes on the exchange's
      mbar_expect(mbar + 2, 4u * B * LP);
      mbar_expect(mbar + 3, 4u * LB);
    }
    // operands of this thread's first pair of the CTA's slice, loaded now
    // so that their latency hides under phase 1 and the exchange
    float xj_first = 0.0f, tl_first = 0.0f;
    bool drop_first = false;
    if (tid < SL) {
      const int b = bk + tid / L, l = tid - (tid / L) * L;
      xj_first = X_in[((size_t)j * L + l) * B + b];
      tl_first = steps[j] * lam1s[l];
      drop_first = keep != nullptr && keep[j * B + b] == 0;
    }

    // phase 1: partial g over this CTA's rows, units (s, h) of tile rows
    // h and h + Bh
    const int nk = cnt / W;
    const int Bh = (B + 1) / 2;
    auto unit_rows = [&](int h, const float*& a0, const float*& a1) {
      int sa = base + h, sb = base + h + Bh;
      if (sa >= BP) sa -= BP;
      if (sb >= BP) sb -= BP;
      a0 = ring + sa * ld;
      a1 = h + Bh < B ? ring + sb * ld : a0;  // odd B: a dropped twin
    };
    // the partials of tile row b (all LP rows l, those past L dropped by
    // their owner) into the owner's row of this CTA's rank, by 16-byte
    // stores into the cluster's shared memory; a cluster of one stores its
    // sums of rows l < L into copy j % 2 instead
    auto put = [&](int b, const float (&acc)[LP]) {
      if (cs == 1) {
#pragma unroll
        for (int l = 0; l < LP; ++l) {
          if (l < L) ll_store(xg + (size_t)ci * LB + b * L + l, acc[l], ep);
        }
      } else {
        const int r = b / Bs;
        const unsigned dst = peer_smem(
            rv_s + ((int)k * Bs + b - r * Bs) * LP, r);
        const unsigned bar = peer_smem(mbar + 2, r);
#pragma unroll
        for (int q = 0; q < LP / 4; ++q) {
          st_async4(dst + 16 * q, acc + 4 * q, bar);
        }
      }
    };
    auto store_partials = [&](int h, const float (&acc0)[LP],
                              const float (&acc1)[LP]) {
      put(h, acc0);
      if (h + Bh < B) put(h + Bh, acc1);
    };
    if (S1 == 1) {
      for (int h = tid; h < Bh; h += kThreads) {
        const float *a0, *a1;
        unit_rows(h, a0, a1);
        float acc0[LP], acc1[LP];
        dot_rows<LP, VEC>(a0, a1, r_s, rows, L, nk, 0, 1, acc0, acc1);
        store_partials(h, acc0, acc1);
      }
    } else {  // S1 * Bh <= kThreads: one unit per thread
      const int s = tid / Bh, h = tid - s * Bh;
      const bool act = s < S1;
      float acc0[LP], acc1[LP];
      if (act) {
        const float *a0, *a1;
        unit_rows(h, a0, a1);
        dot_rows<LP, VEC>(a0, a1, r_s, rows, L, nk, s, S1, acc0, acc1);
        if (s > 0) {
          float* out = red + (size_t)(s - 1) * 2 * LP * Bh + h;
#pragma unroll
          for (int l = 0; l < LP; ++l) {
            out[l * Bh] = acc0[l];
            out[(LP + l) * Bh] = acc1[l];
          }
        }
      }
      __syncthreads();
      if (act && s == 0) {
        for (int u = 1; u < S1; ++u) {
          const float* in = red + (size_t)(u - 1) * 2 * LP * Bh + h;
#pragma unroll
          for (int l = 0; l < LP; ++l) {
            acc0[l] += in[l * Bh];
            acc1[l] += in[(LP + l) * Bh];
          }
        }
        store_partials(h, acc0, acc1);
      }
    }
    if (group) {  // X_in's slice of block j, under the exchange's latency
      const float* Xj = X_in + (size_t)j * LB;
      for (int p = tid; p < LB; p += kThreads) xj_s[p] = Xj[p];
    }
    // the cluster's sum of each pair of this CTA's slice, in rank order,
    // into copy j % 2; a cluster of one stored its sums in phase 1
    if (cs > 1) {
      mbar_wait_cluster(mbar + 2, j & 1);
      for (int t = tid; t < SL; t += kThreads) {
        const float* in = rv_s + (t / L) * LP + (t - (t / L) * L);
        float g = in[0];
        for (int r = 1; r < cs; ++r) g += in[r * Bs * LP];
        ll_store(xg + (size_t)ci * LB + bk * L + t, g, ep);
      }
    }

    // the NC clusters' sums of each pair of the slice, in cluster order (up
    // to 16 loads in flight, each until it holds epoch j + 1), then the
    // prox; the result into the dx_s of every CTA of the cluster
    const float t = steps[j];
    for (int tt = tid; tt < SL; tt += kThreads) {
      const int b = bk + tt / L, l = tt - (tt / L) * L;
      const unsigned long long* src = xg + bk * L + tt;
      float g = 0.0f;
      for (int q0 = 0; q0 < NC; q0 += 16) {
        unsigned long long v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int q = q0 + u;
          v[u] = q < NC ? ll_load(src + (size_t)q * LB)
                        : (unsigned long long)ep << 32;
        }
        bool ready;
        do {
          ready = true;
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if ((unsigned)(v[u] >> 32) != ep) {
              ready = false;
              v[u] = ll_load(src + (size_t)(q0 + u) * LB);
            }
          }
        } while (!ready);
#pragma unroll
        for (int u = 0; u < 16; ++u) g += __uint_as_float((unsigned)v[u]);
      }
      const size_t kx = ((size_t)j * L + l) * B + b;
      const bool first = tt == tid;
      const float xj = first ? xj_first : X_in[kx];
      g = g + lam2 * xj;
      float d;
      if (group) {
        d = xj - t * g;  // v: the group prox needs the whole group
      } else {
        const bool drop =
            first ? drop_first : keep != nullptr && keep[j * B + b] == 0;
        float xn = prox(xj - t * g, first ? tl_first : t * lam1s[l], kind);
        if (drop) xn = 0.0f;
        d = xn - xj;
        if (ci == 0) X_out[kx] = xn;
      }
      float* dst = dx_s + b * DS + l;
      if (cs == 1) {
        *dst = d;
      } else {
        for (int r = 0; r < cs; ++r) {
          st_async(peer_smem(dst, r), d, peer_smem(mbar + 3, r));
        }
      }
    }
    if (cs == 1) {  // the whole dx (group: v) is in
      __syncthreads();
    } else {
      mbar_wait_cluster(mbar + 3, j & 1);
    }

    if (group) {
      // one warp per (l, group): ||v_g||^2 in a fixed order, then the scale
      for (int q = warp; q < L * gpb; q += nwarps) {
        const int l = q / gpb, gi = q - l * gpb;
        const float* v = dx_s + gi * gsize * DS + l;
        float s = 0.0f;
        for (int i = lane; i < gsize; i += 32) {
          s = fmaf(v[i * DS], v[i * DS], s);
        }
        s = warp_sum(s);
        if (lane == 0) {
          const float wq = w != nullptr ? w[j * gpb + gi] : 1.0f;
          sc_s[q] = fmaxf(
              0.0f, 1.0f - t * lam1s[l] * wq / fmaxf(sqrtf(s), 1e-30f));
        }
      }
      __syncthreads();
      for (int p = tid; p < LB; p += kThreads) {
        const int l = p / B, b = p - l * B;
        float xn = dx_s[b * DS + l] * sc_s[l * gpb + b / gsize];
        if (keep != nullptr && keep[j * B + b] == 0) xn = 0.0f;
        if (c == 0) X_out[(size_t)j * LB + p] = xn;
        dx_s[b * DS + l] = xn - xj_s[p];
      }
      __syncthreads();
    }

    // phase 2: r_l += rm * (A_t[j]^T dx_l) over this CTA's rows, units
    // (s, l-quad, q)
    // r += rm * acc on the unit's rows (all W of them exist: cnt % W == 0
    // when VEC, and the callers skip units past cnt)
    auto apply = [&](int lq, int q, float (&acc)[4][W]) {
      float rm[W];
      if (masked) ld_w<W>(rm_s + W * q, rm);
#pragma unroll
      for (int li = 0; li < 4; ++li) {
        if (4 * lq + li >= L) continue;
        float* r = r_s + (4 * lq + li) * rows + W * q;
        if (masked) {
#pragma unroll
          for (int ii = 0; ii < W; ++ii) acc[li][ii] *= rm[ii];
        }
        add_w<W>(r, acc[li]);
        st_w<W>(r, acc[li]);
      }
    };
    if (S2 == 1) {
      for (int u = tid; u < NL * Q; u += kThreads) {
        const int lq = u / Q, q = u - lq * Q;
        if (W * q >= cnt) continue;
        float acc[4][W];
        dot_cols<VEC>(ring, dx_s, ld, BP, base, 0, B, lq, q, L, DS, acc);
        apply(lq, q, acc);
      }
    } else {  // S2 * NL * Q <= kThreads: one unit per thread
      const int s = tid / (NL * Q);
      const int rem = tid - s * NL * Q;
      const int lq = rem / Q, q = rem - lq * Q;
      const bool act = s < S2 && W * q < cnt;
      float acc[4][W];
      if (act) {
        const int b0 = s * B / S2, b1 = (s + 1) * B / S2;
        int sl = base + b0;
        if (sl >= BP) sl -= BP;
        dot_cols<VEC>(ring, dx_s, ld, BP, sl, b0, b1, lq, q, L, DS,
                      acc);
        if (s > 0) {
#pragma unroll
          for (int li = 0; li < 4; ++li) {
            st_w<W>(red + ((s - 1) * LP + 4 * lq + li) * rows + W * q,
                    acc[li]);
          }
        }
      }
      __syncthreads();
      if (act && s == 0) {
        for (int u = 1; u < S2; ++u) {
#pragma unroll
          for (int li = 0; li < 4; ++li) {
            add_w<W>(red + ((u - 1) * LP + 4 * lq + li) * rows + W * q,
                     acc[li]);
          }
        }
        apply(lq, q, acc);
      }
    }
    if (next) {
      if (P < B) __syncthreads();  // phase 2 done with tile j's slots
      issue(j + 1, nbase, P, B, 1);
    }
    base = nbase;
  }
  cp_async_wait<0>();
  cluster_sync();  // no CTA leaves while its stores into a peer may fly
  for (int p = tid; p < L * rows; p += kThreads) {
    const int l = p / rows, i = p - l * rows;
    if (i < cnt) R_out[(size_t)l * m + i0 + i] = r_s[p];
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const uint8_t*,
                        const float*, const float*, float*, float*,
                        unsigned long long*, int, int, int, int, int, int,
                        int, int, int, int, int, float, int, int);

// The instance for L (rounded up to 4) and the read width.
Kernel kernel_for(int L, bool vec) {
  static const Kernel table[2][4] = {
      {batch_sweep_kernel<4, false>, batch_sweep_kernel<8, false>,
       batch_sweep_kernel<12, false>, batch_sweep_kernel<16, false>},
      {batch_sweep_kernel<4, true>, batch_sweep_kernel<8, true>,
       batch_sweep_kernel<12, true>, batch_sweep_kernel<16, true>}};
  return table[vec ? 1 : 0][(L + 3) / 4 - 1];
}

// The largest cluster K5 launches with (the portable limit).
constexpr int kMaxCluster = 8;

// The plan's invariants (ops/bcd_sweep_batch.batch_sweep_tiling): the
// kernel relies on each of them.  The grid is whole clusters, covers m,
// and its last cluster holds a CTA with rows.
bool plan_ok(int B, int m, int L, int gsize, int grid, int rows, int ld,
             int P, int S1, int S2, int cs, int vec) {
  const int LP = 4 * ((L + 3) / 4);
  const int Q = vec ? rows / 4 : rows;
  return L >= 1 && L <= 16 && B >= 1 && rows >= 1 && ld >= rows &&
         P >= 0 && P <= B && S1 >= 1 && S2 >= 1 && cs >= 1 &&
         cs <= kMaxCluster && B % cs == 0 &&
         (S1 == 1 || S1 * ((B + 1) / 2) <= kThreads) &&
         (S2 == 1 || (S2 <= B && S2 * (LP / 4) * Q <= kThreads)) &&
         (gsize == 0 || B % gsize == 0) &&
         (!vec || (m % 4 == 0 && rows % 4 == 0 && ld % 8 == 4)) &&
         (grid >= cs && grid % cs == 0 && (long long)grid * rows >= m &&
          (long long)(grid - cs) * rows < m);
}

// The launch's configuration: grid CTAs in clusters of cs, cooperative
// (every CTA resident at once, or the launch fails).
struct LaunchConfig {
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg;

  LaunchConfig(int grid, int cs, size_t smem, cudaStream_t stream) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cs;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
  }
};

// The most clusters of cs CTAs of kernel k with smem bytes of shared memory
// that the device holds at once (out), after allowing that much shared
// memory; a cudaError_t.
cudaError_t active_clusters(Kernel k, int cs, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  LaunchConfig lc(cs, cs, smem, nullptr);
  lc.cfg.numAttrs = 1;  // the query takes the cluster shape alone
  return cudaOccupancyMaxActiveClusters(out, (const void*)k, &lc.cfg);
}

// cudaSuccess, or cudaErrorNotSupported without cooperative or cluster
// launch on the current device.
cudaError_t launch_supported() {
  int dev = 0, coop = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&clusters, cudaDevAttrClusterLaunch, dev);
  }
  if (err != cudaSuccess) return err;
  return coop && clusters ? cudaSuccess : cudaErrorNotSupported;
}

}  // namespace

extern "C" {

// out[0] = the most clusters of cs CTAs of K5 that the current device
// holds at once at one CTA per SM (each taking the most shared memory a
// CTA may have, so none shares its SM); the plan sizes its grid from it.
// Returns a cudaError_t (cudaErrorNotSupported without cooperative or
// cluster launch).
int cot_batch_sweep_clusters(int cs, int* out) {
  out[0] = 0;
  cudaError_t err = launch_supported();
  if (err != cudaSuccess) return (int)err;
  if (cs < 1 || cs > kMaxCluster) return (int)cudaErrorInvalidValue;
  return (int)active_clusters(kernel_for(16, true), cs, kMaxSmemBytes, out);
}

// Check a plan of K5 (gsize 0 outside group_l2) on the current device:
// out[0] = the shared-memory bytes of its layout, out[1] = the clusters of
// cs CTAs of it that the device holds at once (0 when the layout exceeds
// shared memory); the plan is resident when out[1] >= its cluster count.
// Returns a cudaError_t (cudaErrorNotSupported without cooperative or
// cluster launch).
int cot_batch_sweep_check(int B, int L, int gsize, int rows, int ld, int P,
                          int S1, int S2, int cs, int vec, int* out) {
  out[0] = out[1] = 0;
  cudaError_t err = launch_supported();
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || L > 16 || cs < 1 || cs > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  const int LP = 4 * ((L + 3) / 4);
  const size_t smem =
      sizeof(float) *
      (size_t)layout(B, L, LP, gsize, rows, ld, P, S1, S2, cs, vec != 0)
          .total;
  out[0] = (int)smem;
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaSuccess;
  return (int)active_clusters(kernel_for(L, vec != 0), cs, smem, &out[1]);
}

// One batched sweep on the plan (grid, cs, rows, ld, P, S1, S2, vec):
// grid / cs clusters of cs CTAs, launched cooperatively.  copy: how the
// tile is loaded, 2 bulk copies or 1 16-byte cp.async (both need vec and
// A_t 16-byte aligned), 0 4-byte cp.async.  X_out / R_out must not alias
// the inputs; xch holds 2 * (grid / cs) * L * B words, zero at the launch
// (the exchange's two copies, epoch-tagged).  keep (n,), row_mask (m,) and
// the group weights w (n / gsize,) may be null; gsize is read for kind 2
// only.
int cot_batch_sweep_t(const float* A_t, const float* X_in, const float* R_in,
                      const float* steps, const float* lam1s,
                      const uint8_t* keep, const float* row_mask,
                      const float* w, float* X_out, float* R_out,
                      unsigned long long* xch, int n_blocks, int B, int m,
                      int L,
                      int gsize, float lam2, int kind, int grid, int cs,
                      int rows, int ld, int P, int S1, int S2, int vec,
                      int copy, cudaStream_t stream) {
  if (kind != 2) gsize = 0;
  if (!plan_ok(B, m, L, gsize, grid, rows, ld, P, S1, S2, cs, vec) ||
      copy < 0 || copy > 2 || (copy > 0 && !vec) || xch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int LP = 4 * ((L + 3) / 4);
  const size_t smem =
      sizeof(float) *
      (size_t)layout(B, L, LP, gsize, rows, ld, P, S1, S2, cs, vec != 0)
          .total;
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const Kernel k = kernel_for(L, vec != 0);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&A_t,      (void*)&X_in,  (void*)&R_in,
                  (void*)&steps,    (void*)&lam1s, (void*)&keep,
                  (void*)&row_mask, (void*)&w,     (void*)&X_out,
                  (void*)&R_out,    (void*)&xch,   (void*)&n_blocks,
                  (void*)&B,        (void*)&m,
                  (void*)&L,        (void*)&rows,  (void*)&ld,
                  (void*)&P,        (void*)&S1,    (void*)&S2,
                  (void*)&cs,       (void*)&gsize, (void*)&lam2,
                  (void*)&kind,     (void*)&copy};
  LaunchConfig lc(grid, cs, smem, stream);
  err = cudaLaunchKernelExC(&lc.cfg, (const void*)k, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
