// K9 — one cyclic Gauss-Seidel block-coordinate sweep over the transposed
// block-major layout A_t (n_blocks, B, m), float32, for blocks whose
// per-SM tile does not fit in shared memory (K1's limit, csrc/sweep.cu).
//
// Replaces the Pallas kernel convex_optimization_tpu/ops/
// bcd_sweep_pallas_tiled.py `_kernel` (wrapper `bcd_sweep_pallas_tiled`),
// which streamed (MT, B) row tiles of a block-major copy of A twice per
// block because the block did not fit VMEM.  Per block j, in order:
//
//   g     = A_t[j] r + lam2 x_j                   (B dots of length m)
//   x_j'  = prox(x_j - t_j g, t_j lam1), 0 where the keep mask is 0
//   r    += A_t[j]^T (x_j' - x_j)                 (m axpys of length B)
//
// What bounds it on the H100: bytes.  Each CTA's (B x rows) slab of a block
// does not fit its shared memory (160 MB a block chip-wide at config 4's
// B = 2000, more than the 50 MB L2), so phase 2 reads from memory what the
// ring did not keep: A once (4 m n bytes), plus A again less the kept
// chunks, per sweep, at 3.35 TB/s (chip_smoke.tiled_design_work).
//
// Design: K1's pipeline (csrc/sweep.cu) with the slab STREAMED through a
// ring of `S` slots of C coordinates (b-rows of `rows` floats, stride ld).
// One cooperative launch per sweep, one CTA of 384 threads per SM: one
// producer warp and 11 consumer warps; CTA c owns rows [c*rows, c*rows +
// rows) of r in shared memory for the whole sweep.  The plan (grid, rows,
// ld, C, S, the kept chunks K, S1, S2, RW, the float4 instance) comes from
// ops/bcd_sweep_tiled.tiled_tiling; `layout` below is the shared-memory
// map both sides compute.  What the design does about each limit of the
// first design:
//   1. Phase 2 walks the N chunks of the block BACKWARDS, N-1 ... 0, so its
//      first K chunks are the last phase 1 read: they stay in the ring
//      across the prox and are not copied again; the next ones are those
//      phase 1 read most recently, the likeliest still in L2.  Load t (one
//      chunk) goes to slot t mod S; a block's loads are phase 1's chunks
//      0 .. N-1, then phase 2's N-K-1 .. 0, each issued as soon as its
//      slot's previous chunk has had its last use, so S - K loads of phase
//      2 are in flight across the two barriers, and block j + 1's first
//      chunks during block j's phase 2.  The order is
//      ops/bcd_sweep_tiled.tiled_schedule, CPU-tested.
//   2. Grid barriers on an integer arrival counter (`cons_barrier`, K1's
//      `counter_barrier` among the consumer warps), zeroed by the wrapper
//      per launch.
//   3. One producer warp issues every copy: a bulk copy (1-D TMA) per
//      coordinate's run of `rows` floats (608 bytes at config 4), lane i
//      the coordinates i, i + 32, ...; no address is divided per copy.
//      Where m % 4 != 0 or A_t is not 16-byte aligned (the scalar
//      instance) a copy takes the 16-byte granules that hold the run and
//      the run starts 0-3 floats into its row (`off`).  Each slot has a
//      `full` mbarrier that the copies complete on and an `empty` one on
//      which every consumer warp arrives after the chunk's last use; the
//      producer waits on `empty` before it refills the slot.  So within a
//      phase no step waits for the whole CTA: a consumer warp waits only
//      for its chunk.  16-byte cp.async from the one warp was slower than
//      the bulk copies, and the whole CTA issuing copies in lockstep steps
//      slower still (PERF.md §6).
//   4. The ring fills the shared memory left beside r, dx, the group
//      scales and the segment sums (about 200 KB of 227 KB at config 4).
//   5. Phase 1 is register-blocked as K1's: a unit of two coordinates
//      (h, h + ceil(nb/2)) of the chunk over S1 interleaved row segments
//      held by S1 lanes of one warp, float4 tile reads (ld = 4 mod 8)
//      against a broadcast float4 of r; the segments are summed by a fixed
//      xor-shuffle order and go to a global (G, B) buffer of partials.
//   6. Phase 2 is register-blocked as K1's: a unit (s, q) owns float4 q
//      of the CTA's rows over the s-th of S2 segments of every chunk's
//      coordinates and carries its sums across the block's chunks; the S2
//      sums are added in order through shared memory at the block's end
//      (with S2 = 1 each unit adds its chunk to r at once).
//   Between the phases, K1's split reduction: CTA c sums chunks c, c + G,
//   ... of 32 consecutive coordinates, the G partials split over RW warps
//   and added in warp order; the reducing warp proxes and writes dx (the
//   group's v) to a global (B,) buffer and x_out; barrier 2; every CTA
//   reads dx (for group_l2 it forms the group scales, one warp per group,
//   and dx itself; CTA 0 writes x_out), so every CTA holds the same bits of
//   dx.  One buffer of partials and of dx suffices (csrc/sweep_batch.cu
//   says why).  A is read-only, so a copy may cross a grid barrier.
//
// Determinism: no float atomics; every sum runs in an order fixed by the
// shape, the SM count and the plan, so two launches give the same bits.
//
// Penalties: 0 = l1 (soft threshold), 1 = nonneg_l1 (shift and clip),
// 2 = group_l2 over contiguous groups of gsize coordinates (gsize divides
// B), group weights w (n / gsize,) or null for ones.

#include <cuda_runtime.h>

#include <cstdint>

#include "pipeline.cuh"
#include "prox.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kConsWarps = kThreads / 32 - 1;  // the last warp produces
constexpr int kCons = 32 * kConsWarps;
constexpr int kMaxSmemBytes = 227 * 1024;

// Offsets in floats of the shared regions, and their total; the Python
// plan (ops/bcd_sweep_tiled.TiledPlan.smem_bytes) mirrors it.
struct Layout {
  int r, dx, sc, red, gs, bar, total;
};

__host__ __device__ inline Layout layout(int B, int rows, int ld, int C,
                                         int S, int S2, int RW, bool vec) {
  Layout o;
  o.r = S * C * ld;                            // the ring comes first
  o.dx = o.r + up4(rows, vec);
  o.sc = o.dx + up4(B, vec);
  o.red = o.sc + up4(B, vec);                 // room for B / gsize scales
  o.gs = o.red + up4((S2 - 1) * rows, vec);
  o.bar = o.gs + (RW > 1 ? 32 * RW : 0);
  o.bar += o.bar & 1;                         // 2 S mbarriers of 8 bytes
  o.total = o.bar + 4 * S;
  return o;
}

// One arrival on an mbarrier (release: the arriving thread's reads of the
// slot are done before the producer's wait returns).
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// __syncthreads for the consumer warps alone (named barrier 1).
__device__ __forceinline__ void cons_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCons) : "memory");
}

// counter_barrier (csrc/pipeline.cuh) among the consumer warps: thread 0
// adds one with release semantics and spins until the count reaches
// `target`.
__device__ __forceinline__ void cons_barrier(unsigned* count,
                                             unsigned target) {
  cons_sync();
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
  cons_sync();
}

// The sum over the S1 lanes of one unit (S1 a power of two <= 32, the
// unit's lanes consecutive) in a fixed xor-shuffle order: every lane of the
// unit gets the same bits.
__device__ __forceinline__ float seg_sum(float v, int S1) {
  for (int off = S1 >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Phase 2 of one unit: acc[ii] += sum over b in [b0, b1) of
// tile[b][W q + ii] dx[b]; the scalar instance's row b starts `o` floats
// into its row, o = (o0 + b m4) mod 4 (m4 = m mod 4).
template <bool VEC>
__device__ __forceinline__ void dot_cols(const float* tile, const float* dx,
                                         int ld, int b0, int b1, int q,
                                         int o0, int m4,
                                         float (&acc)[VEC ? 4 : 1]) {
#pragma unroll 4
  for (int b = b0; b < b1; ++b) {
    const float d = dx[b];
    if constexpr (VEC) {
      const float4 t = *reinterpret_cast<const float4*>(tile + b * ld + 4 * q);
      acc[0] = fmaf(t.x, d, acc[0]);
      acc[1] = fmaf(t.y, d, acc[1]);
      acc[2] = fmaf(t.z, d, acc[2]);
      acc[3] = fmaf(t.w, d, acc[3]);
    } else {
      acc[0] = fmaf(tile[b * ld + ((o0 + b * m4) & 3) + q], d, acc[0]);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
tiled_sweep_kernel(const float* __restrict__ A_t,
                   const float* __restrict__ x_in,
                   const float* __restrict__ r_in,
                   const float* __restrict__ steps,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ w, float* __restrict__ x_out,
                   float* __restrict__ r_out, float* partials, unsigned* bar,
                   int n_blocks, int B, int m, int rows, int ld, int C,
                   int S, int K, int S1, int S2, int RW, int gsize,
                   float lam1, float lam2, int kind) {
  constexpr int W = VEC ? 4 : 1;    // rows per phase-2 unit and tile read
  extern __shared__ __align__(16) float smem[];
  const Layout o = layout(B, rows, ld, C, S, S2, RW, VEC);
  float* ring = smem;                 // (S, C, ld) chunk slots
  float* r_s = smem + o.r;            // (rows,)
  float* dx_s = smem + o.dx;          // (B,): group v, then dx
  float* sc_s = smem + o.sc;          // (B / gsize,) group scales
  float* red = smem + o.red;          // (S2 - 1, rows) phase-2 segment sums
  float* gs_s = smem + o.gs;          // (RW, 32) the reduce's warp sums
  unsigned long long* full =          // (S,) a slot's chunk has landed
      reinterpret_cast<unsigned long long*>(smem + o.bar);
  unsigned long long* empty = full + S;  // (S,) its last use is done

  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = (B + C - 1) / C;      // chunks of a block
  const int LB = 2 * N - K;           // loads of a block

  // Where a coordinate's run starts in shared memory: a bulk copy moves
  // 16-byte-aligned bytes, so it copies the aligned granules that hold the
  // run (reading up to 12 bytes of its neighbours, within those granules)
  // and the run starts `off` floats into its row: 0 for the float4
  // instance (m % 4 == 0, A_t 16-byte aligned), else (address / 4) mod 4.
  const int a_off = (int)((reinterpret_cast<uintptr_t>(A_t) >> 2) & 3);
  auto off = [&](int jj, int b) {
    return VEC ? 0 : (int)((a_off + ((size_t)jj * B + b) * m + i0) & 3);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsWarps);
    }
  }
  __syncthreads();

  if (warp == kConsWarps) {
    // The producer warp: load t (its block's chunk l < N of phase 1, else
    // 2N - K - 1 - l of phase 2) into slot t mod S once the slot's
    // previous chunk has had its last use: one bulk copy per coordinate's
    // run, lane i the coordinates i, i + 32, ...
    const int total = n_blocks * LB;  // < 2^31 (the launch checks)
    for (int t = 0; t < total; ++t) {
      const int jj = t / LB, l = t - jj * LB;
      const int k = l < N ? l : 2 * N - K - 1 - l;
      const int slot = t % S;
      if (t >= S) mbar_wait(empty + slot, (t / S - 1) & 1);
      const int b0 = k * C, nb = min(C, B - b0);
      float* dst = ring + (size_t)slot * C * ld;
      const float* src = A_t + ((size_t)jj * B + b0) * m + i0;
      unsigned bytes = 0;
      for (int b = lane; b < nb; b += 32) {
        bytes += 4u * ((off(jj, b0 + b) + cnt + 3) & ~3);
      }
      bytes = __reduce_add_sync(0xffffffffu, bytes);
      if (lane == 0) mbar_expect(full + slot, bytes);
      __syncwarp();
      for (int b = lane; b < nb; b += 32) {
        const int d = off(jj, b0 + b);
        bulk_copy(dst + b * ld, src + (size_t)b * m - d,
                  4u * ((d + cnt + 3) & ~3), full + slot);
      }
    }
    return;
  }

  // The consumer warps (kCons threads).  Use U of a block: phase 1's chunk
  // k (load t0 + k), then phase 2's chunk N - 1 - p (load t0 + N - 1 - p
  // for the K kept, else t0 + N + p - K).  Every consumer warp waits for a
  // chunk before it reads it and, after the chunk's last use, arrives on
  // its slot's `empty` barrier; no step needs the whole CTA.
  unsigned arrivals = 0;  // on `bar` after this CTA's latest grid barrier
  auto grid_sync = [&]() {
    arrivals += G;
    cons_barrier(bar, arrivals);
  };
  auto acquire = [&](int t) { mbar_wait(full + t % S, (t / S) & 1); };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % S);
  };
  const int nk = cnt / W;             // phase-1 row chunks of this CTA
  const int Q = rows / W;             // phase-2 row units
  const bool group = kind == 2;
  const int gpb = group ? B / gsize : 0;
  float* dx_g = partials + (size_t)G * B;  // partials (G, B), dx (B)

  for (int i = tid; i < rows; i += kCons) {
    r_s[i] = i < cnt ? r_in[i0 + i] : 0.0f;
  }
  cons_sync();

  // phase-2 unit of this thread (one per thread when S2 > 1)
  const int s2 = tid / Q, q2 = tid - s2 * Q;
  const bool act2 = S2 > 1 && s2 < S2 && W * q2 < cnt;
  // phase-1 unit: S1 consecutive lanes of a warp
  const int u1 = tid / S1, s1 = tid - u1 * S1;
  const int upp = kCons / S1;         // units per pass

  for (int j = 0; j < n_blocks; ++j) {
    const int t0 = j * LB;
    const float* xj_g = x_in + (size_t)j * B;
    const uint8_t* keep_j = mask != nullptr ? mask + (size_t)j * B : nullptr;
    const float t = steps[j];
    float* part = partials + (size_t)c * B;

    // phase 1: partial g over this CTA's rows, chunk by chunk
    for (int k = 0; k < N; ++k) {
      acquire(t0 + k);
      const float* tile = ring + (size_t)((t0 + k) % S) * C * ld;
      const int b0 = k * C, nb = min(C, B - b0), hp = (nb + 1) / 2;
      for (int h0 = 0; h0 < hp; h0 += upp) {  // uniform in each warp
        const int h = h0 + u1;
        float acc0 = 0.0f, acc1 = 0.0f;
        if (h < hp) {
          const float* a0 = tile + h * ld + off(j, b0 + h);
          const float* a1 = h + hp < nb
                                ? tile + (h + hp) * ld + off(j, b0 + h + hp)
                                : a0;
          dot_rows<VEC>(a0, a1, r_s, nk, s1, S1, acc0, acc1);
        }
        acc0 = seg_sum(acc0, S1);
        acc1 = seg_sum(acc1, S1);
        if (h < hp && s1 == 0) {
          part[b0 + h] = acc0;
          if (h + hp < nb) part[b0 + h + hp] = acc1;
        }
      }
      if (k < N - K) release(t0 + k);  // the last K wait for phase 2
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
        cons_sync();
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
      if (RW > 1) cons_sync();  // warp 0 done with gs_s
    }
    grid_sync();
    for (int b = tid; b < B; b += kCons) dx_s[b] = __ldcg(dx_g + b);
    cons_sync();

    if (group) {
      // one warp per group: ||v_g||^2 in a fixed order, then the scale
      for (int q = warp; q < gpb; q += kConsWarps) {
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
      cons_sync();
      for (int b = tid; b < B; b += kCons) {
        float xn = dx_s[b] * sc_s[b / gsize];
        if (keep_j != nullptr && keep_j[b] == 0) xn = 0.0f;
        dx_s[b] = xn - xj_g[b];
        if (c == 0) x_out[(size_t)j * B + b] = xn;
      }
      cons_sync();
    }

    // phase 2: r += A_t[j]^T dx over this CTA's rows, chunks N-1 ... 0; the
    // first K are still in the ring from phase 1
    float acc[W];
#pragma unroll
    for (int ii = 0; ii < W; ++ii) acc[ii] = 0.0f;
    for (int p = 0; p < N; ++p) {
      const int k = N - 1 - p;
      const int tl = p < K ? t0 + k : t0 + N + (p - K);
      if (p >= K) acquire(tl);  // a kept chunk was acquired in phase 1
      const float* tile = ring + (size_t)(tl % S) * C * ld;
      const int b0 = k * C, nb = min(C, B - b0);
      const int o0 = off(j, b0), m4 = m & 3;
      if (S2 > 1) {
        if (act2) {
          dot_cols<VEC>(tile, dx_s + b0, ld, s2 * nb / S2,
                        (s2 + 1) * nb / S2, q2, o0, m4, acc);
        }
      } else {
        for (int q = tid; q < Q && W * q < cnt; q += kCons) {
          float a[W];
#pragma unroll
          for (int ii = 0; ii < W; ++ii) a[ii] = 0.0f;
          dot_cols<VEC>(tile, dx_s + b0, ld, 0, nb, q, o0, m4, a);
          add_w<W>(r_s + W * q, a);
          st_w<W>(r_s + W * q, a);
        }
      }
      release(tl);
    }
    if (S2 > 1) {  // the S2 segment sums, in order, onto r
      if (act2 && s2 > 0) st_w<W>(red + (s2 - 1) * rows + W * q2, acc);
      cons_sync();
      if (act2 && s2 == 0) {
        for (int u = 1; u < S2; ++u) {
          add_w<W>(red + (u - 1) * rows + W * q2, acc);
        }
        add_w<W>(r_s + W * q2, acc);
        st_w<W>(r_s + W * q2, acc);
      }
    }
    cons_sync();  // r complete before block j + 1's phase 1 reads it
  }
  for (int i = tid; i < cnt; i += kCons) r_out[i0 + i] = r_s[i];
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const uint8_t*, const float*, float*,
                        float*, float*, unsigned*, int, int, int, int, int,
                        int, int, int, int, int, int, int, float, float, int);

Kernel kernel_for(bool vec) {
  return vec ? tiled_sweep_kernel<true> : tiled_sweep_kernel<false>;
}

size_t smem_of(int B, int rows, int ld, int C, int S, int S2, int RW,
               int vec) {
  return sizeof(float) *
         (size_t)layout(B, rows, ld, C, S, S2, RW, vec != 0).total;
}

// The plan's invariants (ops/bcd_sweep_tiled.tiled_tiling): the kernel
// relies on each of them.
bool plan_ok(int B, int m, int gsize, int grid, int rows, int ld, int C,
             int S, int K, int S1, int S2, int RW, int vec) {
  const int Q = vec ? rows / 4 : rows;
  const int N = C >= 1 ? (B + C - 1) / C : 0;
  return B >= 1 && rows >= 1 && ld >= rows && C >= 1 && C <= B && S >= 1 &&
         K >= 0 && K <= N && K <= S && S1 >= 1 && S1 <= 32 &&
         (S1 & (S1 - 1)) == 0 && (RW == 1 || RW == kConsWarps) &&
         (S2 == 1 || (S2 <= C && S2 * Q <= kCons)) &&
         (gsize == 0 || B % gsize == 0) &&
         ld % 4 == 0 && ld >= ((rows + 3) & ~3) &&
         (!vec || (m % 4 == 0 && rows % 4 == 0 && ld % 8 == 4)) &&
         (grid >= 1 && (long long)grid * rows >= m &&
          (long long)(grid - 1) * rows < m);
}

}  // namespace

extern "C" {

// Check a plan of K9 on the current device: out[0] = the shared-memory
// bytes of its layout, out[1] = CTAs that fit on one SM (0 when the layout
// exceeds shared memory).  Returns a cudaError_t (cudaErrorNotSupported
// without cooperative launch).
int cot_sweep_tiled_check(int B, int rows, int ld, int C, int S, int S2,
                          int RW, int vec, int* out) {
  out[0] = out[1] = 0;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = smem_of(B, rows, ld, C, S, S2, RW, vec);
  out[0] = (int)smem;
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaSuccess;
  const Kernel k = kernel_for(vec != 0);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], k, kThreads,
                                                      smem);
  return (int)err;
}

// One sweep of K9 on the plan (grid, rows, ld, C, S, K, S1, S2, RW, vec;
// the float4 instance needs A_t 16-byte aligned).  x_out / r_out must not
// alias the inputs; partials holds (grid + 1) B floats; bar is one
// unsigned, zero at the launch (the grid barriers' arrival counter).  mask
// (n,) and the group weights w (n / gsize,) may be null; gsize is read for
// kind 2 only.
int cot_sweep_tiled_t(const float* A_t, const float* x_in, const float* r_in,
                      const float* steps, const uint8_t* mask, const float* w,
                      float* x_out, float* r_out, float* partials,
                      unsigned* bar, int n_blocks, int B, int m, int gsize,
                      float lam1, float lam2, int kind, int grid, int rows,
                      int ld, int C, int S, int K, int S1, int S2, int RW,
                      int vec, cudaStream_t stream) {
  if (kind != 2) gsize = 0;
  if (!plan_ok(B, m, gsize, grid, rows, ld, C, S, K, S1, S2, RW, vec) ||
      n_blocks < 1 ||
      (long long)n_blocks * 2 * ((B + C - 1) / C) >= (1LL << 31) ||
      (vec && (reinterpret_cast<uintptr_t>(A_t) & 15) != 0) ||
      bar == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_of(B, rows, ld, C, S, S2, RW, vec);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const Kernel k = kernel_for(vec != 0);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&A_t,   (void*)&x_in,     (void*)&r_in,
                  (void*)&steps, (void*)&mask,     (void*)&w,
                  (void*)&x_out, (void*)&r_out,    (void*)&partials,
                  (void*)&bar,   (void*)&n_blocks, (void*)&B,
                  (void*)&m,     (void*)&rows,     (void*)&ld,
                  (void*)&C,     (void*)&S,        (void*)&K,
                  (void*)&S1,    (void*)&S2,       (void*)&RW,
                  (void*)&gsize, (void*)&lam1,     (void*)&lam2,
                  (void*)&kind};
  err = cudaLaunchCooperativeKernel((void*)k, dim3(grid), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
