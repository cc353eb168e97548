// K8 — one cyclic Gauss-Seidel sweep over one rank's column slab of the
// transposed block-major layout A_t (nb_loc, B, m), float32, from the
// replicated consensus residual r_in, with the column-sharded BCD merge's
// payload written in the epilogue.
//
// Replaces the Pallas kernel convex_optimization_tpu/ops/bcd_sweep_pallas.py
// `_sweep_kernel` (wrapper `bcd_sweep_pallas`), the per-chip slab sweep of
// the column-sharded solver (convex_optimization_tpu/parallel/sharded.py
// `sharded_bcd`).  Per block j, in order:
//
//   g     = A_t[j] r + lam2 x_j                   (B dots of length m)
//   x_j'  = prox(x_j - t_j g, t_j lam1), 0 where the keep mask is 0
//   r    += A_t[j]^T (x_j' - x_j)                 (m axpys of length B)
//
// and then, for the merge (sharded.py:370-382 there), in one buffer:
//
//   payload[0:m]  = r_out - r_in                  (the consensus payload dr)
//   payload[m]    = <x, dx>,  payload[m + 1] = <dx, dx>,
//   payload[m + 2] = g(x + dx) - g(x)             (Penalty.value_diff)
//
// so that one sharded BCD step is one launch and one all-reduce of m + 3
// floats.  The TPU kernel's MXU dots at HIGHEST and its one-hot group
// matmuls are not copied: f32 FMAs, fixed-order reductions, no float atomics.
//
// Design: cooperative and persistent like K1 (csrc/sweep.cu): one launch
// per sweep, one CTA per SM, CTA c owns rows [c*rows, c*rows + rows) of r in
// shared memory for the whole sweep and keeps its (B x rows) tile of A_t[j]
// in shared memory between the two products ("A_j resident": each element
// of A is read once per sweep).  The reduction is the split one of K5 and
// K9 (csrc/sweep_batch.cu, csrc/sweep_tiled.cu), which beat K1's serial
// G-term reduction at every L on the H100 (PERF.md):
//
//   * phase 1: one warp per coordinate, lane-strided over the tile's rows,
//     then a shuffle tree; the CTA's partial g (G, B) goes to global;
//   * grid barrier 1; CTA c sums the G partials of coordinates c, c + G, ...
//     one warp each in a fixed lane/shuffle order into g (B,);
//   * grid barrier 2; every CTA reads g and computes the prox of the whole
//     block (group norms in a fixed order, one warp per group), so every CTA
//     holds bit-identical dx; CTA 0 stores x_j' and adds the block's terms
//     of the three scalars, in block order, to its running sums;
//   * phase 2: each thread owns rows of r and adds the tile's A^T dx.
//   * One buffer of partials and of g suffices (csrc/sweep_tiled.cu says
//     why).
//
// What bounds it on the H100: the bytes of the slab, 4 m n_loc (2.0 GB for
// a rank's half of 10k x 100k: 0.60 ms at 3.35 TB/s); in practice the
// per-block latency (un-pipelined tile load, two grid barriers, the
// partials' round trip through L2), as in K1 and K5.  Blocks whose tile does
// not fit go to K9; the Python router computes the payload there.
//
// Penalties: 0 = l1, 1 = nonneg_l1, 2 = group_l2 over contiguous groups of
// gsize coordinates (gsize divides B), weights w (n_loc / gsize,) or null.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "prox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
slab_sweep_kernel(const float* __restrict__ A_t,
                  const float* __restrict__ x_in,
                  const float* __restrict__ r_in,
                  const float* __restrict__ steps,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ w, float* __restrict__ x_out,
                  float* __restrict__ r_out, float* __restrict__ payload,
                  float* partials, float* gbuf, int n_blocks, int B, int m,
                  int rows, int gsize, float lam1, float lam2, int kind) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* tile = smem;               // (B, rows)
  float* r_s = tile + B * rows;     // (rows,)
  float* v_s = r_s + rows;          // (B,): v, then dx
  float* sc_s = v_s + B;            // (B / gsize,): group scales, then
                                    // (CTA 0) the groups' value_diff terms
  float* acc_s = sc_s + B;          // (3,): CTA 0's running sums

  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gpb = kind == 2 ? B / gsize : 0;

  for (int i = tid; i < cnt; i += blockDim.x) r_s[i] = r_in[i0 + i];
  if (tid < 3) acc_s[tid] = 0.0f;

  for (int j = 0; j < n_blocks; ++j) {
    const float* Aj = A_t + (size_t)j * B * m + i0;
    const float* xj_g = x_in + (size_t)j * B;
    __syncthreads();  // r_s initialised / previous block done with smem
    for (int b = warp; b < B; b += nwarps) {
      for (int i = lane; i < cnt; i += 32) {
        tile[b * rows + i] = Aj[(size_t)b * m + i];
      }
    }
    __syncthreads();

    // phase 1: partial g over this CTA's rows, one warp per coordinate
    for (int b = warp; b < B; b += nwarps) {
      float s = 0.0f;
      for (int i = lane; i < cnt; i += 32) {
        s = fmaf(tile[b * rows + i], r_s[i], s);
      }
      s = warp_sum(s);
      if (lane == 0) partials[(size_t)c * B + b] = s;
    }
    grid.sync();

    // this CTA's share of the coordinates: g_b = sum of the G partials
    for (int b = c + G * warp; b < B; b += G * nwarps) {
      float g = 0.0f;
      for (int q = lane; q < G; q += 32) {
        g += __ldcg(partials + (size_t)q * B + b);
      }
      g = warp_sum(g);
      if (lane == 0) gbuf[b] = g;
    }
    grid.sync();

    // prox of the whole block in every CTA (bit-identical everywhere)
    const float tj = steps[j];
    for (int b = tid; b < B; b += blockDim.x) {
      const float xj = xj_g[b];
      v_s[b] = xj - tj * (__ldcg(gbuf + b) + lam2 * xj);
    }
    __syncthreads();
    if (kind == 2) {
      for (int q = warp; q < gpb; q += nwarps) {
        float s = 0.0f;
        for (int i = lane; i < gsize; i += 32) {
          const float v = v_s[q * gsize + i];
          s = fmaf(v, v, s);
        }
        s = warp_sum(s);
        if (lane == 0) {
          const float wq = w != nullptr ? w[(size_t)j * gpb + q] : 1.0f;
          sc_s[q] = fmaxf(0.0f,
                          1.0f - tj * lam1 * wq / fmaxf(sqrtf(s), 1e-30f));
        }
      }
      __syncthreads();
    }
    for (int b = tid; b < B; b += blockDim.x) {
      const size_t k = (size_t)j * B + b;
      const float xj = xj_g[b];
      const float v = v_s[b];
      float xn = kind == 2 ? v * sc_s[b / gsize] : prox(v, tj * lam1, kind);
      if (mask != nullptr && mask[k] == 0) xn = 0.0f;
      v_s[b] = xn - xj;
      if (c == 0) x_out[k] = xn;
    }
    __syncthreads();

    // the merge's scalars (CTA 0 only: c is uniform over the CTA, so its
    // barriers are reached by every thread or by none)
    if (c == 0) {
      if (kind == 2) {
        // ||a + d|| - ||a|| = (2 <a, d> + ||d||^2) / (||a + d|| + ||a||)
        for (int q = warp; q < gpb; q += nwarps) {
          float no = 0.0f, nn = 0.0f, ad = 0.0f, dd = 0.0f;
          for (int i = lane; i < gsize; i += 32) {
            const float a = xj_g[q * gsize + i];
            const float d = v_s[q * gsize + i];
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
          if (lane == 0) {
            const float wq = w != nullptr ? w[(size_t)j * gpb + q] : 1.0f;
            sc_s[q] = wq * (2.0f * ad + dd) /
                      fmaxf(sqrtf(nn) + sqrtf(no), 1e-30f);
          }
        }
        __syncthreads();
      }
      if (warp == 0) {
        float s_xd = 0.0f, s_dd = 0.0f, s_g = 0.0f;
        for (int b = lane; b < B; b += 32) {
          const float a = xj_g[b];
          const float d = v_s[b];
          s_xd = fmaf(a, d, s_xd);
          s_dd = fmaf(d, d, s_dd);
          if (kind != 2) {
            // |a + d| - |a| = sign(a) d where the sign does not flip
            const float an = a + d;
            s_g += an * a > 0.0f ? (a > 0.0f ? d : -d)
                                 : fabsf(an) - fabsf(a);
          }
        }
        for (int q = lane; q < gpb; q += 32) s_g += sc_s[q];
        s_xd = warp_sum(s_xd);
        s_dd = warp_sum(s_dd);
        s_g = warp_sum(s_g);
        if (lane == 0) {
          acc_s[0] += s_xd;
          acc_s[1] += s_dd;
          acc_s[2] += s_g;
        }
      }
    }

    // phase 2: r += A_t[j]^T dx over this CTA's rows, same shared tile
    for (int i = tid; i < cnt; i += blockDim.x) {
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc = fmaf(tile[b * rows + i], v_s[b], acc);
      r_s[i] += acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < cnt; i += blockDim.x) {
    r_out[i0 + i] = r_s[i];
    payload[i0 + i] = r_s[i] - r_in[i0 + i];
  }
  if (c == 0 && tid == 0) {
    payload[m] = acc_s[0];
    payload[m + 1] = acc_s[1];
    payload[m + 2] = lam1 * acc_s[2];
  }
}

// The tile, the CTA's rows of r, dx, the group scales and the three sums:
// within K1's fit rule (ops/bcd_sweep.k1_smem_bytes, 3 B floats beside the
// tile and r) for every B >= 4.
size_t smem_bytes(int B, int rows) {
  return sizeof(float) * ((size_t)B * rows + rows + 2 * (size_t)B + 4);
}

}  // namespace

extern "C" {

// Grid size for a slab sweep at (B, m): one CTA per SM, bounded by
// co-resident capacity and by m.  Returns a cudaError_t; *grid_out = 0 when
// the tile does not fit in shared memory.
int cot_sweep_slab_grid(int B, int m, int* grid_out) {
  *grid_out = 0;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const int G = sms < m ? sms : m;
  const int rows = (m + G - 1) / G;
  const size_t smem = smem_bytes(B, rows);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(slab_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slab_sweep_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid_out = G;
  return (int)cudaSuccess;
}

// One slab sweep.  x_out / r_out / payload must not alias the inputs;
// payload holds m + 3 floats, scratch (grid + 1) * B.  mask (n_loc,) and
// w (n_loc / gsize,) may be null.
int cot_sweep_slab_t(const float* A_t, const float* x_in, const float* r_in,
                     const float* steps, const uint8_t* mask, const float* w,
                     float* x_out, float* r_out, float* payload,
                     float* scratch, int n_blocks, int B, int m, int gsize,
                     float lam1, float lam2, int kind, int grid,
                     cudaStream_t stream) {
  int rows = (m + grid - 1) / grid;
  const size_t smem = smem_bytes(B, rows);
  cudaError_t err = cudaFuncSetAttribute(
      slab_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* partials = scratch;
  float* gbuf = scratch + (size_t)grid * B;
  void* args[] = {(void*)&A_t,      (void*)&x_in,    (void*)&r_in,
                  (void*)&steps,    (void*)&mask,    (void*)&w,
                  (void*)&x_out,    (void*)&r_out,   (void*)&payload,
                  (void*)&partials, (void*)&gbuf,    (void*)&n_blocks,
                  (void*)&B,        (void*)&m,       (void*)&rows,
                  (void*)&gsize,    (void*)&lam1,    (void*)&lam2,
                  (void*)&kind};
  err = cudaLaunchCooperativeKernel((void*)slab_sweep_kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
