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
// Design: K1's (csrc/sweep.cu) cooperative persistent kernel widened to L
// rows.  One launch per sweep, one CTA per SM, two grid barriers per block.
//   * CTA c owns rows [c*rows, c*rows + rows) of all L residual rows and of
//     the row mask, in shared memory for the whole sweep.
//   * Per block j it loads its (B x rows) tile of A_t[j] ONCE; the tile
//     serves phase 1 and phase 2 of all L rows, so A is read from HBM once
//     per sweep whatever L is.
//   * Phase 1: one thread per (l, b) pair sums its CTA's rows serially and
//     writes the partial to a global (G, L, B) buffer.  Barrier 1.
//   * Split reduction: CTA c reduces and proxes the (l, b) pairs c, c + G,
//     ..., one warp per pair (lane-strided over the G partials, then a
//     fixed shuffle tree: no atomics, the same order every run), and writes
//     the finished dx to a global (L, B) buffer.  Barrier 2; every CTA then
//     reads the (L, B) dx.  K1 instead has every CTA sum all G partials
//     after one barrier; widened to L rows that "naive" reduction reads
//     G*L*B floats from L2 per CTA per block (422 KB at L = 10) and was
//     2.9x slower at L = 10 on the H100 (PERF.md), slower at every L.
//   * Phase 2: one thread per (l, i) pair updates r_l[i] from the same
//     shared tile.
//   * One buffer of each suffices: the partials of block j + 1 are written
//     after barrier 2 of block j, when every read of block j's partials is
//     done, and dx of block j + 1 after barrier 1 of block j + 1, which no
//     CTA reaches before it has copied block j's dx.
//
// Row mask: the 0/1 mask multiplies the phase-2 update.  With residual rows
// that come in masked this equals, bit for bit, the same sweep on a masked
// copy of A: phase 1 multiplies by the masked r (0 at masked rows either
// way) and phase 2 adds rm * s, which is the copy's own sum s or 0.
//
// What bounds it on the H100: the bytes of A are the same as one K1 sweep
// (4 m n bytes, 1 GB at 5k x 50k: 0.3 ms at 3.35 TB/s); the per-block
// latency (un-pipelined tile load, two barriers, the partials' round trip
// through L2) bounds it: 6.6 ms per sweep at L = 1 and 9.3 ms at L = 10
// over 625 blocks, 11-15 us per block (PERF.md).
//
// Penalties: 0 = l1 (soft threshold), 1 = nonneg_l1 (shift and clip).
// group_l2 is refused by the Python wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float prox(float v, float tl, int kind) {
  if (kind == 0) {
    const float a = fmaxf(fabsf(v) - tl, 0.0f);
    return v > 0.0f ? a : (v < 0.0f ? -a : 0.0f);
  }
  return fmaxf(v - tl, 0.0f);
}

// Row stride of the shared tile: odd, so that phase 1's threads (one per
// b, reading tile[b * ld + i]) hit distinct banks.
__host__ __device__ inline int tile_ld(int rows) { return rows | 1; }

__global__ void __launch_bounds__(kThreads)
batch_sweep_kernel(const float* __restrict__ A_t,
                   const float* __restrict__ X_in,
                   const float* __restrict__ R_in,
                   const float* __restrict__ steps,
                   const float* __restrict__ lam1s,
                   const uint8_t* __restrict__ keep,
                   const float* __restrict__ row_mask,
                   float* __restrict__ X_out, float* __restrict__ R_out,
                   float* partials, int n_blocks, int B, int m, int L,
                   int rows, float lam2, int kind) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int ld = tile_ld(rows);
  float* tile = smem;                 // (B, ld)
  float* r_s = tile + B * ld;         // (L, rows)
  float* rm_s = r_s + L * rows;       // (rows,)
  float* dx_s = rm_s + rows;          // (L, B)

  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int LB = L * B;
  const int Lr = L * rows;
  const bool masked = row_mask != nullptr;
  float* dx_g = partials + (size_t)G * LB;  // partials (G, L, B), dx (L, B)

  for (int p = tid; p < Lr; p += blockDim.x) {
    const int l = p / rows, i = p - l * rows;
    if (i < cnt) r_s[p] = R_in[(size_t)l * m + i0 + i];
  }
  if (masked) {
    for (int i = tid; i < cnt; i += blockDim.x) rm_s[i] = row_mask[i0 + i];
  }

  for (int j = 0; j < n_blocks; ++j) {
    const float* Aj = A_t + (size_t)j * B * m + i0;
    __syncthreads();  // r_s initialised / previous block done with tile
    for (int p = tid; p < B * cnt; p += blockDim.x) {
      const int b = p / cnt, i = p - b * cnt;
      tile[b * ld + i] = Aj[(size_t)b * m + i];
    }
    __syncthreads();

    // phase 1: partial g over this CTA's rows, one thread per (l, b)
    for (int p = tid; p < LB; p += blockDim.x) {
      const int l = p / B, b = p - l * B;
      const float* a = tile + b * ld;
      const float* r = r_s + l * rows;
      float s = 0.0f;
      for (int i = 0; i < cnt; ++i) s = fmaf(a[i], r[i], s);
      partials[(size_t)c * LB + p] = s;
    }
    grid.sync();

    // reduce and prox this CTA's share of the (l, b) pairs
    const float t = steps[j];
    for (int p = c + G * warp; p < LB; p += G * nwarps) {
      float g = 0.0f;
      for (int q = lane; q < G; q += 32) {
        g += __ldcg(partials + (size_t)q * LB + p);
      }
      for (int off = 16; off > 0; off >>= 1) {
        g += __shfl_xor_sync(0xffffffffu, g, off);
      }
      if (lane == 0) {
        const int l = p / B, b = p - l * B;
        const size_t k = ((size_t)j * L + l) * B + b;
        const float xj = X_in[k];
        g = g + lam2 * xj;
        float xn = prox(xj - t * g, t * lam1s[l], kind);
        if (keep != nullptr && keep[j * B + b] == 0) xn = 0.0f;
        dx_g[p] = xn - xj;
        X_out[k] = xn;
      }
    }
    grid.sync();
    for (int p = tid; p < LB; p += blockDim.x) dx_s[p] = __ldcg(dx_g + p);
    __syncthreads();

    // phase 2: r_l += rm * (A_t[j]^T dx_l) over this CTA's rows
    for (int p = tid; p < Lr; p += blockDim.x) {
      const int l = p / rows, i = p - l * rows;
      if (i >= cnt) continue;
      const float* dx = dx_s + l * B;
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc = fmaf(tile[b * ld + i], dx[b], acc);
      r_s[p] += masked ? rm_s[i] * acc : acc;
    }
  }
  __syncthreads();
  for (int p = tid; p < Lr; p += blockDim.x) {
    const int l = p / rows, i = p - l * rows;
    if (i < cnt) R_out[(size_t)l * m + i0 + i] = r_s[p];
  }
}

size_t smem_bytes(int B, int rows, int L) {
  return sizeof(float) * ((size_t)B * tile_ld(rows) + (size_t)L * rows +
                          rows + (size_t)L * B);
}

}  // namespace

extern "C" {

// Grid size for a batched sweep at (B, m, L): one CTA per SM, bounded by
// co-resident capacity and by m.  Returns a cudaError_t; *grid_out = 0 when
// the tile does not fit in shared memory.
int cot_batch_sweep_grid(int B, int m, int L, int* grid_out) {
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
  int G = sms < m ? sms : m;
  const int rows = (m + G - 1) / G;
  const size_t smem = smem_bytes(B, rows, L);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(batch_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, batch_sweep_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid_out = G;
  return (int)cudaSuccess;
}

// One batched sweep.  X_out / R_out must not alias the inputs; partials
// holds (grid + 1) * L * B floats.  keep (n,) and row_mask (m,) may be null.
int cot_batch_sweep_t(const float* A_t, const float* X_in, const float* R_in,
                      const float* steps, const float* lam1s,
                      const uint8_t* keep, const float* row_mask,
                      float* X_out, float* R_out, float* partials,
                      int n_blocks, int B, int m, int L, float lam2, int kind,
                      int grid, cudaStream_t stream) {
  int rows = (m + grid - 1) / grid;
  size_t smem = smem_bytes(B, rows, L);
  cudaError_t err = cudaFuncSetAttribute(
      batch_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&A_t,      (void*)&X_in,  (void*)&R_in,
                  (void*)&steps,    (void*)&lam1s, (void*)&keep,
                  (void*)&row_mask, (void*)&X_out, (void*)&R_out,
                  (void*)&partials, (void*)&n_blocks, (void*)&B,
                  (void*)&m,        (void*)&L,     (void*)&rows,
                  (void*)&lam2,     (void*)&kind};
  err = cudaLaunchCooperativeKernel((void*)batch_sweep_kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
