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
// On the TPU the grid ran in order on one core and r stayed in VMEM.  Here
// the blocks are sequential but each block's work is spread over the whole
// card, so the kernel is COOPERATIVE and PERSISTENT: one launch per sweep,
// grid = one CTA per SM (never more than can be co-resident), and one grid
// barrier per column block.
//
//   * CTA c owns rows [c*rows, c*rows + rows) of r and keeps them in shared
//     memory for the whole sweep.
//   * Per block j it loads its (B x rows) tile of A_t[j] into shared memory
//     (B = 80, rows = 76 at 10k x 100k: 24 KB), writes its partial g[B] to
//     a global buffer double-buffered by the parity of j, and waits at the
//     grid barrier.  Double buffering makes one barrier per block enough:
//     a CTA can only overwrite buffer (j & 1) again at block j + 2, after
//     every CTA has passed block j + 1's barrier and so finished reading.
//   * Every CTA then sums the partials in CTA order (no atomics), so every
//     CTA computes bit-identical x_j'; CTA 0 stores it.
//   * Each CTA updates its rows of r from the same shared tile, so A is
//     read from HBM exactly once per sweep.
//
// What bounds it on the H100: one sweep streams 4 m n bytes (4 GB at
// 10k x 100k, 1.2 ms at 3.35 TB/s), but it also pays n_blocks grid
// barriers (1250) plus the latency of each block's un-pipelined tile load.
// The barrier and load latency, not bandwidth, are the expected limit;
// they are recorded, not tuned, here (prefetching tile j+1 with cp.async
// before the barrier is the first lever).
//
// Penalties: 0 = l1 (soft threshold), 1 = nonneg_l1 (shift and clip),
// 2 = group_l2 over contiguous groups of gsize coordinates (gsize divides
// B), weights w (n / gsize,) or null for ones.  The group prox scales
// v = x_j - t_j g by max(0, 1 - t_j lam1 w_g / max(||v_g||, 1e-30)); every
// CTA sums ||v_g||^2 in the same fixed order (one warp per group, lane
// stride then a shuffle tree), so x_j' stays bit-identical across CTAs.
//
// Blocks whose (B x rows) tile does not fit in shared memory go to K9
// (csrc/sweep_tiled.cu), which streams the tile instead of holding it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "prox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ A_t, const float* __restrict__ x_in,
             const float* __restrict__ r_in,
             const float* __restrict__ steps,
             const uint8_t* __restrict__ mask, const float* __restrict__ w,
             float* __restrict__ x_out, float* __restrict__ r_out,
             float* partials, int n_blocks, int B, int m, int rows,
             int gsize, float lam1, float lam2, int kind) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* tile = smem;               // (B, rows)
  float* r_s = tile + B * rows;     // (rows,)
  float* dx_s = r_s + rows;         // (B,): group v, then dx
  float* xj_s = dx_s + B;           // (B,) x_j (group_l2)
  float* sc_s = xj_s + B;           // (B / gsize,) group scales

  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < cnt; i += blockDim.x) r_s[i] = r_in[i0 + i];

  for (int j = 0; j < n_blocks; ++j) {
    const float* Aj = A_t + (size_t)j * B * m + i0;
    __syncthreads();  // r_s initialised / previous block done with tile
    for (int b = warp; b < B; b += nwarps) {
      for (int i = lane; i < cnt; i += 32) {
        tile[b * rows + i] = Aj[(size_t)b * m + i];
      }
    }
    __syncthreads();

    // phase 1: partial g over this CTA's rows, one warp per coordinate
    float* part = partials + (size_t)(j & 1) * G * B + (size_t)c * B;
    for (int b = warp; b < B; b += nwarps) {
      float s = 0.0f;
      for (int i = lane; i < cnt; i += 32) {
        s = fmaf(tile[b * rows + i], r_s[i], s);
      }
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) part[b] = s;
    }
    grid.sync();

    // prox: every CTA reduces the partials in the same order
    const float* pj = partials + (size_t)(j & 1) * G * B;
    const float t = steps[j];
    if (kind != 2) {
      for (int b = tid; b < B; b += blockDim.x) {
        float g = 0.0f;
        for (int q = 0; q < G; ++q) g += __ldcg(pj + (size_t)q * B + b);
        const int k = j * B + b;
        const float xj = x_in[k];
        g = g + lam2 * xj;
        float xn = prox(xj - t * g, t * lam1, kind);
        if (mask != nullptr && mask[k] == 0) xn = 0.0f;
        dx_s[b] = xn - xj;
        if (c == 0) x_out[k] = xn;
      }
    } else {
      for (int b = tid; b < B; b += blockDim.x) {
        float g = 0.0f;
        for (int q = 0; q < G; ++q) g += __ldcg(pj + (size_t)q * B + b);
        const float xj = x_in[j * B + b];
        g = g + lam2 * xj;
        xj_s[b] = xj;
        dx_s[b] = xj - t * g;
      }
      __syncthreads();
      const int gpb = B / gsize;
      for (int q = warp; q < gpb; q += nwarps) {
        float s = 0.0f;
        for (int i = lane; i < gsize; i += 32) {
          const float v = dx_s[q * gsize + i];
          s = fmaf(v, v, s);
        }
        for (int off = 16; off > 0; off >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        if (lane == 0) {
          const float wq = w != nullptr ? w[j * gpb + q] : 1.0f;
          sc_s[q] = fmaxf(0.0f,
                          1.0f - t * lam1 * wq / fmaxf(sqrtf(s), 1e-30f));
        }
      }
      __syncthreads();
      for (int b = tid; b < B; b += blockDim.x) {
        const int k = j * B + b;
        float xn = dx_s[b] * sc_s[b / gsize];
        if (mask != nullptr && mask[k] == 0) xn = 0.0f;
        dx_s[b] = xn - xj_s[b];
        if (c == 0) x_out[k] = xn;
      }
    }
    __syncthreads();

    // phase 2: r += A_t[j]^T dx over this CTA's rows, same shared tile
    for (int i = tid; i < cnt; i += blockDim.x) {
      float acc = 0.0f;
      for (int b = 0; b < B; ++b) acc = fmaf(tile[b * rows + i], dx_s[b], acc);
      r_s[i] += acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < cnt; i += blockDim.x) r_out[i0 + i] = r_s[i];
}

size_t smem_bytes(int B, int rows) {
  return sizeof(float) * ((size_t)B * rows + rows + 3 * (size_t)B);
}

}  // namespace

extern "C" {

// Grid size for a sweep at (B, m): one CTA per SM, bounded by co-resident
// capacity and by m.  Returns a cudaError_t; *grid_out = 0 when the tile
// does not fit in shared memory.
int cot_sweep_grid(int B, int m, int* grid_out) {
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
  const size_t smem = smem_bytes(B, rows);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid_out = G;
  return (int)cudaSuccess;
}

// One sweep.  x_out / r_out must not alias x_in; partials holds
// 2 * grid * B floats.  mask may be null (every coordinate kept), and so
// may the group weights w (n / gsize,).
int cot_sweep_t(const float* A_t, const float* x_in, const float* r_in,
                const float* steps, const uint8_t* mask, const float* w,
                float* x_out, float* r_out, float* partials, int n_blocks,
                int B, int m, int gsize, float lam1, float lam2, int kind,
                int grid, cudaStream_t stream) {
  int rows = (m + grid - 1) / grid;
  size_t smem = smem_bytes(B, rows);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&A_t,      (void*)&x_in,     (void*)&r_in,
                  (void*)&steps,    (void*)&mask,     (void*)&w,
                  (void*)&x_out,    (void*)&r_out,    (void*)&partials,
                  (void*)&n_blocks, (void*)&B,        (void*)&m,
                  (void*)&rows,     (void*)&gsize,    (void*)&lam1,
                  (void*)&lam2,     (void*)&kind};
  err = cudaLaunchCooperativeKernel((void*)sweep_kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
