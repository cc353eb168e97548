// K9 — one cyclic Gauss-Seidel block-coordinate sweep over the transposed
// block-major layout A_t (n_blocks, B, m), float32, for blocks whose
// per-SM slab does not fit in shared memory (K1's limit, csrc/sweep.cu).
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
// Design: K1's cooperative persistent kernel (one launch per sweep, one CTA
// per SM, CTA c owns rows [c*rows, c*rows + rows) of r in shared memory for
// the whole sweep), except that the CTA's (B x rows) slab of A_t[j] is not
// held: it is STREAMED, twice per block, through a ring of kStages shared
// buffers of C coordinates each, filled with cp.async:
//
//   * the stream is one sequence of chunks for the whole sweep (block j,
//     phase 1, chunks 0..; block j, phase 2, chunks 0..; block j + 1, ...),
//     kStages - 1 chunks ahead of the compute, so the loads of phase 2 and of
//     the next block's phase 1 are in flight across the grid barriers (A is
//     read-only, so prefetching it past a barrier is safe);
//   * phase 1: one warp per coordinate of the chunk; each coordinate's rows
//     are one contiguous run of `rows` floats; partial g (G, B) to global;
//   * grid barrier 1; split reduction as in K5 (csrc/sweep_batch.cu): CTA c
//     sums the G partials of coordinates c, c + G, ..., one warp each, in a
//     fixed lane/shuffle order (no atomics), into g (B,) in global memory;
//   * grid barrier 2; every CTA reads g and computes the prox for the whole
//     block (group norms in a fixed order, one warp per group), so every CTA
//     holds bit-identical dx in shared memory; CTA 0 stores x_j';
//   * phase 2: each thread owns rows of r and adds the chunk's A^T dx.
//   * One buffer of partials and of g suffices: the partials of block j + 1
//     are written after barrier 2 of block j, when every read of block j's
//     partials is done; g of block j + 1 after barrier 1 of block j + 1,
//     which no CTA reaches before it has read block j's g.
//
// What bounds it on the H100: it reads A twice per sweep (8 m n bytes, 32 GB
// at 20k x 200k: 9.6 ms at 3.35 TB/s), plus two grid barriers and the
// partials' round trip through L2 per block; with large blocks (B = 2000:
// 160 MB per block) the bytes dominate and the ring keeps kStages - 1
// chunks (64 KB) in flight per SM to cover the memory latency.
//
// Penalties: 0 = l1 (soft threshold), 1 = nonneg_l1 (shift and clip),
// 2 = group_l2 over contiguous groups of gsize coordinates (gsize divides
// B), group weights w (n / gsize,) or null for ones.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pipeline.cuh"
#include "prox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kChunkBytes = 32 * 1024;
constexpr int kMaxSmemBytes = 227 * 1024;

template <int V>
__global__ void __launch_bounds__(kThreads)
tiled_sweep_kernel(const float* __restrict__ A_t,
                   const float* __restrict__ x_in,
                   const float* __restrict__ r_in,
                   const float* __restrict__ steps,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ w, float* __restrict__ x_out,
                   float* __restrict__ r_out, float* partials, float* gbuf,
                   int n_blocks, int B, int m, int rows, int C, int gsize,
                   float lam1, float lam2, int kind) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // (kStages, C, rows)
  float* r_s = ring + (size_t)kStages * C * rows;      // (rows,)
  float* v_s = r_s + rows;                             // (B,): v, then dx
  float* sc_s = v_s + B;                               // (B / gsize,)

  const int G = gridDim.x;
  const int c = blockIdx.x;
  const int i0 = c * rows;
  const int cnt = max(0, min(rows, m - i0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nchunks = (B + C - 1) / C;
  const long long total = 2LL * n_blocks * nchunks;
  const int per = cnt / V;  // copies per coordinate

  // chunk t of the sweep's stream into ring slot t % kStages; always
  // commits a group (empty past the end) so the wait count stays uniform
  auto issue = [&](long long t) {
    if (t < total) {
      const int j = (int)(t / (2 * nchunks));
      const int b0 = (int)(t % nchunks) * C;
      const int nb = min(C, B - b0);
      float* dst = ring + (size_t)(t % kStages) * C * rows;
      const float* src = A_t + ((size_t)j * B + b0) * m + i0;
      for (int p = tid; p < nb * per; p += blockDim.x) {
        const int b = p / per;
        const int i = (p - b * per) * V;
        cp_async<V>(dst + b * rows + i, src + (size_t)b * m + i);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < cnt; i += blockDim.x) r_s[i] = r_in[i0 + i];
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  long long t = 0;
  for (int j = 0; j < n_blocks; ++j) {
    // phase 1: partial g over this CTA's rows, one warp per coordinate
    for (int k = 0; k < nchunks; ++k, ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk t landed; slot of chunk t - 1 is free
      issue(t + kStages - 1);
      const float* tile = ring + (size_t)(t % kStages) * C * rows;
      const int b0 = k * C;
      const int nb = min(C, B - b0);
      for (int b = warp; b < nb; b += nwarps) {
        float s = 0.0f;
        for (int i = lane; i < cnt; i += 32) {
          s = fmaf(tile[b * rows + i], r_s[i], s);
        }
        s = warp_sum(s);
        if (lane == 0) partials[(size_t)c * B + b0 + b] = s;
      }
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
      const float xj = x_in[(size_t)j * B + b];
      v_s[b] = xj - tj * (__ldcg(gbuf + b) + lam2 * xj);
    }
    __syncthreads();
    if (kind == 2) {
      const int gpb = B / gsize;
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
      const float xj = x_in[k];
      const float v = v_s[b];
      float xn = kind == 2 ? v * sc_s[b / gsize] : prox(v, tj * lam1, kind);
      if (mask != nullptr && mask[k] == 0) xn = 0.0f;
      v_s[b] = xn - xj;
      if (c == 0) x_out[k] = xn;
    }

    // phase 2: r += A_t[j]^T dx over this CTA's rows, streamed again
    for (int k = 0; k < nchunks; ++k, ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // also orders the dx writes above before the reads
      issue(t + kStages - 1);
      const float* tile = ring + (size_t)(t % kStages) * C * rows;
      const int b0 = k * C;
      const int nb = min(C, B - b0);
      for (int i = tid; i < cnt; i += blockDim.x) {
        float acc = 0.0f;
        for (int b = 0; b < nb; ++b) {
          acc = fmaf(tile[b * rows + i], v_s[b0 + b], acc);
        }
        r_s[i] += acc;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < cnt; i += blockDim.x) r_out[i0 + i] = r_s[i];
}

size_t smem_bytes(int B, int rows, int C) {
  return sizeof(float) *
         ((size_t)kStages * C * rows + rows + 2 * (size_t)B);
}

void* kernel_for(int vec) {
  return vec == 4 ? (void*)tiled_sweep_kernel<4>
                  : (void*)tiled_sweep_kernel<1>;
}

}  // namespace

extern "C" {

// Launch plan of a tiled sweep at (B, m) with `vec` floats per copy (4 when
// m and A_t's address allow 16-byte copies, else 1): plan = {grid, rows,
// chunk}.  Returns a cudaError_t; plan[0] = 0 when even a one-coordinate
// ring does not fit in shared memory.
int cot_sweep_tiled_plan(int B, int m, int vec, int* plan) {
  plan[0] = plan[1] = plan[2] = 0;
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
  if (vec != 4) vec = 1;
  const int G0 = sms < m ? sms : m;
  int rows = (m + G0 - 1) / G0;
  rows = (rows + vec - 1) / vec * vec;
  const int G = (m + rows - 1) / rows;
  int C = kChunkBytes / (int)(sizeof(float) * rows);
  C = C < 1 ? 1 : (C > B ? B : C);
  const size_t smem = smem_bytes(B, rows, C);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaSuccess;
  void* fn = kernel_for(vec);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < G) return (int)cudaErrorCooperativeLaunchTooLarge;
  plan[0] = G;
  plan[1] = rows;
  plan[2] = C;
  return (int)cudaSuccess;
}

// One sweep.  x_out / r_out must not alias x_in / r_in; scratch holds
// (grid + 1) * B floats.  mask (n,) and w (n / gsize,) may be null.
int cot_sweep_tiled_t(const float* A_t, const float* x_in, const float* r_in,
                      const float* steps, const uint8_t* mask, const float* w,
                      float* x_out, float* r_out, float* scratch,
                      int n_blocks, int B, int m, int gsize, float lam1,
                      float lam2, int kind, int grid, int rows, int C,
                      int vec, cudaStream_t stream) {
  if (vec != 4) vec = 1;
  const size_t smem = smem_bytes(B, rows, C);
  void* fn = kernel_for(vec);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* partials = scratch;
  float* gbuf = scratch + (size_t)grid * B;
  void* args[] = {(void*)&A_t,   (void*)&x_in,     (void*)&r_in,
                  (void*)&steps, (void*)&mask,     (void*)&w,
                  (void*)&x_out, (void*)&r_out,    (void*)&partials,
                  (void*)&gbuf,  (void*)&n_blocks, (void*)&B,
                  (void*)&m,     (void*)&rows,     (void*)&C,
                  (void*)&gsize, (void*)&lam1,     (void*)&lam2,
                  (void*)&kind};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
