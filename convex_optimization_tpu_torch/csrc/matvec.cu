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
// 4 GB at 10k x 100k: 1.2 ms at 3.35 TB/s) with 2 flops per 4 bytes, so
// they are bandwidth-bound; the designs keep every read coalesced and give
// the card enough independent CTAs to keep loads in flight.  K4 runs once
// per solve; its 49 passes over each 3.2 MB block do not fit L2 when 132
// blocks run at once, so it re-reads A from HBM each iteration (~100
// passes over A in all) — set-up work, recorded rather than tuned.
//
// No kernel uses atomics: every sum is in a fixed order, so results are
// reproducible run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------- K2 ----
// Threads own rows i, so a warp's reads of A2[k, i..i+31] are one
// coalesced 128-byte line.  One thread per row gives only m threads
// (10k), too few to fill the card, so the n columns are split into S
// slices (grid.y) that write partial sums (S, m); a second pass adds the
// slices in slice order and subtracts b.
constexpr int kAxThreads = 256;

__global__ void __launch_bounds__(kAxThreads)
ax_partial_kernel(const float* __restrict__ A2, const float* __restrict__ x,
                  float* __restrict__ partials, int n, int m, int per_slice) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int k0 = s * per_slice;
  const int k1 = min(n, k0 + per_slice);
  if (i >= m) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = k0; k < k1; ++k) {
    acc = fmaf(A2[(size_t)k * m + i], __ldg(x + k), acc);
  }
  partials[(size_t)s * m + i] = acc;
}

__global__ void __launch_bounds__(kAxThreads)
ax_finish_kernel(const float* __restrict__ partials,
                 const float* __restrict__ b, float* __restrict__ r, int S,
                 int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += partials[(size_t)s * m + i];
  r[i] = acc - b[i];
}

// ---------------------------------------------------------------- K3 ----
// One CTA of 256 threads per output coordinate k: a dot over the
// contiguous row A2[k, :] of length m.  Thread t reads elements
// t, t + 256, ... (coalesced), in GROUPS of 8 consecutive reads whose
// products are summed as a pairwise tree; the group sums are chained;
// then a shuffle tree over the warp and a tree over the 8 warps.
//
// REDUCTION DEPTH (the f64 polish's certificate margin depends on it):
// with k_g = ceil(m / 2048) groups per thread, every product passes
// through at most
//     D(m) = 1 (product) + 3 (group tree) + (k_g - 1) (chain)
//            + 5 (warp tree) + 3 (CTA tree) = ceil(m / 2048) + 11
// roundings, so |z32 - A^T r| <= gamma_D ||A_k|| ||r|| with
// gamma_D = D u / (1 - D u), u = 2^-24 (fused multiply-adds only remove
// roundings).  At m = 10000, D = 16; the polish margin
// gamma = (ceil(log2 m) + 4) eps = 36 u covers it
// (ops/matvec.py: k3_depth, witness_gamma).
constexpr int kAtrThreads = 256;
constexpr int kAtrGroup = 8;
constexpr int kAtrWarps = kAtrThreads / 32;

__global__ void __launch_bounds__(kAtrThreads)
neg_at_r_kernel(const float* __restrict__ A2, const float* __restrict__ r,
                const float* __restrict__ x, float* __restrict__ z, int m,
                float lam2) {
  __shared__ float ws[kAtrWarps];
  const int k = blockIdx.x;
  const float* a = A2 + (size_t)k * m;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float chain = 0.0f;
  for (int base = tid; base < m; base += kAtrThreads * kAtrGroup) {
    float p[kAtrGroup];
#pragma unroll
    for (int q = 0; q < kAtrGroup; ++q) {
      const int i = base + q * kAtrThreads;
      p[q] = i < m ? __ldg(a + i) * __ldg(r + i) : 0.0f;
    }
    chain += ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
  }
  for (int off = 16; off > 0; off >>= 1) {
    chain += __shfl_xor_sync(0xffffffffu, chain, off);
  }
  if (lane == 0) ws[warp] = chain;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kAtrWarps ? ws[lane] : 0.0f;
    for (int off = kAtrWarps / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) z[k] = -v - lam2 * x[k];
  }
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

}  // namespace

extern "C" {

const char* cot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// r = A x - b.  partials holds S * m floats.
int cot_ax_minus_b_t(const float* A2, const float* x, const float* b,
                     float* r, float* partials, int n, int m, int S,
                     cudaStream_t stream) {
  const int per_slice = (n + S - 1) / S;
  const int tiles = (m + kAxThreads - 1) / kAxThreads;
  ax_partial_kernel<<<dim3(tiles, S), kAxThreads, 0, stream>>>(
      A2, x, partials, n, m, per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ax_finish_kernel<<<tiles, kAxThreads, 0, stream>>>(partials, b, r, S, m);
  return (int)cudaGetLastError();
}

// z = -A^T r - lam2 x.
int cot_neg_at_r_t(const float* A2, const float* r, const float* x, float* z,
                   int n, int m, float lam2, cudaStream_t stream) {
  neg_at_r_kernel<<<n, kAtrThreads, 0, stream>>>(A2, r, x, z, m, lam2);
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
