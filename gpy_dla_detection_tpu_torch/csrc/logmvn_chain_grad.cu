// K3's adjoint: the gradient of K3's per-sample log-likelihood
//   ll = -1/2 (misc0 - u^T A^-1 u + misc1 + log det A),  A = I + B,
// with respect to its inputs, times the incoming gradient g of each sample:
//   dll/du = g v,  dll/dmisc = -g/2 in both columns,
//   dll/dB(i, j) = -g/2 (v_i v_j + (A^-1)_ij), twice that for i != j (the
//   packed entry stands for both halves of the symmetric matrix),
// with v = A^-1 u.  B is K3's packed lower triangle (column-major: column c
// holds rows c..k-1 contiguously, entry (row, c) at off(c) + row - c), and
// dB comes back in the same layout.
//
// Replaces: no TPU kernel.  The JAX training (gpy_dla_detection_tpu/
// models/training.py:234-276) differentiates batched_quad_logdet
// (gpy_dla_detection_tpu/ops/logmvn.py:111), K3's function, by autodiff of
// the unrolled chain; the port's training runs K3 forward and this kernel
// backward (ops/logmvn_kernels.chain_loglik).
//
// Bound on the card: the bytes, B, u and g read and dB, du and dmisc
// written, (k(k+1) + 2k + 3) floats a sample (7.6 MB, 0.0023 ms at
// S = 4,096, k = 20).  The work, ~k^3 FMAs a sample (the factor, its
// inverse, A^-1 = W^T W), is serial within a sample, as K3's chain is.
//
// Design: K3's warp chain (logmvn_chain_warp.cuh), a warp a sample, the
// triangle in registers; lane a owns row a (and a + 32 at KMAX = 64):
//   1. stage the triangle as K3 does and factor it (k3::factor): L;
//   2. t = L^-1 u by forward substitution, t_j broadcast from lane j;
//   3. W = L^-1 in place, column by column: W_jc = (e_c - sum_{m<j} L_jm
//      W_mc) / L_jj, each W_jc broadcast from lane j by __shfl_sync; lane a
//      overwrites its entry (a, c) only after the last read of L_ac;
//   4. transpose W through the warp's shared buffer: lane i takes column i;
//   5. v = W^T t: t_m broadcast, each lane sums its column against it;
//   6. column j of A^-1 = W^T W e_j: column j broadcast from lane j entry by
//      entry, each lane i >= j dots its own column with it, and the lanes
//      store column j of dB (consecutive floats).
// About 2.5 k^2 shuffles a sample (1,000 at k = 20; K3's chain has 250).
//
// The wide kernel, for k beyond the warp chain's row bounds (k > 64), as
// K3's wide chain: a block of 128 threads a sample, the triangle in shared
// memory (or, past the block's shared bytes, a global workspace of the
// block's own); a right-looking factorization with t fused in (two
// barriers a step), v = L^-T t by warp 0, then each warp solves L y = e_j
// and L^T z = y for its columns j (j = warp, warp + 4, ...; warp-level
// reductions) and stores column j of dB.
//
// A pivot that is not positive makes L, and so every dB and du of the
// sample, NaN, as K3 gives the sample a NaN likelihood.
//
// Launch geometry: ops/logmvn_kernels.py (chain_grad_geometry) decides it;
// the launchers check only what the kernels' safety needs.

#include <cuda_runtime.h>

#include <cstdint>

#include "logmvn_chain_warp.cuh"

// Warps a block and blocks an SM (the launch bound) at row bounds 32 and 64,
// as ops/logmvn_kernels.py's CHAIN_GRAD_WARPS and CHAIN_GRAD_BLOCKS_PER_SM
// give them.
#ifndef K3G_GEOMETRY
#define K3G_GEOMETRY 8, 2, 8, 1
#endif

namespace {

using Geometry = k3::GeometryOf<K3G_GEOMETRY>;
constexpr unsigned kFull = 0xffffffffu;

// offset of column c's segment in the packed triangle of width k
__device__ __forceinline__ int col_off(int c, int k) { return c * k - c * (c - 1) / 2; }

template <int KMAX>
__global__ void __launch_bounds__(32 * Geometry::warps(KMAX), Geometry::blocks(KMAX))
logmvn_chain_grad_kernel(const float* __restrict__ B, const float* __restrict__ u,
                         const float* __restrict__ g, int S, int k, int buf,
                         float* __restrict__ dB, float* __restrict__ du,
                         float* __restrict__ dmisc) {
  constexpr int Q = KMAX / 32;  // rows a lane: slot q holds row q * 32 + lane
  constexpr int kWarps = Geometry::warps(KMAX);
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int a = threadIdx.x & 31;
  float* const T = reinterpret_cast<float*>(smem4) + warp * buf;
  const int kp = k * (k + 1) / 2;
  // warp w of the grid's T takes samples w S / T up to (w + 1) S / T
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  const int first = (int)(w * S / nwarps);
  const int last = (int)((w + 1) * S / nwarps);

  for (int s = first; s < last; ++s) {
    // 1. stage the triangle as K3 does (dst and src equal modulo 16 bytes)
    const float* src = B + (size_t)s * kp;
    const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    float* const dst = T + shift;
    const int head = min(kp, (4 - shift) & 3);
    const int nv = (kp - head) >> 2;
    const int tail = head + 4 * nv;
    if (a < head) dst[a] = __ldg(src + a);
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    float4* dst4 = reinterpret_cast<float4*>(dst + head);
    for (int v = a; v < nv; v += 32) dst4[v] = __ldg(src4 + v);
    if (tail + a < kp) dst[tail + a] = __ldg(src + tail + a);

    float uq[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int row = q * 32 + a;
      uq[q] = row < k ? __ldg(u + (size_t)s * k + row) : 0.0f;
    }
    const float gs = __ldg(g + s);
    __syncwarp();

    float r[Q][KMAX];
    k3::load_rows<KMAX>(dst, k, r);
    __syncwarp();  // the buffer is free
    {
      float scratch[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) scratch[q] = 0.0f;
      float quad, logdet;  // K3's outputs, not needed here
      k3::factor<KMAX, false>(r, scratch, k, quad, logdet);
    }

    // the reciprocal of each lane's own diagonal entry L_aa
    float di[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) di[q] = 1.0f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k && a == j % 32) di[j / 32] = r[j / 32][j];
#pragma unroll
    for (int q = 0; q < Q; ++q) di[q] = 1.0f / di[q];

    // 2. t = L^-1 u; lane j keeps t_j
    float tq[Q];
    {
      float acc[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        acc[q] = uq[q];
        tq[q] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) {
          const int qj = j / 32, lj = j % 32;
          const float x = __shfl_sync(kFull, acc[qj] * di[qj], lj);
          if (a == lj) tq[qj] = x;
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (j < (q + 1) * 32) acc[q] -= r[q][j] * x;
        }
      }
    }

    // 3. W = L^-1 in place: column c, rows j = c..k-1 in order; rows below
    // j keep L_aj until step j of the column has read it
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < k) {
        float acc[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[q] = q * 32 + a == c ? 1.0f : 0.0f;
#pragma unroll
        for (int j = c; j < KMAX; ++j) {
          if (j < k) {
            const int qj = j / 32, lj = j % 32;
            const float x = __shfl_sync(kFull, acc[qj] * di[qj], lj);  // W_jc
            if (a == lj) r[qj][c] = x;
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (j < (q + 1) * 32) acc[q] -= r[q][j] * x;
          }
        }
      }
    }

    // 4. W's rows into the buffer (packed, column-major), its columns back:
    // lane i's slot q holds column i = q * 32 + a, W_mi at r[q][m] (0 for
    // m < i and past k - 1)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int row = q * 32 + a;
#pragma unroll
      for (int c = 0; c < (q + 1) * 32; ++c)
        if (c < k && c <= row && row < k) T[col_off(c, k) + row - c] = r[q][c];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = q * 32 + a;
      const float* colp = T + (i < k ? col_off(i, k) - i : 0);  // entry (m, i) at colp[m]
#pragma unroll
      for (int m = 0; m < KMAX; ++m) r[q][m] = i < k && m >= i && m < k ? colp[m] : 0.0f;
    }
    __syncwarp();  // the buffer is free for the next sample

    // 5. v = W^T t; lane i keeps v_i
    float v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = 0.0f;
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      if (m < k) {
        const float tm = __shfl_sync(kFull, tq[m / 32], m % 32);
#pragma unroll
        for (int q = 0; q < Q; ++q) v[q] += r[q][m] * tm;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = q * 32 + a;
      if (i < k) du[(size_t)s * k + i] = gs * v[q];
    }
    if (a == 0) {
      dmisc[2 * (size_t)s] = -0.5f * gs;
      dmisc[2 * (size_t)s + 1] = -0.5f * gs;
    }

    // 6. column j of A^-1 = W^T (W e_j): lane i >= j dots its column with
    // column j, broadcast from lane j entry by entry
    float* const out = dB + (size_t)s * kp;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const int qj = j / 32, lj = j % 32;
        float dot[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) dot[q] = 0.0f;
#pragma unroll
        for (int m = j; m < KMAX; ++m) {
          if (m < k) {
            const float wmj = __shfl_sync(kFull, r[qj][m], lj);
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (j < (q + 1) * 32) dot[q] += r[q][m] * wmj;
          }
        }
        const float vj = __shfl_sync(kFull, v[qj], lj);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int i = q * 32 + a;
          if (j < (q + 1) * 32 && i >= j && i < k)
            out[col_off(j, k) + i - j] =
                -0.5f * gs * (v[q] * vj + dot[q]) * (i == j ? 1.0f : 2.0f);
        }
      }
    }
  }
}

template <int KMAX>
int launch(const float* B, const float* u, const float* g, int S, int k, int buf, int smem,
           int grid, float* dB, float* du, float* dmisc, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_chain_grad_kernel<KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  logmvn_chain_grad_kernel<KMAX><<<grid, 32 * Geometry::warps(KMAX), smem, stream>>>(
      B, u, g, S, k, buf, dB, du, dmisc);
  return (int)cudaGetLastError();
}

constexpr int kWideThreads = 128;
constexpr int kWideWarps = kWideThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// kGlobal: the triangle, t, v and the warps' columns live in work (the
// block's kp + (2 + kWideWarps) k floats) instead of shared memory
template <bool kGlobal>
__global__ void __launch_bounds__(kWideThreads) logmvn_chain_grad_wide_kernel(
    const float* __restrict__ B, const float* __restrict__ u, const float* __restrict__ g,
    int S, int k, float* __restrict__ work, float* __restrict__ dB, float* __restrict__ du,
    float* __restrict__ dmisc) {
  extern __shared__ float4 smem4[];
  const int kp = k * (k + 1) / 2;
  float* T = reinterpret_cast<float*>(smem4);
  if constexpr (kGlobal) T = work + (size_t)blockIdx.x * (kp + (2 + kWideWarps) * k);
  float* const tt = T + kp;  // u, then t
  float* const vv = tt + k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* const x = vv + k + warp * k;  // the warp's column

  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    const float gs = __ldg(g + s);
    const float* src = B + (size_t)s * kp;
    for (int e = tid; e < kp; e += kWideThreads) T[e] = __ldg(src + e);
    for (int a = tid; a < k; a += kWideThreads) tt[a] = __ldg(u + (size_t)s * k + a);
    __syncthreads();
    for (int c = tid; c < k; c += kWideThreads) T[col_off(c, k)] += 1.0f;  // + I
    __syncthreads();

    // L in place, right-looking, and t = L^-1 u
    for (int j = 0; j < k; ++j) {
      float* const cj = T + col_off(j, k) - j;  // entry (a, j) at cj[a]
      const float inv = rsqrtf(cj[j]);
      const float t = tt[j] * inv;
      __syncthreads();  // every thread has read the pivot and u_j
      if (tid == 0) tt[j] = t;
      for (int a = j + 1 + tid; a < k; a += kWideThreads) tt[a] -= t * (cj[a] * inv);
      for (int c = j + 1 + warp; c < k; c += kWideWarps) {
        const float lc = cj[c] * inv;
        float* col = T + col_off(c, k) - c;
        for (int a = c + lane; a < k; a += 32) col[a] -= (cj[a] * inv) * lc;
      }
      __syncthreads();  // the trailing update has read column j unscaled
      for (int a = j + tid; a < k; a += kWideThreads) cj[a] *= inv;
    }
    __syncthreads();

    // v = L^-T t, by warp 0
    if (warp == 0) {
      for (int a = lane; a < k; a += 32) vv[a] = tt[a];
      __syncwarp();
      for (int m = k - 1; m >= 0; --m) {
        const float* cm = T + col_off(m, k) - m;
        float part = 0.0f;
        for (int a = m + 1 + lane; a < k; a += 32) part += cm[a] * vv[a];
        const float xm = (vv[m] - warp_sum(part)) / cm[m];
        __syncwarp();
        if (lane == 0) vv[m] = xm;
        __syncwarp();
      }
    }
    __syncthreads();
    for (int a = tid; a < k; a += kWideThreads) du[(size_t)s * k + a] = gs * vv[a];
    if (tid == 0) {
      dmisc[2 * (size_t)s] = -0.5f * gs;
      dmisc[2 * (size_t)s + 1] = -0.5f * gs;
    }

    // column j of A^-1, rows j..k-1: L y = e_j, then L^T z = y in place
    for (int j = warp; j < k; j += kWideWarps) {
      for (int a = j + lane; a < k; a += 32) x[a] = a == j ? 1.0f : 0.0f;
      __syncwarp();
      for (int m = j; m < k; ++m) {
        const float* cm = T + col_off(m, k) - m;
        const float ym = x[m] / cm[m];
        __syncwarp();
        if (lane == 0) x[m] = ym;
        for (int a = m + 1 + lane; a < k; a += 32) x[a] -= cm[a] * ym;
        __syncwarp();
      }
      for (int m = k - 1; m >= j; --m) {
        const float* cm = T + col_off(m, k) - m;
        float part = 0.0f;
        for (int a = m + 1 + lane; a < k; a += 32) part += cm[a] * x[a];
        const float zm = (x[m] - warp_sum(part)) / cm[m];
        __syncwarp();
        if (lane == 0) x[m] = zm;
        __syncwarp();
      }
      const float vj = vv[j];
      float* const out = dB + (size_t)s * kp + col_off(j, k) - j;
      for (int a = j + lane; a < k; a += 32)
        out[a] = -0.5f * gs * (vv[a] * vj + x[a]) * (a == j ? 1.0f : 2.0f);
      __syncwarp();
    }
    __syncthreads();  // before the next sample is staged
  }
}

}  // namespace

// The wide kernel's launch (chain_grad_geometry past the row bounds): 128
// threads, the grid, and either shared bytes for the triangle, t, v and a
// column a warp (work null) or a workspace of grid x (k(k+1)/2 + 6k) floats
// (no shared bytes).  Refused: any other block, an empty grid, shared bytes
// short of the block's floats, both or neither of the two homes.
extern "C" int logmvn_chain_grad_wide_launch(const float* B, const float* u, const float* g,
                                             int S, int k, int threads, int smem, int grid,
                                             float* work, float* dB, float* du, float* dmisc,
                                             void* stream) {
  const long long need = 4LL * (k * (long long)(k + 1) / 2 + (2 + kWideWarps) * (long long)k);
  if (S < 1 || k < 1 || threads != kWideThreads || grid < 1 || smem < 0 ||
      smem > 227 * 1024 || (work == nullptr) == (smem == 0) ||
      (work == nullptr && smem < need))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (work != nullptr) {
    logmvn_chain_grad_wide_kernel<true><<<grid, kWideThreads, 0, st>>>(B, u, g, S, k, work, dB,
                                                                       du, dmisc);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_chain_grad_wide_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  logmvn_chain_grad_wide_kernel<false><<<grid, kWideThreads, smem, st>>>(B, u, g, S, k, nullptr,
                                                                         dB, du, dmisc);
  return (int)cudaGetLastError();
}

// The geometry (row bound, warps a block, shared bytes, grid) comes from
// chain_grad_geometry.  Refused: a row bound that is not compiled or is
// below k, a block of other than the compiled warps, a warp's share of
// shared memory short of its triangle, the 3 floats of alignment and the
// KMAX of padding the rows past k - 1 read, and an empty grid.
extern "C" int logmvn_chain_grad_launch(const float* B, const float* u, const float* g, int S,
                                        int k, int rows, int warps, int smem, int grid,
                                        float* dB, float* du, float* dmisc, void* stream) {
  if (S < 1 || k < 1 || k > rows || (rows != 32 && rows != 64) ||
      warps != Geometry::warps(rows) || grid < 1 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int buf = (smem / (4 * warps)) & ~3;  // floats, in whole float4s
  if (buf < k * (k + 1) / 2 + 3 + rows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 32) return launch<32>(B, u, g, S, k, buf, smem, grid, dB, du, dmisc, st);
  return launch<64>(B, u, g, S, k, buf, smem, grid, dB, du, dmisc, st);
}
