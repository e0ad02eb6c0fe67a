// K3: stage B of the batched Woodbury log-likelihood (factorization chain).
//
// Replaces: gpy_dla_detection_tpu/ops/logmvn_pallas.py :
// _make_chain_kernel_tp2c, the second pallas_call of
// batched_log_mvnpdf_pallas (packed rank-2 steps, the default for even k),
// and _make_chain_kernel_tp, its rank-1 form for odd k (the same function).
//
// Per sample: the Cholesky factor of I + B, with B the packed lower
// triangle (column-major: column j holds rows j..k-1 contiguously) that K2
// wrote, and the forward substitution of u fused in:
//   quad = sum_j t_j^2,  logdet = sum_j log d_j,
//   ll = -1/2 (quad0 - quad + logdet0 + logdet).
//
// Bound on the card: the bytes, (k(k+1)/2 + k + 3) floats a sample (9.3 MB,
// 0.0028 ms at S = 10,000, k = 20).  The work, ~k^3/6 FMAs a sample, is one
// serial chain per sample, so the design runs many chains at once and keeps
// shared memory off each chain's critical path.
//
// Design: a warp per sample, the triangle in registers: the warp chain of
// logmvn_chain_warp.cuh (lane a owns row a; left-looking steps broadcast
// by __shfl_sync; one logf a lane), which K7's kernels share.  k(k-1)/2 +
// 3k shuffles a sample (250 at k = 20), no shared memory in the chain.
//
// Loads: a warp stages its sample's packed triangle in its own shared
// buffer with 16-byte loads and stores, the buffer placed at the source's
// offset modulo 16 bytes; a lane then reads its row column by column, the
// lanes on consecutive floats (no bank conflicts).  u and misc are read
// straight from global memory.
//
// Launch geometry: ops/logmvn_kernels.py (chain_geometry) decides it; the
// launcher checks only what the kernel's safety needs.  At S = 10,000,
// k = 20: KMAX = 32, 8 warps a block, 4 blocks on each of 132 SMs (528
// blocks, 32 warps an SM, one wave), 2 or 3 samples a warp, 7,936 shared
// bytes a block.  ptxas (sm_90a): 64 and 128 registers a thread at KMAX =
// 32 and 64 (the launch bounds' limits), 20 and 28 bytes of spills.  The
// chain is latency-bound: more warps an SM beat fewer registers
// (ops/chain_geometry_sweep.py; PERF.md, PR 7).
//
// The wide chain, for k beyond the warp chain's row bounds (k > 64): a
// warp a sample too, several samples in flight on every SM and no block
// barrier.  The warp stages its sample's triangle with 16-byte copies into
// a buffer of its own (as the warp chain does), u beside it, and factors it
// there left-looking, one column a step: lanes on consecutive rows a = j +
// lane + 32 q (up to 4 slots q a pass, passes of 128 rows; a pass compiled
// for its number of live slots, so it loads nothing for a slot past the
// triangle: the chain is bound by its shared-memory loads), each entry (a,
// j) = B_aj + I_aj - sum_{c<j} l_ac l_jc with c ascending (the FMAs, in
// the order, of the right-looking twin), l_jc a broadcast read of the
// warp's buffer and l_ac a read of consecutive floats.  The pivot d_j is
// row j's entry, broadcast by a shuffle; the column is scaled by rsqrt(d_j)
// and stored, t_j = u_j rsqrt(d_j), quad += t_j^2, logdet += log d_j, and
// u_a -= t_j l_aj; a __syncwarp ends the step.  A buffer holds the
// triangle, 3 floats of alignment, 32 of padding (a pass's lanes past the
// last row read into it) and u: k <= 339 fits a block's shared memory.
// Past that the triangle lives in a global workspace and a block of 128
// threads takes a sample, right-looking with one barrier a step (step j:
// the pivot, t_j, column j scaled on the fly, u_a -= t_j l_aj and the
// trailing entries updated, a warp a column).  Geometry:
// wide_chain_geometry.

#include <cuda_runtime.h>

#include <cstdint>

#include "logmvn_chain_warp.cuh"

// Warps a block and blocks an SM (the launch bound, which caps a thread's
// registers) at row bounds 32 and 64, as ops/logmvn_kernels.py's
// CHAIN_WARPS and CHAIN_BLOCKS_PER_SM give them.  ops/chain_geometry_sweep.py
// rebuilds this file with other values.
#ifndef K3_GEOMETRY
#define K3_GEOMETRY 8, 4, 8, 2
#endif

namespace {

using Geometry = k3::GeometryOf<K3_GEOMETRY>;

template <int KMAX>
__global__ void __launch_bounds__(32 * Geometry::warps(KMAX), Geometry::blocks(KMAX))
logmvn_chain_kernel(const float* __restrict__ B, const float* __restrict__ u,
                    const float* __restrict__ misc, int S, int k, int buf,
                    float* __restrict__ ll) {
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
    // stage the triangle: dst[e] = src[e], dst and src equal modulo 16
    // bytes, so the body moves as float4
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
    float m0 = 0.0f, m1 = 0.0f;
    if (a == 0) {
      m0 = __ldg(misc + 2 * (size_t)s);
      m1 = __ldg(misc + 2 * (size_t)s + 1);
    }
    __syncwarp();

    float r[Q][KMAX];
    k3::load_rows<KMAX>(dst, k, r);
    __syncwarp();  // the buffer is free for the next sample
    float quad, logdet;
    k3::factor<KMAX, false>(r, uq, k, quad, logdet);
    if (a == 0) ll[s] = -0.5f * (m0 - quad + m1 + logdet);
  }
}

template <int KMAX>
int launch(const float* B, const float* u, const float* misc, int S, int k, int buf,
           int smem, int grid, float* ll, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_chain_kernel<KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  logmvn_chain_kernel<KMAX><<<grid, 32 * Geometry::warps(KMAX), smem, stream>>>(
      B, u, misc, S, k, buf, ll);
  return (int)cudaGetLastError();
}

constexpr int kWideThreads = 128;  // the global-workspace chain's block
constexpr int kWideWarps = 8;      // the warp chain's widest block
constexpr int kWidePad = 32;       // floats past the triangle a pass reads

// floats of a wide warp's buffer: the triangle at its source's offset
// modulo 16 bytes, the padding, then u (float4-aligned)
__host__ __device__ inline int wide_tri_floats(int k) {
  return 4 * ((k * (k + 1) / 2 + 3 + kWidePad + 3) / 4);
}
__host__ __device__ inline int wide_warp_floats(int k) {
  return wide_tri_floats(k) + 4 * ((k + 3) / 4);
}

// One pass of step j of the wide warp chain over rows r0 + lane + 32 q, q <
// NQ (all of them rows of the triangle but for lanes past k - 1 in the last
// slot, which read the padding): the dot products of column j, and at the
// pass that holds row j the pivot, t_j and logdet's and quad's terms;
// column j scaled and stored, u updated.  NQ is the pass's live slots, so
// no load is issued for a slot past the triangle.
template <int NQ>
__device__ __forceinline__ void wide_pass(float* T, float* uu, int k, int j, int r0, int offj,
                                          int lane, float& d, float& inv, float& t) {
  float* const colj = T + offj - j;  // entry (a, j) at colj[a]
  float x[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int a = r0 + 32 * q + lane;
    x[q] = colj[a] + (a == j ? 1.0f : 0.0f);  // + I, before the updates
  }
  const float* colc = T + r0 + lane;  // entry (r0 + lane, c), from c = 0
  const float* rowj = T + j;          // entry (j, c)
#pragma unroll 4
  for (int c = 0; c < j; ++c) {
    const float l = *rowj;
#pragma unroll
    for (int q = 0; q < NQ; ++q) x[q] -= colc[32 * q] * l;
    colc += k - 1 - c;
    rowj += k - 1 - c;
  }
  if (r0 == j) {
    d = __shfl_sync(0xffffffffu, x[0], 0);
    inv = rsqrtf(d);
    t = uu[j] * inv;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int a = r0 + 32 * q + lane;
    if (a < k) {
      const float l = x[q] * inv;
      colj[a] = l;
      if (a > j) uu[a] -= t * l;
    }
  }
}

__global__ void __launch_bounds__(32 * kWideWarps) logmvn_chain_wide_warp_kernel(
    const float* __restrict__ B, const float* __restrict__ u,
    const float* __restrict__ misc, int S, int k, int buf, float* __restrict__ ll) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* const Tb = reinterpret_cast<float*>(smem4) + warp * buf;
  float* const uu = Tb + wide_tri_floats(k);
  const int kp = k * (k + 1) / 2;
  const long long nwarps = (long long)gridDim.x * nw;
  const long long w = (long long)blockIdx.x * nw + warp;
  const int first = (int)(w * S / nwarps);
  const int last = (int)((w + 1) * S / nwarps);

  for (int s = first; s < last; ++s) {
    const float* src = B + (size_t)s * kp;
    const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    float* const T = Tb + shift;
    const int head = min(kp, (4 - shift) & 3);
    const int nv = (kp - head) >> 2;
    const int tail = head + 4 * nv;
    if (lane < head) T[lane] = __ldg(src + lane);
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    float4* dst4 = reinterpret_cast<float4*>(T + head);
    for (int v = lane; v < nv; v += 32) dst4[v] = __ldg(src4 + v);
    if (tail + lane < kp) T[tail + lane] = __ldg(src + tail + lane);
    for (int a = lane; a < k; a += 32) uu[a] = __ldg(u + (size_t)s * k + a);
    __syncwarp();

    float quad = 0.0f, logdet = 0.0f;
    int offj = 0;  // column j's first entry, (j, j)
    for (int j = 0; j < k; ++j) {
      float d = 0.0f, inv = 0.0f, t = 0.0f;
      for (int r0 = j; r0 < k; r0 += 128) {
        switch ((min(k - r0, 128) + 31) / 32) {  // the pass's live slots
          case 1: wide_pass<1>(T, uu, k, j, r0, offj, lane, d, inv, t); break;
          case 2: wide_pass<2>(T, uu, k, j, r0, offj, lane, d, inv, t); break;
          case 3: wide_pass<3>(T, uu, k, j, r0, offj, lane, d, inv, t); break;
          default: wide_pass<4>(T, uu, k, j, r0, offj, lane, d, inv, t);
        }
      }
      quad += t * t;
      logdet += logf(d);
      offj += k - j;
      __syncwarp();
    }
    if (lane == 0)
      ll[s] = -0.5f * (__ldg(misc + 2 * (size_t)s) - quad + __ldg(misc + 2 * (size_t)s + 1) +
                       logdet);
    __syncwarp();  // the buffer is free for the next sample
  }
}

// the triangle and u in work (the block's kp + k floats), a block a sample
__global__ void __launch_bounds__(kWideThreads) logmvn_chain_wide_kernel(
    const float* __restrict__ B, const float* __restrict__ u,
    const float* __restrict__ misc, int S, int k, float* __restrict__ work,
    float* __restrict__ ll) {
  const int kp = k * (k + 1) / 2;
  float* const T = work + (size_t)blockIdx.x * (kp + k);
  float* const uu = T + kp;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kWideThreads / 32;

  for (int s = blockIdx.x; s < S; s += gridDim.x) {
    const float* src = B + (size_t)s * kp;
    for (int e = tid; e < kp; e += kWideThreads) T[e] = __ldg(src + e);
    for (int a = tid; a < k; a += kWideThreads) uu[a] = __ldg(u + (size_t)s * k + a);
    __syncthreads();
    for (int c = tid; c < k; c += kWideThreads) T[c * k - c * (c - 1) / 2] += 1.0f;  // + I
    __syncthreads();
    float quad = 0.0f, logdet = 0.0f;  // thread 0's
    for (int j = 0; j < k; ++j) {
      const float* cj = T + j * k - j * (j - 1) / 2 - j;  // entry (a, j) at cj[a]
      const float d = cj[j];
      const float inv = rsqrtf(d);
      const float t = uu[j] * inv;
      if (tid == 0) {
        logdet += logf(d);
        quad += t * t;
      }
      for (int a = j + 1 + tid; a < k; a += kWideThreads) uu[a] -= t * (cj[a] * inv);
      for (int c = j + 1 + warp; c < k; c += kWarps) {
        const float lc = cj[c] * inv;
        float* col = T + c * k - c * (c - 1) / 2 - c;
        for (int a = c + lane; a < k; a += 32) col[a] -= (cj[a] * inv) * lc;
      }
      __syncthreads();
    }
    if (tid == 0)
      ll[s] = -0.5f * (__ldg(misc + 2 * (size_t)s) - quad + __ldg(misc + 2 * (size_t)s + 1) +
                       logdet);
  }
}

}  // namespace

// The wide chain's launch (wide_chain_geometry), either a warp a sample:
// 32 to 32 kWideWarps threads, shared bytes of a wide_warp_floats buffer for
// each warp (a whole number of float4s a warp), no workspace; or a block a
// sample: kWideThreads threads, no shared bytes, a workspace of grid x
// (k(k+1)/2 + k) floats.  Anything else is refused, as is an empty grid.
extern "C" int logmvn_chain_wide_launch(const float* B, const float* u, const float* misc,
                                        int S, int k, int threads, int smem, int grid,
                                        float* work, float* ll, void* stream) {
  if (S < 1 || k < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (work != nullptr) {
    if (threads != kWideThreads || smem != 0) return (int)cudaErrorInvalidValue;
    logmvn_chain_wide_kernel<<<grid, kWideThreads, 0, st>>>(B, u, misc, S, k, work, ll);
    return (int)cudaGetLastError();
  }
  const int warps = threads / 32;
  if (threads % 32 != 0 || warps < 1 || warps > kWideWarps || smem > 227 * 1024 ||
      smem % (16 * warps) != 0 || smem / (4 * warps) < wide_warp_floats(k))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_chain_wide_warp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  logmvn_chain_wide_warp_kernel<<<grid, threads, smem, st>>>(B, u, misc, S, k,
                                                            smem / (4 * warps), ll);
  return (int)cudaGetLastError();
}

// The geometry (row bound, warps a block, shared bytes, grid) comes from
// chain_geometry.  Refused: a row bound that is not compiled or is below k,
// a block of other than the compiled warps, a warp's share of shared
// memory short of its triangle, the 3 floats of alignment and the KMAX of
// padding the rows past k - 1 read, and an empty grid.
extern "C" int logmvn_chain_launch(const float* B, const float* u,
                                   const float* misc, int S, int k, int rows,
                                   int warps, int smem, int grid,
                                   float* ll, void* stream) {
  if (S < 1 || k < 1 || k > rows || (rows != 32 && rows != 64) ||
      warps != Geometry::warps(rows) || grid < 1 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int buf = (smem / (4 * warps)) & ~3;  // floats, in whole float4s
  if (buf < k * (k + 1) / 2 + 3 + rows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 32) return launch<32>(B, u, misc, S, k, buf, smem, grid, ll, st);
  return launch<64>(B, u, misc, S, k, buf, smem, grid, ll, st);
}
