// K2: stage A of the batched Woodbury log-likelihood (capacitance products).
//
// Replaces: gpy_dla_detection_tpu/ops/logmvn_pallas.py : _make_cap_kernel
// (body _assemble), the first pallas_call of batched_log_mvnpdf_pallas.
//
// Per sample s, over the N pixels:
//   a     = A[s] * prod(extra streams)        (masked pixels: a = 1)
//   d     = omega2 a^2 + v,  d_inv = mask / d (guarded: masked -> 0)
//   delta = mask ? y - mu a : 0
//   w = a^2 d_inv,   r = a delta d_inv
// Outputs  B[s, :] = w @ M_pair   (k(k+1)/2 packed lower-triangle columns,
// or the flat k^2 basis; without the +I),  u[s, :] = r @ M,  misc[s] =
// (sum delta^2 d_inv, -sum log d_inv + n log 2 pi).
//
// Bound on the card: the (S x N) . (N x (k(k+1)/2 + k)) product, 2 S N 230
// ~ 5.9 GFLOP per call at S = 10,000, N = 1,280, k = 20, in IEEE float32
// FMA (no TF32: it keeps ~10 mantissa bits, and the per-sample ll
// tolerance does not survive that).
//
// Design: K2's block, logmvn_cap_block.cuh (8 x 8 register tiles, warps of
// 2 x 16 tiles, cp.async double buffering, the assembly one chunk ahead of
// the FMAs; int16 codes decoded in the assembly), which K7's stage kernel
// shares.  The epilogue here stores misc (by the assembly's lanes) and each
// thread's 8 x 8 tile of B | u.  A basis wider than one block holds runs on
// K2's wide kernel, logmvn_cap_wide.cu (ops/logmvn_kernels.py: k2_geometry).

#include <cuda_runtime.h>

#include <cstdint>

#include "logmvn_cap_block.cuh"

namespace {

using namespace cap_block;

struct CapOut {
  float* B;
  float* u;
  float* misc;
  static constexpr bool kProducts = true;
  static constexpr bool kLogDet = true;
  static constexpr bool kSumWR = false;

  __device__ __forceinline__ void finish(const Block& b, const float (&acc)[kTile][kTile],
                                         const double (&q_acc)[kMaxQuads],
                                         const double (&ld_acc)[kMaxQuads],
                                         const double (&)[kMaxQuads]) const {
    if (b.nl_lo == 0) {
#pragma unroll
      for (int qi = 0; qi < kMaxQuads; ++qi) {
        const int quad = b.warp + qi * b.nwarps;
        const int s = b.s0 + 4 * quad + b.sl_lo;
        if (quad < b.n_quads && s < b.S) {
          misc[2 * (size_t)s] = (float)q_acc[qi];
          misc[2 * (size_t)s + 1] = (float)(-ld_acc[qi]) + (float)b.n_valid * kLog2Pi;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int s = b.s0 + b.sg * kTile + i;
      if (s >= b.S) continue;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int c = b.cg * kTile + j;
        if (b.cg < b.gp) {
          if (c < b.kp) B[(size_t)s * b.kp + c] = acc[i][j];
        } else {
          const int jj = c - b.gp * kTile;  // >= k on the padding groups
          if (jj < b.k) u[(size_t)s * b.k + jj] = acc[i][j];
        }
      }
    }
  }
};

// T: the sample streams' storage (float, or int16_t codes); VB: the bytes
// of a staging copy (cap_block::run)
template <int TN, int VB, typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) logmvn_cap_kernel(
    const float* __restrict__ rows, int N, const float* __restrict__ M, int k,
    const float* __restrict__ Mp, int kp, const T* __restrict__ A,
    const T* __restrict__ e0, const T* __restrict__ e1,
    const T* __restrict__ e2, int n_extra, int S, int TS,
    float* __restrict__ B, float* __restrict__ u, float* __restrict__ misc) {
  run<TN, VB, T>(rows, N, M, k, Mp, kp, A, e0, e1, e2, n_extra, S, TS, CapOut{B, u, misc});
}

template <int TN>
void* pick_kernel(int store, int vb) {
  if (store == 0)
    return vb == 16 ? reinterpret_cast<void*>(logmvn_cap_kernel<TN, 16, float>)
                    : reinterpret_cast<void*>(logmvn_cap_kernel<TN, 4, float>);
  return vb == 16  ? reinterpret_cast<void*>(logmvn_cap_kernel<TN, 16, int16_t>)
         : vb == 4 ? reinterpret_cast<void*>(logmvn_cap_kernel<TN, 4, int16_t>)
                   : reinterpret_cast<void*>(logmvn_cap_kernel<TN, 0, int16_t>);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// store: A and the streams as float32 (0) or int16 codes (1).  The
// geometry (ts samples a block, tn pixels a chunk, threads, shared bytes,
// grid) comes from the caller and must be the one cap_geometry gives for
// (S, N, k, kp, n_extra) and the store's element size; anything else is
// refused, as is a float32 stream not 4-byte aligned.
extern "C" int logmvn_cap_launch(
    const float* rows, int N, const float* M, int k, const float* Mp, int kp,
    const void* A, const void* e0, const void* e1, const void* e2,
    int n_extra, int store, int S, int ts, int tn, int threads, int smem, int grid,
    float* B, float* u, float* misc, void* stream) {
  if (k < 1 || kp < 1 || N < 1 || S < 1 || n_extra < 0 || n_extra > 3 ||
      (store != 0 && store != 1))
    return (int)cudaErrorInvalidValue;
  const int elem = store ? 2 : 4;
  if (!geometry_ok(S, k, kp, n_extra, elem, ts, tn, threads, smem, grid))
    return (int)cudaErrorInvalidValue;
  // the widest copy every row of every stream allows
  const void* ps[4] = {A, e0, e1, e2};
  bool a16 = true, a4 = true;
  for (int i = 0; i <= n_extra; ++i) {
    a16 = a16 && aligned(ps[i], 16);
    a4 = a4 && aligned(ps[i], 4);
  }
  const int vb = (N * elem) % 16 == 0 && a16 ? 16 : (N * elem) % 4 == 0 && a4 ? 4 : 0;
  if (store == 0 && vb == 0) return (int)cudaErrorInvalidValue;
  void* kern = tn == 32 ? pick_kernel<32>(store, vb) : pick_kernel<16>(store, vb);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&rows, &N, &M, &k, &Mp, &kp, &A, &e0, &e1, &e2,
                  &n_extra, &S, &ts, &B, &u, &misc};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(threads), args, (size_t)smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
