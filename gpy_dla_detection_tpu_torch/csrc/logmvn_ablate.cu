// K7: the likelihood-ablation kernel group.
//
// Replaces: scripts/kernel_ablate.py : make_kernel (every stage; built in
// build, pallas_call at :608), kb in build_decoupled (call :324), kb_row
// (call :554), kb_xt / kb_xt2 (call :530) and kb_T (call :576) in
// build_chain_only.  ka of build_decoupled is K2's own kernel
// (logmvn_cap.cu) with a k^2-wide basis; kb_xtp is K3 (logmvn_chain.cu).
//
// logmvn_ablate_kernel<stage>: per sample s over the N pixels, K2's
// elementwise assembly (a, d_inv, delta, w = a^2 d_inv, r = a delta d_inv;
// quad0 = sum delta^2 d_inv, logdet0 = -sum log d_inv), then by stage
//   Elementwise       ll = quad0 + logdet0 + sum (w + r)
//   ElementwiseNoLog  ll = quad0 + sum (d_inv + w + r)   (no logf per pixel)
//   Matmul            ll = quad0 + logdet0 + sum B + sum u,
//                     B = w Mp (flat, k^2 columns), u = r M
//   Full              ll = -1/2 (quad0 - quad + logdet0 + logdet + n log 2 pi):
//                     the Cholesky of I + B with the forward substitution
//                     of u, fused behind the products
//   ChainNoDot        Full with the trailing update A -= tile * tile, wrong
//                     on purpose (the TPU ablation's chain without its
//                     dot); NaN wherever a pivot goes negative.
// logmvn_flat_chain_kernel: ll = -1/2 (quad0 - quad + logdet0 + logdet)
// from flat B (k^2 entries per sample, without the +I), u and misc =
// (quad0, logdet0 + n log 2 pi), read through an entry stride and a sample
// stride, so one kernel takes the row layout (S, k^2) and the transposed
// (k^2, S) one without a transpose copy.
//
// Bound on the card, by what each function needs: Elementwise,
// ElementwiseNoLog and Matmul by bytes (the S x N absorption, 51.2 MB at
// S = 10,000, N = 1,280; Matmul's sum B + sum u needs no product, two FMAs
// per sample and pixel); Full and ChainNoDot by K2's products on the
// symmetric basis's triangle, 2 S N (k(k+1)/2 + k) in float32 FMA (5.89
// GFLOP at k = 20), plus the chain; the flat chain by the bytes of the
// triangle ((k(k+1)/2 + k + 3) floats per sample, 9.3 MB).
//
// The stage kernel is K2's block (logmvn_cap_block.cuh) at
// K2's own geometry for the packed basis, cap_geometry(S, N, k, k(k+1)/2),
// so the stages differ in work and not in occupancy; the stage picks the
// block's epilogue.  The matrix is symmetric, so every stage from Matmul on
// computes the packed product, as K2 does: the wrapper gathers the packed
// columns (j, a >= j) of the flat Mp (flat column j k + a) into the packed
// basis K2 takes, one index_select a call, so the staging is K2's own.
// Elementwise and
// ElementwiseNoLog stage and assemble as K2 does (the w | r tile written as
// there) with no basis and no FMA loop, summing w + r (and d_inv in place
// of its log) beside quad0 through the assembly's shuffles.  Matmul runs
// K2's loop and sums each thread's tile, sum B = sum diag + 2 sum
// off-diag, across a warp's column groups by shuffles and across the
// column warps in shared memory; nothing is stored but ll.  Full and
// ChainNoDot write each thread's tile of B | u and each sample's quad0 and
// logdet0 to shared memory over the staging buffers, in K3's column-major
// packed layout (TS (k(k+1)/2 + k + 2) floats, 74,240 bytes at TS = 80, k
// = 20), then each warp runs K3's warp chain (logmvn_chain_warp.cuh) on
// its samples in turn: at the main path 10 warps an SM, 8 samples each,
// where K3 alone runs 32 warps an SM.
//
// The flat chain is K3's warp chain too, a warp a sample.  A block takes
// an even run of consecutive samples (flat_chain_geometry), in chunks that
// fit its shared memory; each chunk is staged into K3's packed layout (the
// upper entries (j, a >= j) of the flat B through a table of their flat
// offsets, then u and misc), the loads ordered so that neighbouring
// threads read neighbouring addresses in either layout (entry-fastest in
// the row layout, sample-fastest in the transposed one, where a sample's
// entries are S floats apart), each sample's buffer an odd number of
// floats long so that the sample-fastest stores fall in distinct banks.

#include <cuda_runtime.h>

#include <cstdint>

#include "logmvn_cap_block.cuh"
#include "logmvn_chain_warp.cuh"

namespace {

using namespace cap_block;
// The flat chain's warps a block, and its blocks an SM (the launch bound)
// at row bounds 32 and 64; the launcher refuses a geometry with others.
using FlatGeometry = k3::GeometryOf<8, 4, 8, 2>;

constexpr int kStageMaxK = 64;  // K3's largest row bound

enum Stage : int {
  kElementwise = 0,
  kElementwiseNoLog = 1,
  kMatmul = 2,
  kFull = 3,
  kChainNoDot = 4,
};

// the row bound of K3's chain that holds k
__host__ __device__ inline int row_bound(int k) { return k <= 32 ? 32 : 64; }

// floats of the fused chain's buffer: each sample's triangle, u and misc,
// and the row bound the rows past k - 1 read beyond the last sample
__host__ __device__ inline size_t chain_floats(int ts, int k) {
  return (size_t)ts * (k * (k + 1) / 2 + k + 2) + row_bound(k);
}

// (column j, row a >= j) of packed column c (column-major lower triangle)
__device__ __forceinline__ void packed_coord(int c, int k, int& j, int& a) {
  int off = 0;
  j = 0;
  while (c >= off + k - j) {
    off += k - j;
    ++j;
  }
  a = j + c - off;
}

template <int kStage, int KMAX = 32>
struct StageOut {
  float* ll;
  static constexpr bool kProducts = kStage >= kMatmul;
  static constexpr bool kLogDet = kStage != kElementwiseNoLog;
  static constexpr bool kSumWR = kStage <= kElementwiseNoLog;

  __device__ __forceinline__ void finish(const Block& b, const float (&acc)[kTile][kTile],
                                         const double (&q)[kMaxQuads],
                                         const double (&ld)[kMaxQuads],
                                         const double (&wr)[kMaxQuads]) const {
    if constexpr (!kProducts) {
      if (b.nl_lo != 0) return;
#pragma unroll
      for (int qi = 0; qi < kMaxQuads; ++qi) {
        const int quad = b.warp + qi * b.nwarps;
        const int s = b.s0 + 4 * quad + b.sl_lo;
        if (quad < b.n_quads && s < b.S)
          ll[s] = (float)(kLogDet ? q[qi] - ld[qi] + wr[qi] : q[qi] + ld[qi] + wr[qi]);
      }
    } else if constexpr (kStage == kMatmul) {
      float* part = b.smem;              // [wc][TS]: each column warp's sums
      float* base = part + b.wc * b.TS;  // [TS]: quad0 + logdet0
      float wt[kTile];  // the weight of each of the thread's columns in the sum
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int c = b.cg * kTile + j;
        if (b.cg < b.gp) {
          int jj = 0, a = 0;
          if (c < b.kp) packed_coord(c, b.k, jj, a);
          wt[j] = c >= b.kp ? 0.0f : a == jj ? 1.0f : 2.0f;
        } else {
          wt[j] = c - b.gp * kTile < b.k ? 1.0f : 0.0f;
        }
      }
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float ps = 0.0f;
#pragma unroll
        for (int j = 0; j < kTile; ++j) ps += wt[j] * acc[i][j];
        // the 16 column groups of the warp's half (lanes of one sample group)
#pragma unroll
        for (int off = 1; off < kWarpCG; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        if (lane % kWarpCG == 0) part[(b.warp % b.wc) * b.TS + b.sg * kTile + i] = ps;
      }
      if (b.nl_lo == 0) {
#pragma unroll
        for (int qi = 0; qi < kMaxQuads; ++qi) {
          const int quad = b.warp + qi * b.nwarps;
          if (quad < b.n_quads) base[4 * quad + b.sl_lo] = (float)q[qi] + (float)(-ld[qi]);
        }
      }
      __syncthreads();
      for (int t = threadIdx.x; t < b.TS; t += blockDim.x) {
        if (b.s0 + t >= b.S) break;
        float v = base[t];
        for (int w = 0; w < b.wc; ++w) v += part[w * b.TS + t];
        ll[b.s0 + t] = v;
      }
    } else {
      // each sample's packed triangle, u and misc, K3's layout
      const int stride = b.kp + b.k + 2;
      float* buf = b.smem;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float* row = buf + (b.sg * kTile + i) * stride;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const int c = b.cg * kTile + j;
          if (b.cg < b.gp) {
            if (c < b.kp) row[c] = acc[i][j];
          } else {
            const int jj = c - b.gp * kTile;  // >= k on the padding groups
            if (jj < b.k) row[b.kp + jj] = acc[i][j];
          }
        }
      }
      if (b.nl_lo == 0) {
#pragma unroll
        for (int qi = 0; qi < kMaxQuads; ++qi) {
          const int quad = b.warp + qi * b.nwarps;
          if (quad < b.n_quads) {
            float* m = buf + (4 * quad + b.sl_lo) * stride + b.kp + b.k;
            m[0] = (float)q[qi];
            m[1] = (float)(-ld[qi]) + (float)b.n_valid * kLog2Pi;
          }
        }
      }
      __syncthreads();
      for (int sl = b.warp; sl < b.TS && b.s0 + sl < b.S; sl += b.nwarps) {
        const float* t = buf + sl * stride;
        const float v = k3::chain_ll<KMAX, kStage == kChainNoDot>(
            t, t + b.kp, t[b.kp + b.k], t[b.kp + b.k + 1], b.k);
        if ((threadIdx.x & 31) == 0) ll[b.s0 + sl] = v;
      }
    }
  }
};

template <int TN, int VB, class Epi>
__global__ void __launch_bounds__(kMaxThreads, 1) logmvn_ablate_kernel(
    const float* __restrict__ rows, int N, const float* __restrict__ M, int k,
    const float* __restrict__ Mp, const float* __restrict__ A, int S, int TS, Epi epi) {
  run<TN, VB, float>(rows, N, M, k, Mp, k * (k + 1) / 2, A, nullptr, nullptr, nullptr, 0,
                     S, TS, epi);
}

struct StageArgs {
  const float* rows;
  int N;
  const float* M;
  int k;
  const float* Mp;
  const float* A;
  int S, ts, threads, smem, grid;
  float* ll;
};

template <int TN, int VB, class Epi>
int launch_stage(const StageArgs& a, cudaStream_t stream) {
  auto kern = logmvn_ablate_kernel<TN, VB, Epi>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       a.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.grid, a.threads, a.smem, stream>>>(a.rows, a.N, a.M, a.k, a.Mp, a.A, a.S, a.ts,
                                              Epi{a.ll});
  return (int)cudaGetLastError();
}

template <class Epi>
int dispatch(const StageArgs& a, int tn, int vb, cudaStream_t stream) {
  if (tn == 32)
    return vb == 16 ? launch_stage<32, 16, Epi>(a, stream) : launch_stage<32, 4, Epi>(a, stream);
  return vb == 16 ? launch_stage<16, 16, Epi>(a, stream) : launch_stage<16, 4, Epi>(a, stream);
}

// dst[i * stride + e] = entry e of sample c0 + i: the packed triangle (the
// flat offsets in tbl), then u, then misc
template <int KMAX>
__global__ void __launch_bounds__(32 * FlatGeometry::warps(KMAX), FlatGeometry::blocks(KMAX))
logmvn_flat_chain_kernel(const float* __restrict__ B, long long b_ss, long long b_es,
                         const float* __restrict__ u, long long u_ss, long long u_es,
                         const float* __restrict__ misc, long long m_ss, long long m_es,
                         int S, int k, int chunk, float* __restrict__ ll) {
  constexpr int kWarps = FlatGeometry::warps(KMAX);
  extern __shared__ float4 smem4[];
  const int kp = k * (k + 1) / 2;
  const int per = kp + k + 2;        // floats of a sample
  const int stride = per | 1;        // odd: the sample-fastest stores' banks
  int* tbl = reinterpret_cast<int*>(smem4);           // [kp] flat offsets
  float* buf = reinterpret_cast<float*>(tbl + kp);    // [chunk][stride] + KMAX
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  for (int j = tid; j < k; j += blockDim.x) {
    const int off = j * k - j * (j - 1) / 2;
    for (int a = j; a < k; ++a) tbl[off + a - j] = j * k + a;
  }
  // block b of the grid's G takes samples b S / G up to (b + 1) S / G
  const int first = (int)((long long)blockIdx.x * S / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * S / gridDim.x);
  const bool sample_fastest = b_ss == 1;  // the transposed layout
  for (int c0 = first; c0 < last; c0 += chunk) {
    const int ns = min(chunk, last - c0);
    __syncthreads();  // the table is in; the last chunk's chains are done
    for (int e = tid; e < ns * per; e += blockDim.x) {
      const int i = sample_fastest ? e % ns : e / per;
      const int q = sample_fastest ? e / ns : e % per;
      const long long s = c0 + i;
      float v;
      if (q < kp)
        v = __ldg(B + s * b_ss + (long long)tbl[q] * b_es);
      else if (q < kp + k)
        v = __ldg(u + s * u_ss + (long long)(q - kp) * u_es);
      else
        v = __ldg(misc + s * m_ss + (long long)(q - kp - k) * m_es);
      buf[i * stride + q] = v;
    }
    __syncthreads();
    for (int i = warp; i < ns; i += kWarps) {
      const float* t = buf + i * stride;
      const float v = k3::chain_ll<KMAX, false>(t, t + kp, t[kp + k], t[kp + k + 1], k);
      if ((tid & 31) == 0) ll[c0 + i] = v;
    }
  }
}

template <int KMAX>
int launch_flat(const float* B, long long b_ss, long long b_es, const float* u,
                long long u_ss, long long u_es, const float* misc, long long m_ss,
                long long m_es, int S, int k, int chunk, int smem, int grid, float* ll,
                cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_flat_chain_kernel<KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  logmvn_flat_chain_kernel<KMAX><<<grid, 32 * FlatGeometry::warps(KMAX), smem, stream>>>(
      B, b_ss, b_es, u, u_ss, u_es, misc, m_ss, m_es, S, k, chunk, ll);
  return (int)cudaGetLastError();
}

}  // namespace

// Mp: the packed pair basis (N, k(k+1)/2), read from Matmul on.  The
// geometry (samples a block, pixels a chunk, threads, shared bytes, grid)
// comes from the caller and must be cap_geometry's for (S, N, k,
// k(k+1)/2) with no extra stream; Full and ChainNoDot also need the chain's
// buffers within those shared bytes.  Anything else is refused, as is A
// not 4-byte aligned.
extern "C" int logmvn_ablate_launch(int stage, const float* rows, int N, const float* M,
                                    int k, const float* Mp, const float* A, int S, int ts,
                                    int tn, int threads, int smem, int grid, float* ll,
                                    void* stream) {
  if (stage < kElementwise || stage > kChainNoDot || k < 1 || k > kStageMaxK || N < 1 ||
      S < 1 || !geometry_ok(S, k, k * (k + 1) / 2, 0, 4, ts, tn, threads, smem, grid) ||
      reinterpret_cast<uintptr_t>(A) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (stage >= kFull && (size_t)smem < sizeof(float) * chain_floats(ts, k))
    return (int)cudaErrorInvalidValue;
  const int vb = N % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 ? 16 : 4;
  const StageArgs a{rows, N, M, k, Mp, A, S, ts, threads, smem, grid, ll};
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = row_bound(k) == 64;
  switch (stage) {
    case kElementwise:
      return dispatch<StageOut<kElementwise>>(a, tn, vb, st);
    case kElementwiseNoLog:
      return dispatch<StageOut<kElementwiseNoLog>>(a, tn, vb, st);
    case kMatmul:
      return dispatch<StageOut<kMatmul>>(a, tn, vb, st);
    case kFull:
      return wide ? dispatch<StageOut<kFull, 64>>(a, tn, vb, st)
                  : dispatch<StageOut<kFull, 32>>(a, tn, vb, st);
    default:
      return wide ? dispatch<StageOut<kChainNoDot, 64>>(a, tn, vb, st)
                  : dispatch<StageOut<kChainNoDot, 32>>(a, tn, vb, st);
  }
}

// The geometry (row bound, warps a block, blocks an SM, samples a staged
// chunk, shared bytes, grid) comes from flat_chain_geometry.  Refused: a
// row bound that is not compiled or is below k, other warps a block or
// blocks an SM than the compiled ones, shared memory short of the offset
// table, a chunk's buffers and the row bound of padding, or beyond 227 KB,
// an empty chunk or grid.
extern "C" int logmvn_flat_chain_launch(const float* B, long long b_ss, long long b_es,
                                        const float* u, long long u_ss, long long u_es,
                                        const float* misc, long long m_ss, long long m_es,
                                        int S, int k, int rows, int warps, int per_sm,
                                        int chunk, int smem, int grid, float* ll,
                                        void* stream) {
  if (S < 1 || k < 1 || k > rows || (rows != 32 && rows != 64) ||
      warps != FlatGeometry::warps(rows) || per_sm != FlatGeometry::blocks(rows) ||
      chunk < 1 || grid < 1 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int kp = k * (k + 1) / 2;
  const long long need = 4LL * (kp + (long long)chunk * ((kp + k + 2) | 1) + rows);
  if (smem < need) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 32)
    return launch_flat<32>(B, b_ss, b_es, u, u_ss, u_es, misc, m_ss, m_es, S, k, chunk, smem,
                           grid, ll, st);
  return launch_flat<64>(B, b_ss, b_es, u, u_ss, u_es, misc, m_ss, m_es, S, k, chunk, smem,
                         grid, ll, st);
}
