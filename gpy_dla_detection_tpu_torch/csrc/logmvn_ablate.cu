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
// triangle ((k(k+1)/2 + k + 3) floats per sample, 9.3 MB).  The flat
// product this kernel computes, 2 S N (k^2 + k) (10.75 GFLOP), is the
// instrument's work.
//
// Design: the stage kernel is K2's tile (32 samples a block, one thread per
// 4 samples x 8 columns, the prologue's 32 x 32 chunk in shared memory);
// the stages stop early by template.  Matmul, Full and ChainNoDot write the
// block's B and u tiles to shared memory over the prologue's space,
// sample-fastest (32 x (k^2 + k) x 4 = 53,760 bytes at k = 20), then one
// thread per sample sums them or runs the chain: 32 of the block's
// threads.  The flat chain kernel stages 32 samples a block the same way,
// its loads coalesced in either layout, then one thread per sample.  The
// chain reads and updates the upper entries (j, a >= j) of the flat matrix
// only, as K3 does on its packed triangle.  Not tuned.

#include <cuda_runtime.h>

namespace {

constexpr int kTS = 32;   // samples per block of the stage kernel
constexpr int kTN = 32;   // pixels per chunk
constexpr int kSPT = 4;   // samples per thread
constexpr int kCPT = 8;   // columns per thread
constexpr int kSampleGroups = kTS / kSPT;
constexpr int kChainSamples = 32;  // samples per block of the flat chain
constexpr float kLog2Pi = 1.8378770664093453f;

enum Stage : int {
  kElementwise = 0,
  kElementwiseNoLog = 1,
  kMatmul = 2,
  kFull = 3,
  kChainNoDot = 4,
};

__host__ __device__ inline int col_groups(int n) { return (n + kCPT - 1) / kCPT; }

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// A read-only load the compiler may not sink into a branch: the prologue
// issues all six of a pixel's loads at once, so the per-pixel rows' latency
// overlaps the absorption's.  Plain loads let the compiler move y and mu
// into the valid-pixel branch behind the division in some instantiations
// (elementwise_nolog), a second round trip behind A's for every element.
__device__ __forceinline__ float load_now(const float* p) {
  float x;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

// One sample's chain on I + B: flat entry p = j k + a at t[p * stride], u's
// entry a at uu[a * stride]; both are overwritten.
__device__ void flat_chain(float* t, float* uu, int stride, int k, float& quad,
                           float& logdet) {
  for (int j = 0; j < k; ++j) t[(j * k + j) * stride] += 1.0f;
  quad = 0.0f;
  logdet = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int off = j * k;
    const float dj = t[(off + j) * stride];
    logdet += logf(dj);
    const float inv = rsqrtf(dj);
    for (int a = j + 1; a < k; ++a) t[(off + a) * stride] *= inv;
    const float tj = uu[j * stride] * inv;
    quad += tj * tj;
    for (int a = j + 1; a < k; ++a) uu[a * stride] -= tj * t[(off + a) * stride];
    // trailing update of rows jj > j:  A[jj, a] -= L[a] L[jj]
    for (int jj = j + 1; jj < k; ++jj) {
      const float l_jj = t[(off + jj) * stride];
      for (int a = jj; a < k; ++a)
        t[(jj * k + a) * stride] -= t[(off + a) * stride] * l_jj;
    }
  }
}

// The same chain with the ablation's wrong trailing update: every later
// row loses col[a]^2 in every column a (col zero below the pivot).  Rows up
// to j are never read again, so they are left as they are.
__device__ void flat_chain_nodot(float* t, float* uu, int stride, int k,
                                 float& quad, float& logdet) {
  for (int j = 0; j < k; ++j) t[(j * k + j) * stride] += 1.0f;
  quad = 0.0f;
  logdet = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int off = j * k;
    const float dj = t[(off + j) * stride];
    logdet += logf(dj);
    const float inv = rsqrtf(dj);
    for (int a = 0; a < k; ++a)
      t[(off + a) * stride] = a >= j ? t[(off + a) * stride] * inv : 0.0f;
    const float tj = uu[j * stride] * inv;
    quad += tj * tj;
    for (int a = j + 1; a < k; ++a) uu[a * stride] -= tj * t[(off + a) * stride];
    for (int i = j + 1; i < k; ++i)
      for (int a = 0; a < k; ++a) {
        const float c = t[(off + a) * stride];
        t[(i * k + a) * stride] -= c * c;
      }
  }
}

template <int kStage>
__global__ void logmvn_ablate_kernel(const float* __restrict__ rows, int N,
                                     const float* __restrict__ M, int k,
                                     const float* __restrict__ Mp,
                                     const float* __restrict__ A, int S,
                                     float* __restrict__ ll) {
  constexpr bool kProducts = kStage >= kMatmul;
  const int kp = k * k;
  const int gp = col_groups(kp);
  const int ng = gp + col_groups(k);
  const int NC = ng * kCPT;
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // [kTN][kTS] w
  float* R = W + kTN * kTS;                   // [kTN][kTS] r
  float* Q = R + kTN * kTS;                   // [kTS][kTN + 1] delta^2 d_inv
  float* LD = Q + kTS * (kTN + 1);            // [kTS][kTN + 1] log d_inv (or d_inv)
  float* Mc = LD + align4(kTS * (kTN + 1));   // [kTN][NC] Mp | M chunk

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // kSampleGroups * ng, at least kTS
  const int cg = tid % ng;
  const int sg = tid / ng;
  // threads beyond the 4 x 8 tiles (a narrow basis) only load and sum
  const bool tiled = sg < kSampleGroups;
  const int s0 = blockIdx.x * kTS;
  const float* L = (cg < gp) ? W : R;
  const float* y = rows;
  const float* mu = rows + N;
  const float* omega2 = rows + 2 * N;
  const float* v = rows + 3 * N;
  const float* mask = rows + 4 * N;

  float acc[kSPT][kCPT];
#pragma unroll
  for (int i = 0; i < kSPT; ++i)
#pragma unroll
    for (int j = 0; j < kCPT; ++j) acc[i][j] = 0.0f;
  double q_acc = 0.0, ld_acc = 0.0, wr_acc = 0.0;
  int n_valid = 0;

  for (int n0 = 0; n0 < N; n0 += kTN) {
    for (int e = tid; e < kTS * kTN; e += nthreads) {
      const int sl = e / kTN;
      const int nl = e % kTN;
      const int s = s0 + sl;
      const int n = n0 + nl;
      float w = 0.0f, r = 0.0f, q = 0.0f, ld = 0.0f;
      if (s < S && n < N) {
        const float a_raw = load_now(A + (size_t)s * N + n);
        const float m = load_now(mask + n);
        const float om = load_now(omega2 + n);
        const float vn = load_now(v + n);
        const float yn = load_now(y + n);
        const float mun = load_now(mu + n);
        const bool valid = m > 0.0f;
        const float a = valid ? a_raw : 1.0f;
        const float d = om * a * a + vn;
        const float d_inv = m / (valid ? d : 1.0f);
        const float delta = valid ? yn - mun * a : 0.0f;
        w = a * a * d_inv;
        r = a * delta * d_inv;
        q = delta * delta * d_inv;
        ld = kStage == kElementwiseNoLog ? d_inv
                                         : logf(d_inv + (valid ? 0.0f : 1.0f));
      }
      W[nl * kTS + sl] = w;
      R[nl * kTS + sl] = r;
      Q[sl * (kTN + 1) + nl] = q;
      LD[sl * (kTN + 1) + nl] = ld;
    }
    if constexpr (kProducts) {
      for (int e = tid; e < kTN * NC; e += nthreads) {
        const int nl = e / NC;
        const int c = e % NC;
        const int n = n0 + nl;
        float val = 0.0f;
        if (n < N) {
          if (c < gp * kCPT) {
            if (c < kp) val = Mp[(size_t)n * kp + c];
          } else {
            const int j = c - gp * kCPT;
            if (j < k) val = M[(size_t)n * k + j];
          }
        }
        Mc[e] = val;
      }
    }
    __syncthreads();

    const int nmax = min(kTN, N - n0);
    if (tid < kTS) {
      for (int nl = 0; nl < nmax; ++nl) {
        q_acc += (double)Q[tid * (kTN + 1) + nl];
        ld_acc += (double)LD[tid * (kTN + 1) + nl];
        n_valid += mask[n0 + nl] > 0.0f;
        if constexpr (!kProducts)
          wr_acc += (double)W[nl * kTS + tid] + (double)R[nl * kTS + tid];
      }
    }
    if (kProducts && tiled) {
      for (int nl = 0; nl < nmax; ++nl) {
        const float4 lv = *reinterpret_cast<const float4*>(L + nl * kTS + sg * kSPT);
        const float4 c0 = *reinterpret_cast<const float4*>(Mc + nl * NC + cg * kCPT);
        const float4 c1 =
            *reinterpret_cast<const float4*>(Mc + nl * NC + cg * kCPT + 4);
        const float ls[kSPT] = {lv.x, lv.y, lv.z, lv.w};
        const float cs[kCPT] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < kSPT; ++i)
#pragma unroll
          for (int j = 0; j < kCPT; ++j) acc[i][j] = fmaf(ls[i], cs[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (!kProducts) {
    if (tid < kTS && s0 + tid < S) {
      const double sum = kStage == kElementwiseNoLog ? q_acc + ld_acc + wr_acc
                                                     : q_acc - ld_acc + wr_acc;
      ll[s0 + tid] = (float)sum;
    }
  } else {
    // the block's B and u tiles, sample-fastest, over the prologue's space
    float* Bt = reinterpret_cast<float*>(smem4);  // [kp][kTS]
    float* Ut = Bt + kp * kTS;                    // [k][kTS]
    if (tiled) {
#pragma unroll
      for (int i = 0; i < kSPT; ++i) {
        const int sl = sg * kSPT + i;
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          const int c = cg * kCPT + j;
          if (cg < gp) {
            if (c < kp) Bt[c * kTS + sl] = acc[i][j];
          } else {
            const int jj = c - gp * kCPT;
            if (jj < k) Ut[jj * kTS + sl] = acc[i][j];
          }
        }
      }
    }
    __syncthreads();
    if (tid < kTS && s0 + tid < S) {
      const float quad0 = (float)q_acc;
      if constexpr (kStage == kMatmul) {
        float sb = 0.0f, su = 0.0f;
        for (int p = 0; p < kp; ++p) sb += Bt[p * kTS + tid];
        for (int a = 0; a < k; ++a) su += Ut[a * kTS + tid];
        ll[s0 + tid] = quad0 + (float)(-ld_acc) + sb + su;
      } else {
        const float logdet0 = (float)(-ld_acc) + (float)n_valid * kLog2Pi;
        float quad, logdet;
        if constexpr (kStage == kFull)
          flat_chain(Bt + tid, Ut + tid, kTS, k, quad, logdet);
        else
          flat_chain_nodot(Bt + tid, Ut + tid, kTS, k, quad, logdet);
        ll[s0 + tid] = -0.5f * (quad0 - quad + logdet0 + logdet);
      }
    }
  }
}

template <int kStage>
int launch_stage(const float* rows, int N, const float* M, int k, const float* Mp,
                 const float* A, int S, float* ll, cudaStream_t stream) {
  const int ng = col_groups(k * k) + col_groups(k);
  const int tiled = kSampleGroups * ng;
  const int threads = tiled < kTS ? kTS : tiled;  // kTS threads sum and chain
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  size_t floats = 2 * kTN * kTS + kTS * (kTN + 1) + align4(kTS * (kTN + 1));
  if (kStage >= kMatmul) floats += (size_t)kTN * ng * kCPT;  // >= kTS (k^2 + k)
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_ablate_kernel<kStage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (S + kTS - 1) / kTS;
  logmvn_ablate_kernel<kStage><<<blocks, threads, smem, stream>>>(rows, N, M, k, Mp,
                                                                  A, S, ll);
  return (int)cudaGetLastError();
}

// dst[p * kChainSamples + i] = src[(s0 + i) * ss + p * es] for the block's
// ns samples and n entries, the loop ordered so that neighbouring threads
// read neighbouring addresses in either layout.
__device__ void stage_in(float* dst, const float* __restrict__ src, long long ss,
                         long long es, int n, int ns, int s0) {
  const int total = ns * n;
  if (ss == 1) {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int i = e % ns, p = e / ns;
      dst[p * kChainSamples + i] = src[(long long)(s0 + i) + p * es];
    }
  } else {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int i = e / n, p = e % n;
      dst[p * kChainSamples + i] = src[(long long)(s0 + i) * ss + p * es];
    }
  }
}

__global__ void logmvn_flat_chain_kernel(const float* __restrict__ B,
                                         long long b_ss, long long b_es,
                                         const float* __restrict__ u,
                                         long long u_ss, long long u_es,
                                         const float* __restrict__ misc,
                                         long long m_ss, long long m_es, int S,
                                         int k, float* __restrict__ ll) {
  extern __shared__ float smem[];
  float* T = smem;                         // [k^2][kChainSamples]
  float* U = T + k * k * kChainSamples;    // [k][kChainSamples]
  float* Mi = U + k * kChainSamples;       // [2][kChainSamples]
  const int s0 = blockIdx.x * kChainSamples;
  const int ns = min(kChainSamples, S - s0);
  stage_in(T, B, b_ss, b_es, k * k, ns, s0);
  stage_in(U, u, u_ss, u_es, k, ns, s0);
  stage_in(Mi, misc, m_ss, m_es, 2, ns, s0);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= ns) return;
  float quad, logdet;
  flat_chain(T + tid, U + tid, kChainSamples, k, quad, logdet);
  ll[s0 + tid] =
      -0.5f * (Mi[tid] - quad + Mi[kChainSamples + tid] + logdet);
}

}  // namespace

extern "C" int logmvn_ablate_launch(int stage, const float* rows, int N,
                                    const float* M, int k, const float* Mp,
                                    const float* A, int S, float* ll,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (stage) {
    case kElementwise:
      return launch_stage<kElementwise>(rows, N, M, k, Mp, A, S, ll, st);
    case kElementwiseNoLog:
      return launch_stage<kElementwiseNoLog>(rows, N, M, k, Mp, A, S, ll, st);
    case kMatmul:
      return launch_stage<kMatmul>(rows, N, M, k, Mp, A, S, ll, st);
    case kFull:
      return launch_stage<kFull>(rows, N, M, k, Mp, A, S, ll, st);
    case kChainNoDot:
      return launch_stage<kChainNoDot>(rows, N, M, k, Mp, A, S, ll, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int logmvn_flat_chain_launch(const float* B, long long b_ss,
                                        long long b_es, const float* u,
                                        long long u_ss, long long u_es,
                                        const float* misc, long long m_ss,
                                        long long m_es, int S, int k, float* ll,
                                        void* stream) {
  const size_t smem = (size_t)(k * k + k + 2) * kChainSamples * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        logmvn_flat_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (S + kChainSamples - 1) / kChainSamples;
  logmvn_flat_chain_kernel<<<blocks, kChainSamples, smem, (cudaStream_t)stream>>>(
      B, b_ss, b_es, u, u_ss, u_es, misc, m_ss, m_es, S, k, ll);
  return (int)cudaGetLastError();
}
