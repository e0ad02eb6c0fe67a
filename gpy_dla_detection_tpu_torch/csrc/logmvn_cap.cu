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
// without the +I),  u[s, :] = r @ M,  misc[s] = (sum delta^2 d_inv,
// -sum log d_inv + n log 2 pi).
//
// Bound on the card: the (S x N) . (N x (k(k+1)/2 + k)) product, 2 S N 230
// ~ 5.9 GFLOP per call at S = 10,000, N = 1,280, k = 20, in IEEE float32
// FMA (no TF32: it keeps ~10 mantissa bits, and the per-sample ll
// tolerance does not survive that).
//
// Design: a block owns 32 samples and all 230 output columns, padded to
// whole groups of 8 (216 pair + 24 projection columns).  It walks the
// pixels in chunks of 32: the elementwise prologue forms w and r for the
// 32 x 32 tile in shared memory, the chunk of M_pair and M is staged in
// shared memory, and each thread accumulates a 4-sample x 8-column
// register tile.  The extra streams multiply into a in registers; their
// product is never written.  The packed M_pair is read precomputed: it is
// formed once per spectrum and shared by all five likelihood calls
// (forming the pairs in the kernel would cut each block's 1.2 MB L2 read
// of it, a later optimisation).  quad0 and logdet0 are summed in double
// by one thread per sample, in pixel order.

#include <cuda_runtime.h>

namespace {

constexpr int kTS = 32;   // samples per block
constexpr int kTN = 32;   // pixels per chunk
constexpr int kSPT = 4;   // samples per thread
constexpr int kCPT = 8;   // columns per thread
constexpr int kSampleGroups = kTS / kSPT;
constexpr float kLog2Pi = 1.8378770664093453f;

__host__ __device__ inline int col_groups(int n) { return (n + kCPT - 1) / kCPT; }

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

__global__ void logmvn_cap_kernel(
    const float* __restrict__ rows, int N, const float* __restrict__ M, int k,
    const float* __restrict__ Mp, int kp, const float* __restrict__ A,
    const float* __restrict__ e0, const float* __restrict__ e1,
    const float* __restrict__ e2, int n_extra, int S, float* __restrict__ B,
    float* __restrict__ u, float* __restrict__ misc) {
  const int gp = col_groups(kp);
  const int ng = gp + col_groups(k);
  const int NC = ng * kCPT;
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // [kTN][kTS] w
  float* R = W + kTN * kTS;                   // [kTN][kTS] r
  float* Q = R + kTN * kTS;                   // [kTS][kTN + 1] delta^2 d_inv
  float* LD = Q + kTS * (kTN + 1);            // [kTS][kTN + 1] log d_inv
  float* Mc = LD + align4(kTS * (kTN + 1));   // [kTN][NC] M_pair | M chunk

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // kSampleGroups * ng
  const int cg = tid % ng;
  const int sg = tid / ng;
  const int s0 = blockIdx.x * kTS;
  const float* L = (cg < gp) ? W : R;  // pair columns take w, M columns r
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
  double q_acc = 0.0, ld_acc = 0.0;
  int n_valid = 0;

  for (int n0 = 0; n0 < N; n0 += kTN) {
    for (int e = tid; e < kTS * kTN; e += nthreads) {
      const int sl = e / kTN;
      const int nl = e % kTN;
      const int s = s0 + sl;
      const int n = n0 + nl;
      float w = 0.0f, r = 0.0f, q = 0.0f, ld = 0.0f;
      if (s < S && n < N) {
        const size_t idx = (size_t)s * N + n;
        float a_raw = A[idx];
        if (n_extra > 0) a_raw = a_raw * e0[idx];
        if (n_extra > 1) a_raw = a_raw * e1[idx];
        if (n_extra > 2) a_raw = a_raw * e2[idx];
        const float m = mask[n];
        const bool valid = m > 0.0f;
        const float a = valid ? a_raw : 1.0f;
        const float d = omega2[n] * a * a + v[n];
        const float d_inv = m / (valid ? d : 1.0f);
        const float delta = valid ? y[n] - mu[n] * a : 0.0f;
        w = a * a * d_inv;
        r = a * delta * d_inv;
        q = delta * delta * d_inv;
        ld = logf(d_inv + (valid ? 0.0f : 1.0f));
      }
      W[nl * kTS + sl] = w;
      R[nl * kTS + sl] = r;
      Q[sl * (kTN + 1) + nl] = q;
      LD[sl * (kTN + 1) + nl] = ld;
    }
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
    __syncthreads();

    const int nmax = min(kTN, N - n0);
    if (tid < kTS) {
      for (int nl = 0; nl < nmax; ++nl) {
        q_acc += (double)Q[tid * (kTN + 1) + nl];
        ld_acc += (double)LD[tid * (kTN + 1) + nl];
        n_valid += mask[n0 + nl] > 0.0f;
      }
    }
    for (int nl = 0; nl < nmax; ++nl) {
      const float4 lv = *reinterpret_cast<const float4*>(L + nl * kTS + sg * kSPT);
      const float4 c0 = *reinterpret_cast<const float4*>(Mc + nl * NC + cg * kCPT);
      const float4 c1 = *reinterpret_cast<const float4*>(Mc + nl * NC + cg * kCPT + 4);
      const float ls[kSPT] = {lv.x, lv.y, lv.z, lv.w};
      const float cs[kCPT] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < kSPT; ++i)
#pragma unroll
        for (int j = 0; j < kCPT; ++j) acc[i][j] = fmaf(ls[i], cs[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kSPT; ++i) {
    const int s = s0 + sg * kSPT + i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      const int c = cg * kCPT + j;
      if (cg < gp) {
        if (c < kp) B[(size_t)s * kp + c] = acc[i][j];
      } else {
        const int jj = c - gp * kCPT;
        if (jj < k) u[(size_t)s * k + jj] = acc[i][j];
      }
    }
  }
  if (tid < kTS && s0 + tid < S) {
    const size_t s = (size_t)(s0 + tid);
    misc[2 * s] = (float)q_acc;
    misc[2 * s + 1] = (float)(-ld_acc) + (float)n_valid * kLog2Pi;
  }
}

}  // namespace

extern "C" int logmvn_cap_launch(
    const float* rows, int N, const float* M, int k, const float* Mp, int kp,
    const float* A, const float* e0, const float* e1, const float* e2,
    int n_extra, int S, float* B, float* u, float* misc, void* stream) {
  const int ng = col_groups(kp) + col_groups(k);
  const int threads = kSampleGroups * ng;
  if (threads > 1024 || n_extra < 0 || n_extra > 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(2 * kTN * kTS + kTS * (kTN + 1) + align4(kTS * (kTN + 1)) +
               kTN * ng * kCPT) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        logmvn_cap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (S + kTS - 1) / kTS;
  logmvn_cap_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rows, N, M, k, Mp, kp, A, e0, e1, e2, n_extra, S, B, u, misc);
  return (int)cudaGetLastError();
}
