// K3: stage B of the batched Woodbury log-likelihood (factorization chain).
//
// Replaces: gpy_dla_detection_tpu/ops/logmvn_pallas.py :
// _make_chain_kernel_tp2c, the second pallas_call of
// batched_log_mvnpdf_pallas (packed rank-2 steps, the default for even k).
//
// Per sample: the Cholesky factor of I + B, with B the packed lower
// triangle (column-major: column j holds rows j..k-1 contiguously) that K2
// wrote, and the forward substitution of u fused in:
//   quad = sum_j t_j^2,  logdet = sum_j log d_j,
//   ll = -1/2 (quad0 - quad + logdet0 + logdet).
//
// Bound on the card: latency of the serial chain.  The work is ~k^3/6
// FMAs (~1.3k at k = 20) per sample and reads 210 + 20 + 2 floats; the
// whole call is a few MFLOP and ~9 MB at S = 10,000.
//
// Design: one thread per sample, the sample's triangle and u in shared
// memory laid out sample-fastest (element r of sample i at r * 64 + i), so
// every step's reads and writes are conflict-free across the warp.
// 64 samples per block use (210 + 20) x 64 x 4 = 58,880 bytes of dynamic
// shared memory and give 157 blocks at S = 10,000, more than the 132 SMs.
// Rank-1 steps: the TPU's rank-2 pairing and 0/1 selection dots existed to
// feed its matrix unit and are not needed here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // samples per block

__global__ void logmvn_chain_kernel(const float* __restrict__ B,
                                    const float* __restrict__ u,
                                    const float* __restrict__ misc, int S,
                                    int k, float* __restrict__ ll) {
  extern __shared__ float smem[];
  const int kp = k * (k + 1) / 2;
  float* T = smem;                 // [kp][kThreads]
  float* U = smem + kp * kThreads;  // [k][kThreads]
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kThreads;
  const int ns = min(kThreads, S - s0);

  // coalesced loads of the block's contiguous rows, transposed into smem
  for (int e = tid; e < ns * kp; e += kThreads)
    T[(e % kp) * kThreads + e / kp] = B[(size_t)s0 * kp + e];
  for (int e = tid; e < ns * k; e += kThreads)
    U[(e % k) * kThreads + e / k] = u[(size_t)s0 * k + e];
  __syncthreads();
  if (tid >= ns) return;

  float* t = T + tid;
  float* uu = U + tid;
  for (int j = 0, off = 0; j < k; off += k - j, ++j)
    t[off * kThreads] += 1.0f;  // + I on the diagonal
  float quad = 0.0f;
  float logdet = 0.0f;
  int off_j = 0;  // packed row of (j, j)
  for (int j = 0; j < k; ++j) {
    const int seg = k - j;
    const float dj = t[off_j * kThreads];
    logdet += logf(dj);
    const float inv = rsqrtf(dj);
    for (int a = 1; a < seg; ++a) t[(off_j + a) * kThreads] *= inv;
    const float tj = uu[j * kThreads] * inv;
    quad += tj * tj;
    for (int a = 1; a < seg; ++a)
      uu[(j + a) * kThreads] -= tj * t[(off_j + a) * kThreads];
    // trailing update of columns jj > j:  T[a, jj] -= L[a, j] L[jj, j]
    int off_jj = off_j + seg;
    for (int jj = j + 1; jj < k; ++jj) {
      const float l_jj = t[(off_j + jj - j) * kThreads];
      for (int a = jj; a < k; ++a)
        t[(off_jj + a - jj) * kThreads] -= t[(off_j + a - j) * kThreads] * l_jj;
      off_jj += k - jj;
    }
    off_j += seg;
  }
  const size_t s = (size_t)(s0 + tid);
  ll[s] = -0.5f * (misc[2 * s] - quad + misc[2 * s + 1] + logdet);
}

}  // namespace

extern "C" int logmvn_chain_launch(const float* B, const float* u,
                                   const float* misc, int S, int k, float* ll,
                                   void* stream) {
  const size_t smem = (size_t)(k * (k + 1) / 2 + k) * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        logmvn_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (S + kThreads - 1) / kThreads;
  logmvn_chain_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      B, u, misc, S, k, ll);
  return (int)cudaGetLastError();
}
