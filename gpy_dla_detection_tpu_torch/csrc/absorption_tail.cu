// K5: broadened absorption from a precomputed unit optical depth.
//
// Replaces: gpy_dla_detection_tpu/ops/voigt_pallas.py : _abs_tail_kernel
// (entry absorption_from_unit_tau_pallas), float32 storage.
//
// Per sample row s and output pixel p:
//   out[s, p] = sum_{k<7} taps[k] * exp(-nhi[s] * unit_tau[s, p + k])
// (valid mode: P input pixels give P - 6 outputs).
//
// Bound on the card: device-memory bytes.  Each row reads P + 1 floats and
// writes P - 6; the arithmetic is one exp and 7 FMAs per pixel.  At the
// catalog's S = 10,000, P = 1,286 that is ~103 MB, ~31 us at 3.35 TB/s.
//
// Design: one block per sample row, so any row count works (the MCMC head
// calls it with 16 or 20 rows, the exact catalog configuration with
// 10,000).  The row's exp(-nhi * tau) goes into dynamic shared memory
// (P floats, ~5 KB at P = 1,286), and the 7-tap stencil reads it from
// there, so the raw profile never reaches device memory.  Reads and writes
// are coalesced along the row.  The TPU kernel padded S to its 8-aligned
// sample block; a block per row needs no padding.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 7;
constexpr int kThreads = 256;

__global__ void absorption_tail_kernel(const float* __restrict__ unit_tau,
                                       const float* __restrict__ nhi, int P,
                                       const float* __restrict__ taps,
                                       float* __restrict__ out) {
  extern __shared__ float raw[];  // [P]
  __shared__ float tp[kTaps];
  const int s = blockIdx.x;
  const int n_out = P - (kTaps - 1);
  if (threadIdx.x < kTaps) tp[threadIdx.x] = taps[threadIdx.x];
  const float nh = nhi[s];
  const float* tau = unit_tau + (size_t)s * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) raw[p] = expf(-nh * tau[p]);
  __syncthreads();
  float* o = out + (size_t)s * n_out;
  for (int p = threadIdx.x; p < n_out; p += blockDim.x) {
    float acc = tp[0] * raw[p];
    for (int k = 1; k < kTaps; ++k) acc = acc + tp[k] * raw[p + k];
    o[p] = acc;
  }
}

}  // namespace

extern "C" int absorption_tail_launch(const float* unit_tau, const float* nhi,
                                      int S, int P, const float* taps,
                                      float* out, void* stream) {
  const size_t smem = (size_t)P * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        absorption_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  absorption_tail_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      unit_tau, nhi, P, taps, out);
  return (int)cudaGetLastError();
}
