// K5: broadened absorption from a precomputed unit optical depth.
//
// Replaces: gpy_dla_detection_tpu/ops/voigt_pallas.py : _abs_tail_kernel
// (entry absorption_from_unit_tau_pallas), float32 and int16 storage.
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
//
// Storage: float32, or int16 fixed-point codes round(a * 32767) (the
// reference's GPY_DLA_ABS_DTYPE=i16 / i16p, its _encode_store), an
// instantiation of its own that differs only at the store: the code is the
// correctly rounded product rounded half to even (as torch.round; roundf
// would round half away from zero).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 7;
constexpr int kThreads = 256;
constexpr float kI16Scale = 32767.0f;  // ABS_I16_SCALE

__device__ __forceinline__ void put(float* o, float a) { *o = a; }
__device__ __forceinline__ void put(int16_t* o, float a) {
  *o = static_cast<int16_t>(__float2int_rn(__fmul_rn(a, kI16Scale)));
}

template <typename OutT>
__global__ void absorption_tail_kernel(const float* __restrict__ unit_tau,
                                       const float* __restrict__ nhi, int P,
                                       const float* __restrict__ taps,
                                       OutT* __restrict__ out) {
  extern __shared__ float raw[];  // [P]
  __shared__ float tp[kTaps];
  const int s = blockIdx.x;
  const int n_out = P - (kTaps - 1);
  if (threadIdx.x < kTaps) tp[threadIdx.x] = taps[threadIdx.x];
  const float nh = nhi[s];
  const float* tau = unit_tau + (size_t)s * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) raw[p] = expf(-nh * tau[p]);
  __syncthreads();
  OutT* o = out + (size_t)s * n_out;
  for (int p = threadIdx.x; p < n_out; p += blockDim.x) {
    float acc = tp[0] * raw[p];
    for (int k = 1; k < kTaps; ++k) acc = acc + tp[k] * raw[p + k];
    put(o + p, acc);
  }
}

template <typename OutT>
int launch(const float* unit_tau, const float* nhi, int S, int P, const float* taps,
           void* out, cudaStream_t stream) {
  const size_t smem = (size_t)P * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        absorption_tail_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  absorption_tail_kernel<OutT><<<S, kThreads, smem, stream>>>(
      unit_tau, nhi, P, taps, static_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// store 0 writes float32, 1 int16 codes.
extern "C" int absorption_tail_launch(const float* unit_tau, const float* nhi,
                                      int S, int P, const float* taps, int store,
                                      void* out, void* stream) {
  if (store != 0 && store != 1) return (int)cudaErrorInvalidValue;
  return store ? launch<int16_t>(unit_tau, nhi, S, P, taps, out, (cudaStream_t)stream)
               : launch<float>(unit_tau, nhi, S, P, taps, out, (cudaStream_t)stream);
}
