// K6: broadened absorption from the unplaced windowed unit optical depth.
//
// Replaces: gpy_dla_detection_tpu/ops/voigt_pallas.py : _abs_windowed_kernel
// (entry absorption_windowed_pallas), float32 and int16 storage.
//
// Per sample row s: tau = far[s] (P_pad pixels, a multiple of 128), then for
// each line l in order, tau[c0[s, l] * 128 + i] += corr[s, l * 256 + i] for
// i < 256; then, for the first P pixels,
//   out[s, p] = sum_{k<7} taps[k] * exp(-nhi[s] * tau[p + k])   (p < P - 6).
//
// Bound on the card: device-memory bytes.  Each row reads P_pad + 256 L
// floats, L ints and nhi, and writes P - 6 floats; the arithmetic is 256 L
// adds, one exp and 7 FMAs per pixel.  At the unfused configuration's
// S = 10,000, P_pad = 1,408, L = 3 that is ~138 MB, ~41 us at 3.35 TB/s.
//
// Design: the TPU kernel tiled each half-window across all chunks
// (pltpu.repeat) and selected by chunk id, because Mosaic cannot slice
// lanes at a row-dependent offset.  Here one block per sample row loads the
// far field into dynamic shared memory (5.6 KB at P_pad = 1,408) and adds
// each line's 256 corrections at its own offset.  Windows of different
// lines may overlap (higher Lyman lines crowd together), so the lines are
// added one after another with a barrier between them.  exp(-nhi * tau)
// overwrites tau in place, and the 7-tap stencil reads it from shared
// memory, so neither the placed tau nor the raw profile reaches device
// memory.  A window pixel outside [0, P_pad) is dropped, as the reference's
// chunk-id select drops it; c0 is clipped to [0, nc - 2] by construction.
//
// Storage: float32, or int16 fixed-point codes round(a * 32767) (the
// reference's GPY_DLA_ABS_DTYPE=i16 / i16p, its _encode_store), an
// instantiation of its own that differs only at the store, as K5's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 7;
constexpr int kChunk = 128;
constexpr int kWindow = 256;
constexpr int kThreads = 256;
constexpr float kI16Scale = 32767.0f;  // ABS_I16_SCALE

__device__ __forceinline__ void put(float* o, float a) { *o = a; }
__device__ __forceinline__ void put(int16_t* o, float a) {
  *o = static_cast<int16_t>(__float2int_rn(__fmul_rn(a, kI16Scale)));
}

template <typename OutT>
__global__ void absorption_windowed_kernel(
    const float* __restrict__ far, const float* __restrict__ corr,
    const int* __restrict__ c0, const float* __restrict__ nhi, int P_pad,
    int P, int L, const float* __restrict__ taps, OutT* __restrict__ out) {
  extern __shared__ float tau[];  // [P_pad]
  __shared__ float tp[kTaps];
  const int s = blockIdx.x;
  const int n_out = P - (kTaps - 1);
  if (threadIdx.x < kTaps) tp[threadIdx.x] = taps[threadIdx.x];
  const float* row = far + (size_t)s * P_pad;
  for (int p = threadIdx.x; p < P_pad; p += blockDim.x) tau[p] = row[p];
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int start = c0[(size_t)s * L + l] * kChunk;
    const float* cw = corr + ((size_t)s * L + l) * kWindow;
    for (int i = threadIdx.x; i < kWindow; i += blockDim.x) {
      const int p = start + i;
      if (p >= 0 && p < P_pad) tau[p] += cw[i];
    }
    __syncthreads();  // the next line's window may overlap this one
  }

  const float nh = nhi[s];
  for (int p = threadIdx.x; p < P; p += blockDim.x) tau[p] = expf(-nh * tau[p]);
  __syncthreads();
  OutT* o = out + (size_t)s * n_out;
  for (int p = threadIdx.x; p < n_out; p += blockDim.x) {
    float acc = tp[0] * tau[p];
    for (int k = 1; k < kTaps; ++k) acc = acc + tp[k] * tau[p + k];
    put(o + p, acc);
  }
}

template <typename OutT>
int launch(const float* far, const float* corr, const int* c0, const float* nhi, int S,
           int P_pad, int P, int L, const float* taps, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)P_pad * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        absorption_windowed_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  absorption_windowed_kernel<OutT><<<S, kThreads, smem, stream>>>(
      far, corr, c0, nhi, P_pad, P, L, taps, static_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// store 0 writes float32, 1 int16 codes.
extern "C" int absorption_windowed_launch(const float* far, const float* corr,
                                          const int* c0, const float* nhi,
                                          int S, int P_pad, int P, int L,
                                          const float* taps, int store, void* out,
                                          void* stream) {
  if (store != 0 && store != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return store ? launch<int16_t>(far, corr, c0, nhi, S, P_pad, P, L, taps, out, st)
               : launch<float>(far, corr, c0, nhi, S, P_pad, P, L, taps, out, st);
}
