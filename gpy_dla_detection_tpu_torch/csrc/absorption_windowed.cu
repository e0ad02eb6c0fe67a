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
// Bound on the card: device-memory bytes.  The function needs far's first
// P pixels, the window pixels below P, L ints and nhi a row, and writes
// P - 6 outputs; the arithmetic is an add per window pixel, one exp and 7
// FMAs per pixel.  At the unfused configuration's S = 10,000, P = 1,286,
// L = 3 that is ~133 MB, ~40 us at 3.35 TB/s.
//
// Design: the TPU kernel tiled each half-window across all chunks
// (pltpu.repeat) and selected by chunk id, because Mosaic cannot slice
// lanes at a row-dependent offset; the earlier CUDA design loaded the far
// field into shared memory and added the windows line by line with a block
// barrier after each.  Here the placement is a gather a pixel, inside the
// shared streaming tail of csrc/absorption_stencil.cuh: for a lane's run of
// pixels p,
//   tau = far[p], then for l = 0 .. L - 1 in order,
//   if ((unsigned)(p - 128 c0[l]) < 256) tau += corr[l][p - 128 c0[l]],
// so overlapping windows (higher Lyman lines crowd together) add in the
// twin's order (ops/voigt.place_windows) and give its bits.  A lane's run
// lies wholly inside or outside a window (runs and window starts are
// multiples of 4 pixels), so a window is one or two float4 loads.  Only
// pixels below P are read: far[P:P_pad] and the window pixels beyond P
// never are.  c0 is clipped to [0, nc - 2] by construction.
//
// Storage: float32, or int16 fixed-point codes round(a * 32767) (the
// reference's GPY_DLA_ABS_DTYPE=i16 / i16p, its _encode_store), an
// instantiation of its own that differs only at the store, as K5's.

#include "absorption_stencil.cuh"

namespace {

constexpr int kWindowChunk = 128;  // ops/voigt.CHUNK
constexpr int kWindow = 256;       // ops/voigt.FAST_WINDOW
static_assert(kWindowChunk % stencil::kPix == 0 && kWindow % stencil::kPix == 0,
              "a lane's run lies wholly inside or outside a window");

struct WindowedSource {
  const float* far;
  const float* corr;
  const int* c0;
  int P_pad, L;

  __device__ __forceinline__ void load(int s, int p0, int n,
                                       float (&v)[stencil::kPix]) const {
    stencil::load_run(far + (size_t)s * P_pad + p0, n, v);
    if (n <= 0) return;
    for (int l = 0; l < L; ++l) {
      const int off = p0 - kWindowChunk * __ldg(c0 + (size_t)s * L + l);
      if ((unsigned)off < (unsigned)kWindow) {
        float w[stencil::kPix];
        stencil::load_run(corr + ((size_t)s * L + l) * kWindow + off, n, w);
#pragma unroll
        for (int j = 0; j < stencil::kPix; ++j) v[j] = v[j] + w[j];
      }
    }
  }
};

}  // namespace

// The geometry (warps a block, shared bytes, grid) comes from
// ops/voigt_kernels.tail_geometry at P; store 0 writes float32, 1 int16
// codes.  Refused besides the tail's refusals: P_pad short of P or no
// multiple of 128, L < 1.
extern "C" int absorption_windowed_launch(const float* far, const float* corr,
                                          const int* c0, const float* nhi,
                                          int S, int P_pad, int P, int L,
                                          const float* taps, int store, int warps, int smem,
                                          int grid, void* out, void* stream) {
  if (P_pad < P || P_pad % kWindowChunk || L < 1) return (int)cudaErrorInvalidValue;
  return stencil::launch(WindowedSource{far, corr, c0, P_pad, L}, nhi, taps, S, P, store,
                         warps, smem, grid, out, (cudaStream_t)stream);
}
