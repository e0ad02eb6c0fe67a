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
// writes P - 6 outputs; the arithmetic is one exp and 7 FMAs per pixel.  At
// the catalog's S = 10,000, P = 1,286 that is ~103 MB, ~31 us at 3.35 TB/s.
//
// Design: the shared streaming tail of csrc/absorption_stencil.cuh (a lane
// owns consecutive pixels, a warp an even run of the rows' chunks, loads
// of later items in flight while the current one is computed, the halo
// from a per-warp ring).  The Source reads unit_tau's row run as vectors
// where the row allows: the catalog's rows of P = 1,286 floats are 16-byte
// aligned every other row and 8-byte aligned otherwise.  Any row count and
// any P: nothing of a row stays in shared memory (the earlier design kept
// the whole row there and refused P beyond it).  The TPU kernel padded S
// to its 8-aligned sample block; the rows' chunk sequence needs no padding.
//
// Storage: float32, or int16 fixed-point codes round(a * 32767) (the
// reference's GPY_DLA_ABS_DTYPE=i16 / i16p, its _encode_store), an
// instantiation of its own that differs only at the store.

#include "absorption_stencil.cuh"

namespace {

struct TailSource {
  const float* tau;
  int P;

  __device__ __forceinline__ void load(int s, int p0, int n,
                                       float (&v)[stencil::kPix]) const {
    stencil::load_run(tau + (size_t)s * P + p0, n, v);
  }
};

}  // namespace

// The geometry (warps a block, shared bytes, grid) comes from
// ops/voigt_kernels.tail_geometry; store 0 writes float32, 1 int16 codes.
extern "C" int absorption_tail_launch(const float* unit_tau, const float* nhi,
                                      int S, int P, const float* taps, int store,
                                      int warps, int smem, int grid, void* out,
                                      void* stream) {
  return stencil::launch(TailSource{unit_tau, P}, nhi, taps, S, P, store, warps, smem, grid,
                         out, (cudaStream_t)stream);
}
