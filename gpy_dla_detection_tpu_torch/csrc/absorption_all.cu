// K1: fused broadened Voigt absorption for every column-density family.
//
// Replaces: gpy_dla_detection_tpu/ops/voigt_pallas.py : _abs_all_kernel
// (entry absorption_all_pallas), the default poly=True form.
//
// Per absorber sample s (redshift z_s) and pixel p, the unit optical depth
// sums over Lyman lines l the far-field Lorentzian where |z|^2 > 256^2
// (lines < far_lines) or, inside that radius, the per-line polynomial
// Faddeeva  Re w = exp(-u) + y_l * R_l(u)  (disk fit for u <= 9, wing fit
// beyond; coefficients from ops/voigt_kernels._window_poly_coeffs).  With
// lls_break (the LLS search's profile), tau starts from the Lyman-limit
// break per unit column density, 10^-17.2 t^3 with
// t = wl * (1 / (911.7641 (1 + z))) where t <= 1, in the reference kernel's
// operation order; otherwise from 0.  Then, per family f:
// out = conv7(exp(-nhi_f[s] * tau)).
//
// Bound on the card: transcendentals and FMAs per pixel (3 lines x ~25
// flops + 1 exp per line + 1 exp per family); the only device-memory
// traffic is z/nhi in and F x S x (P-6) floats out.
//
// Design: the TPU kernel placed chunk-aligned 256-pixel windows because
// Mosaic slices lanes only at 128-aligned offsets.  Here every pixel
// branches on its own |z|^2, which gives the window's values wherever the
// window covers the |z| <= 256 annulus (the reference guarantees that).
// One block per sample row: the row's tau and exp(-nhi*tau) stay in
// shared memory (2 x P floats, ~10 KB at P = 1,286 and ~13 KB at the LLS
// search's P = 1,670) for the 7-tap stencil, so the raw profile never
// reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kDiskCoeffs = 17;  // degree-16 disk fit
constexpr int kWingCoeffs = 11;  // degree-10 wing fit
// per line: lam, amp, y, y^2, disk coefficients, wing coefficients
constexpr int kLineStride = 4 + kDiskCoeffs + kWingCoeffs;
constexpr int kTaps = 7;
constexpr int kThreads = 256;
constexpr float kFarR2 = 256.0f * 256.0f;  // CF_FAR_RADIUS^2
constexpr float kU0 = 9.0f;                // disk/wing split in u = x^2
// float32 roundings of 911.7641 A (the Lyman limit) and 10^-17.2
constexpr float kLymanLimit = 911.7641f;
constexpr float kBreakScale = 6.3095732e-18f;

__global__ void absorption_all_kernel(
    const float* __restrict__ wl, int P, const float* __restrict__ z, int S,
    const float* __restrict__ nhi, int F,
    const float* __restrict__ line_params, int num_lines, int far_lines,
    int lls_break, float inv, float c_cgs, float sqrt_pi,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n_lp = num_lines * kLineStride + kTaps;
  float* lp = smem;
  float* tau = smem + n_lp;
  float* raw = tau + P;
  const int s = blockIdx.x;
  const int n_out = P - (kTaps - 1);

  for (int i = threadIdx.x; i < n_lp; i += blockDim.x) lp[i] = line_params[i];
  __syncthreads();

  const float one_plus_z = 1.0f + z[s];
  const float inv_limit = 1.0f / (kLymanLimit * one_plus_z);
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float w = wl[p];
    float t = 0.0f;
    if (lls_break) {
      const float r = w * inv_limit;  // rest wavelength over the limit
      t = r > 1.0f ? 0.0f : kBreakScale * r * r * r;
    }
    for (int l = 0; l < num_lines; ++l) {
      const float* c = lp + l * kLineStride;
      const float lam_c = c[0] * one_plus_z;
      const float x = (w - lam_c) * (c_cgs / lam_c) * inv;
      const float amp = c[1];
      const float y = c[2];
      const float u = x * x;
      const float r2 = u + c[3];
      if (r2 > kFarR2) {
        if (l < far_lines) t += amp * (y / (sqrt_pi * r2));
      } else {
        const float eu = expf(-u);
        float val;
        if (u <= kU0) {
          const float* cd = c + 4;
          const float sd = u * (2.0f / kU0) - 1.0f;
          float acc = cd[kDiskCoeffs - 1];
          for (int i = kDiskCoeffs - 2; i >= 0; --i) acc = acc * sd + cd[i];
          val = eu + y * acc;
        } else {
          const float* cw = c + 4 + kDiskCoeffs;
          const float tt = 1.0f / fmaxf(u, kU0);
          const float st = tt * (2.0f * kU0) - 1.0f;
          float acc = cw[kWingCoeffs - 1];
          for (int i = kWingCoeffs - 2; i >= 0; --i) acc = acc * st + cw[i];
          val = eu + y * tt * acc;
        }
        t += amp * val;
      }
    }
    tau[p] = t;
  }
  __syncthreads();

  const float* taps = lp + num_lines * kLineStride;
  for (int f = 0; f < F; ++f) {
    const float nh = nhi[(size_t)f * S + s];
    for (int p = threadIdx.x; p < P; p += blockDim.x) raw[p] = expf(-nh * tau[p]);
    __syncthreads();
    float* o = out + ((size_t)f * S + s) * n_out;
    for (int p = threadIdx.x; p < n_out; p += blockDim.x) {
      float acc = taps[0] * raw[p];
      for (int k = 1; k < kTaps; ++k) acc = acc + taps[k] * raw[p + k];
      o[p] = acc;
    }
    __syncthreads();  // raw is overwritten by the next family
  }
}

}  // namespace

extern "C" int absorption_all_launch(
    const float* wl, int P, const float* z, int S, const float* nhi, int F,
    const float* line_params, int num_lines, int far_lines, int lls_break,
    float inv, float c_cgs, float sqrt_pi, float* out, void* stream) {
  const size_t smem =
      (size_t)(num_lines * kLineStride + kTaps + 2 * P) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        absorption_all_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  absorption_all_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      wl, P, z, S, nhi, F, line_params, num_lines, far_lines, lls_break, inv,
      c_cgs, sqrt_pi, out);
  return (int)cudaGetLastError();
}
