// civ_tau: the CIV doublet's unit optical depth, the (S, P) input of K5
// (absorption_tail), for S samples of (z, sigma) on one padded grid.
//
// No TPU kernel: the JAX package evaluates the doublet in plain XLA
// (gpy_dla_detection_tpu/ops/voigt.py: voigt_absorption_civ through the
// blended Faddeeva of ops/faddeeva.py), and so did the port, in plain
// PyTorch: ~520 elementwise launches a spectrum over (S, P) temporaries, 14
// ms of device time at the CIV head's S = 10,000, P = 774, where K5 after it
// takes 0.024 ms.  This kernel evaluates the same function in registers and
// writes the unit optical depth alone.  Its plain twin, the earlier
// composition, is ops/voigt_kernels.civ_unit_tau_reference.
//
// Per sample s and pixel p, with the float32 roundings of the twin:
//   inv = 1 / (sqrt(2) sigma_s);  per line l (CIV 1548, 1550):
//   lam_c = lam_l (1 + z_s),  x = |(wl_p - lam_c) (c / lam_c) inv|,
//   y = gamma_l inv;  Re w(x + iy) by the float32 Weideman rational (N = 20)
//   where x^2 + y^2 <= 7^2, by the float32 continued fraction (K = 5) beyond;
//   tau[s, p] = sum_l ((a_l / sqrt(pi)) inv) Re w.
// The imaginary part, which the stage never reads, is not computed.
//
// Bound on the card: the output, 4 S P bytes (31 MB at S = 10,000, P = 774:
// 9.2 us at 3.35 TB/s).  The arithmetic lies far above it: at every pixel
// and line the continued fraction takes 6 correctly rounded divisions and
// ~40 other operations, so the kernel is issue-bound.  The design:
//   - a warp walks an even run of the rows' steps (the rows' sequence, as
//     K1 walks its chunks) and computes the row's constants once a run:
//     1 + z, inv, and per line lam_c, c / lam_c, y, y^2, the amplitude and
//     the Weideman terms that depend on y (L + y, (L + y)^2, (L - y)(L + y),
//     2 (L + y)), so a pixel starts from x;
//   - the continued fraction, which divides at every term, keeps the
//     twin's correctly rounded divisions (a reciprocal approximation would
//     move its bits); what the design does about their latency is to
//     interleave the two lines' independent chains in a lane, with the
//     launch bound leaving enough warps resident (48 an SM);
//   - the Weideman rational (19 complex multiply-adds and 2 divisions) runs
//     only where a pixel of the warp's step lies inside its line's disk,
//     one vote a line and step.  At sigma = 1e6 to 8e6 cm/s the disk spans
//     +-1.5 to +-12 pixels of SDSS's 69 km/s around a centre, so a step is
//     32 pixels, a pixel a lane, few of which reach the disk;
//   - a warp's step stores one 128-byte line of a row.
// On an H100 at S = 10,000, P = 774 (CUDA events, PERF.md) the shipped
// geometry, 8 warps a block and 6 blocks an SM, takes 0.114 ms, the fastest
// of a sweep: 4 blocks an SM 0.120; 8 blocks 0.116 (32 registers, spills);
// two pixels a lane (8-byte stores, 64-pixel steps) 0.116; four pixels a
// lane (16-byte stores, 128-pixel steps, as K1) 0.140.  A store is the
// same 128-byte line whatever its width, and a wider step runs the
// Weideman rational for more pixels.
//
// float32 rounding: every operation follows the twin's order in
// round-to-nearest intrinsics, so nothing is contracted into an FMA; on an
// H100 the kernel gives the card's twin's bits (and the CPU twin's) at every
// pixel.  The division by sqrt(pi) at the Weideman sum's end stays a
// division: near a line centre the sum cancels, and a product by the
// reciprocal would move its last bit.

#include <cuda_runtime.h>

#include <cstring>

// Warps a block and blocks an SM (the launch bound), as
// ops/voigt_kernels.py's CIV_TAU_WARPS and CIV_TAU_BLOCKS_PER_SM give them.
#ifndef CIV_TAU_GEOMETRY
#define CIV_TAU_GEOMETRY 8, 6
#endif

namespace {

template <int WARPS, int BLOCKS>
struct GeometryOf {
  static constexpr int kWarps = WARPS, kBlocks = BLOCKS;
};
using Geometry = GeometryOf<CIV_TAU_GEOMETRY>;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = Geometry::kWarps;
constexpr int kStep = 32;  // pixels a warp step: one a lane
constexpr int kMaxLines = 2;
constexpr int kWeiN = 20;
constexpr int kCfTerms = 5;
constexpr float kInnerR2 = 7.0f * 7.0f;  // RADIUS^2 of the Weideman disk

// The constants, float32 in the twin's rounding (ops/voigt_kernels.py,
// civ_tau_constants, writes them in this order), passed by value: the
// kernel reads them as uniform operands.
struct Constants {
  float L, two_L, sqrt_pi, sqrt2, c, eps;  // c in cm/s; eps the continued fraction's 1e-30
  float lam[kMaxLines];    // rest wavelengths [A]
  float gamma[kMaxLines];  // Lorentzian widths [cm/s]
  float amp[kMaxLines];    // a_l / sqrt(pi)
  float wei[kWeiN];        // Weideman coefficients, highest power first
};
constexpr int kConstantFloats = (int)(sizeof(Constants) / sizeof(float));

#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn
#define DIV __fdiv_rn

// A line's constants for one row.
struct Line {
  float lam_c, q, y, y2, amp, dr, dr2, lmy_dr, two_dr;
};

__device__ __forceinline__ Line line_constants(const Constants& k, int l, float opz,
                                               float inv) {
  Line r;
  r.lam_c = MUL(k.lam[l], opz);
  r.q = MUL(DIV(1.0f, r.lam_c), k.c);  // c / lam_c as PyTorch takes it: 1 / lam_c, times c
  r.y = MUL(k.gamma[l], inv);
  r.y2 = MUL(r.y, r.y);
  r.amp = MUL(k.amp[l], inv);
  r.dr = ADD(r.y, k.L);
  r.dr2 = MUL(r.dr, r.dr);
  r.lmy_dr = MUL(SUB(k.L, r.y), r.dr);
  r.two_dr = MUL(2.0f, r.dr);
  return r;
}

// Re w(x + iy) by the float32 Weideman rational (x = |x|, xx = x^2), in the
// order of ops/faddeeva._wofz_weideman.
__device__ __forceinline__ float weideman_re(const Constants& k, const Line& ln, float x,
                                             float xx) {
  const float inv_s = DIV(1.0f, ADD(ln.dr2, xx));
  const float zr = MUL(SUB(ln.lmy_dr, xx), inv_s);
  const float zi = MUL(MUL(x, k.two_L), inv_s);
  float pr = k.wei[0], pi = 0.0f;
#pragma unroll
  for (int i = 1; i < kWeiN; ++i) {
    const float nr = ADD(SUB(MUL(pr, zr), MUL(pi, zi)), k.wei[i]);
    pi = ADD(MUL(pr, zi), MUL(pi, zr));
    pr = nr;
  }
  const float inv2_r = MUL(MUL(SUB(ln.dr2, xx), inv_s), inv_s);
  const float inv2_i = MUL(MUL(MUL(ln.two_dr, x), inv_s), inv_s);
  return ADD(MUL(SUB(MUL(pr, inv2_r), MUL(pi, inv2_i)), 2.0f),
             DIV(MUL(ln.dr, inv_s), k.sqrt_pi));
}

// Re w(x + iy) by the float32 continued fraction, K = 5 terms, in the order
// of ops/faddeeva._wofz_cf (whose (n / 2) / d PyTorch takes as 1 / d times
// n / 2).
__device__ __forceinline__ float cf_re(const Constants& k, float x, float y) {
  float vr = x, vi = y;
#pragma unroll
  for (int n = kCfTerms; n >= 1; --n) {
    const float inv_v2 = MUL(DIV(1.0f, ADD(ADD(MUL(vr, vr), MUL(vi, vi)), k.eps)), 0.5f * n);
    vr = SUB(x, MUL(vr, inv_v2));
    vi = ADD(y, MUL(vi, inv_v2));
  }
  return MUL(vi, DIV(1.0f, MUL(ADD(ADD(MUL(vr, vr), MUL(vi, vi)), k.eps), k.sqrt_pi)));
}

template <int NL>
__global__ void __launch_bounds__(32 * kWarps, Geometry::kBlocks)
civ_tau_kernel(const float* __restrict__ wl, int P, const float* __restrict__ z,
               const float* __restrict__ sigma, int S, const Constants k,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nu = (P + kStep - 1) / kStep;  // steps a row
  // the rows' steps in one sequence, row by row: warp w of the grid's T
  // takes steps w U / T up to (w + 1) U / T, a run of whole or partial rows
  const long long steps = (long long)S * nu;  // < 2^31 (checked)
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long wg = (long long)blockIdx.x * kWarps + warp;
  const int k_first = (int)(wg * steps / nwarps), k_last = (int)((wg + 1) * steps / nwarps);
  int s = k_first / nu, u0 = k_first - s * nu;

  for (int kk = k_first; kk < k_last; kk += nu - u0, ++s, u0 = 0) {
    // the piece: row s, steps u0 up to u1
    const int u1 = min(nu, u0 + (k_last - kk));
    const float opz = ADD(__ldg(z + s), 1.0f);
    const float inv = DIV(1.0f, MUL(__ldg(sigma + s), k.sqrt2));
    Line ln[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) ln[l] = line_constants(k, l, opz, inv);
    float* const orow = out + (size_t)s * P;

    for (int u = u0; u < u1; ++u) {
      // this lane's pixel; past the row's end a lane computes the last
      // pixel again (the warp stays converged for its votes) and stores
      // nothing
      const int p = u * kStep + lane;
      const float w = __ldg(wl + min(p, P - 1));
      float x[NL], xx[NL], re[NL];
      bool inner[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        x[l] = fabsf(MUL(MUL(SUB(w, ln[l].lam_c), ln[l].q), inv));
        xx[l] = MUL(x[l], x[l]);
        inner[l] = ADD(xx[l], ln[l].y2) <= kInnerR2;
      }
      // the continued fraction for every line: independent chains, in
      // straight-line code
#pragma unroll
      for (int l = 0; l < NL; ++l) re[l] = cf_re(k, x[l], ln[l].y);
      // the Weideman rational where a pixel of the warp's step is in the disk
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (__any_sync(kFull, inner[l])) {
          const float wei = weideman_re(k, ln[l], x[l], xx[l]);
          if (inner[l]) re[l] = wei;
        }
      }
      float t = MUL(ln[0].amp, re[0]);
#pragma unroll
      for (int l = 1; l < NL; ++l) t = ADD(t, MUL(ln[l].amp, re[l]));
      if (p < P) orow[p] = t;
    }
  }
}

}  // namespace

// The geometry (warps a block, grid) comes from
// ops/voigt_kernels.civ_tau_grid; constants are the n host floats of
// civ_tau_constants.  Refused: a problem the kernel cannot index (S < 1,
// P < 1, S x steps a row >= 2^31), num_lines outside 1..2, another count of
// constants, a block of other than the compiled warps and an empty grid.
extern "C" int civ_tau_launch(const float* wl, int P, const float* z, const float* sigma, int S,
                              int num_lines, const float* constants, int n_constants, int warps,
                              int grid, float* out, void* stream) {
  if (S < 1 || P < 1 || (long long)S * ((P + kStep - 1) / kStep) >= (1LL << 31) ||
      num_lines < 1 || num_lines > kMaxLines || n_constants != kConstantFloats ||
      warps != kWarps || grid < 1)
    return (int)cudaErrorInvalidValue;
  Constants k;
  std::memcpy(&k, constants, sizeof k);
  cudaStream_t st = (cudaStream_t)stream;
  if (num_lines == 2)
    civ_tau_kernel<2><<<grid, 32 * kWarps, 0, st>>>(wl, P, z, sigma, S, k, out);
  else
    civ_tau_kernel<1><<<grid, 32 * kWarps, 0, st>>>(wl, P, z, sigma, S, k, out);
  return (int)cudaGetLastError();
}
