// K1: fused broadened Voigt absorption for every column-density family.
//
// Replaces: gpy_dla_detection_tpu/ops/voigt_pallas.py : _abs_all_kernel
// (entry absorption_all_pallas), both of its window evaluators: the
// per-line polynomial (poly=True, the default) and the Weideman rational
// with the continued fraction (poly=False, the reference's
// GPY_DLA_FUSED_POLY=0).
//
// Per absorber sample s (redshift z_s) and pixel p, the unit optical depth
// sums over Lyman lines l the far-field Lorentzian where |z|^2 > 256^2
// (lines < far_lines) or, inside that radius, the line's window value:
//   poly=True:  Re w = exp(-u) + y_l R_l(u), u = x^2 (disk fit for u <= 9,
//               wing fit beyond; ops/voigt_kernels._window_poly_coeffs);
//   poly=False: the float32 Weideman rational (N = 20) where |z| <= 7, the
//               float32 continued fraction (K = 5) on the annulus beyond.
// With lls_break (the LLS search's profile), tau starts from the
// Lyman-limit break per unit column density, 10^-17.2 t^3 with
// t = wl * (1 / (911.7641 (1 + z))) where t <= 1; otherwise from 0.  Then,
// per family f: out = conv7(exp(-nhi_f[s] * tau)).
//
// Bound on the card: the output, F x S x (P - 6) floats (102 MB at the
// main path's S = 10,000, P = 1,286, F = 2: 0.0306 ms at 3.35 TB/s).  The
// work per byte is small but not nothing: per pixel and line a far-field
// term, per pixel and family an exp and 7 FMAs, and a window evaluation for
// the pixel-lines within 256 thermal widths of a line centre (~95 pixels a
// line).  Measured (PERF.md, K1): issue-bound at ~57% of the byte bound;
// the stores hide behind the arithmetic.  So the design spends few
// instructions and keeps the SM issuing:
//   - per (sample, line) constants (lam_c, x's scale, 1 / (911.7641 (1+z)))
//     are hoisted out of the pixel loop; the line table lives in
//     __constant__ memory (uniform reads are free operands), and the main
//     path's num_lines = 3 is a template instantiation with the lines
//     unrolled;
//   - the far field takes an approximate reciprocal (MUFU.RCP + FFMA);
//   - a line's window runs only when a pixel of the warp is in it (one
//     vote a line and step), and then in straight-line code for a lane's
//     four pixels at once (a branch a pixel ran them one after another);
//     the disk fit and exp(-u) behind a second vote, near the centre;
//   - exp(-nhi tau) is one ex2.approx of a hoisted -nhi log2(e) product.
// Layout: a lane owns 4 consecutive pixels (one 16-byte store of output),
// so a warp step is a 128-pixel chunk.  The rows' chunks form one sequence,
// and each warp takes an even run of it (Python's k1_geometry: 23 or 24
// chunks a warp at the main path, one wave), row piece by row piece.  The 6
// pixels of halo of the 7-tap stencil come from a per-warp ring in shared
// memory holding two chunks of exp(-nhi tau) per family: the step computes
// the NEXT chunk's tau and exps (or, past a piece's last chunk, the 6 halo
// pixels alone, one a lane) into the ring, then reads its own 10 values
// (LDS.128, LDS.128, LDS.64) for 4 outputs.  Only __syncwarp, no block
// barrier.
//
// float32 rounding: the Weideman window follows the twin
// (ops/voigt_kernels.absorption_all_reference) operation by operation, x
// and |z|^2 included; the polynomial window differs from it by a last bit
// (x's hoisted scale, |z|^2 and the fits by FMA, the wing's approximate
// reciprocal); both take the far field's approximate reciprocal and
// ex2.approx for the family exps (<= ~3e-7 of the absorption in all;
// TOL_K1 = 2e-6).
//
// Storage: float32, or int16 fixed-point codes round(a * 32767) (the
// reference's GPY_DLA_ABS_DTYPE=i16 / i16p, ops/kernel_config.py), an
// instantiation of its own.  Only the store differs: a lane's four values
// become four codes, rounded half to even from the correctly rounded
// product (as torch.round and jnp.round do; roundf would round half away
// from zero), in one 8-byte store where the row allows it.  The codes
// halve the output's bytes; a code is a float32 value's rounding, so the
// twin's codes differ by at most one where a value sits near a half-step.
// The kernel is issue-bound, and the encode's ~10 instructions a lane,
// step and family cost more than the halved store bytes save (on an H100,
// chip_smoke.py phase 14: +4-5% over float32 storage; rounding by adding
// 1.5 * 2^23 in place of __float2int_rn saved 0.0007 ms of it).

#include <cuda_runtime.h>

#include <cstdint>

// Pixels a thread, warps a block and blocks an SM (the launch bound), as
// ops/voigt_kernels.py's K1_PIXELS, K1_WARPS and K1_BLOCKS_PER_SM give them.
#ifndef K1_GEOMETRY
#define K1_GEOMETRY 4, 8, 4
#endif
// The stages compiled in: bit 0 the far field, bit 1 the windows, bit 2 the
// stores of the output.  ops/absorption_sweep.py rebuilds this file with one
// cleared to split the time by stage; the shipped kernel has all three.
#ifndef K1_STAGES
#define K1_STAGES 7
#endif

namespace {

template <int PIX, int WARPS, int BLOCKS>
struct GeometryOf {
  static constexpr int kPix = PIX, kWarps = WARPS, kBlocks = BLOCKS;
};
using Geometry = GeometryOf<K1_GEOMETRY>;
static_assert(Geometry::kPix == 4, "a lane's pixels are one float4");

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = K1_STAGES;
constexpr bool kFarField = kStages & 1, kWindows = kStages & 2, kStores = kStages & 4;
constexpr int kWarps = Geometry::kWarps;
constexpr int kChunk = 32 * Geometry::kPix;  // pixels a warp step
constexpr int kRing = 2 * kChunk;             // floats a family a warp
constexpr int kHalo = 6;                      // 7 taps
constexpr int kMaxFamilies = 6;               // families a launch

// The constant table (ops/voigt_kernels.py: _kernel_table writes it).
// Header:
constexpr int kInv = 0;       // 1 / (sqrt(2) sigma)
constexpr int kCgs = 1;       // c [cm/s]
constexpr int kSqrtPi = 2;
constexpr int kWeiTwoL = 3;   // 2 L of the Weideman rational
constexpr int kTapsAt = 8;    // the 7 instrument taps
constexpr int kWeiAt = 16;    // 20 Weideman coefficients, highest power first
constexpr int kWeiN = 20;
constexpr int kLinesAt = 40;  // then one record a line:
constexpr int kLineStride = 40;
constexpr int kLam = 0, kAmp = 1, kY = 2, kY2 = 3;
constexpr int kFar = 4;       // amp y / sqrt(pi): the far field is kFar / |z|^2
constexpr int kDr = 5, kDr2 = 6, kLmyDr = 7, kTwoDr = 8;  // L + y, its square,
                                                          // (L - y)(L + y), 2 (L + y)
constexpr int kDisk = 9;      // 17 disk coefficients, lowest power first
constexpr int kWing = 26;     // 11 wing coefficients
constexpr int kMaxLines = 31;
constexpr int kTableFloats = kLinesAt + kMaxLines * kLineStride;

constexpr float kFarR2 = 256.0f * 256.0f;  // CF_FAR_RADIUS^2
constexpr float kInnerR2 = 7.0f * 7.0f;    // RADIUS^2 of the Weideman disk
constexpr float kU0 = 9.0f;                // disk/wing split in u = x^2
// exp(-u) below half an ulp of the wing's y t S(u) for every line's y
constexpr float kExpNegligible = 50.0f;
constexpr int kCfTerms = 5;
constexpr float kCfEps = 1e-30f;
// float32 roundings of 911.7641 A (the Lyman limit) and 10^-17.2
constexpr float kLymanLimit = 911.7641f;
constexpr float kBreakScale = 6.3095732e-18f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kI16Scale = 32767.0f;  // ABS_I16_SCALE

__constant__ float c_tab[kTableFloats];

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The Weideman rational and the continued fraction are written op by op in
// round-to-nearest intrinsics, so the compiler contracts nothing: with the
// twin's order this gives the twin's bits.  Both cancel near a line centre
// (a ~1e-8 Re w from O(1) terms), and the LLS search's column densities
// turn a last-bit difference there into ~1e-3 of absorption.
#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn
#define DIV __fdiv_rn

// Re w(x + iy) by the float32 Weideman rational (x = |x| <= 7), in the
// order of ops/faddeeva._wofz_weideman.
__device__ __forceinline__ float weideman_re(int b, float x) {
  const float xx = MUL(x, x);
  const float inv_s = DIV(1.0f, ADD(c_tab[b + kDr2], xx));
  const float zr = MUL(SUB(c_tab[b + kLmyDr], xx), inv_s);
  const float zi = MUL(MUL(c_tab[kWeiTwoL], x), inv_s);
  float pr = c_tab[kWeiAt], pi = 0.0f;
#pragma unroll
  for (int i = 1; i < kWeiN; ++i) {
    const float nr = ADD(SUB(MUL(pr, zr), MUL(pi, zi)), c_tab[kWeiAt + i]);
    pi = ADD(MUL(pr, zi), MUL(pi, zr));
    pr = nr;
  }
  const float inv2_r = MUL(MUL(SUB(c_tab[b + kDr2], xx), inv_s), inv_s);
  const float inv2_i = MUL(MUL(MUL(c_tab[b + kTwoDr], x), inv_s), inv_s);
  return ADD(MUL(2.0f, SUB(MUL(pr, inv2_r), MUL(pi, inv2_i))),
             DIV(MUL(c_tab[b + kDr], inv_s), c_tab[kSqrtPi]));
}

// Re w(x + iy) by the float32 continued fraction, K = 5 terms, in the
// order of ops/faddeeva._wofz_cf (whose (n / 2) / d PyTorch evaluates as
// the reciprocal of d times n / 2).
__device__ __forceinline__ float cf_re(float x, float y) {
  float vr = x, vi = y;
#pragma unroll
  for (int n = kCfTerms; n >= 1; --n) {
    const float inv_v2 = MUL(DIV(1.0f, ADD(ADD(MUL(vr, vr), MUL(vi, vi)), kCfEps)), 0.5f * n);
    vr = SUB(x, MUL(vr, inv_v2));
    vi = ADD(y, MUL(vi, inv_v2));
  }
  return MUL(vi, DIV(1.0f, MUL(c_tab[kSqrtPi], ADD(ADD(MUL(vr, vr), MUL(vi, vi)), kCfEps))));
}

// A row's hoisted constants: 1 + z, the break's reciprocal and, for a
// compiled line count, each line's centre lam_c and x's scale: c / lam_c,
// or for the polynomial window (c / lam_c) / (sqrt(2) sigma) in one factor.
template <int NL, bool POLY>
struct Row {
  float opz, inv_limit;
  float lam_c[NL > 0 ? NL : 1], q[NL > 0 ? NL : 1];
};

template <int NL, bool POLY>
__device__ __forceinline__ Row<NL, POLY> row_constants(float z) {
  Row<NL, POLY> r;
  r.opz = 1.0f + z;
  r.inv_limit = 1.0f / (kLymanLimit * r.opz);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    r.lam_c[l] = c_tab[kLinesAt + l * kLineStride + kLam] * r.opz;
    r.q[l] = c_tab[kCgs] / r.lam_c[l];
    if (POLY) r.q[l] *= c_tab[kInv];
  }
  return r;
}

// Line l's share of the unit optical depth at this lane's N pixels.
//
// The polynomial window takes x = (w - lam_c) ((c / lam_c) / (sqrt(2)
// sigma)) and |z|^2 = fma(x, x, y^2), a last bit away from the twin's
// rounding (the fit is smooth, and at the far radius the far field and the
// window differ by 7.6e-6 of a small tau); the Weideman window, whose
// rational cancels near the centre, takes the twin's x and |z|^2 bit for bit.
template <int NL, bool POLY, int N>
__device__ __forceinline__ void add_line(int l, const Row<NL, POLY>& row, int far_lines,
                                         const float (&w)[N], float (&t)[N]) {
  static_assert(NL <= 16, "the compiled line counts are far-field lines");
  const int b = kLinesAt + l * kLineStride;
  float lam_c, q;
  if constexpr (NL > 0) {
    lam_c = row.lam_c[l];
    q = row.q[l];
  } else {
    lam_c = c_tab[b + kLam] * row.opz;
    q = c_tab[kCgs] / lam_c;
    if (POLY) q *= c_tab[kInv];
  }
  const bool far_line = NL > 0 || l < far_lines;
  float x[N], r2[N];
  bool near = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (POLY) {
      x[i] = (w[i] - lam_c) * q;
      r2[i] = fmaf(x[i], x[i], c_tab[b + kY2]);
    } else {
      x[i] = (w[i] - lam_c) * q * c_tab[kInv];
      r2[i] = ADD(MUL(x[i], x[i]), c_tab[b + kY2]);
    }
    const bool far = r2[i] > kFarR2;
    const float rf = rcp_approx(r2[i]);
    if (kFarField && far && far_line) t[i] = fmaf(c_tab[b + kFar], rf, t[i]);
    near |= !far;
  }
  if (!kWindows || !__any_sync(kFull, near)) return;
  // The window, for the warp's N pixels at once and without a branch a
  // pixel: a divergent branch would run the pixels' evaluations one after
  // another; straight-line code interleaves them.  Pixels outside the
  // window compute on and are masked at the end.
  const float y = c_tab[b + kY];
  float val[N];
  if constexpr (POLY) {
    // the wing fit (u > 9) for every pixel; the disk fit and exp(-u) only
    // where a pixel of the warp has u < kExpNegligible (the line centre's
    // chunk): beyond, exp(-u) is below half an ulp of the wing's value
    bool centre = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float u = MUL(x[i], x[i]);
      const float tt = rcp_approx(fmaxf(u, kU0));
      const float st = tt * (2.0f * kU0) - 1.0f;
      float acc = c_tab[b + kWing + 10];
#pragma unroll
      for (int k = 9; k >= 0; --k) acc = fmaf(acc, st, c_tab[b + kWing + k]);
      val[i] = y * tt * acc;
      centre |= !(r2[i] > kFarR2) && u < kExpNegligible;
    }
    if (__any_sync(kFull, centre)) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float u = MUL(x[i], x[i]);
        const float eu = expf(-u);
        const float sd = u * (2.0f / kU0) - 1.0f;
        float acc = c_tab[b + kDisk + 16];
#pragma unroll
        for (int k = 15; k >= 0; --k) acc = fmaf(acc, sd, c_tab[b + kDisk + k]);
        val[i] = u <= kU0 ? eu + y * acc : eu + val[i];
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (!(r2[i] > kFarR2)) t[i] = fmaf(c_tab[b + kAmp], val[i], t[i]);
  } else {
    // the continued fraction on the annulus for every pixel; the Weideman
    // rational only where a pixel of the warp is inside |z| <= 7
    bool inner = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      val[i] = cf_re(fabsf(x[i]), y);
      inner |= r2[i] <= kInnerR2;
    }
    if (__any_sync(kFull, inner)) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float wei = weideman_re(b, fabsf(x[i]));
        val[i] = r2[i] <= kInnerR2 ? wei : val[i];
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (!(r2[i] > kFarR2)) t[i] = ADD(t[i], MUL(c_tab[b + kAmp], val[i]));
  }
}

// A lane's four outputs at pixels q0..q0 + 3 of a row of n_out: one 16-byte
// (float32) or 8-byte (int16 codes) store where the row is aligned for it
// (vec) and holds all four, else one store a pixel.
__device__ __forceinline__ void store4(float* orow, int q0, int n_out, bool vec,
                                       const float (&o)[4]) {
  if (vec && q0 + 3 < n_out) {
    *reinterpret_cast<float4*>(orow + q0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (q0 + i < n_out) orow[q0 + i] = o[i];
  }
}

__device__ __forceinline__ int16_t encode_i16(float a) {
  return static_cast<int16_t>(__float2int_rn(__fmul_rn(a, kI16Scale)));
}

__device__ __forceinline__ void store4(int16_t* orow, int q0, int n_out, bool vec,
                                       const float (&o)[4]) {
  if (vec && q0 + 3 < n_out) {
    *reinterpret_cast<short4*>(orow + q0) =
        make_short4(encode_i16(o[0]), encode_i16(o[1]), encode_i16(o[2]), encode_i16(o[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (q0 + i < n_out) orow[q0 + i] = encode_i16(o[i]);
  }
}

// The unit optical depth at this lane's N pixels of wavelengths w.
template <int NL, bool POLY, int N>
__device__ __forceinline__ void unit_tau(const Row<NL, POLY>& row, int num_lines, int far_lines,
                                         bool lls_break, const float (&w)[N], float (&t)[N]) {
  if (lls_break) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float r = w[i] * row.inv_limit;  // rest wavelength over the limit
      t[i] = r > 1.0f ? 0.0f : kBreakScale * r * r * r;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = 0.0f;
  }
  if constexpr (NL > 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l) add_line<NL, POLY, N>(l, row, far_lines, w, t);
  } else {
    for (int l = 0; l < num_lines; ++l) add_line<NL, POLY, N>(l, row, far_lines, w, t);
  }
}

template <int NL, bool POLY, typename OutT>
__global__ void __launch_bounds__(32 * kWarps, Geometry::kBlocks)
absorption_all_kernel(const float* __restrict__ wl, int P, const float* __restrict__ z, int S,
                      const float* __restrict__ nhi, int F, int num_lines, int far_lines,
                      int lls_break, OutT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* const ring = reinterpret_cast<float*>(smem4) + warp * F * kRing;
  const int n_out = P - kHalo;
  const int nc = (n_out + kChunk - 1) / kChunk;
  // out is 16-byte aligned (checked), so a row's groups of 4 are aligned
  // for their store when a row is a whole number of them
  const bool vec_rows = (n_out & 3) == 0;
  // the rows' chunks in one sequence, row by row: warp w of the grid's T
  // takes chunks w C / T up to (w + 1) C / T, a run of whole or partial rows
  const long long chunks = (long long)S * nc;  // < 2^31 (checked)
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long wg = (long long)blockIdx.x * kWarps + warp;
  const int k_first = (int)(wg * chunks / nwarps), k_last = (int)((wg + 1) * chunks / nwarps);
  int s = k_first / nc, c0 = k_first - s * nc;

  for (int k = k_first; k < k_last; k += nc - c0, ++s, c0 = 0) {
    // the unit: row s, chunks c0 up to c1
    const int c1 = min(nc, c0 + (k_last - k));
    const Row<NL, POLY> row = row_constants<NL, POLY>(__ldg(z + s));
    float nl2[kMaxFamilies];  // -nhi log2(e) per family
#pragma unroll
    for (int f = 0; f < kMaxFamilies; ++f)
      nl2[f] = f < F ? -__ldg(nhi + (size_t)f * S + s) * kLog2e : 0.0f;

    // this lane's 4 pixels of chunk c: tau, then exp(-nhi tau) into the
    // ring's slot c & 1 for every family
    auto chunk_into_ring = [&](int c) {
      const int p0 = c * kChunk + 4 * lane;
      float w[4], t[4];
      if (p0 + 3 < P) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(wl + p0));
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __ldg(wl + min(p0 + i, P - 1));
      }
      unit_tau<NL, POLY, 4>(row, num_lines, far_lines, lls_break, w, t);
      float* slot = ring + (c & 1) * kChunk + 4 * lane;
#pragma unroll
      for (int f = 0; f < kMaxFamilies; ++f) {
        if (f >= F) break;
        *reinterpret_cast<float4*>(slot + f * kRing) =
            make_float4(ex2_approx(nl2[f] * t[0]), ex2_approx(nl2[f] * t[1]),
                        ex2_approx(nl2[f] * t[2]), ex2_approx(nl2[f] * t[3]));
      }
    };

    chunk_into_ring(c0);
    for (int c = c0; c < c1; ++c) {
      if (c + 1 < c1) {
        chunk_into_ring(c + 1);
      } else {
        // the 6 halo pixels past the unit, one a lane (every lane
        // computes, so the warp stays converged for its votes)
        const int p = (c + 1) * kChunk + lane;
        const float w[1] = {__ldg(wl + min(p, P - 1))};
        float t[1];
        unit_tau<NL, POLY, 1>(row, num_lines, far_lines, lls_break, w, t);
        if (lane < kHalo && p < P) {
          float* slot = ring + ((c + 1) & 1) * kChunk + lane;
#pragma unroll
          for (int f = 0; f < kMaxFamilies; ++f) {
            if (f >= F) break;
            slot[f * kRing] = ex2_approx(nl2[f] * t[0]);
          }
        }
      }
      __syncwarp();
      const int a = (c & 1) * kChunk + 4 * lane;
      const int q0 = c * kChunk + 4 * lane;
#pragma unroll
      for (int f = 0; f < kMaxFamilies; ++f) {
        if (f >= F) break;
        const float* rf = ring + f * kRing;
        const float4 v0 = *reinterpret_cast<const float4*>(rf + a);
        const float4 v1 = *reinterpret_cast<const float4*>(rf + ((a + 4) & (kRing - 1)));
        const float2 v2 = *reinterpret_cast<const float2*>(rf + ((a + 8) & (kRing - 1)));
        const float r[10] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, v2.x, v2.y};
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float acc = c_tab[kTapsAt] * r[i];
#pragma unroll
          for (int k = 1; k <= kHalo; ++k) acc = acc + c_tab[kTapsAt + k] * r[i + k];
          o[i] = acc;
        }
        // without the store stage, a store no profile takes (o >= 0) keeps
        // the arithmetic alive
        if (!kStores && !(o[0] + o[1] + o[2] + o[3] < 0.0f)) continue;
        store4(out + ((size_t)f * S + s) * n_out, q0, n_out, vec_rows, o);
      }
      __syncwarp();  // the next step overwrites slot c & 1
    }
  }
}

template <int NL, bool POLY, typename OutT>
int launch(const float* wl, int P, const float* z, int S, const float* nhi, int F,
           int num_lines, int far_lines, int lls_break, int smem, int grid,
           void* out, cudaStream_t stream) {
  absorption_all_kernel<NL, POLY, OutT><<<grid, 32 * kWarps, smem, stream>>>(
      wl, P, z, S, nhi, F, num_lines, far_lines, lls_break, static_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_window(int num_lines, bool poly, const float* wl, int P, const float* z, int S,
                  const float* nhi, int F, int far_lines, int lls_break, int smem, int grid,
                  void* out, cudaStream_t st) {
  if (num_lines == 3) {
    return poly ? launch<3, true, OutT>(wl, P, z, S, nhi, F, num_lines, far_lines, lls_break,
                                        smem, grid, out, st)
                : launch<3, false, OutT>(wl, P, z, S, nhi, F, num_lines, far_lines, lls_break,
                                         smem, grid, out, st);
  }
  return poly ? launch<0, true, OutT>(wl, P, z, S, nhi, F, num_lines, far_lines, lls_break,
                                      smem, grid, out, st)
              : launch<0, false, OutT>(wl, P, z, S, nhi, F, num_lines, far_lines, lls_break,
                                       smem, grid, out, st);
}

}  // namespace

// The line table: n floats of ops/voigt_kernels._kernel_table, copied into
// constant memory on the stream (before the kernels that read it).
extern "C" int absorption_all_upload(const float* table, int n, void* stream) {
  if (n < kLinesAt + kLineStride || n > kTableFloats) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbolAsync(c_tab, table, n * sizeof(float), 0,
                                      cudaMemcpyHostToDevice, (cudaStream_t)stream);
}

// The geometry (warps a block, shared bytes, grid) comes from
// k1_geometry; store 0 writes float32, 1 int16 codes.  Refused: a problem
// the kernel cannot index (S < 1, P <= 6, F outside 1..6, num_lines
// outside 1..31, far_lines outside 0..num_lines), S x chunks a row >=
// 2^31, a block of other than the compiled warps, shared memory short of
// the rings or beyond 48 KB, an empty grid, another store, and wavelengths
// or output not 16-byte aligned.
extern "C" int absorption_all_launch(const float* wl, int P, const float* z, int S,
                                     const float* nhi, int F, int num_lines, int far_lines,
                                     int lls_break, int poly, int store, int warps, int smem,
                                     int grid, void* out, void* stream) {
  const int nc = (P - kHalo + kChunk - 1) / kChunk;
  if (S < 1 || P <= kHalo || F < 1 || F > kMaxFamilies || num_lines < 1 ||
      num_lines > kMaxLines || far_lines < 0 || far_lines > num_lines ||
      (long long)S * nc >= (1LL << 31) || warps != kWarps || grid < 1 ||
      smem < F * kWarps * kRing * (int)sizeof(float) || smem > 48 * 1024 ||
      (store != 0 && store != 1) ||
      (reinterpret_cast<uintptr_t>(wl) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return store ? launch_window<int16_t>(num_lines, poly, wl, P, z, S, nhi, F, far_lines,
                                        lls_break, smem, grid, out, st)
               : launch_window<float>(num_lines, poly, wl, P, z, S, nhi, F, far_lines,
                                      lls_break, smem, grid, out, st);
}
