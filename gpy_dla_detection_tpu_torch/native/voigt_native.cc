// Native Voigt absorption kernels (C ABI shared library).
//
// The runtime twin of the reference's MEX extension (reference:
// voigt.c:253-304, which linked against libcerf).  This library
// implements the Faddeeva function itself — the same two-region scheme
// as the TPU kernel (Weideman rational approximation inside |z| <= 7,
// truncated continued fraction outside) — so the framework has a fast,
// dependency-free host compute path and an independent test oracle.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libvoigt_native.so voigt_native.cc -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr double kSqrtPi = 1.7724538509055160273;
constexpr double kRadius = 7.0;
constexpr int kWeidemanN = 40;
constexpr int kCFTerms = 14;
constexpr double kSpeedOfLightCgs = 2.99792458e10;

// Weideman (1994) polynomial coefficients, computed once at load time
// via the tangent-grid construction (no FFT needed at this size: use
// the direct trigonometric sum).
struct WeidemanCoeffs {
  double a[kWeidemanN];
  double L;
  WeidemanCoeffs() {
    const int m = 2 * kWeidemanN;
    L = std::sqrt(kWeidemanN / std::sqrt(2.0));
    // f(theta_k) on the shifted grid, k = -m+1 .. m-1
    const int n_pts = 2 * m - 1;
    std::vector<double> f(n_pts + 1, 0.0);  // f[0] = 0 prepended
    for (int i = 0; i < n_pts; ++i) {
      const double theta = M_PI * (i - m + 1) / m;
      const double t = L * std::tan(theta / 2.0);
      f[i + 1] = std::exp(-t * t) * (L * L + t * t);
    }
    // a_n = (1/2m) * Re sum_j fftshift(f)[j] exp(-2 pi i j n / 2m)
    // evaluate the DFT directly (2m = 80 points; negligible cost)
    const int total = 2 * m;
    std::vector<double> shifted(total, 0.0);
    // fftshift of [f0..f_{2m-1}] (length n_pts+1 = 2m)
    for (int i = 0; i < total; ++i)
      shifted[i] = f[(i + m) % total];
    for (int n = 1; n <= kWeidemanN; ++n) {
      double re = 0.0;
      for (int j = 0; j < total; ++j)
        re += shifted[j] * std::cos(2.0 * M_PI * j * n / total);
      a[kWeidemanN - n] = re / total;  // highest power first
    }
  }
};

const WeidemanCoeffs kW;

// Re/Im of w(x + iy) for y >= 0 (mirrors ops/faddeeva.py).
inline void wofz_parts(double x, double y, double* w_re, double* w_im) {
  const double sign = x < 0.0 ? -1.0 : 1.0;
  const double ax = std::fabs(x);
  if (ax * ax + y * y <= kRadius * kRadius) {
    const double L = kW.L;
    const double dr = L + y;
    const double s = dr * dr + ax * ax;
    const double inv_s = 1.0 / s;
    const double zr = ((L - y) * dr - ax * ax) * inv_s;
    const double zi = (2.0 * L * ax) * inv_s;
    double pr = kW.a[0], pi = 0.0;
    for (int i = 1; i < kWeidemanN; ++i) {
      const double t = pr * zr - pi * zi + kW.a[i];
      pi = pr * zi + pi * zr;
      pr = t;
    }
    const double inv2_r = (dr * dr - ax * ax) * inv_s * inv_s;
    const double inv2_i = 2.0 * dr * ax * inv_s * inv_s;
    *w_re = 2.0 * (pr * inv2_r - pi * inv2_i) + dr * inv_s / kSqrtPi;
    *w_im = sign * (2.0 * (pr * inv2_i + pi * inv2_r) + ax * inv_s / kSqrtPi);
  } else {
    double vr = ax, vi = y;
    for (int n = kCFTerms; n >= 1; --n) {
      const double an = n / 2.0;
      const double inv = an / (vr * vr + vi * vi);
      vr = ax - vr * inv;
      vi = y + vi * inv;
    }
    const double inv = 1.0 / (kSqrtPi * (vr * vr + vi * vi));
    *w_re = vi * inv;
    *w_im = sign * vr * inv;
  }
}

}  // namespace

extern "C" {

// Re[w(x + iy)] for arrays.
void faddeeva_real(const double* x, const double* y, double* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    double re, im;
    wofz_parts(x[i], y[i], &re, &im);
    out[i] = re;
  }
}

// Summed Lyman-series optical depth for `num_absorbers` absorbers over
// a shared wavelength grid, multithreaded over absorbers; the inner
// structure mirrors the reference MEX kernel (voigt.c:282-292) with
// exp + valid-mode 7-tap convolution fused
// (profile[i] = sum_k raw[i+k] * instrument[k]).
void voigt_absorption_batch(
    const double* wavelengths,        // (num_pixels,)
    const double* nhi,                // (num_absorbers,)
    const double* z_absorber,         // (num_absorbers,)
    const double* line_wavelengths,   // (num_lines,) [A]
    const double* leading_constants,  // (num_lines,)
    const double* lorentz_gamma,      // (num_lines,)
    double sigma,                     // thermal velocity [cm/s]
    const double* instrument_profile, // (2*width+1,) or null
    int width,                        // conv half width (0 = no broadening)
    int num_lines,
    int64_t num_pixels,
    int64_t num_absorbers,
    double* out,                      // (num_absorbers, num_pixels - 2*width)
    int num_threads) {
  const int64_t out_pixels = num_pixels - 2 * (instrument_profile ? width : 0);
  const double inv_sigma = 1.0 / (std::sqrt(2.0) * sigma);

  auto work = [&](int64_t a0, int64_t a1) {
    std::vector<double> raw(num_pixels);
    for (int64_t a = a0; a < a1; ++a) {
      const double one_pz = 1.0 + z_absorber[a];
      for (int64_t p = 0; p < num_pixels; ++p) raw[p] = 0.0;
      for (int l = 0; l < num_lines; ++l) {
        const double lam_c = line_wavelengths[l] * one_pz;
        const double vel_scale = kSpeedOfLightCgs / lam_c;
        const double amp = leading_constants[l] * inv_sigma / kSqrtPi;
        const double yy = lorentz_gamma[l] * inv_sigma;
        for (int64_t p = 0; p < num_pixels; ++p) {
          const double v = (wavelengths[p] - lam_c) * vel_scale;
          double re, im;
          wofz_parts(v * inv_sigma, yy, &re, &im);
          raw[p] += amp * re;
        }
      }
      for (int64_t p = 0; p < num_pixels; ++p)
        raw[p] = std::exp(-nhi[a] * raw[p]);
      double* dst = out + a * out_pixels;
      if (instrument_profile) {
        const int taps = 2 * width + 1;
        for (int64_t p = 0; p < out_pixels; ++p) {
          double acc = 0.0;
          for (int k = 0; k < taps; ++k) acc += raw[p + k] * instrument_profile[k];
          dst[p] = acc;
        }
      } else {
        for (int64_t p = 0; p < out_pixels; ++p) dst[p] = raw[p];
      }
    }
  };

  if (num_threads <= 1 || num_absorbers < 2) {
    work(0, num_absorbers);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (num_absorbers + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t a0 = t * chunk;
    const int64_t a1 = std::min<int64_t>(a0 + chunk, num_absorbers);
    if (a0 >= a1) break;
    threads.emplace_back(work, a0, a1);
  }
  for (auto& th : threads) th.join();
}

// As voigt_absorption_batch plus the Lyman-limit break opacity
// tau_break = nhi / 10^17.2 * (lambda_rest / 911.7641)^3 for rest
// wavelengths below the limit (mirrors ops/voigt.py
// voigt_absorption_lls; reference: voigt_lls.py:254-363).
void voigt_absorption_lls_batch(
    const double* wavelengths, const double* nhi, const double* z_absorber,
    const double* line_wavelengths, const double* leading_constants,
    const double* lorentz_gamma, double sigma,
    const double* instrument_profile, int width, int num_lines,
    int64_t num_pixels, int64_t num_absorbers, double* out,
    int num_threads) {
  const int64_t out_pixels = num_pixels - 2 * (instrument_profile ? width : 0);
  const double inv_sigma = 1.0 / (std::sqrt(2.0) * sigma);
  const double kLymanLimit = 911.7641;
  const double kBreakNorm = std::pow(10.0, 17.2);

  auto work = [&](int64_t a0, int64_t a1) {
    std::vector<double> raw(num_pixels);
    for (int64_t a = a0; a < a1; ++a) {
      const double one_pz = 1.0 + z_absorber[a];
      for (int64_t p = 0; p < num_pixels; ++p) raw[p] = 0.0;
      for (int l = 0; l < num_lines; ++l) {
        const double lam_c = line_wavelengths[l] * one_pz;
        const double vel_scale = kSpeedOfLightCgs / lam_c;
        const double amp = leading_constants[l] * inv_sigma / kSqrtPi;
        const double yy = lorentz_gamma[l] * inv_sigma;
        for (int64_t p = 0; p < num_pixels; ++p) {
          const double v = (wavelengths[p] - lam_c) * vel_scale;
          double re, im;
          wofz_parts(v * inv_sigma, yy, &re, &im);
          raw[p] += amp * re;
        }
      }
      for (int64_t p = 0; p < num_pixels; ++p) {
        double tau = nhi[a] * raw[p];
        const double rest = wavelengths[p] / one_pz;
        if (rest <= kLymanLimit) {
          const double r = rest / kLymanLimit;
          tau += nhi[a] / kBreakNorm * r * r * r;
        }
        raw[p] = std::exp(-tau);
      }
      double* dst = out + a * out_pixels;
      if (instrument_profile) {
        const int taps = 2 * width + 1;
        for (int64_t p = 0; p < out_pixels; ++p) {
          double acc = 0.0;
          for (int k = 0; k < taps; ++k) acc += raw[p + k] * instrument_profile[k];
          dst[p] = acc;
        }
      } else {
        for (int64_t p = 0; p < out_pixels; ++p) dst[p] = raw[p];
      }
    }
  };

  if (num_threads <= 1 || num_absorbers < 2) {
    work(0, num_absorbers);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (num_absorbers + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t a0 = t * chunk;
    const int64_t a1 = std::min<int64_t>(a0 + chunk, num_absorbers);
    if (a0 >= a1) break;
    threads.emplace_back(work, a0, a1);
  }
  for (auto& th : threads) th.join();
}

// CIV doublet absorption with a FREE per-absorber broadening velocity
// (mirrors ops/voigt.py voigt_absorption_civ; reference:
// voigt_civ.py:103-175).
void voigt_absorption_civ_batch(
    const double* wavelengths,        // (num_pixels,)
    const double* nciv,               // (num_absorbers,)
    const double* z_civ,              // (num_absorbers,)
    const double* sigma,              // (num_absorbers,) [cm/s]
    const double* line_wavelengths,   // (num_lines,) [A]
    const double* leading_constants,  // (num_lines,)
    const double* lorentz_gamma,      // (num_lines,)
    const double* instrument_profile, int width, int num_lines,
    int64_t num_pixels, int64_t num_absorbers, double* out,
    int num_threads) {
  const int64_t out_pixels = num_pixels - 2 * (instrument_profile ? width : 0);

  auto work = [&](int64_t a0, int64_t a1) {
    std::vector<double> raw(num_pixels);
    for (int64_t a = a0; a < a1; ++a) {
      const double one_pz = 1.0 + z_civ[a];
      const double inv_sigma = 1.0 / (std::sqrt(2.0) * sigma[a]);
      for (int64_t p = 0; p < num_pixels; ++p) raw[p] = 0.0;
      for (int l = 0; l < num_lines; ++l) {
        const double lam_c = line_wavelengths[l] * one_pz;
        const double vel_scale = kSpeedOfLightCgs / lam_c;
        const double amp = leading_constants[l] / kSqrtPi * inv_sigma;
        const double yy = lorentz_gamma[l] * inv_sigma;
        for (int64_t p = 0; p < num_pixels; ++p) {
          const double v = (wavelengths[p] - lam_c) * vel_scale;
          double re, im;
          wofz_parts(v * inv_sigma, yy, &re, &im);
          raw[p] += amp * re;
        }
      }
      for (int64_t p = 0; p < num_pixels; ++p)
        raw[p] = std::exp(-nciv[a] * raw[p]);
      double* dst = out + a * out_pixels;
      if (instrument_profile) {
        const int taps = 2 * width + 1;
        for (int64_t p = 0; p < out_pixels; ++p) {
          double acc = 0.0;
          for (int k = 0; k < taps; ++k) acc += raw[p + k] * instrument_profile[k];
          dst[p] = acc;
        }
      } else {
        for (int64_t p = 0; p < out_pixels; ++p) dst[p] = raw[p];
      }
    }
  };

  if (num_threads <= 1 || num_absorbers < 2) {
    work(0, num_absorbers);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (num_absorbers + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t a0 = t * chunk;
    const int64_t a1 = std::min<int64_t>(a0 + chunk, num_absorbers);
    if (a0 >= a1) break;
    threads.emplace_back(work, a0, a1);
  }
  for (auto& th : threads) th.join();
}

// Median-normalize + window + pad one spectrum (the hot host-side
// preprocessing loop of the production data loader; mirrors
// data/spectrum.py preprocess()).  Returns number of window pixels, or
// -1 on failure.
int64_t preprocess_spectrum(
    const double* wavelengths, const double* flux,
    const double* noise_variance, const uint8_t* pixel_mask,
    int64_t n, double z_qso,
    double norm_min, double norm_max,    // rest-frame normalization window
    double min_lambda, double max_lambda,  // rest-frame model window
    int64_t num_pixels_padded, double pixel_spacing, int pad_width,
    double* padded_wavelengths,  // (num_pixels_padded + 2*pad_width,)
    double* flux_out,            // (num_pixels_padded,)
    double* var_out,             // (num_pixels_padded,)
    uint8_t* mask_out,           // (num_pixels_padded,)
    double* median_out) {
  const double one_pz = 1.0 + z_qso;
  // median over the normalization window
  std::vector<double> norm_vals;
  norm_vals.reserve(256);
  for (int64_t i = 0; i < n; ++i) {
    const double rest = wavelengths[i] / one_pz;
    if (rest >= norm_min && rest <= norm_max && !pixel_mask[i] &&
        std::isfinite(flux[i]))
      norm_vals.push_back(flux[i]);
  }
  double median = 1.0;
  if (!norm_vals.empty()) {
    std::sort(norm_vals.begin(), norm_vals.end());
    const size_t m = norm_vals.size();
    median = (m % 2) ? norm_vals[m / 2]
                     : 0.5 * (norm_vals[m / 2 - 1] + norm_vals[m / 2]);
  }
  *median_out = median;
  const double inv_med = 1.0 / median;
  const double inv_med2 = inv_med * inv_med;

  // window pixels
  int64_t n_w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double rest = wavelengths[i] / one_pz;
    if (rest < min_lambda || rest > max_lambda) continue;
    if (n_w >= num_pixels_padded) return -1;
    padded_wavelengths[pad_width + n_w] = wavelengths[i];
    // validity is judged on the NORMALIZED values, matching the
    // Python twin (data/spectrum.py) — with a zero or non-finite
    // normalization median the scaled flux is inf/NaN and the pixel
    // must be masked, not passed through
    const double f_n = flux[i] * inv_med;
    const double v_n = noise_variance[i] * inv_med2;
    const bool valid = !pixel_mask[i] && std::isfinite(f_n) &&
                       std::isfinite(v_n);
    flux_out[n_w] = valid ? f_n : 0.0;
    var_out[n_w] = valid ? v_n : 1.0;
    mask_out[n_w] = valid ? 1 : 0;
    ++n_w;
  }
  if (n_w == 0) return -1;
  // pads: log-spaced continuation on both sides + tail fill
  const double lo = std::log10(padded_wavelengths[pad_width]);
  for (int k = 0; k < pad_width; ++k)
    padded_wavelengths[k] = std::pow(10.0, lo + pixel_spacing * (k - pad_width));
  const double hi = std::log10(padded_wavelengths[pad_width + n_w - 1]);
  const int64_t n_tail = num_pixels_padded - n_w + pad_width;
  for (int64_t k = 0; k < n_tail; ++k)
    padded_wavelengths[pad_width + n_w + k] =
        std::pow(10.0, hi + pixel_spacing * (k + 1));
  for (int64_t k = n_w; k < num_pixels_padded; ++k) {
    flux_out[k] = 0.0;
    var_out[k] = 1.0;
    mask_out[k] = 0;
  }
  return n_w;
}

}  // extern "C"
