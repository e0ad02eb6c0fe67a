"""Quasi-Monte-Carlo parameter samples for absorber marginalization.

Native replacement for the MATLAB sample generators (reference:
generate_dla_samples.m:8-57, multi_dlas/set_lls_parameters.m:1-70) and
the .mat loaders (reference: gpy_dla_detection/dla_samples.py:53-131,
subdla_samples.py:66-125).  The column-density prior is the Garnett
(2017) mixture

    p(logNHI) = alpha * N_trunc(m, s; [fit_min, 25]) + (1 - alpha) * U[20, 23]

whose data-driven component ``exp(-1.2695 x^2 + 50.863 x - 509.33)``
is a (truncated, unnormalized) Gaussian, so the CDF is analytic in
``erf`` and inverse-transform sampling reduces to vectorized bisection
(the reference calls scalar ``fzero``/``quad`` per sample).

The low-discrepancy sequence is a standard Halton set (bases 2/3/5);
the reference uses MATLAB's reverse-radix-scrambled Halton.  Only the
distribution matters downstream — both are uniform low-discrepancy
sets — and ``.mat``-file loading (data/loaders.py) reproduces the
reference's exact samples when bit-parity is required.

The port's own copy of ``gpy_dla_detection_tpu/data/samples.py`` (numpy
only), kept equal to it name for name and number for number so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.special import erf

from ..params import Parameters

# Garnett (2017) quadratic fit to log p(logNHI) (reference:
# dla_samples.py:115-117): exp(-A x^2 + B x + C)
_FIT_A = 1.2695
_FIT_B = 50.863
_FIT_C = -509.33
_FIT_UPPER = 25.0  # hard-coded integration upper limit (dla_samples.py:118)

# analytic peak of the quadratic fit, used as the extrapolation point of
# the subDLA prior (reference: set_lls_parameters.m:52-55)
_FIT_PEAK = 20.03269


class LogNHIFit(NamedTuple):
    """Quadratic fit to the log column-density prior:
    p(logNHI) ~ exp(-A x^2 + B x + C).  The published Garnett (2017)
    coefficients are the default everywhere; :func:`fit_log_nhi_prior`
    re-derives them from a catalog's own DLAs like the MATLAB generator
    (reference: generate_dla_samples.m:21-54)."""

    A: float
    B: float
    C: float

    @property
    def peak(self) -> float:
        """argmax of the fit pdf (reference: set_lls_parameters.m:52)."""
        return self.B / (2.0 * self.A)


GARNETT_FIT = LogNHIFit(_FIT_A, _FIT_B, _FIT_C)


def fit_log_nhi_prior(
    log_nhis: np.ndarray, params: Parameters, num_points: int = 1000
) -> LogNHIFit:
    """Re-derive the column-density prior from observed DLA logNHIs:
    Gaussian KDE evaluated on [fit_min, fit_max], then a quadratic fit
    to the log density (reference: generate_dla_samples.m:33-37).

    The KDE bandwidth is MATLAB ``ksdensity``'s default normal-reference
    rule: sigma_robust * (4 / (3 n))^(1/5) with
    sigma_robust = min(std, IQR/1.349).
    """
    log_nhis = np.asarray(log_nhis, np.float64).ravel()
    log_nhis = log_nhis[np.isfinite(log_nhis)]
    n = log_nhis.size
    if n < 2:
        raise ValueError(f"need at least 2 logNHI values, got {n}")
    x = np.linspace(params.fit_min_log_nhi, params.fit_max_log_nhi, num_points)
    std = np.std(log_nhis, ddof=1)
    iqr = float(np.subtract(*np.percentile(log_nhis, [75.0, 25.0])))
    sigma = min(std, iqr / 1.349) or std
    if sigma <= 0:
        raise ValueError(
            "logNHI values are all (nearly) identical — the KDE "
            "bandwidth degenerates; a catalog-driven prior needs spread"
        )
    bw = sigma * (4.0 / (3.0 * n)) ** 0.2
    # chunk over evaluation points: (num_points, n) can be ~1000 x 100k
    kde = np.empty_like(x)
    for s in range(0, num_points, 128):
        sl = slice(s, min(s + 128, num_points))
        kde[sl] = np.mean(
            np.exp(-0.5 * ((x[sl, None] - log_nhis[None, :]) / bw) ** 2), axis=1
        ) / (bw * np.sqrt(2.0 * np.pi))
    # fit only where the KDE is strictly positive: with a tiny
    # bandwidth the kernels underflow to exactly 0 at the grid edges,
    # and log(0) = -inf would make polyfit return NaN coefficients
    pos = kde > 0
    if pos.sum() < 10:
        raise ValueError(
            "KDE support covers too little of the logNHI fit range; a "
            "catalog-driven prior needs spread across the fit window"
        )
    f2, f1, f0 = np.polyfit(x[pos], np.log(kde[pos]), 2)
    if not (f2 < 0):  # also rejects NaN
        raise ValueError(
            "quadratic log-pdf fit is not concave; the catalog's logNHI "
            "distribution does not support the Gaussian-mixture prior"
        )
    return LogNHIFit(A=-float(f2), B=float(f1), C=float(f0))


class DLASamples(NamedTuple):
    """QMC samples of (z offset, logNHI) plus the prior's metadata."""

    offset_samples: np.ndarray  # (S,) uniform [0, 1) low-discrepancy
    log_nhi_samples: np.ndarray  # (S,)
    nhi_samples: np.ndarray  # (S,)
    alpha: float
    uniform_min_log_nhi: float
    uniform_max_log_nhi: float
    fit_min_log_nhi: float


class SubDLASamples(NamedTuple):
    offset_samples: np.ndarray
    log_nhi_samples: np.ndarray
    nhi_samples: np.ndarray
    # partition functions re-weighting the subDLA model prior
    # (reference: subdla_gp.py:311-346)
    Z_lls: float
    Z_dla: float


def halton_sequence(n: int, dim: int, skip: int = 0) -> np.ndarray:
    """Radical-inverse Halton sequence in bases (2, 3, 5, ...): (n, dim)."""
    primes = [2, 3, 5, 7, 11]
    if dim > len(primes):
        raise ValueError(
            f"halton_sequence supports up to {len(primes)} dimensions, "
            f"got {dim}"
        )
    bases = primes[:dim]
    out = np.empty((n, dim))
    idx = np.arange(skip + 1, skip + n + 1, dtype=np.int64)
    for d, b in enumerate(bases):
        x = np.zeros(n)
        denom = 1.0
        i = idx.copy()
        while np.any(i > 0):
            denom *= b
            x += (i % b) / denom
            i //= b
        out[:, d] = x
    return out


def _gaussian_fit_integral(lo, hi, fit: LogNHIFit = GARNETT_FIT):
    """integral of exp(-A x^2 + B x + C) over [lo, hi], analytic."""
    m = fit.B / (2.0 * fit.A)
    sa = np.sqrt(fit.A)
    return (
        np.exp(fit.C + fit.B**2 / (4.0 * fit.A))
        * np.sqrt(np.pi)
        / (2.0 * sa)
        * (erf(sa * (hi - m)) - erf(sa * (lo - m)))
    )


def _fit_pdf(x, fit: LogNHIFit = GARNETT_FIT):
    return np.exp(-fit.A * x * x + fit.B * x + fit.C)


def log_nhi_mixture_pdf(log_nhi, params: Parameters, fit: LogNHIFit = GARNETT_FIT):
    """The normalized logNHI prior density (reference: dla_samples.py:106-131)."""
    Z = _gaussian_fit_integral(params.fit_min_log_nhi, _FIT_UPPER, fit)
    uniform = np.where(
        (log_nhi >= params.uniform_min_log_nhi)
        & (log_nhi <= params.uniform_max_log_nhi),
        1.0 / (params.uniform_max_log_nhi - params.uniform_min_log_nhi),
        0.0,
    )
    return params.alpha * _fit_pdf(log_nhi, fit) / Z + (1.0 - params.alpha) * uniform


def _mixture_cdf(x, params: Parameters, fit: LogNHIFit = GARNETT_FIT):
    """CDF of the mixture from fit_min_log_nhi (reference integrates the
    normalized pdf from fit_min, generate_dla_samples.m:44)."""
    Z = _gaussian_fit_integral(params.fit_min_log_nhi, _FIT_UPPER, fit)
    fit_part = _gaussian_fit_integral(params.fit_min_log_nhi, x, fit) / Z
    width = params.uniform_max_log_nhi - params.uniform_min_log_nhi
    uni_part = np.clip((x - params.uniform_min_log_nhi) / width, 0.0, 1.0)
    return params.alpha * fit_part + (1.0 - params.alpha) * uni_part


def _invert_cdf(u, cdf, lo, hi, iters: int = 80):
    """Vectorized bisection inverse of a monotone CDF."""
    lo = np.full_like(u, lo, dtype=np.float64)
    hi = np.full_like(u, hi, dtype=np.float64)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < u
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def generate_dla_samples(
    params: Parameters,
    num_samples: int | None = None,
    fit: LogNHIFit | None = None,
) -> DLASamples:
    """Generate the (offset, logNHI) QMC sample set
    (reference: generate_dla_samples.m:8-57).

    :param fit: column-density prior coefficients; the published Garnett
        fit by default, or one re-derived from a catalog's own DLAs via
        :func:`fit_log_nhi_prior`.
    """
    fit = fit or GARNETT_FIT
    S = num_samples or params.num_dla_samples
    seq = halton_sequence(S, 2)
    offsets = seq[:, 0]
    log_nhi = _invert_cdf(
        seq[:, 1],
        lambda x: _mixture_cdf(x, params, fit),
        params.fit_min_log_nhi,
        _FIT_UPPER,
    )
    return DLASamples(
        offset_samples=offsets,
        log_nhi_samples=log_nhi,
        nhi_samples=10.0**log_nhi,
        alpha=params.alpha,
        uniform_min_log_nhi=params.uniform_min_log_nhi,
        uniform_max_log_nhi=params.uniform_max_log_nhi,
        fit_min_log_nhi=params.fit_min_log_nhi,
    )


def _extended_pdf_integral(lo, hi, extrapolate_point=None, fit: LogNHIFit = GARNETT_FIT):
    """integral of the peak-extrapolated unnormalized fit pdf: constant
    below the analytic peak, the Gaussian fit above it
    (reference: set_lls_parameters.m:50-55)."""
    if extrapolate_point is None:
        extrapolate_point = fit.peak
    lo = np.float64(lo)
    hi = np.float64(hi)
    peak_val = _fit_pdf(extrapolate_point, fit)
    const_part = peak_val * max(0.0, min(hi, extrapolate_point) - lo)
    gauss_part = (
        _gaussian_fit_integral(max(lo, extrapolate_point), hi, fit)
        if hi > extrapolate_point
        else 0.0
    )
    return const_part + gauss_part


def generate_subdla_samples(
    params: Parameters,
    num_samples: int | None = None,
    min_lls_log_nhi: float = 19.5,
    uniform_max_log_nhi: float = 23.0,
    fit: LogNHIFit | None = None,
) -> SubDLASamples:
    """Generate subDLA (LLS) samples and the partition functions
    (reference: multi_dlas/set_lls_parameters.m:1-70).

    logNHI is uniform on [19.5, 20.0); Z_lls / Z_dla integrate the
    peak-extrapolated mixture prior over the subDLA and DLA ranges.
    """
    fit = fit or GARNETT_FIT
    S = num_samples or params.num_dla_samples
    seq = halton_sequence(S, 3)
    offsets = seq[:, 0]
    lls_log_nhi = min_lls_log_nhi + (
        params.fit_min_log_nhi - min_lls_log_nhi
    ) * seq[:, 2]

    # normalized, peak-extrapolated mixture (alpha fit + uniform[19.5, 23])
    Z = _extended_pdf_integral(min_lls_log_nhi, _FIT_UPPER, fit=fit)
    width = uniform_max_log_nhi - min_lls_log_nhi

    def norm_pdf_integral(lo, hi):
        uni = (np.clip(hi, min_lls_log_nhi, uniform_max_log_nhi)
               - np.clip(lo, min_lls_log_nhi, uniform_max_log_nhi)) / width
        return (
            params.alpha * _extended_pdf_integral(lo, hi, fit=fit) / Z
            + (1.0 - params.alpha) * uni
        )

    Z_lls = norm_pdf_integral(min_lls_log_nhi, params.fit_min_log_nhi)
    Z_dla = norm_pdf_integral(params.fit_min_log_nhi, uniform_max_log_nhi)

    return SubDLASamples(
        offset_samples=offsets,
        log_nhi_samples=lls_log_nhi,
        nhi_samples=10.0**lls_log_nhi,
        Z_lls=float(Z_lls),
        Z_dla=float(Z_dla),
    )
