"""The benchmark's inputs, made from ``--seed`` (numpy only).

Frozen copies of the generators the port carries in
``gpy_dla_detection_tpu_torch/data/{synthetic,samples,spectrum}.py`` and
``models/zqso.prepare_z_spectrum``: a later change to the port's own copies
cannot move what the benchmark feeds it.  Every array comes back as plain
numpy; the drivers wrap them in the port's types and the reference reads
them as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.special import erf, wofz

from reference import physics as C


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """An independent stream for one part of a run's inputs."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def seed_for(seed: int, *tags: int) -> int:
    """A 63-bit seed for one part of a run (a torch generator's)."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0] >> 1)


# --- the DLA catalog's learned GP, prior catalog and QMC samples --------------

class Learned(NamedTuple):
    """The null-model GP, in the field order of the port's ``LearnedModel``."""

    rest_wavelengths: np.ndarray
    mu: np.ndarray
    M: np.ndarray
    log_omega: np.ndarray
    log_c_0: np.ndarray
    log_tau_0: np.ndarray
    log_beta: np.ndarray
    prev_tau_0: np.ndarray
    prev_beta: np.ndarray


def _smooth(x: np.ndarray, width: int) -> np.ndarray:
    kernel = np.exp(-0.5 * (np.arange(-3 * width, 3 * width + 1) / width) ** 2)
    kernel /= kernel.sum()
    return np.convolve(x, kernel, mode="same")


def learned_model(cfg: dict, rng: np.random.Generator) -> Learned:
    """A quasar-continuum-like GP on the rest grid of ``cfg``."""
    rest = np.arange(cfg["min_lambda"], cfg["max_lambda"] + cfg["dlambda"] / 2, cfg["dlambda"])
    R, k = rest.shape[0], cfg["k"]
    mu = (1.0 + 2.2 * np.exp(-0.5 * ((rest - 1215.67) / 12.0) ** 2)
          + 0.6 * np.exp(-0.5 * ((rest - 1025.72) / 9.0) ** 2)
          + 0.25 * np.exp(-0.5 * ((rest - 972.54) / 7.0) ** 2)
          + 0.1 * (rest - rest[0]) / (rest[-1] - rest[0]))
    M = np.stack([_smooth(rng.normal(size=R), 25) for _ in range(k)], axis=1)
    M *= 0.35 * mu[:, None] / np.sqrt(k) * 3.0
    log_omega = np.log(0.1 + 0.05 * np.abs(np.sin(rest / 40.0)))
    f = np.float64
    return Learned(rest, mu, M, log_omega, f(np.log(cfg["initial_c_0"])),
                   f(np.log(cfg["initial_tau_0"])), f(np.log(cfg["initial_beta"])),
                   f(cfg["prev_tau_0"]), f(cfg["prev_beta"]))


def prior_catalog(rng: np.random.Generator, num_quasars: int = 5000, dla_rate: float = 0.1):
    """(z_qsos, dla_ind) of the model prior's quasar sample."""
    z_qsos = rng.uniform(2.15, 5.5, size=num_quasars)
    return z_qsos, rng.uniform(size=num_quasars) < dla_rate


def halton(n: int, dim: int) -> np.ndarray:
    """Radical-inverse Halton points in bases 2, 3, 5: (n, dim)."""
    out = np.empty((n, dim))
    for d, b in enumerate((2, 3, 5)[:dim]):
        x, denom, i = np.zeros(n), 1.0, np.arange(1, n + 1, dtype=np.int64)
        while np.any(i > 0):
            denom *= b
            x += (i % b) / denom
            i //= b
        out[:, d] = x
    return out


# Garnett (2017) fit to log p(logNHI): exp(-A x^2 + B x + C), integrated to 25
_FIT = (1.2695, 50.863, -509.33)
_FIT_UPPER = 25.0


def _fit_integral(lo, hi):
    A, B, Cc = _FIT
    m, sa = B / (2.0 * A), np.sqrt(A)
    return (np.exp(Cc + B**2 / (4.0 * A)) * np.sqrt(np.pi) / (2.0 * sa)
            * (erf(sa * (hi - m)) - erf(sa * (lo - m))))


def _fit_pdf(x):
    A, B, Cc = _FIT
    return np.exp(-A * x * x + B * x + Cc)


class Samples(NamedTuple):
    offset_samples: np.ndarray
    log_nhi_samples: np.ndarray
    nhi_samples: np.ndarray


def dla_samples(cfg: dict) -> Samples:
    """The DLA family's QMC set: Halton offsets and the mixture prior's
    logNHI by inverse transform (bisection)."""
    S = cfg["num_dla_samples"]
    seq = halton(S, 2)
    Z = _fit_integral(cfg["fit_min_log_nhi"], _FIT_UPPER)
    width = cfg["uniform_max_log_nhi"] - cfg["uniform_min_log_nhi"]

    def cdf(x):
        return (cfg["alpha"] * (_fit_integral(cfg["fit_min_log_nhi"], x) / Z)
                + (1 - cfg["alpha"]) * np.clip((x - cfg["uniform_min_log_nhi"]) / width, 0, 1))

    lo, hi = np.full(S, cfg["fit_min_log_nhi"]), np.full(S, _FIT_UPPER)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < seq[:, 1]
        lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
    log_nhi = 0.5 * (lo + hi)
    return Samples(seq[:, 0], log_nhi, 10.0**log_nhi)


def subdla_samples(cfg: dict) -> tuple[Samples, float, float]:
    """The subDLA family's set (logNHI uniform on [19.5, 20)) and the
    partition functions (Z_lls, Z_dla) of its prior."""
    S, lls_min, u_max = cfg["num_dla_samples"], 19.5, 23.0
    seq = halton(S, 3)
    log_nhi = lls_min + (cfg["fit_min_log_nhi"] - lls_min) * seq[:, 2]
    A, B, _ = _FIT
    peak = B / (2.0 * A)

    def ext(lo, hi):
        const = _fit_pdf(peak) * max(0.0, min(hi, peak) - lo)
        return const + (_fit_integral(max(lo, peak), hi) if hi > peak else 0.0)

    Z = ext(lls_min, _FIT_UPPER)

    def norm(lo, hi):
        uni = (np.clip(hi, lls_min, u_max) - np.clip(lo, lls_min, u_max)) / (u_max - lls_min)
        return cfg["alpha"] * ext(lo, hi) / Z + (1 - cfg["alpha"]) * uni

    z_lls = float(norm(lls_min, cfg["fit_min_log_nhi"]))
    z_dla = float(norm(cfg["fit_min_log_nhi"], u_max))
    return Samples(seq[:, 0], log_nhi, 10.0**log_nhi), z_lls, z_dla


# --- a catalog spectrum -------------------------------------------------------

def sdss_grid(min_lambda=3600.0, max_lambda=10400.0, dex=1e-4) -> np.ndarray:
    n = int(np.floor(np.log10(max_lambda / min_lambda) / dex)) + 1
    return min_lambda * 10 ** (dex * np.arange(n))


def forest_tau(wl, z_qso, tau_0, beta, num_lines):
    """The Lyman forest's summed effective optical depth on ``wl``."""
    tau = np.zeros_like(wl)
    for i in range(num_lines):
        z_i = wl / C.LYMAN_WAVELENGTHS_A[i] - 1.0
        scale = (tau_0 * C.LYMAN_OSC[i] / C.LYMAN_OSC[0]
                 * C.LYMAN_WAVELENGTHS_A[i] / C.LYMAN_WAVELENGTHS_A[0])
        tau += np.where(z_i <= z_qso, scale * (1.0 + z_i) ** beta, 0.0)
    return tau


def observation(cfg, learned: Learned, z_qso, rng, dlas=(), noise_level=0.1,
                masked_fraction=0.01):
    """One observed spectrum drawn from the GP at ``z_qso``, with the
    absorbers ``dlas`` [(z, logNHI)] multiplied in (exact Faddeeva):
    (wavelengths, flux, noise_variance, pixel_mask)."""
    wl = sdss_grid()
    rest = wl / (1.0 + z_qso)
    mu = np.interp(rest, learned.rest_wavelengths, learned.mu)
    M = np.stack([np.interp(rest, learned.rest_wavelengths, learned.M[:, i])
                  for i in range(learned.M.shape[1])], axis=1)
    outside = (rest < learned.rest_wavelengths[0]) | (rest > learned.rest_wavelengths[-1])
    M[outside], mu[outside] = 0.0, 1.0
    flux = mu + M @ rng.normal(size=M.shape[1])
    flux = flux * np.exp(-forest_tau(wl, z_qso, float(learned.prev_tau_0),
                                     float(learned.prev_beta), cfg["num_forest_lines"]))
    for z_dla, log_nhi in dlas:
        tau = np.zeros_like(wl)
        for l in range(cfg["num_lines"]):
            lam_c = C.LYMAN_WAVELENGTHS_A[l] * (1.0 + z_dla)
            v = (wl - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
            zz = (v + 1j * C.LYMAN_GAMMA_V[l]) / (np.sqrt(2.0) * C.THERMAL_SIGMA_CGS)
            tau += 10.0**log_nhi * C.LYMAN_LEADING[l] * (
                np.real(wofz(zz)) / (np.sqrt(2.0 * np.pi) * C.THERMAL_SIGMA_CGS))
        flux = flux * np.exp(-tau)
    sigma = noise_level * (0.8 + 0.4 * rng.uniform(size=wl.shape))
    flux = flux + sigma * rng.normal(size=wl.shape)
    return wl, flux, sigma**2, rng.uniform(size=wl.shape) < masked_fraction


class CatalogSpectrum(NamedTuple):
    """One preprocessed spectrum, the field order of the port's ``Spectrum``."""

    padded_wavelengths: np.ndarray  # (N + 6,)
    flux: np.ndarray  # (N,)
    noise_variance: np.ndarray
    mask: np.ndarray
    z_qso: np.ndarray
    min_z_dla: np.ndarray
    max_z_dla: np.ndarray
    normalization_median: np.ndarray


def kms_to_z(kms):
    return kms * 1000.0 / C.SPEED_OF_LIGHT_SI


def preprocess(cfg, wl, flux, noise_variance, pixel_mask, z_qso) -> CatalogSpectrum:
    """Median-normalize, window and pad one observation (the pipeline's
    preprocessing, fixed shape: N = ``num_pixels_padded`` window pixels)."""
    flux, noise_variance = flux.copy(), noise_variance.copy()
    rest = wl / (1.0 + z_qso)
    ind = ((rest >= cfg["normalization_min_lambda"]) & (rest <= cfg["normalization_max_lambda"])
           & ~pixel_mask)
    median = float(np.nanmedian(flux[ind])) if np.any(ind) else 1.0
    flux /= median
    noise_variance /= median**2
    in_window = (rest >= cfg["min_lambda"]) & (rest <= cfg["max_lambda"])
    window = wl[in_window]
    n_w, N = window.shape[0], cfg["num_pixels_padded"]
    if n_w > N:
        raise ValueError(f"spectrum has {n_w} window pixels > {N}")
    valid_wl = wl[in_window & ~pixel_mask]
    lya = C.LYMAN_WAVELENGTHS_A[0]
    max_z = min(float(np.max(valid_wl)) / lya - 1.0 - kms_to_z(cfg["max_z_cut_kms"]),
                z_qso - kms_to_z(cfg["max_z_cut_kms"]))
    min_z = max(float(np.min(valid_wl)) / lya - 1.0,
                C.LYMAN_LIMIT_A * (1.0 + z_qso) / lya - 1.0 + kms_to_z(cfg["min_z_cut_kms"]))
    dex, pad = cfg["pixel_spacing"], 3
    head = 10 ** (np.log10(window[0]) + dex * np.arange(-pad, 0))
    tail = 10 ** (np.log10(window[-1]) + dex * np.arange(1, N - n_w + pad + 1))
    fx, nv, mk = np.zeros(N), np.ones(N), np.zeros(N, bool)
    fw, vw = flux[in_window], noise_variance[in_window]
    ok = ~pixel_mask[in_window] & np.isfinite(fw) & np.isfinite(vw)
    fx[:n_w] = np.where(ok, np.nan_to_num(fw), 0.0)
    nv[:n_w] = np.where(ok, np.nan_to_num(vw, nan=1.0), 1.0)
    mk[:n_w] = ok
    f = np.float64
    return CatalogSpectrum(np.concatenate([head, window, tail]), fx, nv, mk, f(z_qso),
                           f(min_z), f(max_z), f(median))


# --- the zQSO GP and its observations -----------------------------------------

class ZLearned(NamedTuple):
    """The zQSO GP, in the field order of the port's ``ZLearnedModel``."""

    rest_wavelengths: np.ndarray
    mu: np.ndarray
    M: np.ndarray
    bluewards_mu: np.ndarray
    bluewards_sigma: np.ndarray
    redwards_mu: np.ndarray
    redwards_sigma: np.ndarray


def z_learned_model(cfg: dict, rng: np.random.Generator) -> ZLearned:
    """Lya / CIV / MgII bumps on a unit continuum over the zQSO window, unit
    median over the normalization window, smooth eigenvectors."""
    rest = np.arange(cfg["min_lambda"], cfg["max_lambda"] + cfg["dlambda"] / 2, cfg["dlambda"])
    mu = (1.0 + 2.0 * np.exp(-0.5 * ((rest - 1215.67) / 14.0) ** 2)
          + 0.8 * np.exp(-0.5 * ((rest - 1549.0) / 18.0) ** 2)
          + 0.5 * np.exp(-0.5 * ((rest - 2799.0) / 25.0) ** 2))
    norm = np.median(mu[(rest >= cfg["normalization_min_lambda"])
                        & (rest <= cfg["normalization_max_lambda"])])
    mu /= norm
    kernel = np.exp(-0.5 * (np.arange(-60, 61) / 20.0) ** 2)
    kernel /= kernel.sum()
    M = np.stack([np.convolve(rng.normal(size=rest.shape[0]), kernel, "same")
                  for _ in range(cfg["k"])], axis=1) * (1.5 / norm)
    f = np.float64
    return ZLearned(rest, mu, M, f(0.2), f(0.5), f(0.8), f(0.3))


def z_observation(learned: ZLearned, z_true, rng, noise=0.08, num_pixels=4600,
                  grid="log", start=3600.0, step=1e-4):
    """An observation drawn from the zQSO GP at ``z_true``: (wavelengths,
    flux, noise_variance, pixel_mask).  The pixel grid starts at ``start``
    A and is log-uniform (``grid="log"``, ``step`` in dex, SDSS's 1e-4 by
    default) or linear (``grid="linear"``, ``step`` in A)."""
    if grid == "log":
        wl = start * 10 ** (step * np.arange(num_pixels))
    elif grid == "linear":
        wl = start + step * np.arange(num_pixels)
    else:
        raise ValueError(f"unknown pixel grid {grid!r}: expected 'log' or 'linear'")
    rest = wl / (1 + z_true)
    mu = np.interp(rest, learned.rest_wavelengths, learned.mu)
    M = np.stack([np.interp(rest, learned.rest_wavelengths, learned.M[:, i])
                  for i in range(learned.M.shape[1])], axis=1)
    out = (rest < learned.rest_wavelengths[0]) | (rest > learned.rest_wavelengths[-1])
    M[out] = 0.0
    flux = mu + M @ rng.normal(size=M.shape[1])
    flux[out] = np.where(rest[out] < learned.rest_wavelengths[0],
                         float(learned.bluewards_mu), float(learned.redwards_mu))
    flux += noise * rng.normal(size=wl.shape)
    return wl, flux, np.full_like(wl, noise**2), np.zeros(wl.shape, bool)


class ZObs(NamedTuple):
    """One padded zQSO observation, the field order of the port's ``ZSpectrum``."""

    wavelengths: np.ndarray
    flux: np.ndarray
    noise_variance: np.ndarray
    valid: np.ndarray


def pad_z_observation(wl, flux, nv, pm, num_pixels: int) -> ZObs:
    """Pad an observation to ``num_pixels`` (the last wavelength repeated,
    padding invalid); unusable pixels are invalid."""
    n = wl.shape[0]
    bad = pm | ~np.isfinite(nv) | ~np.isfinite(flux)
    w, f, v, ok = np.full(num_pixels, wl[-1]), np.zeros(num_pixels), np.ones(num_pixels), \
        np.zeros(num_pixels, bool)
    w[:n], f[:n] = wl, np.where(bad, 0.0, np.nan_to_num(flux))
    v[:n], ok[:n] = np.where(bad, 1.0, np.nan_to_num(nv, nan=1.0)), ~bad
    return ZObs(w, f, v, ok)
