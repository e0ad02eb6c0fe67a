"""The CIV cell's inputs, made from ``--seed`` (numpy only).

The learned GP of the CIV window (rest 1,311-1,554 A) with CIV 1549 and
Si IV 1400 emission on a smooth continuum, its observations on the SDSS
pixel grid with a CIV doublet multiplied in where asked, their
preprocessing and the QMC samples.  ``harness/gen.py``'s DLA model has the
Lyman-series emission baked in, so the CIV window gets its own; the
preprocessing and the samples are frozen copies of the port's
(``data/spectrum.preprocess`` with ``CIVParameters``' search range, and
``models/civ.generate_civ_samples``), so that a later change to the port's
copies cannot move what the benchmark feeds it.  The CIV window lies
redwards of Lyman alpha, where the forest's mean-flux suppression is 1:
the observations carry none.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.special import wofz

from harness.gen import CatalogSpectrum, Learned, _smooth, halton, kms_to_z, rng_for, sdss_grid
from reference import civ as ref_civ

SI_IV_A = 1399.8  # the Si IV 1394/1403 blend [A]
CIV_EMISSION_A = 1549.06


def civ_learned_model(cfg: dict, rng: np.random.Generator) -> Learned:
    """A GP on the rest grid of ``cfg``: unit median over the normalization
    window, CIV and Si IV emission on a gently sloped continuum, smooth
    eigenvectors at ~10% of the mean (``log_omega`` is unused: the CIV
    model has no absorption-noise term)."""
    rest = np.arange(cfg["min_lambda"], cfg["max_lambda"] + cfg["dlambda"] / 2, cfg["dlambda"])
    R, k = rest.shape[0], cfg["k"]
    mu = (1.0 + 0.15 * (cfg["max_lambda"] - rest) / (cfg["max_lambda"] - cfg["min_lambda"])
          + 1.2 * np.exp(-0.5 * ((rest - CIV_EMISSION_A) / 10.0) ** 2)
          + 0.35 * np.exp(-0.5 * ((rest - SI_IV_A) / 9.0) ** 2))
    norm = np.median(mu[(rest >= cfg["normalization_min_lambda"])
                        & (rest <= cfg["normalization_max_lambda"])])
    mu /= norm
    M = np.stack([_smooth(rng.normal(size=R), 12) for _ in range(k)], axis=1)
    M *= 0.35 * mu[:, None] / np.sqrt(k) * 1.5
    log_omega = np.log(0.1 + 0.05 * np.abs(np.sin(rest / 40.0)))
    f = np.float64
    return Learned(rest, mu, M, log_omega, f(np.log(cfg["initial_c_0"])),
                   f(np.log(cfg["initial_tau_0"])), f(np.log(cfg["initial_beta"])),
                   f(cfg["prev_tau_0"]), f(cfg["prev_beta"]))


class CIVSamples(NamedTuple):
    """The QMC samples, the field order of the port's ``CIVSamples``."""

    offset_samples: np.ndarray
    log_nciv_samples: np.ndarray
    nciv_samples: np.ndarray
    sigma_samples: np.ndarray


def civ_samples(cfg: dict) -> CIVSamples:
    """Halton points in bases 2, 3, 5: the redshift offset, logN_CIV uniform
    on its prior range and the broadening sigma uniform on its range."""
    seq = halton(cfg["num_civ_samples"], 3)
    lo, hi = cfg["uniform_min_log_nciv"], cfg["uniform_max_log_nciv"]
    log_n = lo + (hi - lo) * seq[:, 1]
    sigma = cfg["min_sigma"] + (cfg["max_sigma"] - cfg["min_sigma"]) * seq[:, 2]
    return CIVSamples(seq[:, 0], log_n, 10.0**log_n, sigma)


def doublet_transmission(wl, z_civ: float, log_n: float, sigma: float) -> np.ndarray:
    """exp(-tau) of one CIV doublet on ``wl`` (scipy's Faddeeva, no
    instrumental broadening)."""
    tau = np.zeros_like(wl)
    for l in range(2):
        lam_c = ref_civ.CIV_WAVELENGTHS_A[l] * (1.0 + z_civ)
        v = (wl - lam_c) * (ref_civ.SPEED_OF_LIGHT_CGS / lam_c)
        zz = (v + 1j * ref_civ.CIV_GAMMA_V[l]) / (np.sqrt(2.0) * sigma)
        tau += 10.0**log_n * ref_civ.CIV_LEADING[l] * (
            np.real(wofz(zz)) / (np.sqrt(2.0 * np.pi) * sigma))
    return np.exp(-tau)


def civ_search_range(cfg: dict, window_wl: np.ndarray, z_qso: float) -> tuple[float, float]:
    """(min, max) CIV redshift searched given the window's valid pixels
    (``CIVParameters.min_z_civ`` / ``max_z_civ``)."""
    lam = cfg["civ_1548_wavelength"]
    lo = max(float(np.min(window_wl)) / lam - 1.0, 1310.0 * (1.0 + z_qso) / lam - 1.0)
    return lo, z_qso - kms_to_z(cfg["max_z_cut_kms"])


def civ_observation(cfg, learned: Learned, z_qso, rng, civ=None, noise_level=0.1,
                    masked_fraction=0.01):
    """One observed spectrum drawn from the GP at ``z_qso``, with the
    doublet ``civ`` = (z_civ, logN_CIV, sigma) multiplied in if given:
    (wavelengths, flux, noise_variance, pixel_mask)."""
    wl = sdss_grid()
    rest = wl / (1.0 + z_qso)
    mu = np.interp(rest, learned.rest_wavelengths, learned.mu)
    M = np.stack([np.interp(rest, learned.rest_wavelengths, learned.M[:, i])
                  for i in range(learned.M.shape[1])], axis=1)
    outside = (rest < learned.rest_wavelengths[0]) | (rest > learned.rest_wavelengths[-1])
    M[outside], mu[outside] = 0.0, 1.0
    flux = mu + M @ rng.normal(size=M.shape[1])
    if civ is not None:
        flux = flux * doublet_transmission(wl, *civ)
    sigma = noise_level * (0.8 + 0.4 * rng.uniform(size=wl.shape))
    flux = flux + sigma * rng.normal(size=wl.shape)
    return wl, flux, sigma**2, rng.uniform(size=wl.shape) < masked_fraction


def civ_preprocess(cfg, wl, flux, noise_variance, pixel_mask, z_qso) -> CatalogSpectrum:
    """Median-normalize, window and pad one observation (the port's
    preprocessing at ``CIVParameters``: N = ``num_pixels_padded``)."""
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
    min_z, max_z = civ_search_range(cfg, wl[in_window & ~pixel_mask], z_qso)
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


def civ_pool(cfg: dict, traffic: dict, learned: Learned, seed: int) -> tuple[list, list]:
    """The traffic's pool: ``pool`` quasars at z_QSO spread over the
    traffic's range, a doublet injected in every ``civ_every``-th, its
    redshift spread over the injected spectra's search windows (the
    fractions ``civ_z_span``).  Returns (preprocessed spectra, the injected
    doublets or None)."""
    lo, hi = traffic["z_qso"]
    zs = np.linspace(lo, hi, traffic["pool"])
    every = traffic["civ_every"]
    injected = [i for i in range(len(zs)) if i % every == every - 1]
    f_lo, f_hi = traffic["civ_z_span"]
    frac = dict(zip(injected, np.linspace(f_lo, f_hi, len(injected))))
    pool, doublets = [], []
    for i, z in enumerate(zs):
        civ = None
        if i in frac:
            wl = sdss_grid()
            rest = wl / (1.0 + z)
            z_lo, z_hi = civ_search_range(
                cfg, wl[(rest >= cfg["min_lambda"]) & (rest <= cfg["max_lambda"])], z)
            civ = (z_lo + frac[i] * (z_hi - z_lo), traffic["civ_log_n"], traffic["civ_sigma"])
        obs = civ_observation(cfg, learned, z, rng_for(seed, 3, i), civ,
                              traffic["noise_level"], traffic["masked_fraction"])
        pool.append(civ_preprocess(cfg, *obs, z))
        doublets.append(civ)
    return pool, doublets
