"""Synthetic learned models, catalogs, and spectra (numpy only).

A copy of the generators of ``gpy_dla_detection_tpu/data/synthetic.py``,
without the JAX model containers: the learned GP comes back as
:class:`LearnedArrays`, plain numpy arrays in the field order of the
reference's ``LearnedModel``, which
``models.learned.LearnedModel.from_numpy`` moves to a device; the zQSO GP
as the port's ``models.zqso.ZLearnedModel`` with numpy fields, which its
``to`` moves.  For the same seed every array is bit-identical to the
reference's.  ``write_speclite`` writes an observation as the SDSS
speclite FITS file the CLIs read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..params import Parameters
from .catalog import PriorCatalog
from .spectrum import Spectrum, preprocess


class LearnedArrays(NamedTuple):
    """Trained null-model GP as numpy arrays (field order of the
    reference's ``LearnedModel``)."""

    rest_wavelengths: np.ndarray  # (R,) uniform rest grid [A]
    mu: np.ndarray  # (R,)
    M: np.ndarray  # (R, k)
    log_omega: np.ndarray  # (R,)
    log_c_0: np.ndarray  # scalar
    log_tau_0: np.ndarray  # scalar
    log_beta: np.ndarray  # scalar
    prev_tau_0: np.ndarray  # scalar
    prev_beta: np.ndarray  # scalar


def _smooth(x: np.ndarray, width: int) -> np.ndarray:
    kernel = np.exp(-0.5 * (np.arange(-3 * width, 3 * width + 1) / width) ** 2)
    kernel /= kernel.sum()
    return np.convolve(x, kernel, mode="same")


def synthetic_learned_model(params: Parameters, seed: int = 0) -> LearnedArrays:
    """A quasar-continuum-like learned GP on the standard rest grid."""
    rng = np.random.default_rng(seed)
    rest = np.arange(params.min_lambda, params.max_lambda + params.dlambda / 2, params.dlambda)
    R = rest.shape[0]

    # continuum with Lya / Lyb emission-line bumps
    mu = (
        1.0
        + 2.2 * np.exp(-0.5 * ((rest - 1215.67) / 12.0) ** 2)
        + 0.6 * np.exp(-0.5 * ((rest - 1025.72) / 9.0) ** 2)
        + 0.25 * np.exp(-0.5 * ((rest - 972.54) / 7.0) ** 2)
        + 0.1 * (rest - rest[0]) / (rest[-1] - rest[0])
    )

    # smooth random low-rank covariance factor, scaled to ~10% of mu
    M = np.stack(
        [_smooth(rng.normal(size=R), 25) for _ in range(params.k)], axis=1
    )
    M *= 0.35 * mu[:, None] / np.sqrt(params.k) * 3.0

    log_omega = np.log(0.1 + 0.05 * np.abs(np.sin(rest / 40.0)))

    return LearnedArrays(
        rest_wavelengths=rest,
        mu=mu,
        M=M,
        log_omega=log_omega,
        log_c_0=np.float64(np.log(params.initial_c_0)),
        log_tau_0=np.float64(np.log(params.initial_tau_0)),
        log_beta=np.float64(np.log(params.initial_beta)),
        prev_tau_0=np.float64(params.prev_tau_0),
        prev_beta=np.float64(params.prev_beta),
    )


def synthetic_prior_catalog(
    params: Parameters, num_quasars: int = 5000, dla_rate: float = 0.1, seed: int = 1
) -> PriorCatalog:
    rng = np.random.default_rng(seed)
    z_qsos = rng.uniform(2.15, 5.5, size=num_quasars)
    dla_ind = rng.uniform(size=num_quasars) < dla_rate
    return PriorCatalog.from_arrays(params, z_qsos, dla_ind)


def synthetic_sdss_grid(
    min_lambda: float = 3600.0, max_lambda: float = 10400.0, dex: float = 1e-4
) -> np.ndarray:
    n = int(np.floor(np.log10(max_lambda / min_lambda) / dex)) + 1
    return min_lambda * 10 ** (dex * np.arange(n))


def synthetic_observation(
    params: Parameters,
    learned: LearnedArrays,
    z_qso: float,
    seed: int = 0,
    noise_level: float = 0.1,
    dlas: list[tuple[float, float]] | None = None,
    masked_fraction: float = 0.01,
    with_lls_break: bool = False,
    with_omega_noise: bool = False,
):
    """Draw one observed spectrum from the learned GP's generative model.

    :param dlas: optional [(z_dla, log_nhi), ...] absorbers to inject.
    :param with_lls_break: add each injected absorber's Lyman-limit
        break opacity (reference: voigt_lls.py:254-284) so the
        LLS-finder accuracy gates can inject the 17.2 < logNHI < 20
        regime its search targets.
    :param with_omega_noise: also draw the model's diagonal
        absorption-noise term omega * (1 - exp(-tau) + c_0) * a — the
        Omega block of y ~ N(mu a, A(MM' + Omega)A + V) (reference:
        null_gp.py:185,236) that the default draw omits.  With it, the
        training rebuild's recovered omega/tau_0/beta are identifiable
        (scripts/train_fullscale.py); without it the synthetic spectra
        carry no stochastic forest and those parameters collapse.
        Default off: the inference gates and golden artifacts predate
        this flag and stay bit-stable.
    :return: (wavelengths, flux, noise_variance, pixel_mask) in the
        convention of the reference's ``read_spec``
        (reference: read_spec.py:22-71).
    """
    rng = np.random.default_rng(seed)
    wavelengths = synthetic_sdss_grid()
    rest = wavelengths / (1.0 + z_qso)

    # continuum: interpolate mu inside the model grid; outside it, a
    # flat unit continuum — crucially this puts the 1310-1325 A
    # normalization window at ~1, matching how the learned mean is
    # normalized in the real pipeline (clamping mu's red edge there
    # would bias every normalized flux low and fake absorption)
    mu = np.interp(rest, learned.rest_wavelengths, learned.mu)
    M = np.stack(
        [
            np.interp(rest, learned.rest_wavelengths, learned.M[:, i])
            for i in range(learned.M.shape[1])
        ],
        axis=1,
    )
    outside = (rest < learned.rest_wavelengths[0]) | (
        rest > learned.rest_wavelengths[-1]
    )
    M[outside] = 0.0
    mu[outside] = 1.0

    flux = mu + M @ rng.normal(size=M.shape[1])

    # Lyman-forest mean-flux suppression blueward of Lya
    tau = np.zeros_like(wavelengths)
    from ..constants import (
        LYMAN_OSCILLATOR_STRENGTHS,
        LYMAN_WAVELENGTHS_A,
    )

    for i in range(params.num_forest_lines):
        lam_i = LYMAN_WAVELENGTHS_A[i]
        osc = LYMAN_OSCILLATOR_STRENGTHS[i]
        z_i = wavelengths / lam_i - 1.0
        scale = (
            float(learned.prev_tau_0)
            * osc
            / LYMAN_OSCILLATOR_STRENGTHS[0]
            * lam_i
            / LYMAN_WAVELENGTHS_A[0]
        )
        tau += np.where(z_i <= z_qso, scale * (1.0 + z_i) ** float(learned.prev_beta), 0.0)
    flux = flux * np.exp(-tau)

    if with_omega_noise:
        # noise std per the model's Omega block: omega * s * a with
        # s = 1 - exp(-tau_eff) + c_0, tau_eff built from the LEARNED
        # tau_0/beta (the parameters training recovers), a = exp(-tau)
        # the mean-flux factor already applied to the flux above
        # (reference: null_gp.py:204-242, learn_qso_model_meanflux.m:2-6)
        omega = np.interp(rest, learned.rest_wavelengths, np.exp(learned.log_omega))
        omega[outside] = 0.0
        tau_eff = np.zeros_like(wavelengths)
        tau_0 = float(np.exp(learned.log_tau_0))
        beta = float(np.exp(learned.log_beta))
        for i in range(params.num_forest_lines):
            lam_i = LYMAN_WAVELENGTHS_A[i]
            osc = LYMAN_OSCILLATOR_STRENGTHS[i]
            z_i = wavelengths / lam_i - 1.0
            scale = (
                tau_0
                * osc
                / LYMAN_OSCILLATOR_STRENGTHS[0]
                * lam_i
                / LYMAN_WAVELENGTHS_A[0]
            )
            tau_eff += np.where(z_i <= z_qso, scale * (1.0 + z_i) ** beta, 0.0)
        s = 1.0 - np.exp(-tau_eff) + float(np.exp(learned.log_c_0))
        flux = flux + omega * s * np.exp(-tau) * rng.normal(size=wavelengths.shape)

    if dlas:
        from scipy.special import wofz

        from ..constants import (
            LYMAN_LEADING_CONSTANTS,
            LYMAN_LORENTZIAN_WIDTHS,
            SPEED_OF_LIGHT_CGS,
            THERMAL_SIGMA_CGS,
        )

        for z_dla, log_nhi in dlas:
            tau_dla = np.zeros_like(wavelengths)
            for l in range(params.num_lines):
                lam_c = LYMAN_WAVELENGTHS_A[l] * (1.0 + z_dla)
                v = (wavelengths - lam_c) * (SPEED_OF_LIGHT_CGS / lam_c)
                zz = (v + 1j * LYMAN_LORENTZIAN_WIDTHS[l]) / (
                    np.sqrt(2.0) * THERMAL_SIGMA_CGS
                )
                profile = np.real(wofz(zz)) / (
                    np.sqrt(2.0 * np.pi) * THERMAL_SIGMA_CGS
                )
                tau_dla += 10.0**log_nhi * LYMAN_LEADING_CONSTANTS[l] * profile
            if with_lls_break:
                rest_abs = wavelengths / (1.0 + z_dla)
                tau_dla += np.where(
                    rest_abs > 911.7641,
                    0.0,
                    10.0**log_nhi / 10**17.2 * (rest_abs / 911.7641) ** 3,
                )
            flux = flux * np.exp(-tau_dla)

    noise_sigma = noise_level * (0.8 + 0.4 * rng.uniform(size=wavelengths.shape))
    noise_variance = noise_sigma**2
    flux = flux + noise_sigma * rng.normal(size=wavelengths.shape)

    pixel_mask = rng.uniform(size=wavelengths.shape) < masked_fraction

    return wavelengths, flux, noise_variance, pixel_mask


def synthetic_training_lists(
    params: Parameters,
    learned: LearnedArrays,
    z_qsos,
    obs_seed: int,
    noise_level: float,
):
    """Training spectra drawn from ``learned``: spectrum i at ``z_qsos[i]``
    with seed ``obs_seed + i`` (:func:`synthetic_observation`), each
    normalized by its median flux at 1,310-1,325 A rest, as the pipeline
    normalizes (the reference's training tests draw their lists so;
    ``scripts/make_torch_golden.py train`` draws the golden's with this).

    :return: the lists (wavelengths, flux, noise_variance, pixel_mask) that
        ``models.training.prepare_training_set`` takes.
    """
    lists = ([], [], [], [])
    for i, z in enumerate(z_qsos):
        wl, fx, nv, pm = synthetic_observation(params, learned, float(z), seed=obs_seed + i,
                                               noise_level=noise_level)
        rest = wl / (1 + z)
        norm = np.nanmedian(fx[(rest >= 1310) & (rest <= 1325)])
        for out, x in zip(lists, (wl, fx / norm, nv / norm**2, pm)):
            out.append(x)
    return lists


def synthetic_training_problem(Q: int, R: int, k: int, seed: int = 0):
    """The training benchmark's synthetic problem (the reference's
    ``scripts/train_throughput.py``): float32 parameters and Q spectra of
    R rest pixels, drawn by numpy from ``seed`` in its order.

    :return: (the ``TrainingParams`` fields M, log_omega, log_c_0,
        log_tau_0, log_beta; the fit's arrays flux_centered, lya_1pz,
        noise_variance, mask, zqso_1pz).
    """
    rng = np.random.default_rng(seed)
    fields = (
        rng.normal(0, 0.3, (R, k)).astype(np.float32),
        np.log(rng.uniform(0.1, 0.3, R)).astype(np.float32),
        np.float32(np.log(0.1)),
        np.float32(np.log(0.0023)),
        np.float32(np.log(3.65)),
    )
    flux = rng.normal(0, 1, (Q, R)).astype(np.float32)
    lya_1pz = np.linspace(3.0, 4.2, R).astype(np.float32)[None].repeat(Q, 0)
    nv = rng.uniform(0.01, 0.3, (Q, R)).astype(np.float32)
    mask = rng.uniform(size=(Q, R)) > 0.2
    zqso = rng.uniform(2.5, 4.5, Q).astype(np.float32)
    return fields, (flux * mask, lya_1pz, nv, mask, zqso)


def _log_sum_exp(x: np.ndarray) -> np.ndarray:
    """log sum exp over the last axis, NaN entries left out (NaN where
    every entry is)."""
    x = np.where(np.isnan(x), -np.inf, x)
    top = x.max(axis=-1, keepdims=True)
    shift = np.where(np.isfinite(top), top, 0.0)
    with np.errstate(divide="ignore"):
        out = (shift + np.log(np.exp(x - shift).sum(axis=-1, keepdims=True)))[..., 0]
    return np.where(np.isfinite(top[..., 0]), out, np.nan)


def synthetic_processed_catalog(num_spec: int = 64, num_samples: int = 2000, seed: int = 0):
    """A processed catalog whose statistics can be checked by hand, for
    ``analysis.cddf.ProcessedCatalog(**arrays, max_k=2)``: the toy catalog
    of ``tests/test_cddf.py`` (a detected spectrum's whole likelihood on
    one sample, log evidences normalized so that the per-sample
    probabilities sum to one) with two DLA levels.

    About half the spectra hold a DLA at a picked sample (p_dla 0.95), a
    third of those a second one at another sample whose chained first
    absorber (``base_sample_inds``, 0-based, (Q, S, 1)) is mostly the first
    pick; the chained level's likelihoods are NaN where the pair cut would
    drop a sample.  Search ranges vary per spectrum over 2.0-2.3 to
    3.0-4.5, and the last spectrum's likelihoods are NaN throughout (an
    evidence that failed; its posterior is the null model's).  ``scripts/make_torch_golden.py analysis`` and
    ``chip_smoke.py`` draw the same catalog from ``seed``.

    :return: dict of the constructor's arrays.
    """
    rng = np.random.default_rng(seed)
    Q, S = num_spec, num_samples
    z_min = 2.0 + 0.3 * rng.uniform(size=Q)
    z_max = 3.0 + 1.5 * rng.uniform(size=Q)
    offsets = rng.uniform(size=S)
    lnhi = rng.uniform(20.0, 22.5, size=S)

    picked = rng.integers(0, S, size=Q)
    picked2 = rng.integers(0, S, size=Q)
    detected = rng.uniform(size=Q) < 0.5
    double = detected & (rng.uniform(size=Q) < 1.0 / 3.0)
    detected[-1] = double[-1] = False
    chained = rng.uniform(size=(Q, S)) < 0.8
    base = np.where(chained, picked[:, None], rng.integers(0, S, size=(Q, S)))[..., None]

    sll = np.full((Q, S, 2), -200.0)
    sll[detected, picked[detected], 0] = 0.0
    sll[:, :, 1][rng.uniform(size=(Q, S)) < 0.05] = np.nan
    sll[double, picked2[double], 1] = 0.0
    sll[-1] = np.nan
    log_ev = np.stack(
        [_log_sum_exp(sll[:, :, 0]) - np.log(S), _log_sum_exp(sll[:, :, 1]) - 2 * np.log(S)],
        axis=1,
    )

    p_one = np.where(detected & ~double, 0.95, np.where(double, 0.04, 1e-4))
    p_two = np.where(double, 0.91, 1e-6)
    mp = np.stack([1 - p_one - p_two - 1e-5, np.full(Q, 1e-5), p_one, p_two], axis=1)
    return dict(
        min_z_dlas=z_min,
        max_z_dlas=z_max,
        model_posteriors=mp,
        sample_log_likelihoods=sll,
        log_likelihoods_dla=log_ev,
        base_sample_inds=base,
        offset_samples=offsets,
        log_nhi_samples=lnhi,
    )


def catalog_statistics(cat, tables) -> dict[str, np.ndarray]:
    """The science stage's statistics of a ``ProcessedCatalog`` at their
    default ranges, flat by ``<statistic>.<field>``: ``column_density_function``,
    ``line_density``, ``omega_dla``, ``omega_dla_cddf``, ``map_from_samples``
    at k = 1 and 2, ``get_sample_errors(nsample=5, rng=0)``, and the three
    LaTeX tables of ``tables`` (``cddf_table``, ``line_density_table``,
    ``omega_table``) as strings.  Either package's catalog and tables
    module: the golden fixture holds the JAX package's, ``chip_smoke.py``
    and the tests compare the port's with it."""
    out = {}

    def put(name, fields, values):
        for field, value in zip(fields, values):
            out[f"{name}.{field}"] = np.asarray(value)

    cddf = cat.column_density_function()
    dndx = cat.line_density()
    omega = cat.omega_dla()
    put("cddf", ("l_cent", "cddf", "cddf68", "cddf95", "xerrs"), cddf)
    put("line_density", ("z_cent", "dNdX", "dndx68", "dndx95", "xerrs"), dndx)
    put("omega_dla", ("z_cent", "omega", "omega_err"), omega)
    put("omega_dla_cddf", ("z_cent", "omega", "omega68", "omega95", "xerrs"),
        cat.omega_dla_cddf())
    for k in (1, 2):
        put(f"map_k{k}", ("z", "log_nhi"), cat.map_from_samples(k - 1))
    put("sample_errors", *zip(*cat.get_sample_errors(nsample=5, rng=0).items()))
    put("tables", ("cddf", "line_density", "omega"), (
        tables.cddf_table(*cddf[:4]), tables.line_density_table(*dndx[:4]),
        tables.omega_table(*omega)))
    return out


def synthetic_spectrum(
    params: Parameters,
    learned: LearnedArrays,
    z_qso: float,
    seed: int = 0,
    **kw,
) -> Spectrum:
    wl, flux, nv, mask = synthetic_observation(params, learned, z_qso, seed, **kw)
    return preprocess(wl, flux, nv, mask, z_qso, params)


def civ_doublet_transmission(
    wavelengths: np.ndarray, z_civ: float, log_nciv: float, sigma: float
) -> np.ndarray:
    """exp(-tau) of one CIV doublet on an observed grid, unbroadened: the
    injection of the JAX package's CIV accuracy gate
    (tests/test_accuracy_gates.py), exact Faddeeva from scipy.

    :param sigma: broadening velocity [cm/s].
    """
    from scipy.special import wofz

    from ..constants import (
        CIV_LEADING_CONSTANTS,
        CIV_LORENTZIAN_WIDTHS,
        CIV_WAVELENGTHS_CM,
        SPEED_OF_LIGHT_CGS,
    )

    tau = np.zeros_like(wavelengths, dtype=np.float64)
    for l in range(2):
        lam_c = CIV_WAVELENGTHS_CM[l] * 1e8 * (1 + z_civ)
        vel = (wavelengths - lam_c) * (SPEED_OF_LIGHT_CGS / lam_c)
        zz = (vel + 1j * CIV_LORENTZIAN_WIDTHS[l]) / (np.sqrt(2) * sigma)
        tau += (
            10.0**log_nciv
            * CIV_LEADING_CONSTANTS[l]
            * np.real(wofz(zz))
            / (np.sqrt(2 * np.pi) * sigma)
        )
    return np.exp(-tau)


def synthetic_civ_spectrum(
    params: Parameters,
    learned: LearnedArrays,
    z_qso: float,
    seed: int = 0,
    civ: tuple[float, float, float] | None = None,
) -> Spectrum:
    """A synthetic spectrum (:func:`synthetic_observation`) with an
    optional CIV doublet ``civ = (z_civ, logN_CIV, sigma)`` multiplied into
    its flux, preprocessed for the CIV search."""
    wl, flux, nv, mask = synthetic_observation(params, learned, z_qso, seed)
    if civ is not None:
        flux = flux * civ_doublet_transmission(wl, *civ)
    return preprocess(wl, flux, nv, mask, z_qso, params)


def synthetic_z_learned_model(seed: int = 0, k: int = 5):
    """Generative synthetic zQSO GP over the wide 910-3000 A window:
    Lya / CIV / MgII emission bumps on a unit continuum, smooth
    eigenvectors, and blueward/redward iid statistics
    (reference model layout: zqso_gp.py:288-319), as the port's
    ``ZLearnedModel`` with numpy fields."""
    from ..models.zqso import ZLearnedModel

    rng = np.random.default_rng(seed)
    rest = np.arange(910.0, 3000.0 + 0.125, 0.25)
    R = rest.shape[0]
    mu = (
        1.0
        + 2.0 * np.exp(-0.5 * ((rest - 1215.67) / 14.0) ** 2)
        + 0.8 * np.exp(-0.5 * ((rest - 1549.0) / 18.0) ** 2)
        + 0.5 * np.exp(-0.5 * ((rest - 2799.0) / 25.0) ** 2)
    )
    # unit median over the 1176-1256 A normalization window, consistent
    # with the normalization applied at inference time
    norm = np.median(mu[(rest >= 1176.0) & (rest <= 1256.0)])
    mu /= norm
    kernel = np.exp(-0.5 * (np.arange(-60, 61) / 20.0) ** 2)
    kernel /= kernel.sum()
    M = np.stack(
        [np.convolve(rng.normal(size=R), kernel, "same") for _ in range(k)],
        axis=1,
    ) * (1.5 / norm)
    return ZLearnedModel(
        rest_wavelengths=rest,
        mu=mu,
        M=M,
        bluewards_mu=np.float64(0.2),
        bluewards_sigma=np.float64(0.5),
        redwards_mu=np.float64(0.8),
        redwards_sigma=np.float64(0.3),
    )


def synthetic_z_observation(
    z_true, seed: int = 0, noise: float = 0.08, k: int = 5,
    obs_seed: int | None = None,
):
    """(ZLearnedModel, (wavelengths, flux, noise_variance, pixel_mask))
    observation drawn from the synthetic zQSO GP at a known redshift,
    with out-of-window pixels at the model's blue/redward levels.

    :param obs_seed: seed of the observation noise draw alone (default
        ``seed + 1000``); lets a survey-scale accuracy run draw many
        observations from ONE learned model (fixed ``seed``)."""
    learned = synthetic_z_learned_model(seed=seed, k=k)
    rng = np.random.default_rng(seed + 1000 if obs_seed is None else obs_seed)
    wl = 3600.0 * 10 ** (1e-4 * np.arange(4600))
    rest = wl / (1 + z_true)
    mu = np.interp(rest, learned.rest_wavelengths, learned.mu)
    M = np.stack(
        [
            np.interp(rest, learned.rest_wavelengths, learned.M[:, i])
            for i in range(learned.M.shape[1])
        ],
        axis=1,
    )
    out = (rest < learned.rest_wavelengths[0]) | (
        rest > learned.rest_wavelengths[-1]
    )
    M[out] = 0.0
    flux = mu + M @ rng.normal(size=M.shape[1])
    flux[out] = np.where(
        rest[out] < learned.rest_wavelengths[0],
        float(learned.bluewards_mu),
        float(learned.redwards_mu),
    )
    nv = np.full_like(wl, noise**2)
    flux += noise * rng.normal(size=wl.shape)
    pm = np.zeros(wl.shape, bool)
    return learned, (wl, flux, nv, pm)


def write_speclite(path, wavelengths, flux, noise_variance, pixel_mask) -> str:
    """Write an observation as an SDSS speclite FITS file, the subset
    ``data.fits.read_spec`` reads: an empty primary HDU and one COADD
    binary table of flux, loglam, ivar and and_mask (BRIGHTSKY, bit 24,
    where ``pixel_mask``), big-endian, in 2,880-byte blocks.

    :return: ``path`` as a string.
    """
    def card(key, value):
        if isinstance(value, str):
            return f"{key:<8}= '{value:<8}'".ljust(80)
        text = ("T" if value else "F") if isinstance(value, bool) else str(value)
        return f"{key:<8}= {text:>20}".ljust(80)

    def block(cards):
        text = "".join(cards) + "END".ljust(80)
        return (text + " " * (-len(text) % 2880)).encode("ascii")

    rec = np.zeros(len(flux), dtype=[("flux", ">f4"), ("loglam", ">f4"), ("ivar", ">f4"),
                                     ("and_mask", ">i4")])
    rec["flux"], rec["loglam"] = flux, np.log10(wavelengths)
    rec["ivar"], rec["and_mask"] = 1.0 / noise_variance, np.where(pixel_mask, 1 << 24, 0)
    columns = [card(f"{k}{i}", v) for i, (name, form) in enumerate(
        (("flux", "E"), ("loglam", "E"), ("ivar", "E"), ("and_mask", "J")), 1)
        for k, v in (("TTYPE", name), ("TFORM", form))]
    data = rec.tobytes()
    with open(path, "wb") as f:
        f.write(block([card("SIMPLE", True), card("BITPIX", 8), card("NAXIS", 0)]))
        f.write(block([card("XTENSION", "BINTABLE"), card("BITPIX", 8), card("NAXIS", 2),
                       card("NAXIS1", rec.dtype.itemsize), card("NAXIS2", len(rec)),
                       card("PCOUNT", 0), card("GCOUNT", 1), card("TFIELDS", 4), *columns,
                       card("EXTNAME", "COADD")]))
        f.write(data + b"\x00" * (-len(data) % 2880))
    return str(path)
