"""Strong-Lya-absorber (LLS) search.

Port of ``gpy_dla_detection_tpu/models/lls.py``: the DLA pipeline's GP and
QMC machinery with

* the Lyman-limit-break absorption profile (``profile="lls"`` of
  ``models.evidence``: K1 with ``lls_break`` on the float32 default path,
  the exact unit optical depth plus the break and K5 in the exact
  configuration, the placed windowed unit optical depth plus the break
  and K5 in the unfused windowed one),
* a data-driven column-density prior on logNHI in [17.2, 23]: the
  Garnett (2017) quadratic-fit density above 20.03 with a flat extension
  below it, sampled by analytic inverse CDF at Halton points,
* the catalog-driven model priors P(k absorbers | z_qso) of the DLA
  pipeline, or a flat split of ``p_lls`` without a catalog,
* optionally the BOSS mean-flux parameters tau_0 = 0.00554, beta = 3.182.

The numpy parts (samples, prior density, posteriors, the Fumagalli table)
are the port's own copies of the reference's, under the same names.
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import logsumexp

from ..data.samples import (
    _fit_pdf,
    _gaussian_fit_integral,
    _invert_cdf,
    halton_sequence,
)
from ..data.spectrum import Spectrum, stack, to_torch
from ..params import Parameters
from ..utils.pipeline import pipelined_batches
from .evidence import QMCEvidenceResult, null_log_evidence, qmc_log_evidences
from .learned import FIELDS, LearnedModel, SpectrumModel, build_spectrum_model
from .pipeline import sample_tensors
from .selection import log_priors_k_dlas

# BOSS DR12 mean-flux measurement used by the LLS search
BOSS_TAU_0 = 0.00554
BOSS_BETA = 3.182

# below this column density the Garnett quadratic fit is extended flat
LYA_FLAT_BELOW = 20.03


class LyaSamples(NamedTuple):
    """QMC samples for strong Lya absorbers: uniform z offsets and logNHI
    from the chosen prior."""

    offset_samples: np.ndarray
    log_nhi_samples: np.ndarray
    nhi_samples: np.ndarray


def _lya_unnormalized_integral(lo, hi):
    """integral of the flat-below-20.03 Garnett density over [lo, hi];
    vectorized over ``hi`` (``lo`` is a scalar)."""
    lo = np.float64(lo)
    hi = np.asarray(hi, np.float64)
    flat = _fit_pdf(LYA_FLAT_BELOW) * np.clip(
        np.minimum(hi, LYA_FLAT_BELOW) - lo, 0.0, None
    )
    gauss = np.where(
        hi > LYA_FLAT_BELOW,
        _gaussian_fit_integral(
            max(lo, LYA_FLAT_BELOW), np.maximum(hi, LYA_FLAT_BELOW)
        ),
        0.0,
    )
    return flat + gauss


def lya_log_nhi_pdf(log_nhi, min_log_nhi: float = 17.2, max_log_nhi: float = 23.0):
    """Normalized logNHI prior density of the LLS search: the Garnett
    (2017) fit with a flat low-column extension, normalized on
    [min_log_nhi, max_log_nhi]."""
    log_nhi = np.asarray(log_nhi, np.float64)
    Z = _lya_unnormalized_integral(min_log_nhi, max_log_nhi)
    raw = np.where(
        log_nhi < LYA_FLAT_BELOW, _fit_pdf(LYA_FLAT_BELOW), _fit_pdf(log_nhi)
    )
    in_range = (log_nhi >= min_log_nhi) & (log_nhi <= max_log_nhi)
    return np.where(in_range, raw / Z, 0.0)


def generate_lya_samples(
    num_samples: int = 10000,
    min_log_nhi: float = 17.2,
    max_log_nhi: float = 23.0,
    prior: str = "garnett",
) -> LyaSamples:
    """QMC samples of (z offset, logNHI) for the LLS search.

    ``prior="garnett"`` (default) inverse-CDF samples the density of
    :func:`lya_log_nhi_pdf`; ``prior="uniform"`` keeps a flat logNHI prior.
    """
    seq = halton_sequence(num_samples, 2)
    if prior == "uniform":
        log_nhi = min_log_nhi + (max_log_nhi - min_log_nhi) * seq[:, 1]
    elif prior == "garnett":
        Z = _lya_unnormalized_integral(min_log_nhi, max_log_nhi)
        cdf = lambda x: _lya_unnormalized_integral(min_log_nhi, x) / Z
        log_nhi = _invert_cdf(seq[:, 1], cdf, min_log_nhi, max_log_nhi)
    else:
        raise ValueError(f"unknown prior {prior!r}")
    return LyaSamples(
        offset_samples=seq[:, 0],
        log_nhi_samples=log_nhi,
        nhi_samples=10.0**log_nhi,
    )


def with_boss_meanflux(learned: LearnedModel) -> LearnedModel:
    """A new model with the Kim mean-flux parameters replaced by the BOSS
    measurement (the other buffers are shared)."""
    like = learned.prev_tau_0
    swap = {
        "prev_tau_0": torch.tensor(BOSS_TAU_0, dtype=like.dtype, device=like.device),
        "prev_beta": torch.tensor(BOSS_BETA, dtype=like.dtype, device=like.device),
    }
    return LearnedModel(*[swap.get(f, getattr(learned, f)) for f in FIELDS])


def lls_log_evidences(
    learned: LearnedModel,
    spec: Spectrum,
    samples: LyaSamples,
    generator: torch.Generator,
    max_lya: int,
    params: Parameters,
    base_inds_override=None,
    voigt_impl: str = "windowed",
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
    resampler: str = "multinomial",
) -> tuple[torch.Tensor, QMCEvidenceResult]:
    """(null evidence, QMC result for 1..max_lya absorbers) for one
    spectrum with the LLS-break profile, on the learned model's device and
    dtype.

    :param generator: drives the importance resampling; on that device.
    :param base_inds_override: optional (max_lya - 1, S) resampling indices
        replacing the draws.
    :param voigt_impl: ``"windowed"`` (K1 with the break),
        ``"windowed_weideman"`` (K1 with the break and the Weideman window),
        ``"exact"`` or ``"windowed_unfused"`` (see
        ``models.evidence.single_absorber_profiles``).
    :param abs_dtype: storage of the profiles, None (the model's dtype) or
        ``torch.int16`` (see ``models.evidence.qmc_log_evidences``).
    :param window_tier: the reference's ``GPY_DLA_WINDOW_TIER`` for
        ``"windowed_unfused"``; ignored by the other configurations.
    :param use_kernels: the float32 likelihood's route (see
        ``ops.logmvn.batched_log_mvnpdf``).
    :param resampler: ``"multinomial"`` or ``"systematic"`` (see
        ``models.evidence.qmc_log_evidences``).
    """
    device, dtype = learned.mu.device, learned.mu.dtype
    model = build_spectrum_model(learned, to_torch(spec, device, dtype), params)
    if base_inds_override is not None:
        base_inds_override = torch.as_tensor(
            np.asarray(base_inds_override, np.int64), device=device
        )
    result = qmc_log_evidences(
        model, *sample_tensors(samples, device, dtype), generator, max_lya, params,
        base_inds_override=base_inds_override, voigt_impl=voigt_impl, profile="lls",
        abs_dtype=abs_dtype, window_tier=window_tier, use_kernels=use_kernels,
        resampler=resampler,
    )
    return null_log_evidence(model), result


def lls_model_posteriors(
    log_evidence_null: float,
    log_evidences_lls: np.ndarray,
    num_dlas: int | None = None,
    num_quasars: int | None = None,
    p_lls: float = 0.5,
):
    """Posterior over {no absorber, 1..k absorbers}.

    With catalog counts (``num_dlas``/``num_quasars`` from
    ``PriorCatalog.less_ind``) the absorber priors are the DLA pipeline's
    P(k | z_qso) and the null prior is 1 minus their total; without them
    ``p_lls`` is split flat over k.
    """
    k = np.size(log_evidences_lls)
    if num_dlas is not None and num_quasars is not None:
        log_priors_abs = log_priors_k_dlas(num_dlas, num_quasars, k)
        log_prior_null = np.log1p(-np.exp(logsumexp(log_priors_abs)))
        log_priors = np.concatenate([[log_prior_null], log_priors_abs])
    else:
        log_priors = np.log(np.concatenate([[1.0 - p_lls], np.full(k, p_lls / k)]))
    log_post = (
        np.concatenate([[log_evidence_null], np.ravel(log_evidences_lls)]) + log_priors
    )
    m = np.nanmax(log_post)
    with np.errstate(invalid="ignore"):
        post = np.exp(log_post - m)
    post = np.nan_to_num(post)
    post /= post.sum()
    return post


class FumagalliTable(NamedTuple):
    """The Fumagalli+ 2020 LLS truth table (staa2388 supplemental data)."""

    quasar_name: np.ndarray
    right_ascension_deg: np.ndarray
    declination_deg: np.ndarray
    redshift: np.ndarray
    SN_1150A: np.ndarray
    science_primary: np.ndarray
    in_training_set: np.ndarray
    classification_outcome: np.ndarray
    LLS_redshift: np.ndarray


def load_fumagalli_table(filepath: str, skiprows: int = 15) -> FumagalliTable:
    """Parse the whitespace-separated Fumagalli supplemental table."""
    names, ras, decs, zs, sns = [], [], [], [], []
    prim, train, outcome, z_lls = [], [], [], []
    with open(filepath) as f:
        for i, line in enumerate(f):
            if i < skiprows:
                continue
            parts = line.split()
            if len(parts) < 9:
                continue
            names.append(parts[0])
            ras.append(float(parts[1]))
            decs.append(float(parts[2]))
            zs.append(float(parts[3]))
            sns.append(float(parts[4]))
            prim.append(int(float(parts[5])))
            train.append(int(float(parts[6])))
            outcome.append(int(float(parts[7])))
            z_lls.append(float(parts[8]))
    return FumagalliTable(
        quasar_name=np.asarray(names),
        right_ascension_deg=np.asarray(ras),
        declination_deg=np.asarray(decs),
        redshift=np.asarray(zs),
        SN_1150A=np.asarray(sns),
        science_primary=np.asarray(prim),
        in_training_set=np.asarray(train),
        classification_outcome=np.asarray(outcome),
        LLS_redshift=np.asarray(z_lls),
    )


def lls_inference_many(
    learned: LearnedModel,
    specs: Iterable[Spectrum],
    samples: LyaSamples,
    generator: torch.Generator,
    max_lya: int,
    params: Parameters,
    batch_size: int = 8,
    voigt_impl: str = "windowed",
    base_inds_override=None,
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
    resampler: str = "multinomial",
    max_in_flight: int = 2,
) -> list[tuple[float, QMCEvidenceResult]]:
    """The LLS search over many spectra.  Each batch of ``batch_size``
    spectra is stacked, moved to the device and modelled in one pass; the
    QMC levels then run per spectrum on the device, and the copies of the
    batch's results to the host are queued behind them.  Up to
    ``max_in_flight`` batches are dispatched ahead of the readback
    (``utils.pipeline.pipelined_batches``).  ``generator`` is consumed in
    stream order, so the results equal :func:`lls_log_evidences` called on
    the same spectra in turn with the same generator, whatever
    ``max_in_flight`` is.

    :param specs: any iterable of preprocessed spectra.
    :param voigt_impl: as for :func:`lls_log_evidences`.
    :param base_inds_override: optional (n_spectra, max_lya - 1, S)
        resampling indices replacing the draws, in the order of ``specs``.
    :param abs_dtype, window_tier, use_kernels, resampler: as for
        :func:`lls_log_evidences`.
    :param max_in_flight: batches dispatched ahead of the readback (0:
        each batch is read back before the next is dispatched).
    :return: per spectrum (null evidence, QMC result as numpy arrays).
    """
    device, dtype = learned.mu.device, learned.mu.dtype
    sample_t = sample_tensors(samples, device, dtype)
    if base_inds_override is not None:
        base_inds_override = torch.as_tensor(
            np.asarray(base_inds_override, np.int64), device=device
        )

    def dispatch(batch, batch_inds):
        models = build_spectrum_model(learned, to_torch(stack(batch), device, dtype), params)
        null = null_log_evidence(models)
        results = [
            qmc_log_evidences(
                SpectrumModel(*[f[i] for f in models]), *sample_t, generator,
                max_lya, params, voigt_impl=voigt_impl, profile="lls",
                abs_dtype=abs_dtype, window_tier=window_tier, use_kernels=use_kernels,
                resampler=resampler,
                base_inds_override=None if batch_inds is None else batch_inds[i],
            )
            for i in range(len(batch))
        ]
        return null, [torch.stack(f) for f in zip(*results)]

    def finalize(n, out):
        null, stacked = out
        return [
            (float(null[i]), QMCEvidenceResult(*[f[i] for f in stacked])) for i in range(n)
        ]

    return pipelined_batches(specs, batch_size, max_in_flight, dispatch, finalize,
                             aux=base_inds_override)
