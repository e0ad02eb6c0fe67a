"""CIV doublet detection: the QMC model evidence and posterior.

Port of ``gpy_dla_detection_tpu/models/civ.py``: null (no CIV) against one
CIV doublet, marginalized by QMC over (z_civ, logN_CIV, sigma) with the
DLA engine's estimator (log-mean-exp of the per-sample likelihoods with a
1/S Occam factor).  The profiles are the CIV doublet with a free
broadening per sample (``ops/voigt.voigt_absorption_civ``: K5 does the
exp and the convolution on float32), the likelihoods K2 and K3 with no
absorption-noise term (omega2 = 0: the CIV covariance is M M^T + V).
Per spectrum that is one K5, one K2 and one K3 launch.

A batch is dispatched by :func:`dispatch_civ_batch`, which enqueues its
device work and returns its evidences' tensors without waiting, and
finalized by :func:`finalize_civ_batch` from the read-back evidences;
:func:`civ_inference_many` runs the two through the in-flight window.  Stages are marked with ``utils.timing.span`` (recorded
only inside a ``timing.recording()`` block): ``gpy.civ_dispatch`` around
a dispatch, in it ``gpy.civ_model`` (the batch's models and null
evidences) and per spectrum ``gpy.civ_profile`` (the doublet's unit
optical depth and K5) and ``gpy.civ_likelihood`` (K2, K3 and the
log-mean-exp); ``gpy.civ_finalize`` around a finalize.

The numpy parts (samples, posterior) are the port's own copies of the
reference's, under the same names.
"""

from __future__ import annotations

import math
from collections.abc import Iterable
from typing import NamedTuple

import numpy as np
import torch

from ..data.samples import halton_sequence
from ..data.spectrum import Spectrum, stack, to_torch
from ..ops.logmvn import batched_log_mvnpdf, likelihood_pair_basis, log_mvnpdf_low_rank
from ..ops.voigt import voigt_absorption_civ
from ..params import CIVParameters
from ..utils.pipeline import pipelined_batches
from ..utils.timing import span
from .learned import LearnedModel, SpectrumModel, build_spectrum_model


class CIVSamples(NamedTuple):
    """QMC samples of (z offset, logN_CIV, sigma)."""

    offset_samples: np.ndarray
    log_nciv_samples: np.ndarray
    nciv_samples: np.ndarray
    sigma_samples: np.ndarray


def generate_civ_samples(
    params: CIVParameters,
    num_samples: int | None = None,
    min_sigma: float = 1e6,
    max_sigma: float = 8e6,
) -> CIVSamples:
    """Uniform priors over logN (reference: civ_gp.py:99-110) and the
    broadening velocity sigma, at Halton points."""
    S = num_samples or params.num_civ_samples
    seq = halton_sequence(S, 3)
    log_n = params.uniform_min_log_nciv + (
        params.uniform_max_log_nciv - params.uniform_min_log_nciv
    ) * seq[:, 1]
    sigma = min_sigma + (max_sigma - min_sigma) * seq[:, 2]
    return CIVSamples(
        offset_samples=seq[:, 0],
        log_nciv_samples=log_n,
        nciv_samples=10.0**log_n,
        sigma_samples=sigma,
    )


def civ_null_log_evidence(model: SpectrumModel) -> torch.Tensor:
    """log p(D | no CIV): N(y; mu, M M^T + V), batched over any leading
    axes of the model (reference: civ_gp.py:158-183)."""
    return log_mvnpdf_low_rank(model.y, model.mu, model.M, model.v, model.mask)


def civ_qmc_log_evidence(
    model: SpectrumModel, samples: CIVSamples, params: CIVParameters,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """log p(D | 1 CIV) by QMC over (z, logN, sigma), on the model's device
    and dtype; the samples may be numpy arrays or tensors there.

    :param use_kernels: the float32 likelihood's route (None: K2 and K3;
        False: the plain composition, on the CPU only; see
        ``ops.logmvn.batched_log_mvnpdf``).

    :return: (evidence, (S,) per-sample log-likelihoods with the 1/S Occam
        factor).
    """
    dtype, device = model.y.dtype, model.y.device
    offsets, nciv, sigma = (
        torch.as_tensor(x, dtype=dtype, device=device)
        for x in (samples.offset_samples, samples.nciv_samples, samples.sigma_samples)
    )
    S = offsets.shape[0]
    with span("gpy.civ_profile"):
        z_civ = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * offsets
        absorption = voigt_absorption_civ(
            model.padded_wavelengths, nciv, z_civ, sigma, params.num_lines
        )
    with span("gpy.civ_likelihood"):
        lls = batched_log_mvnpdf(
            model.y, model.mu, model.M, torch.zeros_like(model.v), model.v, model.mask,
            absorption, likelihood_pair_basis(model.M), use_kernels=use_kernels,
        ) - math.log(S)
        max_ll = torch.max(lls)
        evidence = max_ll + torch.log(torch.mean(torch.exp(lls - max_ll)))
    return evidence, lls


def civ_model_posterior(log_evidence_null, log_evidence_civ, p_civ_prior: float = 0.5):
    """Two-model posterior P(CIV | D)."""
    lp = np.array([
        float(log_evidence_null) + np.log1p(-p_civ_prior),
        float(log_evidence_civ) + np.log(p_civ_prior),
    ])
    m = lp.max()
    post = np.exp(lp - m)
    post /= post.sum()
    return post[1]


def civ_spectrum_model(
    learned: LearnedModel, spec: Spectrum, params: CIVParameters
) -> SpectrumModel:
    """The learned model on a spectrum (or a stacked batch) with no
    absorption-noise term (reference: civ_gp.py:158-183)."""
    device, dtype = learned.mu.device, learned.mu.dtype
    model = build_spectrum_model(learned, to_torch(spec, device, dtype), params)
    return model._replace(omega2=torch.zeros_like(model.v))


def civ_log_evidences(
    learned: LearnedModel, spec: Spectrum, samples: CIVSamples, params: CIVParameters,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(null, CIV) log evidences of one spectrum, on the learned model's
    device and dtype (the reference's ``_civ_step``; ``use_kernels`` as
    for :func:`civ_qmc_log_evidence`)."""
    model = civ_spectrum_model(learned, spec, params)
    return (civ_null_log_evidence(model),
            civ_qmc_log_evidence(model, samples, params, use_kernels)[0])


def civ_sample_tensors(samples: CIVSamples, learned: LearnedModel) -> CIVSamples:
    """The QMC samples as tensors on the learned model's device and dtype,
    moved there once for every batch :func:`dispatch_civ_batch` takes."""
    device, dtype = learned.mu.device, learned.mu.dtype
    return CIVSamples(*[torch.as_tensor(x, dtype=dtype, device=device) for x in samples])


def dispatch_civ_batch(
    learned: LearnedModel,
    batch: list[Spectrum],
    samples: CIVSamples,
    params: CIVParameters,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue one batch's CIV evidences on the learned model's device and
    dtype and return without waiting: the batch is stacked and modelled in
    one pass with its null evidences, then each spectrum's QMC evidence
    runs on the device.

    :param samples: the QMC samples as :func:`civ_sample_tensors` gives them.
    :param use_kernels: as for :func:`civ_qmc_log_evidence`.
    :return: the (2, B) null and CIV log evidences and the (B, S)
        per-sample log-likelihoods (with the 1/S Occam factor).
    """
    with span("gpy.civ_dispatch"):
        with span("gpy.civ_model"):
            models = civ_spectrum_model(learned, stack(batch), params)
            null = civ_null_log_evidence(models)
        civ, lls = zip(*[
            civ_qmc_log_evidence(SpectrumModel(*[f[i] for f in models]), samples, params,
                                 use_kernels)
            for i in range(len(batch))
        ])
        return torch.stack([null, torch.stack(civ)]), torch.stack(lls)


def finalize_civ_batch(evidences, p_civ_prior: float = 0.5) -> list[tuple[float, float, float]]:
    """Per spectrum (p_civ, log_evidence_null, log_evidence_civ) of one
    batch, from its (2, B) evidences read back to the host."""
    with span("gpy.civ_finalize"):
        return [
            (civ_model_posterior(null, civ, p_civ_prior), float(null), float(civ))
            for null, civ in zip(*evidences)
        ]


def civ_inference_many(
    learned: LearnedModel,
    specs: Iterable[Spectrum],
    samples: CIVSamples,
    params: CIVParameters,
    p_civ_prior: float = 0.5,
    batch_size: int = 16,
    use_kernels: bool | None = None,
    max_in_flight: int = 4,
) -> list[tuple[float, float, float]]:
    """CIV detection over many spectra.  Each batch of ``batch_size``
    spectra is stacked, moved to the device and modelled in one pass; the
    QMC evidence then runs per spectrum on the device, and the copies of
    the batch's evidences to the host are queued behind it.  Up to
    ``max_in_flight`` batches are dispatched ahead of the readback
    (``utils.pipeline.pipelined_batches``); the results do not depend on
    it.

    :param specs: any iterable of preprocessed spectra.
    :param use_kernels: as for :func:`civ_qmc_log_evidence`.
    :param max_in_flight: batches dispatched ahead of the readback (0:
        each batch is read back before the next is dispatched).
    :return: per spectrum (p_civ, log_evidence_null, log_evidence_civ).
    """
    sample_t = civ_sample_tensors(samples, learned)
    return pipelined_batches(
        specs, batch_size, max_in_flight,
        lambda batch, _: dispatch_civ_batch(learned, batch, sample_t, params, use_kernels)[0],
        lambda n, evidences: finalize_civ_batch(evidences, p_civ_prior),
    )
