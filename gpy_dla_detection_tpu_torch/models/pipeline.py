"""End-to-end per-spectrum Bayesian model selection.

Port of ``gpy_dla_detection_tpu/models/pipeline.py``: model construction,
the null evidence and the subDLA and multi-DLA QMC evidences run on the
device; the catalog priors and the posterior combination are host
scalars (``models.selection``, the port's copy of the reference's).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.catalog import PriorCatalog
from ..data.samples import DLASamples, SubDLASamples
from ..data.spectrum import Spectrum, to_torch
from ..params import Parameters
from .evidence import QMCEvidenceResult, null_log_evidence, qmc_log_evidences
from .learned import LearnedModel, build_spectrum_model
from .selection import (
    ModelSelectionResult,
    log_priors_k_dlas,
    log_priors_subdla,
    model_selection,
)


class EvidenceOutputs(NamedTuple):
    """Device-side outputs of the evidence computation."""

    log_evidence_null: torch.Tensor
    dla: QMCEvidenceResult
    subdla: QMCEvidenceResult


class SampleTensors(NamedTuple):
    """One QMC sample set on the device."""

    offset_samples: torch.Tensor  # (S,)
    log_nhi_samples: torch.Tensor  # (S,)
    nhi_samples: torch.Tensor  # (S,)


def sample_tensors(samples: DLASamples | SubDLASamples, device, dtype) -> SampleTensors:
    put = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return SampleTensors(
        put(samples.offset_samples),
        put(samples.log_nhi_samples),
        put(samples.nhi_samples),
    )


def compute_evidences(
    learned: LearnedModel,
    spec: Spectrum,
    dla: SampleTensors,
    sub: SampleTensors,
    generator: torch.Generator,
    params: Parameters,
    max_dlas: int,
    base_inds_override: torch.Tensor | None = None,
    voigt_impl: str = "windowed",
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
) -> EvidenceOutputs:
    """All model evidences for one tensor spectrum.

    :param base_inds_override: optional (max_dlas - 1, S) resampling
        indices replacing the draws of the DLA chain.
    :param voigt_impl: ``"windowed"`` (K1), ``"windowed_weideman"`` (K1
        with the Weideman window), ``"exact"`` (exact unit optical depth +
        K5) or ``"windowed_unfused"`` (windowed parts + K6).
    :param abs_dtype: storage of the absorption profiles, None (the
        model's dtype) or ``torch.int16`` (see
        ``models.evidence.qmc_log_evidences``).
    :param window_tier: the reference's ``GPY_DLA_WINDOW_TIER`` for
        ``"windowed_unfused"``; ignored by the other configurations.
    :param use_kernels: the float32 likelihood's route (None: K2 and K3;
        False: the plain composition, on the CPU only; see
        ``ops.logmvn.batched_log_mvnpdf``).
    """
    model = build_spectrum_model(learned, spec, params)
    return EvidenceOutputs(
        log_evidence_null=null_log_evidence(model),
        dla=qmc_log_evidences(
            model, *dla, generator, max_dlas, params,
            base_inds_override=base_inds_override, voigt_impl=voigt_impl,
            abs_dtype=abs_dtype, window_tier=window_tier, use_kernels=use_kernels,
        ),
        subdla=qmc_log_evidences(
            model, *sub, generator, 1, params, voigt_impl=voigt_impl,
            abs_dtype=abs_dtype, window_tier=window_tier, use_kernels=use_kernels,
        ),
    )


class SpectrumResult(NamedTuple):
    """Everything the catalog records for one spectrum."""

    selection: ModelSelectionResult
    log_evidence_null: float
    log_evidences_dla: np.ndarray  # (max_dlas,)
    log_evidence_subdla: float
    sample_log_likelihoods_dla: np.ndarray  # (S, max_dlas)
    sample_log_likelihoods_subdla: np.ndarray  # (S,)
    base_sample_inds: np.ndarray  # (max_dlas - 1, S)
    map_z_dlas: np.ndarray  # (max_dlas, max_dlas)
    map_log_nhis: np.ndarray  # (max_dlas, max_dlas)
    min_z_dla: float
    max_z_dla: float
    p_dla: float
    p_no_dla: float


def spectrum_result(
    null_ev: float,
    dla_ev: np.ndarray,
    sub_ev: np.ndarray,
    dla_sll: np.ndarray,
    sub_sll: np.ndarray,
    base_inds: np.ndarray,
    map_z: np.ndarray,
    map_lognhi: np.ndarray,
    spec: Spectrum,
    subdla_samples: SubDLASamples,
    prior: PriorCatalog,
    max_dlas: int,
) -> SpectrumResult:
    """Host-side model selection for one spectrum's evidences."""
    num_dlas, num_quasars = prior.less_ind(float(spec.z_qso))
    lp_dla = log_priors_k_dlas(num_dlas, num_quasars, max_dlas)
    lp_sub = log_priors_subdla(
        num_dlas, num_quasars, subdla_samples.Z_lls, subdla_samples.Z_dla
    )
    sel = model_selection(lp_sub, lp_dla, float(null_ev), sub_ev, dla_ev)
    return SpectrumResult(
        selection=sel,
        log_evidence_null=float(null_ev),
        log_evidences_dla=dla_ev,
        log_evidence_subdla=float(sub_ev[0]),
        sample_log_likelihoods_dla=dla_sll,
        sample_log_likelihoods_subdla=sub_sll[:, 0],
        base_sample_inds=base_inds,
        map_z_dlas=map_z,
        map_log_nhis=map_lognhi,
        min_z_dla=float(spec.min_z_dla),
        max_z_dla=float(spec.max_z_dla),
        p_dla=sel.p_dla,
        p_no_dla=sel.p_no_dla,
    )


def process_spectrum(
    learned: LearnedModel,
    spec: Spectrum,
    dla_samples: DLASamples,
    subdla_samples: SubDLASamples,
    prior: PriorCatalog,
    params: Parameters,
    generator: torch.Generator,
    max_dlas: int = 4,
    base_inds_override: np.ndarray | None = None,
    voigt_impl: str = "windowed",
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
) -> SpectrumResult:
    """Full Bayesian model selection for one preprocessed spectrum, on the
    learned model's device and dtype (``voigt_impl``, ``abs_dtype``,
    ``window_tier`` and ``use_kernels`` as in :func:`compute_evidences`)."""
    device, dtype = learned.mu.device, learned.mu.dtype
    out = compute_evidences(
        learned,
        to_torch(spec, device, dtype),
        sample_tensors(dla_samples, device, dtype),
        sample_tensors(subdla_samples, device, dtype),
        generator,
        params,
        max_dlas,
        base_inds_override=(
            None
            if base_inds_override is None
            else torch.as_tensor(np.asarray(base_inds_override, np.int64), device=device)
        ),
        voigt_impl=voigt_impl,
        abs_dtype=abs_dtype,
        window_tier=window_tier,
        use_kernels=use_kernels,
    )
    host = lambda t: t.detach().cpu().numpy()
    return spectrum_result(
        host(out.log_evidence_null),
        host(out.dla.log_evidences),
        host(out.subdla.log_evidences),
        host(out.dla.sample_log_likelihoods),
        host(out.subdla.sample_log_likelihoods),
        host(out.dla.base_sample_inds),
        host(out.dla.map_z_dlas),
        host(out.dla.map_log_nhis),
        spec,
        subdla_samples,
        prior,
        max_dlas,
    )
