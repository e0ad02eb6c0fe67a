"""Batched Bayesian model selection over many spectra on one device.

Port of the single-device part of
``gpy_dla_detection_tpu/parallel/batch.py``.  The spectra of a batch are
interpolated and their null evidences computed as one batched pass; the
QMC marginalization then loops over the spectra, each level launching the
likelihood kernels over all S samples of one spectrum.  When the DLA and
subDLA sample sets share their redshift offsets (as the reference's
sample files do), one redshift evaluation serves both families: one K1
launch by default (``voigt_impl="windowed"``, or with the Weideman window
``"windowed_weideman"``); in the exact configuration
(``voigt_impl="exact"``) one exact unit optical depth and one K5 launch
per family; in the unfused windowed configuration
(``voigt_impl="windowed_unfused"``) one windowed unit optical depth in
parts and one K6 launch per family.  With ``abs_dtype=torch.int16`` the
profiles are stored as fixed-point codes (``ops/kernel_config.py``):
encoded in that launch, for both families, and decoded in K2.

``dispatch_batch`` only enqueues device work and returns device tensors;
``finalize_batch`` copies them to the host once and runs the model
selection, so a caller can overlap one batch's host work with the next
batch's device work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.catalog import PriorCatalog
from ..data.samples import DLASamples, SubDLASamples
from ..data.spectrum import Spectrum, stack, to_torch
from ..models.evidence import (
    QMCEvidenceResult,
    null_log_evidence,
    qmc_log_evidences,
    single_absorber_profiles,
)
from ..models.learned import LearnedModel, SpectrumModel, build_spectrum_model
from ..models.pipeline import (
    EvidenceOutputs,
    SampleTensors,
    SpectrumResult,
    sample_tensors,
    spectrum_result,
)
from ..params import Parameters


def _stack_results(results: list[QMCEvidenceResult]) -> QMCEvidenceResult:
    return QMCEvidenceResult(*[torch.stack(f) for f in zip(*results)])


def batch_evidences(
    learned: LearnedModel,
    specs: Spectrum,
    dla: SampleTensors,
    sub: SampleTensors,
    generator: torch.Generator,
    params: Parameters,
    max_dlas: int = 4,
    shared_offsets: bool = False,
    base_inds_override: torch.Tensor | None = None,
    voigt_impl: str = "windowed",
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
) -> EvidenceOutputs:
    """Evidences for a batch of tensor spectra (leading axis).

    :param shared_offsets: the DLA and subDLA offsets are equal, so one
        profile evaluation serves both families.
    :param base_inds_override: optional (B, max_dlas - 1, S) resampling
        indices replacing the draws of each spectrum's DLA chain.
    :param voigt_impl: ``"windowed"`` (K1), ``"windowed_weideman"`` (K1
        with the Weideman window), ``"exact"`` (exact unit optical depth +
        K5) or ``"windowed_unfused"`` (windowed parts + K6); see
        ``models.evidence.single_absorber_profiles``.
    :param abs_dtype: storage of the profiles: None keeps the model's
        dtype, ``torch.int16`` stores fixed-point codes (see
        ``models.evidence.qmc_log_evidences``).
    :param window_tier: the reference's ``GPY_DLA_WINDOW_TIER`` for
        ``"windowed_unfused"``; ignored by the other configurations.
    :param use_kernels: the float32 likelihood's route (see
        ``ops.logmvn.batched_log_mvnpdf``).
    """
    models = build_spectrum_model(learned, specs, params)
    null = null_log_evidence(models)
    dla_out, sub_out = [], []
    for i in range(null.shape[0]):
        model = SpectrumModel(*[f[i] for f in models])
        A_dla = A_sub = None
        if shared_offsets:
            z = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * dla.offset_samples
            A_dla, A_sub = single_absorber_profiles(
                model.padded_wavelengths, z,
                (dla.nhi_samples, sub.nhi_samples), params.num_lines,
                voigt_impl, out_dtype=abs_dtype, window_tier=window_tier,
            )
        dla_out.append(
            qmc_log_evidences(
                model, *dla, generator, max_dlas, params,
                base_inds_override=(
                    None if base_inds_override is None else base_inds_override[i]
                ),
                A_override=A_dla,
                voigt_impl=voigt_impl,
                abs_dtype=abs_dtype,
                window_tier=window_tier,
                use_kernels=use_kernels,
            )
        )
        sub_out.append(
            qmc_log_evidences(
                model, *sub, generator, 1, params, A_override=A_sub,
                voigt_impl=voigt_impl, abs_dtype=abs_dtype, window_tier=window_tier,
                use_kernels=use_kernels,
            )
        )
    return EvidenceOutputs(null, _stack_results(dla_out), _stack_results(sub_out))


def dispatch_batch(
    learned: LearnedModel,
    spectra: list[Spectrum],
    dla_samples: DLASamples,
    subdla_samples: SubDLASamples,
    params: Parameters,
    generator: torch.Generator,
    max_dlas: int = 4,
    base_inds_override: np.ndarray | None = None,
    voigt_impl: str = "windowed",
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
) -> EvidenceOutputs:
    """Enqueue one batch's evidence computation on the learned model's
    device and dtype, and return the device outputs without waiting.

    :param base_inds_override: optional (B, max_dlas - 1, S) resampling
        indices replacing the draws (reproduces a reference run).
    :param voigt_impl: ``"windowed"`` (default, K1),
        ``"windowed_weideman"``, ``"exact"`` or ``"windowed_unfused"``.
    :param abs_dtype: profile storage, None (the model's dtype) or
        ``torch.int16``.
    :param window_tier, use_kernels: as for :func:`batch_evidences`.
    """
    device, dtype = learned.mu.device, learned.mu.dtype
    shared = np.array_equal(
        np.asarray(dla_samples.offset_samples),
        np.asarray(subdla_samples.offset_samples),
    )
    return batch_evidences(
        learned,
        to_torch(stack(spectra), device, dtype),
        sample_tensors(dla_samples, device, dtype),
        sample_tensors(subdla_samples, device, dtype),
        generator,
        params,
        max_dlas,
        shared_offsets=bool(shared),
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


def finalize_batch(
    out: EvidenceOutputs,
    spectra: list[Spectrum],
    subdla_samples: SubDLASamples,
    prior: PriorCatalog,
    max_dlas: int = 4,
) -> list[SpectrumResult]:
    """Copy one dispatched batch to the host (once per output) and run
    the model selection per spectrum."""
    host = lambda t: t.detach().cpu().numpy()
    null_ev = host(out.log_evidence_null)
    dla_ev = host(out.dla.log_evidences)
    sub_ev = host(out.subdla.log_evidences)
    dla_sll = host(out.dla.sample_log_likelihoods)
    sub_sll = host(out.subdla.sample_log_likelihoods)
    base_inds = host(out.dla.base_sample_inds)
    map_z = host(out.dla.map_z_dlas)
    map_lognhi = host(out.dla.map_log_nhis)
    return [
        spectrum_result(
            null_ev[i], dla_ev[i], sub_ev[i], dla_sll[i], sub_sll[i],
            base_inds[i], map_z[i], map_lognhi[i], spec, subdla_samples,
            prior, max_dlas,
        )
        for i, spec in enumerate(spectra)
    ]


def process_batch(
    learned: LearnedModel,
    spectra: list[Spectrum],
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
) -> list[SpectrumResult]:
    """Full model selection for a list of spectra: dispatch + finalize.

    :param generator: drives the importance resampling; on the learned
        model's device.
    :param base_inds_override: optional (B, max_dlas - 1, S) resampling
        indices replacing the draws.
    :param voigt_impl: ``"windowed"`` (default, K1),
        ``"windowed_weideman"`` (K1 with the Weideman window, the
        reference's ``GPY_DLA_FUSED_POLY=0``), ``"exact"`` (exact unit
        optical depth + K5, the reference's ``GPY_DLA_FAST_VOIGT=0``) or
        ``"windowed_unfused"`` (windowed parts + K6, the reference's
        ``GPY_DLA_FUSED_ABS=0``).
    :param abs_dtype: storage of the absorption profiles: None (default)
        keeps the model's dtype; ``torch.int16`` stores fixed-point codes
        (the reference's ``GPY_DLA_ABS_DTYPE=i16`` or ``i16p``; see
        ``ops.kernel_config.profile_store_dtype``).
    :param window_tier: the two-tier window of ``"windowed_unfused"`` (the
        reference's ``GPY_DLA_WINDOW_TIER``, on by default); ignored by the
        other configurations.
    :param use_kernels: the float32 likelihood's route (the reference's
        ``use_pallas``): None (default) takes K2 and K3 at any GP basis
        width; False the plain composition, on the CPU only.
    """
    out = dispatch_batch(
        learned, spectra, dla_samples, subdla_samples, params, generator,
        max_dlas, base_inds_override, voigt_impl, abs_dtype, window_tier, use_kernels,
    )
    return finalize_batch(out, spectra, subdla_samples, prior, max_dlas)
