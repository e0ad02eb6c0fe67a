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

``dispatch_batch`` only enqueues device work, then the copies of its
outputs into host buffers (pinned, non-blocking, closed by a CUDA event;
on the CPU a plain copy), and returns without waiting;
``finalize_batch`` waits for that event alone, not for the device's
queue, and runs the model selection.  A caller can so keep several
batches in flight and finalize one while the device computes the next
(the catalog CLI's window, ``run_bayes_select.py``).
``device_put_inputs`` moves the batch-invariant inputs to the device
once, and with them the decision that the two sample sets share their
offsets.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

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
    resampler: str = "multinomial",
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
    :param resampler: the DLA chain's importance resampler,
        ``"multinomial"`` or ``"systematic"`` (see
        ``models.evidence.qmc_log_evidences``).
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
                resampler=resampler,
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


class DeviceInputs(NamedTuple):
    """The batch-invariant inputs on the device (:func:`device_put_inputs`)."""

    learned: LearnedModel
    dla: SampleTensors
    sub: SampleTensors
    shared_offsets: bool  # the two sample sets' offsets are equal


def _with_samples(
    learned: LearnedModel, dla_samples: DLASamples, subdla_samples: SubDLASamples
) -> DeviceInputs:
    """Both sample sets on the learned model's device and dtype, and the
    decision, made here once, that they share their offsets (one profile
    evaluation then serves both families)."""
    device, dtype = learned.mu.device, learned.mu.dtype
    return DeviceInputs(
        learned,
        sample_tensors(dla_samples, device, dtype),
        sample_tensors(subdla_samples, device, dtype),
        np.array_equal(
            np.asarray(dla_samples.offset_samples),
            np.asarray(subdla_samples.offset_samples),
        ),
    )


def device_put_inputs(
    learned: Sequence,
    dla_samples: DLASamples,
    subdla_samples: SubDLASamples,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> DeviceInputs:
    """Move the learned model and both QMC sample sets to the device once,
    for every batch of a run, and decide there once whether the two sets
    share their offsets (no batch compares them again).

    :param learned: the reference container's fields as numpy arrays
        (``LearnedModel.from_numpy``).
    """
    return _with_samples(
        LearnedModel.from_numpy(learned, device, dtype), dla_samples, subdla_samples
    )


class BatchReadback(NamedTuple):
    """One dispatched batch: its outputs' host copies, being filled.

    The host tensors are pinned on a CUDA device and written by
    non-blocking copies; ``done`` is the event recorded after them (None
    on the CPU, where the copies are plain).  They are held here, so each
    buffer outlives its copy.  In catalog-lite batches the per-sample
    fields are None: those arrays never leave the device."""

    log_evidence_null: torch.Tensor  # (B,)
    dla_log_evidences: torch.Tensor  # (B, max_dlas)
    sub_log_evidences: torch.Tensor  # (B, 1)
    dla_sample_lls: torch.Tensor | None  # (B, S, max_dlas)
    sub_sample_lls: torch.Tensor | None  # (B, S, 1)
    base_sample_inds: torch.Tensor | None  # (B, max_dlas - 1, S)
    map_z_dlas: torch.Tensor  # (B, max_dlas, max_dlas)
    map_log_nhis: torch.Tensor  # (B, max_dlas, max_dlas)
    done: torch.cuda.Event | None


def _start_readback(out: EvidenceOutputs, with_sample_lls: bool) -> BatchReadback:
    """Enqueue the copies of a batch's outputs to the host, behind the
    work already queued on the current stream, and return at once
    (the counterpart of the reference's ``copy_to_host_async``)."""
    cuda = out.log_evidence_null.is_cuda

    def copy(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        return host.copy_(t.detach(), non_blocking=cuda)

    sample = lambda t: copy(t) if with_sample_lls else None
    fields = (
        copy(out.log_evidence_null),
        copy(out.dla.log_evidences),
        copy(out.subdla.log_evidences),
        sample(out.dla.sample_log_likelihoods),
        sample(out.subdla.sample_log_likelihoods),
        sample(out.dla.base_sample_inds),
        copy(out.dla.map_z_dlas),
        copy(out.dla.map_log_nhis),
    )
    done = None
    if cuda:
        done = torch.cuda.Event()
        done.record()
    return BatchReadback(*fields, done)


def dispatch_batch(
    inputs: DeviceInputs,
    spectra: list[Spectrum],
    params: Parameters,
    generator: torch.Generator,
    max_dlas: int = 4,
    base_inds_override: np.ndarray | None = None,
    voigt_impl: str = "windowed",
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
    resampler: str = "multinomial",
    with_sample_lls: bool = True,
) -> BatchReadback:
    """Enqueue one batch's evidence computation on the learned model's
    device and dtype, then the copies of its outputs to the host, and
    return without waiting.

    :param inputs: the batch-invariant inputs of :func:`device_put_inputs`,
        which a run moves to the device once.
    :param base_inds_override: optional (B, max_dlas - 1, S) resampling
        indices replacing the draws (reproduces a reference run).
    :param voigt_impl: ``"windowed"`` (default, K1),
        ``"windowed_weideman"``, ``"exact"`` or ``"windowed_unfused"``.
    :param abs_dtype: profile storage, None (the model's dtype) or
        ``torch.int16``.
    :param window_tier, use_kernels, resampler: as for
        :func:`batch_evidences`.
    :param with_sample_lls: False is catalog-lite: the per-sample
        log-likelihoods and resampling indices never leave the device, and
        :func:`finalize_batch` gives None in those fields (evidences, MAPs
        and posteriors are unchanged).
    """
    device, dtype = inputs.learned.mu.device, inputs.learned.mu.dtype
    out = batch_evidences(
        inputs.learned,
        to_torch(stack(spectra), device, dtype),
        inputs.dla,
        inputs.sub,
        generator,
        params,
        max_dlas,
        shared_offsets=inputs.shared_offsets,
        base_inds_override=(
            None
            if base_inds_override is None
            else torch.as_tensor(np.asarray(base_inds_override, np.int64), device=device)
        ),
        voigt_impl=voigt_impl,
        abs_dtype=abs_dtype,
        window_tier=window_tier,
        use_kernels=use_kernels,
        resampler=resampler,
    )
    return _start_readback(out, with_sample_lls)


def finalize_batch(
    out: BatchReadback,
    spectra: list[Spectrum],
    subdla_samples: SubDLASamples,
    prior: PriorCatalog,
    max_dlas: int = 4,
) -> list[SpectrumResult]:
    """Wait for one dispatched batch's host copies (its event, not the
    device's queue) and run the model selection per spectrum."""
    if out.done is not None:
        out.done.synchronize()
    host = lambda t: None if t is None else t.numpy()
    null_ev, dla_ev, sub_ev, dla_sll, sub_sll, base_inds, map_z, map_lognhi = (
        host(t) for t in out[:-1])
    at = lambda a, i: None if a is None else a[i]
    return [
        spectrum_result(
            null_ev[i], dla_ev[i], sub_ev[i], at(dla_sll, i), at(sub_sll, i),
            at(base_inds, i), map_z[i], map_lognhi[i], spec, subdla_samples,
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
    resampler: str = "multinomial",
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
    :param resampler: the DLA chain's importance resampler,
        ``"multinomial"`` (default) or ``"systematic"`` (the reference's
        ``GPY_DLA_RESAMPLER``).
    """
    out = dispatch_batch(
        _with_samples(learned, dla_samples, subdla_samples), spectra, params, generator,
        max_dlas, base_inds_override, voigt_impl, abs_dtype, window_tier, use_kernels,
        resampler,
    )
    return finalize_batch(out, spectra, subdla_samples, prior, max_dlas)
