"""Model evidences: null GP and QMC-marginalized k-absorber models.

Port of ``gpy_dla_detection_tpu/models/evidence.py``.  Each level's S
per-sample likelihoods are one batched Woodbury evaluation (K2 then K3
on the float32 path); the single-absorber profiles are computed once (K1, with
its polynomial or its Weideman window; in the exact configuration the exact unit optical depth and K5; in the
unfused windowed configuration the windowed unit optical depth parts and
K6) and deeper levels gather rows of them by the importance-resampled
parent indices.  The level-k evidence is

    log P(D | k) = max_i ll_i + log(mean_{valid i} exp(ll_i - max)) - k log S

with the mean over samples that pass the 3000 km/s pair-separation cut.
Everything stays on the device: no value is read back inside the loop.

The profiles may be stored compactly (``abs_dtype=torch.int16``: the
fixed-point codes of ``ops/kernel_config.py``, the reference's
``GPY_DLA_ABS_DTYPE=i16`` and ``i16p``): the absorption kernels encode
them at their store, the chained rows are gathered as codes, and K2
decodes them as it assembles.  The default keeps the model's dtype.

Stages are marked with ``utils.timing.span``: ``gpy.profiles`` (the
profiles, where this module computes them), and per level ``gpy.level``,
in it ``gpy.resample`` (the chained levels' draw and gathers) and
``gpy.likelihood`` (the batched likelihood).
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from typing import NamedTuple

import torch

from ..ops.logmvn import batched_log_mvnpdf, likelihood_pair_basis, log_mvnpdf_low_rank
from ..ops.voigt import (
    absorption_from_unit_tau,
    lyman_limit_unit_tau,
    place_windows,
    unit_lyman_optical_depth,
    windowed_tau_parts,
)
from ..ops.voigt_kernels import absorption_all, absorption_windowed
from ..params import Parameters
from ..utils.timing import span
from .learned import SpectrumModel


VOIGT_IMPLS = ("windowed", "exact", "windowed_unfused", "windowed_weideman")
# importance resamplers of the chained levels (the reference's
# GPY_DLA_RESAMPLER): multinomial draws, or the rotated systematic comb
RESAMPLERS = ("multinomial", "systematic")
# absorption-profile families: "dla" = Lyman series only, "lls" = Lyman
# series plus the Lyman-limit break
PROFILES = ("dla", "lls")


def single_absorber_profiles(
    wavelengths: torch.Tensor,
    z_samples: torch.Tensor,
    nhis: Sequence[torch.Tensor],
    num_lines: int,
    voigt_impl: str = "windowed",
    profile: str = "dla",
    out_dtype: torch.dtype | None = None,
    window_tier: bool = True,
) -> tuple[torch.Tensor, ...]:
    """(S, N) broadened absorption of one absorber per sample for every
    column-density family sharing the redshift samples.

    :param voigt_impl: float32 evaluation: ``"windowed"`` runs K1 for all
        families in one launch; ``"windowed_weideman"`` runs K1 with the
        Weideman rational and continued fraction in the windows in place of
        the per-line polynomial (the reference's ``GPY_DLA_FUSED_POLY=0``);
        ``"exact"`` evaluates the exact unit optical depth once and runs K5
        once per family (the reference's ``GPY_DLA_FAST_VOIGT=0``
        configuration); ``"windowed_unfused"`` builds the windowed unit
        optical depth parts once and runs K6 once per family (the
        reference's ``GPY_DLA_FUSED_ABS=0``).  On
        the CPU they run the kernels' twins.  float64 is always exact (the
        CPU conformance path), with one unit optical depth serving every
        family.
    :param profile: ``"dla"`` or ``"lls"`` (the Lyman-limit break, linear
        in nhi, rides the unit optical depth: K1 with ``lls_break``; added
        to the exact unit optical depth; or, unfused, added to the placed
        windowed unit optical depth before K5, as the reference places
        the LLS windows outside K6 (its ``voigt_absorption_lls``)).
    :param out_dtype: storage of the profiles: None keeps the wavelengths'
        dtype; ``torch.int16`` stores fixed-point codes, encoded at the
        store of K1, K5 or K6 on float32 and after the exact profiles on
        float64 (:func:`profile_store`).
    :param window_tier: the two-tier window of ``"windowed_unfused"``'s
        parts (the reference's ``GPY_DLA_WINDOW_TIER``, on by default);
        False evaluates the Weideman rational and the full continued
        fraction over the whole window, in both profiles.  The reference
        reads the flag nowhere else, so the other configurations ignore it.
    """
    if voigt_impl not in VOIGT_IMPLS:
        raise ValueError(f"voigt_impl must be one of {VOIGT_IMPLS}, got {voigt_impl!r}")
    if profile not in PROFILES:
        raise ValueError(f"profile must be one of {PROFILES}, got {profile!r}")
    store = profile_store(out_dtype, wavelengths.dtype)
    lls = profile == "lls"
    if wavelengths.dtype == torch.float32 and voigt_impl in ("windowed", "windowed_weideman"):
        return absorption_all(wavelengths, z_samples, nhis, num_lines, lls_break=lls,
                              poly=voigt_impl == "windowed", out_dtype=store)
    if wavelengths.dtype == torch.float32 and voigt_impl == "windowed_unfused":
        parts = windowed_tau_parts(wavelengths, z_samples, num_lines, window_tier)
        if not lls:
            return tuple(absorption_windowed(parts, nhi, store) for nhi in nhis)
        unit = place_windows(parts) + lyman_limit_unit_tau(wavelengths, z_samples)
        return tuple(absorption_from_unit_tau(unit, nhi, store) for nhi in nhis)
    unit = unit_lyman_optical_depth(wavelengths, z_samples, num_lines)
    if lls:
        unit = unit + lyman_limit_unit_tau(wavelengths, z_samples)
    return tuple(absorption_from_unit_tau(unit, nhi, store) for nhi in nhis)


def profile_store(abs_dtype: torch.dtype | None, dtype: torch.dtype) -> torch.dtype | None:
    """The storage of profiles computed in ``dtype``, or None to keep
    ``dtype``: ``abs_dtype`` None or ``dtype`` keeps it; ``torch.int16``
    stores the fixed-point codes."""
    if abs_dtype is None or abs_dtype == dtype:
        return None
    if abs_dtype == torch.int16:
        return abs_dtype
    raise TypeError(f"{dtype} profiles cannot be stored as {abs_dtype}")


def systematic_comb(cdf: torch.Tensor, u0: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The systematic resampler's S parent indices for the cumulative
    weights ``cdf``: one uniform ``u0`` in [0, 1) places a stratified comb
    ``(i + u0) * cdf[-1] / S``, each tooth takes the first category whose
    cumulative weight exceeds it, and the comb is rolled by ``shift`` in
    [0, S) (as ``numpy.roll``; ``u0`` and ``shift`` may be device tensors,
    read on the device).

    The roll matters: slot i of a chained level pairs parent ``base[i]``
    with the fixed new sample i, so an unrolled comb under near-flat
    weights gives ``base[i] == i``, every slot chains with itself, and the
    3000 km/s pair cut voids the level.  A uniform roll keeps each slot's
    marginal exact, the counts within 1 of S p_i, and the indices one
    rotation of an ascending run."""
    S = cdf.shape[0]
    arange = torch.arange(S, dtype=cdf.dtype, device=cdf.device)
    u = (arange + u0) * (cdf[-1] / S)
    base = torch.clamp(torch.searchsorted(cdf, u, right=True), max=S - 1)
    rolled = torch.remainder(torch.arange(S, device=cdf.device) - shift, S)
    return base.index_select(0, rolled)


def _draw_base_indices(
    generator: torch.Generator, probs: torch.Tensor, resampler: str = "multinomial"
) -> torch.Tensor:
    """S parent indices ~ Categorical(probs / sum(probs)).

    ``"multinomial"`` draws S inverse-CDF uniforms (the reference's default
    resampler); ``"systematic"`` draws one comb offset and one roll
    (:func:`systematic_comb`; the reference's ``GPY_DLA_RESAMPLER=systematic``)."""
    S = probs.shape[0]
    cdf = torch.cumsum(probs, dim=0)
    if resampler == "systematic":
        u0 = torch.rand((), generator=generator, dtype=probs.dtype, device=probs.device)
        shift = torch.randint(0, S, (1,), generator=generator, device=probs.device)
        return systematic_comb(cdf, u0, shift)
    u = torch.rand(
        S, generator=generator, dtype=probs.dtype, device=probs.device
    ) * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, u, right=True), max=S - 1)


def null_log_evidence(model: SpectrumModel) -> torch.Tensor:
    """log p(D | no absorber)."""
    return log_mvnpdf_low_rank(
        model.y, model.mu, model.M, model.omega2 + model.v, model.mask
    )


class QMCEvidenceResult(NamedTuple):
    """Everything the catalog records per spectrum and model."""

    log_evidences: torch.Tensor  # (max_k,) log p(D | k absorbers)
    sample_log_likelihoods: torch.Tensor  # (S, max_k), NaN where invalid
    base_sample_inds: torch.Tensor  # (max_k - 1, S) resampled indices
    map_z_dlas: torch.Tensor  # (max_k, max_k) MAP redshifts (NaN padded)
    map_log_nhis: torch.Tensor  # (max_k, max_k)


def qmc_log_evidences(
    model: SpectrumModel,
    offset_samples: torch.Tensor,
    log_nhi_samples: torch.Tensor,
    nhi_samples: torch.Tensor,
    generator: torch.Generator,
    max_k: int,
    params: Parameters,
    base_inds_override: torch.Tensor | None = None,
    A_override: torch.Tensor | None = None,
    voigt_impl: str = "windowed",
    profile: str = "dla",
    abs_dtype: torch.dtype | None = None,
    window_tier: bool = True,
    use_kernels: bool | None = None,
    resampler: str = "multinomial",
) -> QMCEvidenceResult:
    """Marginalize the k-absorber models over the QMC sample set.

    :param model: interpolated model of one spectrum.
    :param offset_samples: (S,) uniform offsets mapped onto
        [min_z_dla, max_z_dla].
    :param log_nhi_samples, nhi_samples: (S,) column-density samples.
    :param generator: drives the importance resampling; on the model's
        device.
    :param max_k: number of absorber models.
    :param base_inds_override: optional (max_k - 1, S) resampling indices
        replacing the draws (reproduces a reference run exactly).
    :param A_override: optional precomputed (S, N) single-absorber
        profiles for these samples (the batch layer computes both families
        from one redshift evaluation), in the model's dtype or as int16
        codes.
    :param voigt_impl, profile: profile evaluation when ``A_override``
        is None (see :func:`single_absorber_profiles`).
    :param abs_dtype: storage of the profiles and of the chained rows
        gathered from them: None keeps the model's dtype (float32 on the
        card, float64 on the CPU conformance path); ``torch.int16`` stores
        fixed-point codes in every ``voigt_impl`` and profile (the
        reference's ``GPY_DLA_ABS_DTYPE=i16`` or ``i16p``).
    :param window_tier: the reference's ``GPY_DLA_WINDOW_TIER`` for
        ``voigt_impl="windowed_unfused"`` (see
        :func:`single_absorber_profiles`); ignored by the others.
    :param use_kernels: the float32 likelihood's route (the reference's
        ``use_pallas``; see ``ops.logmvn.batched_log_mvnpdf``): None takes
        K2 and K3 at any GP basis width; False the plain composition, on
        the CPU only.
    :param resampler: ``"multinomial"`` (default, the reference's default)
        or ``"systematic"`` (the rotated comb, :func:`systematic_comb`; the
        reference's ``GPY_DLA_RESAMPLER=systematic``), both drawn from
        ``generator``.
    """
    if resampler not in RESAMPLERS:
        raise ValueError(f"resampler must be one of {RESAMPLERS}, got {resampler!r}")
    S = offset_samples.shape[0]
    dtype, device = model.y.dtype, model.y.device
    log_S = math.log(S)
    min_sep = params.min_z_separation

    z_samples = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * offset_samples
    if A_override is None:
        with span("gpy.profiles"):
            (A,) = single_absorber_profiles(
                model.padded_wavelengths, z_samples, (nhi_samples,), params.num_lines,
                voigt_impl, profile, out_dtype=abs_dtype, window_tier=window_tier,
            )
    else:
        A = A_override
    M_pair = likelihood_pair_basis(model.M)

    extra = []  # gathered parent profile rows, one per chained level
    z_rows = [z_samples]
    lognhi_rows = [log_nhi_samples]
    alive = torch.ones((), dtype=torch.bool, device=device)
    prev_valid = torch.ones((S,), dtype=torch.bool, device=device)
    prev_ll_centered = torch.zeros((S,), dtype=dtype, device=device)

    log_evidences, sample_lls, base_inds_rows, map_z, map_lognhi = [], [], [], [], []
    for k0 in range(max_k):  # k0 = number of additional absorbers
        with span("gpy.level"):
            if k0 > 0:
                with span("gpy.resample"):
                    if base_inds_override is not None:
                        base = base_inds_override[k0 - 1].to(device=device, dtype=torch.int64)
                    else:
                        logits = torch.where(prev_valid, prev_ll_centered, -math.inf)
                        # an underflowed previous level keeps indices in range
                        # with uniform logits (its results are NaN-masked)
                        logits = torch.where(alive, logits, 0.0)
                        probs = torch.exp(logits - torch.max(logits))
                        base = _draw_base_indices(generator, probs, resampler)
                    base_inds_rows.append(base)
                    extra.append(A[base])  # in A's storage: int16 codes stay codes
                    z_rows.append(z_samples[base])
                    lognhi_rows.append(log_nhi_samples[base])

            with span("gpy.likelihood"):
                ll = (
                    batched_log_mvnpdf(
                        model.y, model.mu, model.M, model.omega2, model.v, model.mask,
                        A, M_pair, extra=extra, use_kernels=use_kernels,
                    )
                    - log_S
                )

            # pair-separation validity
            if k0 > 0:
                all_z = torch.sort(torch.stack(z_rows), dim=0).values
                valid = torch.all(torch.diff(all_z, dim=0) >= min_sep, dim=0)
            else:
                valid = torch.ones((S,), dtype=torch.bool, device=device)

            masked_ll = torch.where(valid, ll, -math.inf)
            max_ll = torch.max(masked_ll)
            ll_centered = ll - max_ll
            n_valid = torch.sum(valid)
            mean_prob = torch.sum(torch.where(valid, torch.exp(ll_centered), 0.0)) / n_valid
            evidence = max_ll + torch.log(mean_prob) - k0 * log_S
            prev_valid, prev_ll_centered = valid, ll_centered

            evidence = torch.where(alive, evidence, math.nan)
            alive = alive & torch.isfinite(evidence)

            log_evidences.append(evidence)
            sample_lls.append(torch.where(valid & alive, ll, math.nan))

            # MAP chain: argmax returns the first maximum, as the reference's.
            # index_select keeps the index on the device (indexing with a 0-dim
            # tensor reads it back to the host and stalls the queue)
            maxind = torch.argmax(masked_ll).reshape(1)
            pad = torch.full((max_k - k0 - 1,), math.nan, dtype=dtype, device=device)
            map_z.append(torch.cat([torch.stack(z_rows).index_select(1, maxind)[:, 0], pad]))
            map_lognhi.append(
                torch.cat([torch.stack(lognhi_rows).index_select(1, maxind)[:, 0], pad])
            )

    base_sample_inds = (
        torch.stack(base_inds_rows)
        if base_inds_rows
        else torch.zeros((0, S), dtype=torch.int64, device=device)
    )
    return QMCEvidenceResult(
        log_evidences=torch.stack(log_evidences),
        sample_log_likelihoods=torch.stack(sample_lls, dim=1),
        base_sample_inds=base_sample_inds,
        map_z_dlas=torch.stack(map_z),
        map_log_nhis=torch.stack(map_lognhi),
    )
