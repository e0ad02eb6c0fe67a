"""Learned GP model and per-spectrum model construction.

Port of ``gpy_dla_detection_tpu/models/learned.py``: ``LearnedModel``
holds the trained null-GP arrays as module buffers, and
``build_spectrum_model`` interpolates them onto a spectrum (or a batch of
spectra on a leading axis) and applies the mean-flux suppression.
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..data.spectrum import Spectrum
from ..ops.interp import interp_uniform
from ..ops.optical_depth import effective_optical_depth
from ..params import Parameters

FIELDS = (
    "rest_wavelengths",  # (R,) uniform rest grid [A]
    "mu",  # (R,)
    "M",  # (R, k)
    "log_omega",  # (R,)
    "log_c_0",  # scalars from here on
    "log_tau_0",
    "log_beta",
    "prev_tau_0",  # mean-flux suppression (Kim et al. 2007)
    "prev_beta",
)


class LearnedModel(nn.Module):
    """Trained null-model GP; the arrays are buffers, so ``.to(device,
    dtype)`` moves them all."""

    def __init__(self, *arrays: torch.Tensor):
        super().__init__()
        if len(arrays) != len(FIELDS):
            raise ValueError(f"expected {len(FIELDS)} arrays, got {len(arrays)}")
        for name, value in zip(FIELDS, arrays):
            self.register_buffer(name, value)

    @classmethod
    def from_numpy(
        cls,
        fields: Iterable,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ) -> "LearnedModel":
        """The weight carry-over: the reference container's fields as
        numpy arrays (``np.asarray(f) for f in learned``, in its field
        order) moved to ``device`` in ``dtype``.  The default is the
        card in float32, the kernels' path; the CPU (float32 twins, or
        the float64 conformance path) is asked for explicitly."""
        return cls(
            *[
                torch.as_tensor(np.asarray(f), dtype=dtype, device=device)
                for f in fields
            ]
        )


class SpectrumModel(NamedTuple):
    """A learned model interpolated onto one spectrum's pixels, with
    mean-flux suppression applied (batches add a leading axis)."""

    padded_wavelengths: torch.Tensor  # (N + 6,)
    y: torch.Tensor  # (N,) normalized flux
    v: torch.Tensor  # (N,) instrumental noise variance
    mask: torch.Tensor  # (N,) bool
    mu: torch.Tensor  # (N,) suppressed GP mean
    M: torch.Tensor  # (N, k) suppressed covariance factor
    omega2: torch.Tensor  # (N,) scaled absorption-noise variance
    z_qso: torch.Tensor
    min_z_dla: torch.Tensor
    max_z_dla: torch.Tensor


def build_spectrum_model(
    learned: LearnedModel, spec: Spectrum, params: Parameters
) -> SpectrumModel:
    """Interpolate the learned GP onto tensor spectra and apply the
    Lyman-series mean-flux suppression and noise scaling:

        a(lambda) = exp(-sum_i tau_kim,i(lambda))
        mu <- mu a;  M <- M a
        omega2 <- exp(2 log_omega) (1 - exp(-sum tau_learned) + c0)^2 a^2
    """
    wavelengths = spec.padded_wavelengths[..., 3:-3]
    rest = wavelengths / (1.0 + spec.z_qso[..., None])

    x0 = learned.rest_wavelengths[0]
    dx = learned.rest_wavelengths[1] - learned.rest_wavelengths[0]
    mu = interp_uniform(x0, dx, learned.mu, rest)
    M = interp_uniform(x0, dx, learned.M, rest)
    log_omega = interp_uniform(x0, dx, learned.log_omega, rest)
    omega2 = torch.exp(2.0 * log_omega)

    tau_learned = effective_optical_depth(
        wavelengths,
        torch.exp(learned.log_beta),
        torch.exp(learned.log_tau_0),
        spec.z_qso[..., None, None],
        params.num_forest_lines,
    )
    scaling = (
        1.0 - torch.exp(-torch.sum(tau_learned, dim=-1)) + torch.exp(learned.log_c_0)
    )

    if params.suppress_mean_flux:
        tau_kim = effective_optical_depth(
            wavelengths,
            learned.prev_beta,
            learned.prev_tau_0,
            spec.z_qso[..., None, None],
            params.num_forest_lines,
        )
        a_lya = torch.exp(-torch.sum(tau_kim, dim=-1))
        mu = mu * a_lya
        M = M * a_lya[..., None]
        omega2 = omega2 * scaling**2 * a_lya**2
    else:
        # 2017 single-DLA mode: only the noise is scaled
        omega2 = omega2 * scaling**2

    return SpectrumModel(
        padded_wavelengths=spec.padded_wavelengths,
        y=spec.flux,
        v=spec.noise_variance,
        mask=spec.mask,
        mu=mu,
        M=M,
        omega2=omega2,
        z_qso=spec.z_qso,
        min_z_dla=spec.min_z_dla,
        max_z_dla=spec.max_z_dla,
    )
