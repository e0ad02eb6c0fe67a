"""Exact batched Voigt absorption profiles (the float64 conformance path).

Port of the exact parts of ``gpy_dla_detection_tpu/ops/voigt.py``: the
summed Lyman-series unit optical depth from the blended Faddeeva function
at every pixel, ``exp(-nhi * unit_tau)`` and the 7-tap instrumental
convolution.  The TPU's windowed evaluation is not ported: the float32
catalog path is the fused kernel K1 (``ops/voigt_kernels.py``).
"""

from __future__ import annotations

import math

import torch

from gpy_dla_detection_tpu import constants as C

from .faddeeva import SQRT_PI, wofz_parts

# beyond |z| = CF_FAR_RADIUS the Lorentzian Re w = y / (sqrt(pi) |z|^2)
# differs from w by <= 1/(2|z|^2) ~ 7.6e-6 relative; inside it the kernel
# evaluates the per-line polynomial Faddeeva
CF_FAR_RADIUS = 256.0

# the far field is evaluated for the first FAR_FIELD_LINES Lyman lines
# only: the dropped lines' far tau sums to < 5e-5 absorption at
# logNHI = 23 (their cores stay exact)
FAR_FIELD_LINES = 16


def instrumental_broadening(raw: torch.Tensor) -> torch.Tensor:
    """Valid-mode convolution with the 7-tap SDSS instrument profile:
    (..., P) -> (..., P - 6)."""
    width = C.INSTRUMENT_PROFILE_HALF_WIDTH
    P = raw.shape[-1]
    n = P - 2 * width
    out = float(C.INSTRUMENT_PROFILE[0]) * raw[..., :n]
    for k in range(1, 2 * width + 1):
        out = out + float(C.INSTRUMENT_PROFILE[k]) * raw[..., k : n + k]
    return out


def unit_lyman_optical_depth(
    wavelengths: torch.Tensor,
    z_absorber: torch.Tensor,
    num_lines: int,
    sigma: float = C.THERMAL_SIGMA_CGS,
) -> torch.Tensor:
    """Summed Lyman-series optical depth per unit column density.

    :param wavelengths: (P,) observed wavelengths [A].
    :param z_absorber: (...,) absorber redshifts.
    :return: (..., P); ``tau = nhi * unit_tau``.
    """
    one_plus_z = (1.0 + z_absorber)[..., None]
    inv = 1.0 / (math.sqrt(2.0) * sigma)
    tau = None
    for l in range(num_lines):
        lam_c = float(C.LYMAN_WAVELENGTHS_A[l]) * one_plus_z
        velocity = (wavelengths - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
        w_re, _ = wofz_parts(
            velocity * inv,
            torch.full_like(velocity, float(C.LYMAN_LORENTZIAN_WIDTHS[l]) * inv),
        )
        contrib = (float(C.LYMAN_LEADING_CONSTANTS[l]) * inv / SQRT_PI) * w_re
        tau = contrib if tau is None else tau + contrib
    return tau


def absorption_from_unit_tau(unit_tau: torch.Tensor, nhi: torch.Tensor) -> torch.Tensor:
    """Broadened absorption ``conv(exp(-nhi * unit_tau))``: (S, P) ->
    (S, P - 6)."""
    return instrumental_broadening(torch.exp(-nhi[..., None] * unit_tau))


def voigt_absorption(
    wavelengths: torch.Tensor,
    nhi: torch.Tensor,
    z_absorber: torch.Tensor,
    num_lines: int = 3,
) -> torch.Tensor:
    """Broadened absorption exp(-tau) of one absorber per sample, exact
    Faddeeva at every pixel (the reference's ``impl="exact"``).

    :return: (..., P - 6).
    """
    return absorption_from_unit_tau(
        unit_lyman_optical_depth(wavelengths, z_absorber, num_lines), nhi
    )
