"""Exact batched Voigt absorption profiles.

Port of the exact parts of ``gpy_dla_detection_tpu/ops/voigt.py``: the
summed Lyman-series unit optical depth from the blended Faddeeva function
at every pixel (float64 or float32 tiers, on any device),
``exp(-nhi * unit_tau)`` with the 7-tap instrumental convolution (K5 on
float32, ``ops/voigt_kernels.absorption_tail``), and the CIV doublet
profile with a free broadening per sample.  The TPU's windowed
evaluation is not ported: the default float32 catalog path is the fused
kernel K1 (``ops/voigt_kernels.absorption_all``).
"""

from __future__ import annotations

import math

import torch

from .. import constants as C

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
    """Broadened absorption ``conv(exp(-nhi * unit_tau))``: (..., P) ->
    (..., P - 6), the leading axes of ``unit_tau`` matching ``nhi``'s.

    Dispatch by tensor: float32 runs K5 (its kernel on CUDA, its plain
    twin on the CPU); float64 runs the plain composition on the CPU, the
    conformance path; anything else raises."""
    if unit_tau.dtype == torch.float64:
        if unit_tau.device.type != "cpu":
            raise TypeError(
                "the float64 absorption is the CPU conformance path; the "
                "CUDA kernels take float32"
            )
        return instrumental_broadening(torch.exp(-nhi[..., None] * unit_tau))
    from .voigt_kernels import absorption_tail

    lead, P = unit_tau.shape[:-1], unit_tau.shape[-1]
    out = absorption_tail(
        unit_tau.reshape(-1, P).contiguous(), nhi.reshape(-1).contiguous()
    )
    return out.reshape(*lead, out.shape[-1])


def voigt_absorption(
    wavelengths: torch.Tensor,
    nhi: torch.Tensor,
    z_absorber: torch.Tensor,
    num_lines: int = 3,
) -> torch.Tensor:
    """Broadened absorption exp(-tau) of one absorber per sample, exact
    Faddeeva at every pixel (the reference's ``impl="exact"``).

    :param wavelengths: (P,) padded observed wavelengths [A].
    :param nhi, z_absorber: (...,) column densities and redshifts.
    :return: (..., P - 6).
    """
    return absorption_from_unit_tau(
        unit_lyman_optical_depth(wavelengths, z_absorber, num_lines), nhi
    )


def voigt_absorption_civ(
    wavelengths: torch.Tensor,
    nciv: torch.Tensor,
    z_civ: torch.Tensor,
    sigma: torch.Tensor,
    num_lines: int = 2,
) -> torch.Tensor:
    """Broadened CIV doublet absorption; the broadening velocity ``sigma``
    [cm/s] is a free parameter per sample
    (``gpy_dla_detection_tpu/ops/voigt.py:voigt_absorption_civ``).  The
    optical depth per unit column density goes through the same exp and
    convolution as the Lyman series (K5 on float32).

    :param nciv, z_civ, sigma: (...,) per-sample parameters.
    :return: (..., P - 6).
    """
    sigma = sigma[..., None]
    one_plus_z = (1.0 + z_civ)[..., None]
    inv = 1.0 / (math.sqrt(2.0) * sigma)
    tau = None
    for l in range(num_lines):
        lam_c = float(C.CIV_WAVELENGTHS_CM[l] * 1e8) * one_plus_z
        velocity = (wavelengths - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
        w_re, _ = wofz_parts(
            velocity * inv, float(C.CIV_LORENTZIAN_WIDTHS[l]) * inv
        )
        contrib = (float(C.CIV_LEADING_CONSTANTS[l]) / SQRT_PI) * inv * w_re
        tau = contrib if tau is None else tau + contrib
    return absorption_from_unit_tau(tau, nciv)
