"""Effective (mean-flux) optical depth of the Lyman-series forest.

Port of ``gpy_dla_detection_tpu/ops/optical_depth.py``.
"""

from __future__ import annotations

import functools

import torch

from .. import constants as C


def effective_optical_depth(wavelengths, beta, tau_0, z_qso, num_forest_lines: int):
    """Per-line effective optical depth of the Lyman forest,
    ``tau_0 (f_i lambda_i)/(f_lya lambda_lya) (1 + z_i)^beta`` where
    ``1 + z_i = lambda / lambda_i <= 1 + z_qso``.

    :param wavelengths: (..., P) observed wavelengths [A].
    :param beta, tau_0: scalars.
    :param z_qso: quasar redshift, broadcastable against (..., P, L).
    :return: (..., P, num_forest_lines).
    """
    lam, osc = _line_constants(num_forest_lines, wavelengths.dtype, wavelengths.device)
    lya_lam = float(C.LYMAN_WAVELENGTHS_A[0])
    lya_osc = float(C.LYMAN_OSCILLATOR_STRENGTHS[0])

    one_plus_z = wavelengths[..., None] / lam
    scale = tau_0 * osc / lya_osc * lam / lya_lam
    tau = scale * one_plus_z**beta
    indicator = one_plus_z - 1.0 <= z_qso
    return tau * indicator


@functools.lru_cache(maxsize=16)
def _line_constants(num_forest_lines: int, dtype: torch.dtype, device: torch.device):
    """The forest lines' wavelengths and oscillator strengths on
    ``device``, uploaded once (an upload from pageable memory waits for
    the device's queue)."""
    put = lambda x: torch.as_tensor(x[:num_forest_lines], dtype=dtype, device=device)
    return put(C.LYMAN_WAVELENGTHS_A), put(C.LYMAN_OSCILLATOR_STRENGTHS)


def mean_flux_suppression(wavelengths, beta, tau_0, z_qso, num_forest_lines: int):
    """``exp(-sum_i tau_i)``, the total Lyman-series suppression."""
    tau = effective_optical_depth(wavelengths, beta, tau_0, z_qso, num_forest_lines)
    return torch.exp(-torch.sum(tau, dim=-1))
