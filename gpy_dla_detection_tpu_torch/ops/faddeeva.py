"""Faddeeva function w(z) in real-pair tensor arithmetic.

Port of ``gpy_dla_detection_tpu/ops/faddeeva.py``: a Weideman (1994)
rational approximation inside ``|z| <= RADIUS`` blended with a truncated
continued fraction outside it, with dtype-tiered term counts (float64
N=40 / K=14, float32 N=20 / K=5).  It serves the exact absorption
profile, the windowed unit optical depth's window corrections and the
normalized Voigt profile (``voigt_profile``); the
default float32 catalog path uses the per-line polynomial of
``ops/voigt_kernels.py`` instead.
"""

from __future__ import annotations

import numpy as np
import torch

SQRT_PI = 1.7724538509055160273

RADIUS = 7.0
N_WEIDEMAN = 40
N_CONTINUED_FRACTION = 14
N_WEIDEMAN_F32 = 20
N_CONTINUED_FRACTION_F32 = 5


def _weideman_coefficients(n: int) -> tuple[np.ndarray, float]:
    """Weideman coefficients (highest power first) and the scale L."""
    m = 2 * n
    L = np.sqrt(n / np.sqrt(2.0))
    theta = np.pi * np.arange(-m + 1, m) / m
    t = L * np.tan(theta / 2.0)
    f = np.exp(-(t**2)) * (L**2 + t**2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2.0 * m)
    a = a[1 : n + 1][::-1].copy()
    return a, float(L)


_WEIDEMAN_A, _WEIDEMAN_L = _weideman_coefficients(N_WEIDEMAN)
_WEIDEMAN_A32, _WEIDEMAN_L32 = _weideman_coefficients(N_WEIDEMAN_F32)


def _wofz_weideman(x: torch.Tensor, y: torch.Tensor):
    """Weideman rational approximation of w(x + iy)."""
    if x.dtype == torch.float32:
        coeffs, L = _WEIDEMAN_A32, _WEIDEMAN_L32
    else:
        coeffs, L = _WEIDEMAN_A, _WEIDEMAN_L

    # 1 / (L - iz) = ((L + y) - ix) / s
    dr = L + y
    s = dr * dr + x * x
    inv_s = 1.0 / s

    # Z = (L + iz) / (L - iz)
    zr = ((L - y) * dr - x * x) * inv_s
    zi = (2.0 * L * x) * inv_s

    pr = torch.full_like(x, float(coeffs[0]))
    pi = torch.zeros_like(x)
    for c in coeffs[1:]:
        pr, pi = pr * zr - pi * zi + float(c), pr * zi + pi * zr

    # w = 2 P(Z) / (L - iz)^2 + (1 / sqrt(pi)) / (L - iz)
    inv2_r = (dr * dr - x * x) * inv_s * inv_s
    inv2_i = 2.0 * dr * x * inv_s * inv_s
    # sqrt(pi) as a tensor: PyTorch divides a CUDA tensor by a Python
    # scalar as a product with the scalar's reciprocal, one rounding more
    # than the CPU and the reference take, and near a line centre, where
    # this sum cancels, that rounding shows in float32
    sqrt_pi = torch.full_like(inv_s, SQRT_PI)
    w_re = 2.0 * (pr * inv2_r - pi * inv2_i) + dr * inv_s / sqrt_pi
    w_im = 2.0 * (pr * inv2_i + pi * inv2_r) + x * inv_s / sqrt_pi
    return w_re, w_im


def _wofz_cf(x: torch.Tensor, y: torch.Tensor, terms: int | None = None):
    """Truncated continued fraction for w(x + iy), accurate for |z| > ~6;
    guarded so that evaluating it inside the disk stays finite.

    :param terms: override the dtype-tiered depth (the windowed unit
        optical depth uses 2 terms in the far part of each window)."""
    if terms is None:
        terms = (
            N_CONTINUED_FRACTION_F32 if x.dtype == torch.float32 else N_CONTINUED_FRACTION
        )
    eps = 1e-30
    vr = x
    vi = y
    for n in range(terms, 0, -1):
        inv_v2 = (n / 2.0) / (vr * vr + vi * vi + eps)
        vr = x - vr * inv_v2
        vi = y + vi * inv_v2
    inv_v2 = 1.0 / (SQRT_PI * (vr * vr + vi * vi + eps))
    return vi * inv_v2, vr * inv_v2


def wofz_parts(x: torch.Tensor, y: torch.Tensor):
    """(Re, Im) of w(x + iy) for y >= 0; broadcasts ``x`` and ``y``."""
    x, y = torch.broadcast_tensors(x, y)
    sign = torch.sign(x)
    ax = torch.abs(x)
    inner = ax * ax + y * y <= RADIUS * RADIUS
    wr_in, wi_in = _wofz_weideman(
        torch.where(inner, ax, 0.0), torch.where(inner, y, 0.0)
    )
    wr_out, wi_out = _wofz_cf(
        torch.where(inner, RADIUS + 1.0, ax), torch.where(inner, 1.0, y)
    )
    w_re = torch.where(inner, wr_in, wr_out)
    w_im = torch.where(inner, wi_in, wi_out)
    return w_re, sign * w_im


def voigt_profile(v: torch.Tensor, sigma, gamma) -> torch.Tensor:
    """Normalized Voigt profile in velocity space,
    ``Re[w((v + i gamma) / (sqrt(2) sigma))] / (sqrt(2 pi) sigma)``
    (``gpy_dla_detection_tpu/ops/faddeeva.py:voigt_profile``); broadcasts
    ``v``, ``sigma`` and ``gamma``, which may be tensors or numbers."""
    v = torch.as_tensor(v)
    sigma = torch.as_tensor(sigma, dtype=v.dtype, device=v.device)
    gamma = torch.as_tensor(gamma, dtype=v.dtype, device=v.device)
    inv = 1.0 / (np.sqrt(2.0) * sigma)
    w_re, _ = wofz_parts(v * inv, gamma * inv)
    return w_re * (inv / SQRT_PI)
