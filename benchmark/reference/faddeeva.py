"""The Faddeeva function w(z), Im z >= 0, in plain PyTorch complex arithmetic.

Inside ``|z| < RADIUS`` Weideman's rational approximation (J. A. C.
Weideman, SIAM J. Numer. Anal. 31 (1994) 1497, with N terms); outside it
the Laplace continued fraction of the asymptotic expansion, evaluated
from the bottom up.  float64 takes N = 40 and 40 fractions, float32 N = 20
and 12; ``tests/test_bench_reference.py`` holds both to scipy's ``wofz``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RADIUS = 8.0
_TERMS = {torch.float64: (40, 40), torch.float32: (20, 12)}


def weideman_coefficients(n: int) -> tuple[np.ndarray, float]:
    """The polynomial's coefficients, highest power first, and L."""
    m = 2 * n
    L = math.sqrt(n / math.sqrt(2.0))
    theta = np.pi * np.arange(-m + 1, m) / m
    t = L * np.tan(theta / 2.0)
    f = np.concatenate([[0.0], np.exp(-t * t) * (L * L + t * t)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2.0 * m)
    return a[1:n + 1][::-1].copy(), L


def wofz(z: torch.Tensor) -> torch.Tensor:
    """w(z) for a complex tensor ``z`` with Im z >= 0 (complex128 or complex64)."""
    real = z.real.dtype
    n_w, n_cf = _TERMS[real]
    coeffs, L = weideman_coefficients(n_w)
    inv_sqrt_pi = 1.0 / math.sqrt(math.pi)

    far = z.abs() >= RADIUS
    zi = torch.where(far, torch.zeros_like(z), z)
    den = L - 1j * zi
    Z = (L + 1j * zi) / den
    p = torch.full_like(z, float(coeffs[0]))
    for c in coeffs[1:]:
        p = p * Z + float(c)
    inner = 2.0 * p / (den * den) + inv_sqrt_pi / den

    zo = torch.where(far, z, torch.full_like(z, RADIUS))
    r = torch.zeros_like(z)
    for j in range(n_cf, 0, -1):
        r = (0.5 * j) / (zo - r)
    outer = 1j * inv_sqrt_pi / (zo - r)
    return torch.where(far, outer, inner)
