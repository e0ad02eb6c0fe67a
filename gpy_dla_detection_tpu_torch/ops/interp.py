"""1-D linear interpolation on tensors.

Port of ``gpy_dla_detection_tpu/ops/interp.py``: a direct index
computation on uniform grids, and ``torch.searchsorted`` on arbitrary
ascending grids.  Out-of-range queries clamp to the boundary value; the
callers mask those pixels out.
"""

from __future__ import annotations

import torch


def interp_uniform(x0, dx, values: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``values`` sampled at ``x0 + dx * arange(n)``.

    :param values: (n,) or (n, k) grid samples.
    :param xq: (...,) query points.
    :return: (...,) or (..., k).
    """
    n = values.shape[0]
    t = (xq - x0) / dx
    idx = torch.clamp(torch.floor(t).to(torch.int64), 0, n - 2)
    frac = torch.clamp(t - idx, 0.0, 1.0)
    lo = values[idx]
    hi = values[idx + 1]
    if values.ndim == 2:
        frac = frac[..., None]
    return lo * (1.0 - frac) + hi * frac


def interp(xg: torch.Tensor, values: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Linear interpolation on an arbitrary ascending grid ``xg``."""
    n = xg.shape[0]
    idx = torch.clamp(torch.searchsorted(xg, xq, right=True) - 1, 0, n - 2)
    x_lo = xg[idx]
    x_hi = xg[idx + 1]
    frac = torch.clamp((xq - x_lo) / (x_hi - x_lo), 0.0, 1.0)
    lo = values[idx]
    hi = values[idx + 1]
    if values.ndim == 2:
        frac = frac[..., None]
    return lo * (1.0 - frac) + hi * frac
