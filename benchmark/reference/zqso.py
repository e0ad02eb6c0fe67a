"""The quasar-redshift scan log p(D | z) over the redshift grid, in plain PyTorch.

The reference the zQSO cell holds the program to.  The scan the program
times (its correlation scan) reads the learned GP from a table on a
log-uniform rest grid ``SCAN_OVERSAMPLE`` times finer than the pixels: at
redshift z, pixel p reads entry ``t = s0(z) + O p`` and blends it with
``t + 1`` by the fractional shift, and the entry's rest window is the
pixel's model window.  This module builds that table again from the
learned model's arrays (linear interpolation), then for every z directly,
with no FFT: the blended model on each pixel, the masked median of the
flux over the normalization window, the low-rank Woodbury likelihood
inside the model window (a Cholesky of the k x k capacitance), and the iid
Gaussians blue- and redward of the observable cut.

With ``table=False`` it follows the other scan of the program, the exact
scan: the learned model interpolated at each pixel's own rest wavelength,
the model window and the observable cut compared per pixel.

``Precision`` is :mod:`reference.catalog`'s: float64, or float32 with the
products in TF32 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import physics as C
from .catalog import REFERENCE, Precision, _interp_uniform, matmul

SCAN_OVERSAMPLE = 4
SCAN_WL_BOUNDS = (3.0e3, 1.3e4)


def pixel_dlog(wavelengths, max_drift: float = 0.02) -> float:
    """The log10 step of a log-uniform pixel grid (a padded tail of repeated
    wavelengths ignored), rounded to 1e-9 dex; raises if the grid is not."""
    logs = np.log10(np.asarray(wavelengths, np.float64))
    real = np.diff(logs) > 0
    last = np.nonzero(real)[0][-1]
    if not real[:last + 1].all():
        raise ValueError("the pixel grid is not log-uniform")
    d = round(float((logs[last + 1] - logs[0]) / (last + 1)), 9)
    p = np.arange(last + 2)
    if np.max(np.abs(logs[:last + 2] - (logs[0] + p * d))) > max_drift * d:
        raise ValueError("the pixel grid is not log-uniform")
    return d


def takes_table(wavelengths, method: str) -> bool:
    """Whether the scan ``method`` reads the correlation scan's table on this
    pixel grid: "corr" always, "exact" never, and "auto" where the grid is
    log-uniform and lies within ``SCAN_WL_BOUNDS``."""
    if method != "auto":
        return method == "corr"
    try:
        pixel_dlog(wavelengths)
    except ValueError:
        return False
    wl = np.asarray(wavelengths, np.float64)
    return bool(wl[0] >= SCAN_WL_BOUNDS[0] and wl[-1] <= SCAN_WL_BOUNDS[1])


def flat_table(learned, dlog_px: float, num_pixels: int, z_min: float, z_max: float):
    """mu and M on the table's log-uniform rest grid, edge-clamped:
    (grid (T+1,), mu_t, M_t (T+1, k), log_x0, dlog, T)."""
    O = SCAN_OVERSAMPLE
    rest = np.asarray(learned.rest_wavelengths, np.float64)
    dlog = dlog_px / O
    log_x0 = np.log10(min(rest[0], SCAN_WL_BOUNDS[0] / (1.0 + z_max)) * 0.999)
    hi = np.log10(SCAN_WL_BOUNDS[1]) + num_pixels * dlog_px - np.log10(1.0 + z_min) + 1e-3
    T = int(np.ceil((hi - log_x0) / dlog)) + 8 * O
    T = -(-T // O) * O
    grid = 10.0 ** (log_x0 + dlog * np.arange(T + 1))
    mu_t = np.interp(grid, rest, np.asarray(learned.mu, np.float64))
    M = np.asarray(learned.M, np.float64)
    M_t = np.stack([np.interp(grid, rest, M[:, j]) for j in range(M.shape[1])], axis=1)
    return grid, mu_t, M_t, float(log_x0), float(dlog), T


def _masked_median(flux, mask):
    """Median of ``flux`` over each row's ``mask`` (mean of the two middle
    values), +inf for an empty row."""
    x = torch.sort(torch.where(mask, flux, math.inf), dim=-1).values
    n = mask.sum(-1, keepdim=True)
    last = x.shape[-1] - 1
    lo = torch.clamp((n - 1) // 2, 0, last)
    hi = torch.clamp(n // 2, 0, last)
    return torch.where(n[:, 0] > 0, 0.5 * (x.gather(-1, lo) + x.gather(-1, hi))[:, 0], math.inf)


def _iid_ll(ind, y, v, m, s):
    d = s * s + v
    delta = torch.where(ind, y - m, 0.0)
    return -0.5 * (torch.sum(torch.where(ind, delta * delta / d, 0.0), -1)
                   + torch.sum(torch.where(ind, torch.log(d), 0.0), -1)
                   + ind.sum(-1).to(y.dtype) * C.LOG_2PI)


def scan(learned, obs, cfg: dict, device, prec: Precision = REFERENCE, chunk: int = 250,
         table: bool = True):
    """(Z,) log p(D | z) of one padded observation over the config's grid:
    the correlation scan's model (``table``) or the exact scan's."""
    dt = prec.dtype
    O = SCAN_OVERSAMPLE
    P = obs.wavelengths.shape[0]
    z_min, z_max = cfg["z_qso_min"], cfg["z_qso_max"]
    put = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dt)
    if table:
        _, mu_t, M_t, log_x0, dlog, T = flat_table(learned, pixel_dlog(obs.wavelengths), P,
                                                   z_min, z_max)
        n_rows = O * ((T + 1) // O)  # table entries the scan can read
        grid_rest = 10.0 ** (log_x0 + dlog * np.arange(T + 1))
        val = torch.as_tensor((grid_rest >= cfg["min_lambda"]) & (grid_rest <= cfg["max_lambda"]),
                              device=device)
        mu_t, M_t = put(mu_t), put(M_t)
    else:
        grid = np.asarray(learned.rest_wavelengths, np.float64)
        x0, dx = float(grid[0]), float(grid[1] - grid[0])
        mu_g, M_g = put(learned.mu), put(learned.M)
    wl = torch.as_tensor(np.asarray(obs.wavelengths, np.float64), device=device)
    flux, noise = put(obs.flux), put(obs.noise_variance)
    valid = torch.as_tensor(np.asarray(obs.valid), device=device)
    wl_lo, wl_hi = wl[valid].min(), wl[valid].max()
    sv = valid & (wl > wl_lo) & (wl < wl_hi)
    z_all = torch.as_tensor(np.linspace(z_min, z_max, cfg["num_zqso_samples"]), device=device)
    if table:
        s_real = (torch.log10(wl[0]) - torch.log10(1.0 + z_all) - log_x0) / dlog
        s0_all = torch.floor(s_real).long()
        f_all = (s_real - s0_all).to(dt)
        pix = torch.arange(P, device=device)
    bmu, bsig = float(learned.bluewards_mu), float(learned.bluewards_sigma)
    rmu, rsig = float(learned.redwards_mu), float(learned.redwards_sigma)
    k = cfg["k"]
    eye = torch.eye(k, dtype=dt, device=device)
    out = []
    for c in range(0, z_all.shape[0], chunk):
        z = z_all[c:c + chunk, None]
        min_obs = torch.maximum(cfg["min_lambda"] * (1.0 + z), wl_lo)
        max_obs = torch.minimum(cfg["max_lambda"] * (1.0 + z), wl_hi)
        rest = wl / (1.0 + z)
        if table:
            s0, f = s0_all[c:c + chunk, None], f_all[c:c + chunk, None]
            t = s0 + O * pix
            inside = (t >= 0) & (t < n_rows)
            ti = torch.where(inside, t, 0)
            w0, w1 = 1.0 - f, f
            mu = w0 * mu_t[ti] + w1 * mu_t[ti + 1]
            M = w0[..., None] * M_t[ti] + w1[..., None] * M_t[ti + 1]
            mask = sv & inside & val[ti]
        else:
            rest_d = rest.to(dt)
            mu = _interp_uniform(x0, dx, mu_g, rest_d)
            M = _interp_uniform(x0, dx, M_g, rest_d)
            mask = ((rest >= cfg["min_lambda"]) & (rest <= cfg["max_lambda"])
                    & (wl > min_obs) & (wl < max_obs) & valid)
        norm = ((rest >= cfg["normalization_min_lambda"]) & (rest <= cfg["normalization_max_lambda"])
                & (wl > min_obs) & (wl < max_obs) & valid)
        med = _masked_median(flux.expand(norm.shape[0], -1), norm)[:, None]
        bad = ~torch.isfinite(med)
        m1 = torch.where(bad, 1.0, med)
        y, v = flux / m1, noise / (m1 * m1)
        d_inv = torch.where(mask, 1.0 / v, 0.0)
        delta = torch.where(mask, y - mu, 0.0)
        Mw = M * d_inv[..., None]
        B = eye + matmul(M.transpose(1, 2), Mw, prec)
        u = matmul(M.transpose(1, 2), (d_inv * delta)[..., None], prec)[..., 0]
        L, info = torch.linalg.cholesky_ex(B)
        tt = torch.linalg.solve_triangular(L, u[..., None], upper=False)[..., 0]
        quad = torch.sum(delta * delta * d_inv, -1) - torch.sum(tt * tt, -1)
        logdet = (torch.sum(torch.where(mask, torch.log(v), 0.0), -1)
                  + 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1))
        in_ll = -0.5 * (quad + logdet + mask.sum(-1).to(dt) * C.LOG_2PI)
        in_ll = torch.where((info == 0) & ~bad[:, 0], in_ll, math.nan)
        yy, vv = flux / med, noise / (med * med)
        iid = (_iid_ll((wl < min_obs) & valid, yy, vv, bmu, bsig)
               + _iid_ll((wl > max_obs) & valid, yy, vv, rmu, rsig))
        out.append(in_ll + iid)
    return torch.cat(out).cpu().numpy()


def compare(lls_prog: np.ndarray, lls_ref: np.ndarray) -> dict:
    """The numbers the zQSO cell compares for one scan: the largest gap of
    the (Z,) log likelihoods (inf where one side is finite and the other
    not), and at the program's MAP redshift how far the reference's
    likelihood lies below the reference's best plus how far the program's
    likelihood lies from the reference's."""
    a, b = np.asarray(lls_prog, np.float64), np.asarray(lls_ref, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    gap = math.inf if np.any(fa != fb) else float(np.max(np.abs(a[fa] - b[fa]), initial=0.0))
    if not fa.any():
        return {"scan_gap": gap, "map_gap": 0.0 if not fb.any() else math.inf}
    i = int(np.argmax(np.where(fa, a, -np.inf)))
    return {"scan_gap": gap, "map_gap": float(np.nanmax(b) - b[i] + abs(a[i] - b[i]))}
