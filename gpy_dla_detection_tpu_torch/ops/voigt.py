"""Batched Voigt absorption profiles.

Port of ``gpy_dla_detection_tpu/ops/voigt.py``:

* the exact summed Lyman-series unit optical depth from the blended
  Faddeeva function at every pixel (float64 or float32 tiers, on any
  device), ``exp(-nhi * unit_tau)`` with the 7-tap instrumental
  convolution (K5 on float32, ``ops/voigt_kernels.absorption_tail``), the
  Lyman-limit break of the LLS profile and the CIV doublet profile with a
  free broadening per sample (its unit optical depth by
  ``ops/voigt_kernels.civ_unit_tau``);
* the windowed unit optical depth in unplaced form
  (:func:`windowed_tau_parts`: a far field on the chunk-padded grid plus
  one 256-pixel correction window per line), which K6
  (``ops/voigt_kernels.absorption_windowed``) places, exponentiates and
  broadens in the unfused windowed configuration.  The default float32
  catalog path is the fused kernel K1 (``ops/voigt_kernels.absorption_all``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C

from ._build import launch_counts
from .faddeeva import RADIUS, SQRT_PI, _wofz_cf, _wofz_weideman, wofz_parts
from .kernel_config import ABS_I16_SCALE

# beyond |z| = CF_FAR_RADIUS the Lorentzian Re w = y / (sqrt(pi) |z|^2)
# differs from w by <= 1/(2|z|^2) ~ 7.6e-6 relative; inside it the kernel
# evaluates the per-line polynomial Faddeeva
CF_FAR_RADIUS = 256.0

# the far field is evaluated for the first FAR_FIELD_LINES Lyman lines
# only: the dropped lines' far tau sums to < 5e-5 absorption at
# logNHI = 23 (their cores stay exact)
FAR_FIELD_LINES = 16

# the windowed unit optical depth aligns each line's window to 128-pixel
# chunks; two chunks cover the |z| <= CF_FAR_RADIUS annulus (~+-48 px at
# SDSS resolution) around the line centre with room for the centre
# estimate's error
CHUNK = 128
FAST_WINDOW = 256
# the two-tier window: the Weideman disk and the full continued fraction
# run on a strip of STRIP_BLOCKS blocks of STRIP_BLOCK pixels around the
# centre estimate, the 2-term continued fraction on the rest
STRIP_BLOCK = 32
STRIP_BLOCKS = 3

LYMAN_LIMIT_A = 911.7641  # rest wavelength of the Lyman limit [A]
LYMAN_LIMIT_LOG_NHI = 17.2  # tau_break = nhi / 10^17.2 at the limit


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


def encode_profile_store(out: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """Profiles in their storage dtype: ``None`` keeps them, float32 and
    float64 cast, int16 stores the fixed-point codes ``round(out *
    ABS_I16_SCALE)`` (round half to even, in ``out``'s float type), as
    ``gpy_dla_detection_tpu/ops/voigt.py:encode_profile_store`` does.  The
    plain version of the encode at the stores of K1, K5 and K6."""
    if dtype is None:
        return out
    if dtype == torch.int16:
        return torch.round(out * ABS_I16_SCALE).to(torch.int16)
    if dtype in (torch.float32, torch.float64):
        return out.to(dtype)
    raise TypeError(f"profiles are stored as float32, float64 or int16, not {dtype}")


def absorption_from_unit_tau(
    unit_tau: torch.Tensor, nhi: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """Broadened absorption ``conv(exp(-nhi * unit_tau))``: (..., P) ->
    (..., P - 6), the leading axes of ``unit_tau`` matching ``nhi``'s,
    stored as ``out_dtype`` (:func:`encode_profile_store`; None keeps
    ``unit_tau``'s dtype).

    Dispatch by tensor: float32 runs K5 (its kernel on CUDA, its plain
    twin on the CPU), which encodes int16 at its store; float64 runs the
    plain composition on the CPU, the conformance path, and encodes after
    it; anything else raises."""
    if unit_tau.dtype == torch.float64:
        if unit_tau.device.type != "cpu":
            raise TypeError(
                "the float64 absorption is the CPU conformance path; the "
                "CUDA kernels take float32"
            )
        return encode_profile_store(
            instrumental_broadening(torch.exp(-nhi[..., None] * unit_tau)), out_dtype
        )
    from .voigt_kernels import absorption_tail

    lead, P = unit_tau.shape[:-1], unit_tau.shape[-1]
    out = absorption_tail(
        unit_tau.reshape(-1, P).contiguous(), nhi.reshape(-1).contiguous(), out_dtype
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


def lyman_limit_unit_tau(wavelengths: torch.Tensor, z_absorber: torch.Tensor) -> torch.Tensor:
    """Lyman-limit break opacity per unit column density:
    ``(lambda_rest / 911.7641)^3 / 10^17.2`` below the limit, 0 above it.

    :param wavelengths: (P,) observed wavelengths [A].
    :param z_absorber: (...,) absorber redshifts.
    :return: (..., P).
    """
    rest = wavelengths / (1.0 + z_absorber)[..., None]
    return torch.where(
        rest > LYMAN_LIMIT_A,
        0.0,
        (rest / LYMAN_LIMIT_A) ** 3 / 10.0**LYMAN_LIMIT_LOG_NHI,
    )


def voigt_absorption_lls(
    wavelengths: torch.Tensor,
    nhi: torch.Tensor,
    z_absorber: torch.Tensor,
    num_lines: int = 3,
) -> torch.Tensor:
    """Broadened absorption of one absorber per sample including the
    Lyman-limit break, exact Faddeeva at every pixel
    (``gpy_dla_detection_tpu/ops/voigt.py:voigt_absorption_lls``, exact
    form).  The break is linear in nhi, so it is added to the unit
    optical depth before the tail (K5 on float32).

    :param nhi, z_absorber: (...,) column densities and redshifts.
    :return: (..., P - 6).
    """
    unit = unit_lyman_optical_depth(wavelengths, z_absorber, num_lines)
    return absorption_from_unit_tau(
        unit + lyman_limit_unit_tau(wavelengths, z_absorber), nhi
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
    optical depth per unit column density (``ops/voigt_kernels.civ_unit_tau``:
    civ_tau on float32 CUDA tensors, its plain twin on the CPU) goes through
    the same exp and convolution as the Lyman series (K5 on float32).  Each
    call on a CUDA device adds one to ``launch_counts["civ_profile"]``.

    :param nciv, z_civ, sigma: (...,) per-sample parameters.
    :return: (..., P - 6).
    """
    from .voigt_kernels import civ_unit_tau

    z_civ, sigma = torch.broadcast_tensors(z_civ, sigma)
    tau = civ_unit_tau(wavelengths.contiguous(), z_civ.reshape(-1).contiguous(),
                       sigma.reshape(-1).contiguous(), num_lines)
    if tau.is_cuda:
        launch_counts["civ_profile"] += 1
    return absorption_from_unit_tau(tau.reshape(*z_civ.shape, wavelengths.shape[0]), nciv)


class WindowedTauParts(NamedTuple):
    """The windowed unit optical depth before its windows are placed:
    K6's input (``ops/voigt_kernels.absorption_windowed``)."""

    far: torch.Tensor  # (S, P_pad) far-field unit tau on the chunk-padded grid
    corr: torch.Tensor  # (S, L * FAST_WINDOW) per-line window corrections
    c0: torch.Tensor  # (S, L) int32 chunk index of each window's start
    num_pixels: int  # P, the unpadded pixel count


def chunk_pad_wavelengths(wavelengths: torch.Tensor) -> torch.Tensor:
    """Pad a (P,) grid to a multiple of CHUNK pixels by continuing its last
    spacing (an edge-repeated partial chunk would compress the chunk's
    span and throw off the linear within-chunk centre estimate)."""
    P = wavelengths.shape[0]
    P_pad = -(-P // CHUNK) * CHUNK
    if P_pad == P:
        return wavelengths
    step = wavelengths[-1] - wavelengths[-2]
    step = torch.where(step > 0, step, torch.ones_like(step))
    ext = wavelengths[-1] + step * torch.arange(
        1, P_pad - P + 1, dtype=wavelengths.dtype, device=wavelengths.device
    )
    return torch.cat([wavelengths, ext])


def _line_center_estimates(
    wl_chunks: torch.Tensor, lam_c_all: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(centre pixel, window start chunk) per sample and line on a
    chunk-padded grid: the chunk that holds the line centre, then a
    linear map between that chunk's end wavelengths (~0.01 px off on the
    log-uniform SDSS grid; the window tolerates ~+-15 px).

    :param wl_chunks: (nc, CHUNK) padded wavelengths.
    :param lam_c_all: (..., L) observed-frame line centres.
    :return: (centre, c0), both (..., L) int64.
    """
    nc = wl_chunks.shape[0]
    tops = wl_chunks[:, -1]
    firsts = wl_chunks[:, 0]
    c_idx = torch.clamp(torch.sum(lam_c_all[..., None] >= tops, dim=-1), 0, nc - 1)
    first = firsts[c_idx]
    last = tops[c_idx]
    within = torch.clamp(
        (lam_c_all - first) / torch.clamp(last - first, min=1e-30) * (CHUNK - 1),
        0.0,
        CHUNK - 1.0,
    )
    center = c_idx * CHUNK + within.to(torch.int64)
    c0 = torch.clamp(
        torch.div(center - CHUNK // 2, CHUNK, rounding_mode="floor"), 0, nc - 2
    )
    return center, c0


def lyman_line_constants(num_lines: int, sigma: float = C.THERMAL_SIGMA_CGS):
    """The float32 scalars of the windowed and fused unit optical depth,
    rounded in the reference kernels' order: (inv, c, sqrt(pi), per line
    (lam, amp, y, y^2)) with inv = 1 / (sqrt(2) sigma), amp = a_l inv /
    sqrt(pi) and y = gamma_l inv."""
    f = np.float32
    inv = f(1.0) / (np.sqrt(f(2.0)) * f(sigma))
    sqrt_pi = f(np.sqrt(np.pi))
    lines = []
    for l in range(num_lines):
        y = f(C.LYMAN_LORENTZIAN_WIDTHS[l]) * inv
        lines.append((
            float(f(C.LYMAN_WAVELENGTHS_A[l])),
            float(f(C.LYMAN_LEADING_CONSTANTS[l]) * inv / sqrt_pi),
            float(y),
            float(y * y),
        ))
    return float(inv), float(f(C.SPEED_OF_LIGHT_CGS)), float(sqrt_pi), tuple(lines)


def windowed_tau_parts(
    wavelengths: torch.Tensor,
    z_absorber: torch.Tensor,
    num_lines: int = 3,
    window_tier: bool = True,
) -> WindowedTauParts:
    """The windowed unit optical depth in unplaced form, float32
    (``gpy_dla_detection_tpu/ops/voigt.py:_windowed_tau_parts``; its
    float64 branch is not ported: float64 is the exact path).

    Every pixel of the chunk-padded grid gets the far-field Lorentzian
    ``y / (sqrt(pi) |z|^2)`` where ``|z| > CF_FAR_RADIUS`` (first
    FAR_FIELD_LINES lines); inside that radius each line's value comes
    from a 256-pixel window starting at chunk ``c0``, estimated from the
    chunk ends (K6's input, so kept exactly as the reference computes
    it): the Weideman rational on the ``|z| <= RADIUS`` disk and the
    continued fraction on the annulus.  With ``window_tier`` the Weideman
    and the full continued fraction run only on a 96-pixel strip around
    the centre, the 2-term continued fraction on the rest of the window.

    :param wavelengths: (P,) padded observed wavelengths [A], float32.
    :param z_absorber: (S,) absorber redshifts, float32.
    :param window_tier: the reference's ``GPY_DLA_WINDOW_TIER``.
    """
    if wavelengths.dtype != torch.float32:
        raise TypeError(
            f"the windowed unit optical depth is float32 (float64 takes the "
            f"exact path), got {wavelengths.dtype}"
        )
    device = wavelengths.device
    S, P = z_absorber.shape[0], wavelengths.shape[0]
    W = FAST_WINDOW
    nc = -(-P // CHUNK)
    wl_pad = chunk_pad_wavelengths(wavelengths)
    wl_chunks = wl_pad.reshape(nc, CHUNK)
    inv, c_over, sqrt_pi, lines = lyman_line_constants(num_lines)
    far2 = CF_FAR_RADIUS * CF_FAR_RADIUS
    one_plus_z = (1.0 + z_absorber)[:, None]  # (S, 1)
    lam_c_all = torch.cat([lam * one_plus_z for lam, _, _, _ in lines], dim=1)
    centers, c0_all = _line_center_estimates(wl_chunks, lam_c_all)
    rows = torch.arange(S, device=device)[:, None]

    far = torch.zeros((S, nc * CHUNK), dtype=wavelengths.dtype, device=device)
    corrs = []
    for l, (_, amp, y, y2) in enumerate(lines):
        lam_c = lam_c_all[:, l : l + 1]  # (S, 1)
        if l < FAR_FIELD_LINES:
            x_all = (wl_pad - lam_c) * (c_over / lam_c) * inv
            r2_all = x_all * x_all + y2
            far = far + amp * torch.where(r2_all > far2, y / (sqrt_pi * r2_all), 0.0)

        center, c0 = centers[:, l], c0_all[:, l]
        wl_win = torch.cat([wl_chunks[c0], wl_chunks[c0 + 1]], dim=1)  # (S, W)
        x_win = (wl_win - lam_c) * (c_over / lam_c) * inv
        ax = torch.abs(x_win)
        r2 = ax * ax + y2
        y_win = torch.full_like(ax, y)
        if window_tier:
            nb = W // STRIP_BLOCK
            lc_local = center - c0 * CHUNK
            b_strip = torch.clamp(
                torch.div(lc_local, STRIP_BLOCK, rounding_mode="floor") - 1,
                0, nb - STRIP_BLOCKS,
            )
            blk = b_strip[:, None] + torch.arange(STRIP_BLOCKS, device=device)  # (S, 3)
            ax_strip = ax.reshape(S, nb, STRIP_BLOCK)[rows, blk].reshape(S, -1)
            y_strip = torch.full_like(ax_strip, y)
            r2_s = ax_strip * ax_strip + y2
            inner_s = r2_s <= RADIUS * RADIUS
            ann_s = ~inner_s & (r2_s <= far2)
            wei_s, _ = _wofz_weideman(torch.where(inner_s, ax_strip, 0.0), y_strip)
            cf_s, _ = _wofz_cf(ax_strip, y_strip)
            strip_val = torch.where(inner_s, wei_s, 0.0) + torch.where(ann_s, cf_s, 0.0)
            cf2, _ = _wofz_cf(ax, y_win, terms=2)
            in_strip = torch.zeros((S, nb), dtype=torch.bool, device=device)
            in_strip[rows, blk] = True
            # outside the strip: the 2-term continued fraction on the
            # annulus only (never on the disk, should the centre
            # estimate ever miss it)
            mid = (~in_strip[:, :, None]) & (
                (r2 <= far2) & (r2 > RADIUS * RADIUS)
            ).reshape(S, nb, STRIP_BLOCK)
            corr = torch.where(mid, cf2.reshape(S, nb, STRIP_BLOCK), 0.0)
            corr[rows, blk] = strip_val.reshape(S, STRIP_BLOCKS, STRIP_BLOCK)
            corrs.append(amp * corr.reshape(S, W))
        else:
            inner = r2 <= RADIUS * RADIUS
            annulus = ~inner & (r2 <= far2)
            wei, _ = _wofz_weideman(torch.where(inner, ax, 0.0), y_win)
            cf, _ = _wofz_cf(ax, y_win)
            corrs.append(
                amp * (torch.where(inner, wei, 0.0) + torch.where(annulus, cf, 0.0))
            )

    return WindowedTauParts(
        far=far,
        corr=torch.cat(corrs, dim=1),
        c0=c0_all.to(torch.int32),
        num_pixels=P,
    )


def place_windows(parts: WindowedTauParts) -> torch.Tensor:
    """Add each line's window correction onto the far field at chunks
    (c0, c0 + 1), one line after another (windows of different lines may
    overlap); returns the dense (S, P) unit optical depth."""
    far, corr, c0, P = parts
    S = far.shape[0]
    rows = torch.arange(S, device=far.device)[:, None]
    cols = torch.arange(FAST_WINDOW, device=far.device)
    tau = far.clone()
    for l in range(c0.shape[1]):
        idx = c0[:, l : l + 1].to(torch.int64) * CHUNK + cols
        tau[rows, idx] = tau[rows, idx] + corr[:, l * FAST_WINDOW : (l + 1) * FAST_WINDOW]
    return tau[:, :P]
