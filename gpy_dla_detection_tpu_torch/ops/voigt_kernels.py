"""K1, K5 and K6: the broadened Voigt absorption kernels.

K1 is the fused absorption of every column-density family from the
shared redshift samples (the default catalog path; with ``lls_break`` the
LLS search's profile); K5 is the tail alone, ``conv7(exp(-nhi *
unit_tau))`` over a precomputed unit optical depth (the exact-Voigt
catalog configuration and the MCMC head); K6 places the windowed unit
optical depth's corrections and runs the same tail (the unfused windowed
catalog configuration).

``absorption_all`` launches ``csrc/absorption_all.cu`` on float32 CUDA
tensors and runs its plain twin ``absorption_all_reference`` on float32
CPU tensors.  Both evaluate, per sample and pixel, the far-field
Lorentzian beyond ``|z| = CF_FAR_RADIUS`` and the per-line polynomial
Faddeeva inside it, with the float32 constants of
``gpy_dla_detection_tpu/ops/voigt_pallas.py:_abs_all_kernel`` (poly=True).
``absorption_tail`` launches ``csrc/absorption_tail.cu`` on float32 CUDA
tensors and runs ``absorption_tail_reference`` on float32 CPU tensors; it
replaces ``voigt_pallas.py:_abs_tail_kernel``.  ``absorption_windowed``
launches ``csrc/absorption_windowed.cu`` and runs
``absorption_windowed_reference`` likewise; it replaces
``voigt_pallas.py:_abs_windowed_kernel``.
"""

from __future__ import annotations

import functools
from collections.abc import Sequence

import numpy as np
import torch

from .. import constants as C

from ._build import (
    MAX_DYNAMIC_SHARED_BYTES,
    check_cuda_f32,
    check_launch,
    launch_counts,
    load_library,
    ptr,
    stream_ptr,
    use_kernel,
)
from .voigt import (
    CF_FAR_RADIUS,
    CHUNK,
    FAR_FIELD_LINES,
    FAST_WINDOW,
    LYMAN_LIMIT_A,
    LYMAN_LIMIT_LOG_NHI,
    WindowedTauParts,
    instrumental_broadening,
    lyman_line_constants,
    place_windows,
)

WINDOW_U0 = 9.0  # disk/wing split of the polynomial Faddeeva, in u = x^2


@functools.lru_cache(maxsize=32)
def _window_poly_coeffs(y: float, u0: float = 9.0,
                        deg_disk: int = 16, deg_wing: int = 10):
    """Per-line polynomial fit of Re w(x + iy) for a fixed Lorentzian
    width ``y``: ``exp(-u) + y * R(u)`` with u = x^2.

    * disk  u in [0, u0]:           R(s),  s = 2 u / u0 - 1
    * wing  u in [u0, CF_FAR^2]:    w = exp(-u) + y * t * S(st),
                                    t = 1/u, st = 2 u0 t - 1

    Monomial coefficients (lowest power first) of Chebyshev fits to
    scipy's float64 ``wofz``, rounded to float32; a copy of
    ``gpy_dla_detection_tpu/ops/voigt_pallas.py:_window_poly_coeffs``.
    """
    from scipy.special import wofz

    u = np.linspace(0.0, u0, 30001)
    w = wofz(np.sqrt(u) + 1j * y).real
    R = (w - np.exp(-u)) / y
    s = 2.0 * u / u0 - 1.0
    cd = (
        np.polynomial.chebyshev.Chebyshev.fit(s, R, deg_disk)
        .convert(kind=np.polynomial.Polynomial)
        .coef.astype(np.float32)
    )
    uu = np.geomspace(u0, float(CF_FAR_RADIUS) ** 2, 30001)
    t = 1.0 / uu
    S = (wofz(np.sqrt(uu) + 1j * y).real - np.exp(-uu)) / (y * t)
    st = 2.0 * u0 * t - 1.0
    cw = (
        np.polynomial.chebyshev.Chebyshev.fit(st, S, deg_wing)
        .convert(kind=np.polynomial.Polynomial)
        .coef.astype(np.float32)
    )
    return tuple(float(c) for c in cd), tuple(float(c) for c in cw)


def _f32(x) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=8)
def _kernel_constants(num_lines: int) -> tuple[dict, tuple[float, ...]]:
    """Scalar float32 constants shared by the kernel and its twin, rounded
    exactly as the reference kernel rounds them, plus the flat parameter
    table the CUDA kernel reads (per line: lam, amp, y, y^2, disk and wing
    coefficients; then the 7 instrument taps)."""
    sigma = float(C.THERMAL_SIGMA_CGS)
    inv, c_cgs, sqrt_pi, line_scalars = lyman_line_constants(num_lines, sigma)
    lines = []
    table = []
    for l, (lam, amp, y, y2) in enumerate(line_scalars):
        y_fit = float(C.LYMAN_LORENTZIAN_WIDTHS[l]) * (
            1.0 / (float(np.sqrt(2.0)) * sigma)
        )
        cd, cw = _window_poly_coeffs(y_fit, WINDOW_U0)
        lines.append(dict(lam=lam, amp=amp, y=y, y2=y2, cd=cd, cw=cw))
        table += [lam, amp, y, y2, *cd, *cw]
    table += [_f32(t) for t in C.INSTRUMENT_PROFILE]
    consts = dict(inv=inv, sqrt_pi=sqrt_pi, c_cgs=c_cgs, lines=tuple(lines))
    return consts, tuple(table)


@functools.lru_cache(maxsize=8)
def _device_table(num_lines: int, device: torch.device) -> torch.Tensor:
    _, table = _kernel_constants(num_lines)
    return torch.tensor(table, dtype=torch.float32, device=device)


def absorption_all_reference(
    wavelengths: torch.Tensor,
    z_absorber: torch.Tensor,
    nhis: Sequence[torch.Tensor],
    num_lines: int = 3,
    lls_break: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of K1 (dense per-pixel formula).

    :param wavelengths: (P,) padded observed wavelengths [A], float32.
    :param z_absorber: (S,) absorber redshifts.
    :param nhis: column densities, one (S,) tensor per family.
    :param lls_break: start each row's optical depth from the Lyman-limit
        break per unit column density (the LLS profile).
    :return: one (S, P - 6) broadened absorption per family.
    """
    consts, _ = _kernel_constants(num_lines)
    inv, sqrt_pi, c_cgs = consts["inv"], consts["sqrt_pi"], consts["c_cgs"]
    far_r2 = CF_FAR_RADIUS * CF_FAR_RADIUS
    u0 = WINDOW_U0
    wl = wavelengths[None, :]
    one_plus_z = (1.0 + z_absorber)[:, None]
    if lls_break:
        # the reference kernel's order: t = wl * (1 / (limit (1 + z))),
        # then ((10^-17.2 t) t) t below the limit
        r = wl * (1.0 / (_f32(LYMAN_LIMIT_A) * one_plus_z))
        tau = torch.where(r > 1.0, 0.0, _f32(10.0**-LYMAN_LIMIT_LOG_NHI) * r * r * r)
    else:
        tau = torch.zeros(
            (z_absorber.shape[0], wavelengths.shape[0]),
            dtype=wavelengths.dtype, device=wavelengths.device,
        )
    for l, line in enumerate(consts["lines"]):
        amp, y = line["amp"], line["y"]
        lam_c = line["lam"] * one_plus_z
        x = (wl - lam_c) * (c_cgs / lam_c) * inv
        u = x * x
        r2 = u + line["y2"]
        far = r2 > far_r2
        if l < FAR_FIELD_LINES:
            tau = tau + amp * torch.where(far, y / (sqrt_pi * r2), 0.0)
        eu = torch.exp(-u)
        cd, cw = line["cd"], line["cw"]
        s = u * (2.0 / u0) - 1.0
        disk = torch.full_like(u, cd[-1])
        for c in cd[-2::-1]:
            disk = disk * s + c
        disk = eu + y * disk
        t = 1.0 / torch.clamp(u, min=u0)
        st = t * (2.0 * u0) - 1.0
        wing = torch.full_like(u, cw[-1])
        for c in cw[-2::-1]:
            wing = wing * st + c
        wing = eu + y * t * wing
        tau = tau + amp * torch.where(far, 0.0, torch.where(u <= u0, disk, wing))
    return tuple(
        instrumental_broadening(torch.exp(-nhi[:, None] * tau)) for nhi in nhis
    )


def absorption_all(
    wavelengths: torch.Tensor,
    z_absorber: torch.Tensor,
    nhis: Sequence[torch.Tensor],
    num_lines: int = 3,
    lls_break: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Broadened absorption profiles of every family in ``nhis`` from the
    shared redshift samples: K1 on CUDA, its twin on the CPU (float32).

    :param lls_break: include the Lyman-limit break (the LLS profile).
    :return: one (S, P - 6) float32 profile per family.
    """
    if not use_kernel(wavelengths):
        return absorption_all_reference(
            wavelengths, z_absorber, nhis, num_lines, lls_break
        )
    device = wavelengths.device
    nhi = torch.stack(tuple(nhis)).contiguous()  # (F, S)
    check_cuda_f32(device, wavelengths=wavelengths, z_absorber=z_absorber, nhi=nhi)
    P = wavelengths.shape[0]
    S = z_absorber.shape[0]
    F = nhi.shape[0]
    if wavelengths.ndim != 1 or z_absorber.ndim != 1 or nhi.shape[1] != S:
        raise ValueError(
            f"expected wavelengths (P,), z (S,), nhis F x (S,); got "
            f"{tuple(wavelengths.shape)}, {tuple(z_absorber.shape)}, "
            f"{tuple(nhi.shape)}"
        )
    if S == 0 or P <= 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH:
        raise ValueError(f"empty problem: S={S}, P={P}")
    consts, table_values = _kernel_constants(num_lines)
    smem = 4 * (len(table_values) + 2 * P)
    if smem > MAX_DYNAMIC_SHARED_BYTES:
        raise ValueError(
            f"absorption_all keeps two rows of P={P} floats and the line table "
            f"in shared memory: {smem} bytes > {MAX_DYNAMIC_SHARED_BYTES}"
        )
    table = _device_table(num_lines, device)
    out = torch.empty(
        (F, S, P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH),
        dtype=torch.float32, device=device,
    )
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.absorption_all_launch(
            ptr(wavelengths), P, ptr(z_absorber), S, ptr(nhi), F, ptr(table),
            num_lines, min(num_lines, FAR_FIELD_LINES), int(lls_break),
            consts["inv"], consts["c_cgs"], consts["sqrt_pi"], ptr(out),
            stream_ptr(device),
        )
    check_launch("absorption_all", err)
    launch_counts["absorption_all"] += 1
    return tuple(out.unbind(0))


@functools.lru_cache(maxsize=8)
def _device_taps(device: torch.device) -> torch.Tensor:
    return torch.tensor(
        [_f32(t) for t in C.INSTRUMENT_PROFILE], dtype=torch.float32, device=device
    )


def absorption_tail_reference(unit_tau: torch.Tensor, nhi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K5: ``conv7(exp(-nhi[:, None] * unit_tau))``
    with K5's float32 taps, summed in the kernel's order.

    :param unit_tau: (S, P) optical depth per unit column density.
    :param nhi: (S,) column densities.
    :return: (S, P - 6).
    """
    return instrumental_broadening(torch.exp(-nhi[:, None] * unit_tau))


def absorption_tail(unit_tau: torch.Tensor, nhi: torch.Tensor) -> torch.Tensor:
    """Broadened absorption from a unit optical depth: K5 on CUDA, its
    twin on the CPU (float32).  Any row count; one block per row.

    :param unit_tau: (S, P) float32, contiguous.
    :param nhi: (S,) float32.
    :return: (S, P - 6) float32.
    """
    if not use_kernel(unit_tau):
        return absorption_tail_reference(unit_tau, nhi)
    device = unit_tau.device
    check_cuda_f32(device, unit_tau=unit_tau, nhi=nhi)
    if unit_tau.ndim != 2 or nhi.shape != unit_tau.shape[:1]:
        raise ValueError(
            f"expected unit_tau (S, P) and nhi (S,); got "
            f"{tuple(unit_tau.shape)}, {tuple(nhi.shape)}"
        )
    S, P = unit_tau.shape
    if S == 0 or P <= 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH:
        raise ValueError(f"empty problem: S={S}, P={P}")
    if P * 4 > MAX_DYNAMIC_SHARED_BYTES:
        raise ValueError(
            f"absorption_tail keeps a row of P={P} floats in shared memory; "
            f"at most {MAX_DYNAMIC_SHARED_BYTES // 4} fit"
        )
    out = torch.empty(
        (S, P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH), dtype=torch.float32, device=device
    )
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.absorption_tail_launch(
            ptr(unit_tau), ptr(nhi), S, P, ptr(_device_taps(device)), ptr(out),
            stream_ptr(device),
        )
    check_launch("absorption_tail", err)
    launch_counts["absorption_tail"] += 1
    return out


def absorption_windowed_reference(parts: WindowedTauParts, nhi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K6: place the window corrections
    (``ops/voigt.place_windows``), then ``conv7(exp(-nhi * tau))``.

    :param parts: the windowed unit optical depth of S samples.
    :param nhi: (S,) column densities.
    :return: (S, num_pixels - 6).
    """
    return absorption_tail_reference(place_windows(parts), nhi)


def absorption_windowed(parts: WindowedTauParts, nhi: torch.Tensor) -> torch.Tensor:
    """Broadened absorption from the unplaced windowed unit optical depth:
    K6 on CUDA, its twin on the CPU (float32).  One block per row.

    :param parts: far (S, P_pad) with P_pad a multiple of 128, corr
        (S, L * 256), c0 (S, L) int32 in [0, P_pad / 128 - 2], num_pixels P.
    :param nhi: (S,) column densities.
    :return: (S, P - 6) float32.
    """
    far, corr, c0, P = parts
    if not use_kernel(far):
        return absorption_windowed_reference(parts, nhi)
    device = far.device
    check_cuda_f32(device, far=far, corr=corr, nhi=nhi)
    if c0.dtype != torch.int32 or c0.device != device or not c0.is_contiguous():
        raise ValueError(f"c0 must be contiguous int32 on {device}")
    S, P_pad = far.shape[0], far.shape[-1]
    L = c0.shape[-1]
    if (
        far.ndim != 2 or c0.ndim != 2 or P_pad % CHUNK or c0.shape[0] != S
        or tuple(corr.shape) != (S, L * FAST_WINDOW) or tuple(nhi.shape) != (S,)
    ):
        raise ValueError(
            f"expected far (S, P_pad) with P_pad % {CHUNK} == 0, corr (S, L*"
            f"{FAST_WINDOW}), c0 (S, L), nhi (S,); got {tuple(far.shape)}, "
            f"{tuple(corr.shape)}, {tuple(c0.shape)}, {tuple(nhi.shape)}"
        )
    if S == 0 or not 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH < P <= P_pad:
        raise ValueError(f"empty problem or bad pixel count: S={S}, P={P}, P_pad={P_pad}")
    if P_pad * 4 > MAX_DYNAMIC_SHARED_BYTES:
        raise ValueError(
            f"absorption_windowed keeps a row of P_pad={P_pad} floats in shared "
            f"memory; at most {MAX_DYNAMIC_SHARED_BYTES // 4} fit"
        )
    out = torch.empty(
        (S, P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH), dtype=torch.float32, device=device
    )
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.absorption_windowed_launch(
            ptr(far), ptr(corr), ptr(c0), ptr(nhi), S, P_pad, P, L,
            ptr(_device_taps(device)), ptr(out), stream_ptr(device),
        )
    check_launch("absorption_windowed", err)
    launch_counts["absorption_windowed"] += 1
    return out
