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
Lorentzian beyond ``|z| = CF_FAR_RADIUS`` and a window Faddeeva inside
it, with the float32 constants of
``gpy_dla_detection_tpu/ops/voigt_pallas.py:_abs_all_kernel``: the
per-line polynomial (``poly=True``, the default) or the Weideman rational
inside ``|z| = RADIUS`` and the continued fraction beyond (``poly=False``,
the reference's ``GPY_DLA_FUSED_POLY=0``).  The kernel's launch geometry
is :func:`k1_geometry`.
``absorption_tail`` launches ``csrc/absorption_tail.cu`` on float32 CUDA
tensors and runs ``absorption_tail_reference`` on float32 CPU tensors; it
replaces ``voigt_pallas.py:_abs_tail_kernel``.  ``absorption_windowed``
launches ``csrc/absorption_windowed.cu`` and runs
``absorption_windowed_reference`` likewise; it replaces
``voigt_pallas.py:_abs_windowed_kernel``.  Both kernels are the streaming
tail of ``csrc/absorption_stencil.cuh``, launched at :func:`tail_geometry`.

Each takes ``out_dtype``: float32 (``None``) or int16, the fixed-point
codes of compact profile storage (``ops/kernel_config.py``), which each
kernel encodes at its store in an instantiation of its own, counted
under its own name (``_build.store_name``: ``absorption_all_i16``,
``absorption_all_weideman_i16``, ``absorption_tail_i16``,
``absorption_windowed_i16``).  Each twin encodes its float32 result with
``ops/voigt.encode_profile_store``.

``civ_unit_tau`` computes K5's input for the CIV doublet, the unit optical
depth of ``ops/voigt.voigt_absorption_civ``: it launches
``csrc/civ_tau.cu`` on float32 CUDA tensors (no TPU counterpart: the JAX
package composes it in plain XLA) and runs its plain twin
``civ_unit_tau_reference``, that composition in PyTorch, on float32 and
float64 CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C

from ._build import (
    check_cuda_f32,
    check_launch,
    check_store_dtype,
    launch_counts,
    load_library,
    ptr,
    store_name,
    stream_ptr,
    use_kernel,
)
from .faddeeva import (
    _WEIDEMAN_A32,
    _WEIDEMAN_L32,
    RADIUS,
    SQRT_PI,
    _wofz_cf,
    _wofz_weideman,
    wofz_parts,
)
from .logmvn_kernels import H100_SMS, _chain_grid, _sm_count
from .voigt import (
    CF_FAR_RADIUS,
    CHUNK,
    FAR_FIELD_LINES,
    FAST_WINDOW,
    LYMAN_LIMIT_A,
    LYMAN_LIMIT_LOG_NHI,
    WindowedTauParts,
    encode_profile_store,
    instrumental_broadening,
    lyman_line_constants,
    place_windows,
)

WINDOW_U0 = 9.0  # disk/wing split of the polynomial Faddeeva, in u = x^2

# K1's launch (csrc/absorption_all.cu, K1_GEOMETRY): a lane owns K1_PIXELS
# consecutive pixels, so a warp steps through a row K1_CHUNK pixels at a
# time; K1_WARPS warps a block, K1_BLOCKS_PER_SM blocks an SM (the launch
# bound: 64 registers a thread).  A warp keeps a ring of two chunks of
# exp(-nhi tau) per family in shared memory; K1_MAX_FAMILIES rings fill
# 48 KB a block, and more families take more launches.
K1_PIXELS = 4
K1_WARPS = 8
K1_BLOCKS_PER_SM = 4
K1_CHUNK = 32 * K1_PIXELS
K1_MAX_FAMILIES = 6

# K1's constant table (csrc/absorption_all.cu, c_tab): a header, then one
# record of K1_LINE_STRIDE floats a line, at most K1_MAX_LINES lines
K1_MAX_LINES = 31
K1_TABLE_HEADER = 40
K1_LINE_STRIDE = 40
_TAB_TAPS, _TAB_WEI = 8, 16  # the 7 instrument taps, the 20 Weideman coefficients
_LINE_DISK, _LINE_WING = 9, 26  # a line record's 17 disk and 11 wing coefficients


# K5's and K6's launch (csrc/absorption_stencil.cuh, K56_GEOMETRY): a lane
# owns K56_PIXELS consecutive pixels, so a warp steps through a row
# K56_CHUNK pixels at a time, with K56_DEPTH items' loads in flight;
# K56_WARPS warps a block, K56_BLOCKS_PER_SM blocks an SM (the launch
# bound).  A warp keeps a ring of two chunks of exp(-nhi tau) in shared
# memory.
K56_PIXELS = 8
K56_DEPTH = 2
K56_WARPS = 8
K56_BLOCKS_PER_SM = 4
K56_CHUNK = 32 * K56_PIXELS


# civ_tau's launch (csrc/civ_tau.cu, CIV_TAU_GEOMETRY): a lane owns a
# pixel, so a warp steps through a row CIV_TAU_STEP pixels at a time, the
# unit of its Weideman vote; CIV_TAU_WARPS warps a block,
# CIV_TAU_BLOCKS_PER_SM blocks an SM (the launch bound).
CIV_TAU_STEP = 32
CIV_TAU_WARPS = 8
CIV_TAU_BLOCKS_PER_SM = 6


class AbsorptionGeometry(NamedTuple):
    """K1's, K5's and K6's launch: ``warps`` a block, ``shared_bytes`` a
    block (the warps' rings) and ``grid`` blocks.  The rows' nc chunks each
    form one sequence of C = S nc chunks, row by row; warp w of the grid's
    T takes chunks ``w * C // T`` up to ``(w + 1) * C // T``."""

    warps: int
    shared_bytes: int
    grid: int


def k1_chunks(P: int) -> int:
    """Chunks of K1_CHUNK output pixels a row of P pixels takes."""
    return -(-(P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH) // K1_CHUNK)


def k1_geometry(S: int, P: int, F: int, sms: int = H100_SMS) -> AbsorptionGeometry:
    """K1's launch geometry for S rows of P pixels and F <= K1_MAX_FAMILIES
    families on ``sms`` SMs: K3's grid rule (``_chain_grid``) over the S nc
    chunks, so every warp takes an even share of them in one wave (a
    warp's share need not be whole rows: whole rows left the main path's
    warps 2 or 3 rows each, a third of them working on alone at the end)."""
    if S < 1 or P <= 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH:
        raise ValueError(f"K1 needs S >= 1 and P > 6, got S={S}, P={P}")
    if not 1 <= F <= K1_MAX_FAMILIES:
        raise ValueError(f"a K1 launch takes 1 to {K1_MAX_FAMILIES} families, got {F}")
    return AbsorptionGeometry(
        warps=K1_WARPS, shared_bytes=4 * F * K1_WARPS * 2 * K1_CHUNK,
        grid=_chain_grid(S * k1_chunks(P), K1_WARPS, K1_BLOCKS_PER_SM, sms),
    )


def tail_chunks(P: int) -> int:
    """Chunks of K56_CHUNK output pixels a K5 or K6 row of P pixels takes."""
    return -(-(P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH) // K56_CHUNK)


def tail_items(k0: int, k1: int, P: int) -> list[tuple[int, int, bool]]:
    """The items a K5 or K6 warp walks for its run of output chunks [k0, k1)
    of the rows' sequence, as ``csrc/absorption_stencil.cuh``'s Cursor
    does: per row piece (s, c0 .. c1 - 1) the full items (s, c) and then
    the halo item (s, c1, True), the first 6 pixels of chunk c1."""
    nc = tail_chunks(P)
    items = []
    for k in range(k0, k1):
        s, c = divmod(k, nc)
        items.append((s, c, False))
        if k + 1 == k1 or c + 1 == nc:
            items.append((s, c + 1, True))
    return items


def tail_geometry(S: int, P: int, sms: int = H100_SMS) -> AbsorptionGeometry:
    """K5's and K6's launch geometry for S rows of P used pixels on ``sms``
    SMs: K3's grid rule (``_chain_grid``) over the S nc output chunks, so
    every warp takes an even share of them in one wave."""
    if S < 1 or P <= 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH:
        raise ValueError(f"K5 and K6 need S >= 1 and P > 6, got S={S}, P={P}")
    chunks = S * tail_chunks(P)
    if chunks >= 2**31:
        raise ValueError(f"S x chunks a row = {chunks} does not fit the kernels' int index")
    return AbsorptionGeometry(
        warps=K56_WARPS, shared_bytes=4 * K56_WARPS * 2 * K56_CHUNK,
        grid=_chain_grid(chunks, K56_WARPS, K56_BLOCKS_PER_SM, sms),
    )


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
def _kernel_constants(num_lines: int) -> dict:
    """Scalar float32 constants shared by the kernel and its twin, rounded
    exactly as the reference kernel rounds them: inv, c, sqrt(pi) and per
    line lam, amp, y, y^2 and the polynomial fit's disk and wing
    coefficients."""
    if not 1 <= num_lines <= K1_MAX_LINES:
        raise ValueError(f"K1 takes 1 to {K1_MAX_LINES} lines, got {num_lines}")
    sigma = float(C.THERMAL_SIGMA_CGS)
    inv, c_cgs, sqrt_pi, line_scalars = lyman_line_constants(num_lines, sigma)
    lines = []
    for l, (lam, amp, y, y2) in enumerate(line_scalars):
        y_fit = float(C.LYMAN_LORENTZIAN_WIDTHS[l]) * (
            1.0 / (float(np.sqrt(2.0)) * sigma)
        )
        cd, cw = _window_poly_coeffs(y_fit, WINDOW_U0)
        lines.append(dict(lam=lam, amp=amp, y=y, y2=y2, cd=cd, cw=cw))
    return dict(inv=inv, sqrt_pi=sqrt_pi, c_cgs=c_cgs, lines=tuple(lines))


@functools.lru_cache(maxsize=8)
def _kernel_table(num_lines: int) -> np.ndarray:
    """The constant table the CUDA kernel reads (csrc/absorption_all.cu,
    c_tab), float32: inv, c, sqrt(pi), 2 L of the Weideman rational, the
    taps and the 20 Weideman coefficients; then per line lam, amp, y, y^2,
    amp y / sqrt(pi) (the far field's numerator), L + y, (L + y)^2,
    (L - y)(L + y) and 2 (L + y) in the Weideman rational's float32
    rounding, and the disk and wing coefficients."""
    f = np.float32
    consts = _kernel_constants(num_lines)
    L = f(_WEIDEMAN_L32)
    tab = np.zeros(K1_TABLE_HEADER + num_lines * K1_LINE_STRIDE, np.float32)
    tab[:4] = consts["inv"], consts["c_cgs"], consts["sqrt_pi"], f(2.0) * L
    tab[_TAB_TAPS:_TAB_TAPS + 7] = np.asarray(C.INSTRUMENT_PROFILE, np.float32)
    tab[_TAB_WEI:_TAB_WEI + len(_WEIDEMAN_A32)] = np.asarray(_WEIDEMAN_A32, np.float32)
    for l, line in enumerate(consts["lines"]):
        y = f(line["y"])
        dr = L + y
        rec = tab[K1_TABLE_HEADER + l * K1_LINE_STRIDE:][:K1_LINE_STRIDE]
        rec[:9] = (line["lam"], line["amp"], y, line["y2"],
                   line["amp"] * line["y"] / consts["sqrt_pi"],
                   dr, dr * dr, (L - y) * dr, f(2.0) * dr)
        rec[_LINE_DISK:_LINE_DISK + 17] = line["cd"]
        rec[_LINE_WING:_LINE_WING + 11] = line["cw"]
    return tab


def absorption_all_reference(
    wavelengths: torch.Tensor,
    z_absorber: torch.Tensor,
    nhis: Sequence[torch.Tensor],
    num_lines: int = 3,
    lls_break: bool = False,
    poly: bool = True,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch twin of K1 (dense per-pixel formula).

    :param wavelengths: (P,) padded observed wavelengths [A], float32.
    :param z_absorber: (S,) absorber redshifts.
    :param nhis: column densities, one (S,) tensor per family.
    :param lls_break: start each row's optical depth from the Lyman-limit
        break per unit column density (the LLS profile).
    :param poly: the window's Faddeeva by the per-line polynomial; False
        takes the Weideman rational where ``|z| <= RADIUS`` and the
        continued fraction on the annulus out to ``CF_FAR_RADIUS``
        (``ops/faddeeva._wofz_weideman`` / ``_wofz_cf``, float32 N = 20 and
        K = 5), in the order of the reference kernel's poly=False branch.
    :param out_dtype: storage of the profiles, float32 (None) or int16
        codes (``encode_profile_store`` of the float32 result).
    :return: one (S, P - 6) broadened absorption per family.
    """
    out_dtype = check_store_dtype(out_dtype)
    consts = _kernel_constants(num_lines)
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
        # c / lam_c divides tensors: PyTorch takes a Python scalar over a
        # tensor as the tensor's reciprocal times the scalar, one rounding
        # more than the reference and the kernel, and the Weideman window's
        # cancellation near a line centre turns a last bit of x into ~1e-3
        # of absorption
        x = (wl - lam_c) * (torch.full_like(lam_c, c_cgs) / lam_c) * inv
        u = x * x
        r2 = u + line["y2"]
        far = r2 > far_r2
        if l < FAR_FIELD_LINES:
            tau = tau + amp * torch.where(far, y / (sqrt_pi * r2), 0.0)
        if not poly:
            ax = torch.abs(x)
            y_full = torch.full_like(ax, y)
            inner = r2 <= RADIUS * RADIUS
            annulus = ~inner & ~far
            wei, _ = _wofz_weideman(torch.where(inner, ax, 0.0), y_full)
            cf, _ = _wofz_cf(ax, y_full)
            tau = tau + amp * (torch.where(inner, wei, 0.0) + torch.where(annulus, cf, 0.0))
            continue
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
        encode_profile_store(instrumental_broadening(torch.exp(-nhi[:, None] * tau)), out_dtype)
        for nhi in nhis
    )


def k1_launch_name(poly: bool, out_dtype: torch.dtype | None = None) -> str:
    """The launch count of K1's instantiation: ``absorption_all`` for the
    polynomial window, ``absorption_all_weideman`` for poly=False, each
    with ``_i16`` for int16 output."""
    return store_name("absorption_all" if poly else "absorption_all_weideman",
                      check_store_dtype(out_dtype))


def _check_out(out: torch.Tensor, device: torch.device) -> torch.dtype:
    """An output buffer's storage dtype, checked: float32 or int16,
    contiguous, on ``device``."""
    store = check_store_dtype(out.dtype)
    if out.device != device or not out.is_contiguous():
        raise ValueError(f"out must be contiguous on {device}")
    return store


# lines of K1's table in each device's constant memory
_uploaded_lines: dict[torch.device, int] = {}


def launch_absorption_all(
    wavelengths: torch.Tensor,
    z_absorber: torch.Tensor,
    nhi: torch.Tensor,
    out: torch.Tensor,
    num_lines: int = 3,
    lls_break: bool = False,
    poly: bool = True,
) -> None:
    """One K1 launch: the (F, S, P - 6) profiles of the (F, S) column
    densities ``nhi`` into ``out`` (float32 CUDA tensors, F <=
    K1_MAX_FAMILIES; ``out`` float32, or int16 for the codes), counted
    under :func:`k1_launch_name`."""
    device = wavelengths.device
    check_cuda_f32(device, wavelengths=wavelengths, z_absorber=z_absorber, nhi=nhi)
    store = _check_out(out, device)
    P, S, F = wavelengths.shape[0], z_absorber.shape[0], nhi.shape[0]
    n_out = P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH
    if (wavelengths.ndim != 1 or z_absorber.ndim != 1 or nhi.ndim != 2
            or nhi.shape[1] != S or tuple(out.shape) != (F, S, n_out)):
        raise ValueError(
            f"expected wavelengths (P,), z (S,), nhi (F, S), out (F, S, P - 6); got "
            f"{tuple(wavelengths.shape)}, {tuple(z_absorber.shape)}, "
            f"{tuple(nhi.shape)}, {tuple(out.shape)}"
        )
    g = k1_geometry(S, P, F, _sm_count(device))
    lib = load_library()
    with torch.cuda.device(device):
        if _uploaded_lines.get(device, 0) < num_lines:
            table = _kernel_table(num_lines)
            err = lib.absorption_all_upload(
                ctypes.c_void_p(table.ctypes.data), table.size, stream_ptr(device))
            check_launch("absorption_all (table upload)", err)
            _uploaded_lines[device] = num_lines
        err = lib.absorption_all_launch(
            ptr(wavelengths), P, ptr(z_absorber), S, ptr(nhi), F, num_lines,
            min(num_lines, FAR_FIELD_LINES), int(lls_break), int(poly),
            int(store == torch.int16), g.warps, g.shared_bytes, g.grid, ptr(out),
            stream_ptr(device),
        )
    name = k1_launch_name(poly, store)
    check_launch(name, err)
    launch_counts[name] += 1


def absorption_all(
    wavelengths: torch.Tensor,
    z_absorber: torch.Tensor,
    nhis: Sequence[torch.Tensor],
    num_lines: int = 3,
    lls_break: bool = False,
    poly: bool = True,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, ...]:
    """Broadened absorption profiles of every family in ``nhis`` from the
    shared redshift samples: K1 on CUDA (one launch for up to
    K1_MAX_FAMILIES families), its twin on the CPU (float32).

    :param lls_break: include the Lyman-limit break (the LLS profile).
    :param poly: the polynomial window (True) or the Weideman rational and
        continued fraction (False, the reference's GPY_DLA_FUSED_POLY=0).
    :param out_dtype: float32 (None) or int16, the codes K1 encodes at its
        store.
    :return: one (S, P - 6) profile per family, stored as ``out_dtype``.
    """
    out_dtype = check_store_dtype(out_dtype)
    if not use_kernel(wavelengths):
        return absorption_all_reference(
            wavelengths, z_absorber, nhis, num_lines, lls_break, poly, out_dtype
        )
    nhi = torch.stack(tuple(nhis))  # (F, S)
    if wavelengths.ndim != 1 or z_absorber.ndim != 1 or nhi.shape[1:] != z_absorber.shape:
        raise ValueError(
            f"expected wavelengths (P,), z (S,), nhis F x (S,); got "
            f"{tuple(wavelengths.shape)}, {tuple(z_absorber.shape)}, {tuple(nhi.shape)}"
        )
    S, n_out = z_absorber.shape[0], wavelengths.shape[0] - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH
    if S == 0 or n_out <= 0:
        raise ValueError(f"empty problem: S={S}, P={wavelengths.shape[0]}")
    if wavelengths.data_ptr() % 16:
        wavelengths = wavelengths.clone()  # the kernel reads it as float4
    profiles = []
    for f0 in range(0, nhi.shape[0], K1_MAX_FAMILIES):
        group = nhi[f0:f0 + K1_MAX_FAMILIES]
        out = torch.empty((group.shape[0], S, n_out), dtype=out_dtype,
                          device=wavelengths.device)
        launch_absorption_all(wavelengths, z_absorber, group, out, num_lines, lls_break, poly)
        profiles += out.unbind(0)
    return tuple(profiles)


@functools.lru_cache(maxsize=8)
def _device_taps(device: torch.device) -> torch.Tensor:
    return torch.tensor(
        [_f32(t) for t in C.INSTRUMENT_PROFILE], dtype=torch.float32, device=device
    )


def absorption_tail_reference(unit_tau: torch.Tensor, nhi: torch.Tensor,
                              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch twin of K5: ``conv7(exp(-nhi[:, None] * unit_tau))``
    with K5's float32 taps, summed in the kernel's order, stored as
    ``out_dtype`` (``encode_profile_store``).

    :param unit_tau: (S, P) optical depth per unit column density.
    :param nhi: (S,) column densities.
    :return: (S, P - 6).
    """
    return encode_profile_store(
        instrumental_broadening(torch.exp(-nhi[:, None] * unit_tau)),
        check_store_dtype(out_dtype))


def absorption_tail(unit_tau: torch.Tensor, nhi: torch.Tensor,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Broadened absorption from a unit optical depth: K5 on CUDA, its
    twin on the CPU (float32).  Any row count and any P (up to the
    kernel's int index, :func:`tail_geometry`).

    :param unit_tau: (S, P) float32, contiguous.
    :param nhi: (S,) float32.
    :param out_dtype: float32 (None) or int16, the codes K5 encodes at its
        store.
    :return: (S, P - 6) in ``out_dtype``.
    """
    out_dtype = check_store_dtype(out_dtype)
    if not use_kernel(unit_tau):
        return absorption_tail_reference(unit_tau, nhi, out_dtype)
    device = unit_tau.device
    check_cuda_f32(device, unit_tau=unit_tau, nhi=nhi)
    if unit_tau.ndim != 2 or nhi.shape != unit_tau.shape[:1]:
        raise ValueError(
            f"expected unit_tau (S, P) and nhi (S,); got "
            f"{tuple(unit_tau.shape)}, {tuple(nhi.shape)}"
        )
    S, P = unit_tau.shape
    g = tail_geometry(S, P, _sm_count(device))
    out = torch.empty(
        (S, P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH), dtype=out_dtype, device=device
    )
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.absorption_tail_launch(
            ptr(unit_tau), ptr(nhi), S, P, ptr(_device_taps(device)),
            int(out_dtype == torch.int16), g.warps, g.shared_bytes, g.grid, ptr(out),
            stream_ptr(device),
        )
    name = store_name("absorption_tail", out_dtype)
    check_launch(name, err)
    launch_counts[name] += 1
    return out


def absorption_windowed_reference(parts: WindowedTauParts, nhi: torch.Tensor,
                                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch twin of K6: place the window corrections
    (``ops/voigt.place_windows``), then ``conv7(exp(-nhi * tau))``, stored
    as ``out_dtype``.

    :param parts: the windowed unit optical depth of S samples.
    :param nhi: (S,) column densities.
    :return: (S, num_pixels - 6).
    """
    return absorption_tail_reference(place_windows(parts), nhi, out_dtype)


def absorption_windowed(parts: WindowedTauParts, nhi: torch.Tensor,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Broadened absorption from the unplaced windowed unit optical depth:
    K6 on CUDA, its twin on the CPU (float32), at :func:`tail_geometry`.

    :param parts: far (S, P_pad) with P_pad a multiple of 128, corr
        (S, L * 256), c0 (S, L) int32 in [0, P_pad / 128 - 2], num_pixels P.
    :param nhi: (S,) column densities.
    :param out_dtype: float32 (None) or int16, the codes K6 encodes at its
        store.
    :return: (S, P - 6) in ``out_dtype``.
    """
    out_dtype = check_store_dtype(out_dtype)
    far, corr, c0, P = parts
    if not use_kernel(far):
        return absorption_windowed_reference(parts, nhi, out_dtype)
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
    if P > P_pad or L == 0:
        raise ValueError(f"bad pixel or line count: P={P}, P_pad={P_pad}, L={L}")
    g = tail_geometry(S, P, _sm_count(device))
    out = torch.empty(
        (S, P - 2 * C.INSTRUMENT_PROFILE_HALF_WIDTH), dtype=out_dtype, device=device
    )
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.absorption_windowed_launch(
            ptr(far), ptr(corr), ptr(c0), ptr(nhi), S, P_pad, P, L,
            ptr(_device_taps(device)), int(out_dtype == torch.int16), g.warps,
            g.shared_bytes, g.grid, ptr(out), stream_ptr(device),
        )
    name = store_name("absorption_windowed", out_dtype)
    check_launch(name, err)
    launch_counts[name] += 1
    return out


def civ_unit_tau_reference(
    wavelengths: torch.Tensor,
    z_civ: torch.Tensor,
    sigma: torch.Tensor,
    num_lines: int = 2,
) -> torch.Tensor:
    """Plain PyTorch twin of civ_tau: the CIV doublet's optical depth per
    unit column density, each line's Re w by ``ops/faddeeva.wofz_parts``
    (float32: Weideman N = 20, continued fraction K = 5; float64: N = 40, K
    = 14), with the broadening velocity ``sigma`` [cm/s] free per sample
    (``gpy_dla_detection_tpu/ops/voigt.py:voigt_absorption_civ``).

    :param wavelengths: (P,) padded observed wavelengths [A].
    :param z_civ, sigma: (...,) per-sample redshifts and broadenings.
    :return: (..., P).
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
    return tau


@functools.lru_cache(maxsize=1)
def civ_tau_constants() -> np.ndarray:
    """civ_tau's constants (``csrc/civ_tau.cu``, Constants), float32 as its
    twin rounds them: the Weideman scale L and 2 L, sqrt(pi), sqrt(2), c
    [cm/s], the continued fraction's 1e-30; per line the rest wavelength
    [A], the Lorentzian width [cm/s] and a_l / sqrt(pi); the 20 float32
    Weideman coefficients, highest power first."""
    return np.array(
        [_WEIDEMAN_L32, 2.0 * _WEIDEMAN_L32, SQRT_PI, math.sqrt(2.0), C.SPEED_OF_LIGHT_CGS,
         1e-30, *(C.CIV_WAVELENGTHS_CM * 1e8), *C.CIV_LORENTZIAN_WIDTHS,
         *(C.CIV_LEADING_CONSTANTS / SQRT_PI), *_WEIDEMAN_A32],
        dtype=np.float32,
    )


def civ_tau_grid(S: int, P: int, sms: int = H100_SMS) -> int:
    """civ_tau's grid for S rows of P pixels on ``sms`` SMs: K3's grid rule
    (``_chain_grid``) over the rows' S ceil(P / CIV_TAU_STEP) warp steps,
    so every warp takes an even share of them in one wave."""
    if S < 1 or P < 1:
        raise ValueError(f"civ_tau needs S >= 1 and P >= 1, got S={S}, P={P}")
    steps = S * -(-P // CIV_TAU_STEP)
    if steps >= 2**31:
        raise ValueError(f"S x steps a row = {steps} does not fit the kernel's int index")
    return _chain_grid(steps, CIV_TAU_WARPS, CIV_TAU_BLOCKS_PER_SM, sms)


def civ_unit_tau(
    wavelengths: torch.Tensor,
    z_civ: torch.Tensor,
    sigma: torch.Tensor,
    num_lines: int = 2,
) -> torch.Tensor:
    """The CIV doublet's unit optical depth, K5's input: civ_tau on float32
    CUDA tensors (one launch, counted ``launch_counts["civ_tau"]``), its twin
    :func:`civ_unit_tau_reference` on float32 CPU tensors and, as the
    conformance path, on float64 CPU tensors; anything else raises.

    :param wavelengths: (P,) padded observed wavelengths [A].
    :param z_civ, sigma: (S,) absorber redshifts and broadenings [cm/s].
    :param num_lines: the doublet's first ``num_lines`` lines (1 or 2).
    :return: (S, P) in the wavelengths' dtype.
    """
    if not 1 <= num_lines <= len(C.CIV_WAVELENGTHS_CM):
        raise ValueError(f"the CIV doublet has 1 or 2 lines, got {num_lines}")
    for name, t in (("z_civ", z_civ), ("sigma", sigma)):
        if t.dtype != wavelengths.dtype or t.device != wavelengths.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, the wavelengths "
                            f"{wavelengths.dtype} on {wavelengths.device}")
    if wavelengths.ndim != 1 or z_civ.ndim != 1 or sigma.shape != z_civ.shape:
        raise ValueError(
            f"expected wavelengths (P,), z_civ (S,), sigma (S,); got "
            f"{tuple(wavelengths.shape)}, {tuple(z_civ.shape)}, {tuple(sigma.shape)}"
        )
    for name, t in (("wavelengths", wavelengths), ("z_civ", z_civ), ("sigma", sigma)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wavelengths.dtype == torch.float64:
        if wavelengths.device.type != "cpu":
            raise TypeError("the float64 unit optical depth is the CPU conformance path; the "
                            "CUDA kernel takes float32")
        return civ_unit_tau_reference(wavelengths, z_civ, sigma, num_lines)
    if not use_kernel(wavelengths):
        return civ_unit_tau_reference(wavelengths, z_civ, sigma, num_lines)
    device = wavelengths.device
    S, P = z_civ.shape[0], wavelengths.shape[0]
    grid = civ_tau_grid(S, P, _sm_count(device))
    out = torch.empty((S, P), dtype=torch.float32, device=device)
    table = civ_tau_constants()
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.civ_tau_launch(
            ptr(wavelengths), P, ptr(z_civ), ptr(sigma), S, num_lines,
            ctypes.c_void_p(table.ctypes.data), table.size, CIV_TAU_WARPS, grid, ptr(out),
            stream_ptr(device),
        )
    check_launch("civ_tau", err)
    launch_counts["civ_tau"] += 1
    return out
