"""The CIV doublet's unit optical depth (``ops/voigt_kernels.civ_unit_tau``:
civ_tau on the card, its plain twin on the CPU) on the CPU.

* ``ops/voigt.voigt_absorption_civ`` is bit for bit the composition it ran
  before the kernel (frozen here), in float32 and float64, at the shapes
  its callers pass: the CIV head's (S,) samples, the MCMC's (walkers, 1)
  and a single sample;
* the kernel's order of operations (``csrc/civ_tau.cu``), replayed in
  numpy float32 from its constants table, gives the twin's bits at every
  pixel: the row's hoisted terms, the continued fraction's reciprocals,
  the Weideman terms that depend on y, the division by sqrt(pi);
* a CPU call launches nothing; the wrapper refuses what the kernel does
  not take; the grid gives every warp an even share in one wave.

The kernel itself is held to the twin on the card in
tests/test_torch_kernels_gpu.py.
"""

import math

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu_torch import constants as C
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops import voigt as TV
from gpy_dla_detection_tpu_torch.ops.faddeeva import SQRT_PI, wofz_parts
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    CIV_TAU_BLOCKS_PER_SM,
    CIV_TAU_STEP,
    CIV_TAU_WARPS,
    civ_tau_constants,
    civ_tau_grid,
    civ_unit_tau,
    civ_unit_tau_reference,
)

torch.set_num_threads(2)

P_CIV = 774  # the CIV head's padded row (CIVParameters)


def _parent_voigt_absorption_civ(wavelengths, nciv, z_civ, sigma, num_lines=2):
    """``voigt_absorption_civ`` as it was before civ_tau, frozen."""
    sigma = sigma[..., None]
    one_plus_z = (1.0 + z_civ)[..., None]
    inv = 1.0 / (math.sqrt(2.0) * sigma)
    tau = None
    for l in range(num_lines):
        lam_c = float(C.CIV_WAVELENGTHS_CM[l] * 1e8) * one_plus_z
        velocity = (wavelengths - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c)
        w_re, _ = wofz_parts(velocity * inv, float(C.CIV_LORENTZIAN_WIDTHS[l]) * inv)
        contrib = (float(C.CIV_LEADING_CONSTANTS[l]) / SQRT_PI) * inv * w_re
        tau = contrib if tau is None else tau + contrib
    return TV.absorption_from_unit_tau(tau, nciv)


def _problem(S=64, P=P_CIV, seed=11):
    """A CIV window's log-uniform grid (SDSS's 1e-4 dex pixels) and S
    samples whose doublet lies on it, sigma over the prior's 1e6-8e6 cm/s;
    the first two (where S > 1) put line 1548's centre on the first pixel
    and line 1550's on the last."""
    rng = np.random.default_rng(seed)
    wl = 1311.0 * 3.4 * 10 ** (1e-4 * np.arange(P))
    lam = C.CIV_WAVELENGTHS_CM * 1e8
    z = rng.uniform(wl[0] / lam[0] - 1.0, wl[-1] / lam[1] - 1.0, S)
    z[:2] = [wl[0] / lam[0] - 1.0, wl[-1] / lam[1] - 1.0][:S]
    sigma = rng.uniform(1e6, 8e6, S)
    nciv = 10 ** rng.uniform(12.88, 14.5, S)
    return wl, z, sigma, nciv


@pytest.mark.parametrize("shape", [(64,), (16, 1), ()], ids=["samples", "walkers", "one"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_voigt_absorption_civ_is_the_earlier_composition_bit_for_bit(dtype, shape):
    wl, z, sigma, nciv = _problem(S=int(np.prod(shape)))
    put = lambda a: torch.as_tensor(a, dtype=dtype).reshape(shape)
    args = (torch.as_tensor(wl, dtype=dtype), put(nciv), put(z), put(sigma))
    got, want = TV.voigt_absorption_civ(*args), _parent_voigt_absorption_civ(*args)
    assert got.dtype == dtype and got.shape == want.shape == (*shape, P_CIV - 6)
    assert torch.equal(got, want)
    # the doublet absorbs on the grid
    assert float(got.min()) < 0.9


def _kernel_order(wl, z, sigma, num_lines=2):
    """civ_tau's arithmetic (csrc/civ_tau.cu) in numpy float32, operation
    by operation, from its constants table."""
    k = civ_tau_constants()
    f = np.float32
    L, two_L, sqrt_pi, sqrt2, c, eps = k[:6]
    lam, gamma, amp_l, wei = k[6:8], k[8:10], k[10:12], k[12:]
    opz = (z + f(1.0))[:, None]
    inv = (f(1.0) / (sigma * sqrt2))[:, None]
    tau = None
    for l in range(num_lines):
        lam_c = lam[l] * opz
        q = (f(1.0) / lam_c) * c
        y = gamma[l] * inv
        amp = amp_l[l] * inv
        dr = y + L
        dr2, lmy_dr, two_dr = dr * dr, (L - y) * dr, f(2.0) * dr
        x = np.abs(((wl[None, :] - lam_c) * q) * inv)
        xx = x * x
        inner = xx + y * y <= f(49.0)
        vr, vi = x, np.broadcast_to(y, x.shape)
        for n in range(5, 0, -1):
            inv_v2 = (f(1.0) / ((vr * vr + vi * vi) + eps)) * f(0.5 * n)
            vr, vi = x - vr * inv_v2, y + vi * inv_v2
        cf = vi * (f(1.0) / (((vr * vr + vi * vi) + eps) * sqrt_pi))
        inv_s = f(1.0) / (dr2 + xx)
        zr, zi = (lmy_dr - xx) * inv_s, (x * two_L) * inv_s
        pr, pi = np.full_like(x, wei[0]), np.zeros_like(x)
        for w in wei[1:]:
            pr, pi = (pr * zr - pi * zi) + w, pr * zi + pi * zr
        inv2_r = ((dr2 - xx) * inv_s) * inv_s
        inv2_i = ((two_dr * x) * inv_s) * inv_s
        weideman = (pr * inv2_r - pi * inv2_i) * f(2.0) + (dr * inv_s) / sqrt_pi
        term = amp * np.where(inner, weideman, cf)
        tau = term if tau is None else tau + term
    return tau


@pytest.mark.parametrize("num_lines", [1, 2])
def test_the_kernels_order_gives_the_twins_bits(num_lines):
    wl, z, sigma, _ = _problem(S=96)
    f32 = lambda a: np.asarray(a, np.float32)
    want = civ_unit_tau_reference(*[torch.as_tensor(f32(a)) for a in (wl, z, sigma)],
                                  num_lines).numpy()
    got = _kernel_order(f32(wl), f32(z), f32(sigma), num_lines)
    assert got.dtype == np.float32 and got.shape == want.shape == (96, P_CIV)
    np.testing.assert_array_equal(got, want)


def test_a_cpu_call_launches_nothing():
    wl, z, sigma, nciv = _problem(S=8)
    _build.reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        t = [torch.as_tensor(a, dtype=dtype) for a in (wl, z, sigma, nciv)]
        civ_unit_tau(t[0], t[1], t[2])
        TV.voigt_absorption_civ(t[0], t[3], t[1], t[2])
    assert _build.launch_counts["civ_tau"] == 0
    assert not any(_build.launch_counts.values())


def _refused(case):
    wl, z, sigma, _ = (torch.as_tensor(a, dtype=torch.float32) for a in _problem(S=8))
    return {
        "float16": ((wl.half(), z.half(), sigma.half()), TypeError),
        "mixed dtypes": ((wl, z.double(), sigma), TypeError),
        "non-contiguous": ((wl, torch.stack([z, z], 1)[:, 0], sigma), ValueError),
        "z not (S,)": ((wl, z[:, None], sigma[:, None]), ValueError),
        "sigma not z's shape": ((wl, z, sigma[:4]), ValueError),
        "wavelengths not (P,)": ((wl[None, :], z, sigma), ValueError),
        "three lines": ((wl, z, sigma, 3), ValueError),
    }[case]


@pytest.mark.parametrize("case", ["float16", "mixed dtypes", "non-contiguous", "z not (S,)",
                                  "sigma not z's shape", "wavelengths not (P,)", "three lines"])
def test_civ_unit_tau_refuses_what_the_kernel_does_not_take(case):
    args, error = _refused(case)
    with pytest.raises(error):
        civ_unit_tau(*args)


@pytest.mark.parametrize("S, P, sms, grid", [
    (10_000, P_CIV, 132, 132 * CIV_TAU_BLOCKS_PER_SM),  # the CIV head: one full wave
    (1, P_CIV, 132, -(-(-(-P_CIV // CIV_TAU_STEP)) // CIV_TAU_WARPS)),  # the MCMC
    (1, 1, 132, 1),
    (40, 771, 4, 4 * CIV_TAU_BLOCKS_PER_SM),
])
def test_civ_tau_grid_is_one_even_wave(S, P, sms, grid):
    assert civ_tau_grid(S, P, sms) == grid
    steps = S * -(-P // CIV_TAU_STEP)
    warps = grid * CIV_TAU_WARPS
    shares = [(w + 1) * steps // warps - w * steps // warps for w in range(warps)]
    assert sum(shares) == steps and max(shares) - min(shares) <= 1


@pytest.mark.parametrize("S, P", [(0, P_CIV), (10, 0),
                                  (2**31 // -(-P_CIV // CIV_TAU_STEP) + 1, P_CIV)])
def test_civ_tau_grid_refuses_what_the_kernel_cannot_index(S, P):
    with pytest.raises(ValueError):
        civ_tau_grid(S, P)
