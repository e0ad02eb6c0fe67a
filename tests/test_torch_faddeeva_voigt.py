"""Faddeeva function and exact Voigt absorption of the PyTorch port
against the JAX package, in float64 (the conformance path), plus the
per-line polynomial coefficients of K1.

Tolerance 1e-12 relative; 1e-10 on the summed unit optical depth, whose
far-wing terms (~1e-23) lose digits where XLA contracts multiply-adds
that PyTorch rounds separately (measured 1.2e-11).
"""

import numpy as np
import pytest
import torch
from scipy.special import wofz

import jax.numpy as jnp

from gpy_dla_detection_tpu import constants as C
from gpy_dla_detection_tpu.ops import faddeeva as JF
from gpy_dla_detection_tpu.ops import voigt as JV
from gpy_dla_detection_tpu.ops.voigt_pallas import (
    _window_poly_coeffs as jax_window_poly_coeffs,
)
from gpy_dla_detection_tpu_torch.ops import faddeeva as TF
from gpy_dla_detection_tpu_torch.ops import voigt as TV
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import _window_poly_coeffs

torch.set_num_threads(2)

RTOL = 1e-12


def _z_grid():
    x = np.concatenate([-np.geomspace(1e-3, 1e5, 200), np.linspace(-8, 8, 161),
                        np.geomspace(1e-3, 1e5, 200)])
    y = np.array([1e-5, 1e-3, 0.1, 1.0, 5.0])
    return np.meshgrid(x, y, indexing="ij")


def test_wofz_parts_float64_matches_jax_and_scipy():
    x, y = _z_grid()
    want_re, want_im = (np.asarray(a) for a in JF.wofz_parts(jnp.asarray(x), jnp.asarray(y)))
    got_re, got_im = TF.wofz_parts(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(got_re.numpy(), want_re, rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(got_im.numpy(), want_im, rtol=RTOL, atol=1e-300)
    ref = wofz(x + 1j * y)
    np.testing.assert_allclose(got_re.numpy(), ref.real, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dtype_tiered_branches_match_jax(dtype):
    """The Weideman and continued-fraction branches on their own, at the
    term counts each dtype selects."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 7, 500).astype(dtype)
    y = rng.uniform(1e-4, 3, 500).astype(dtype)
    xf = rng.uniform(7, 300, 500).astype(dtype)
    rtol = 2e-6 if dtype == np.float32 else RTOL
    for fn_t, fn_j, args in (
        (TF._wofz_weideman, JF._wofz_weideman, (x, y)),
        (TF._wofz_cf, JF._wofz_cf, (xf, y)),
    ):
        got = fn_t(*(torch.as_tensor(a) for a in args))
        want = fn_j(*(jnp.asarray(a) for a in args))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 if dtype == np.float32 else torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=1e-30)


def test_exact_voigt_absorption_matches_jax():
    rng = np.random.default_rng(1)
    wl = 1215.67 * 3.4 * 10 ** (1e-4 * np.arange(700))
    z = rng.uniform(2.5, 3.5, 12)
    nhi = 10 ** rng.uniform(19.5, 22.5, 12)
    want = np.asarray(
        JV.voigt_absorption(jnp.asarray(wl), jnp.asarray(nhi), jnp.asarray(z), 3, impl="exact")
    )
    got = TV.voigt_absorption(torch.as_tensor(wl), torch.as_tensor(nhi), torch.as_tensor(z), 3)
    assert got.shape == (12, 700 - 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-300)
    tau_j = np.asarray(
        JV._unit_lyman_series_optical_depth(jnp.asarray(wl), jnp.asarray(z), 5, C.THERMAL_SIGMA_CGS)
    )
    tau_t = TV.unit_lyman_optical_depth(torch.as_tensor(wl), torch.as_tensor(z), 5)
    np.testing.assert_allclose(tau_t.numpy(), tau_j, rtol=1e-10, atol=1e-300)


def test_instrumental_broadening_matches_jax():
    raw = np.random.default_rng(2).uniform(size=(4, 50))
    np.testing.assert_allclose(
        TV.instrumental_broadening(torch.as_tensor(raw)).numpy(),
        np.asarray(JV.instrumental_broadening(jnp.asarray(raw))), rtol=1e-15,
    )


def test_window_poly_coeffs_equal_jax():
    """The copied fit yields the reference kernel's coefficient tuples
    exactly, for each production Lyman line."""
    inv = 1.0 / (float(np.sqrt(2.0)) * float(C.THERMAL_SIGMA_CGS))
    for l in range(3):
        y = float(C.LYMAN_LORENTZIAN_WIDTHS[l]) * inv
        assert _window_poly_coeffs(y, 9.0) == jax_window_poly_coeffs(y, 9.0)
    assert TV.CF_FAR_RADIUS == JV.CF_FAR_RADIUS
    assert TV.FAR_FIELD_LINES == JV.FAR_FIELD_LINES
