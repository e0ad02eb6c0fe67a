"""K5 (the absorption tail) and the exact Voigt profiles of the PyTorch
port against the JAX package.

Tolerances (profiles lie in [0, 1]):
* K5's float32 twin vs the Pallas K5 in interpret mode, same float32
  inputs: 1e-6 absolute (the same exp and 7-tap sum; measured 1.8e-7);
* K5's twin vs the JAX float64 composition of the same unit optical
  depth: 1e-6 absolute (float32 rounding of exp(-nhi tau); measured
  1.8e-7);
* ``voigt_absorption`` / ``voigt_absorption_civ`` in float64 vs JAX
  float64: 1e-10 absolute (same algorithm; exp(-nhi tau) scales the unit
  optical depth's 2e-16 relative rounding by the optical depth; measured
  5.0e-12);
* in float32, both packages run the same float32 Weideman / continued
  fraction tiers, whose own error against float64 reaches 2.1e-3 (DLA)
  and 4.4e-4 (CIV) at the worst pixel, JAX and the port alike.  The port's float32 error against
  JAX float64 is held to 1.5x JAX float32's own, and port and JAX float32
  agree to 2e-6 on all but 1e-3 of the pixels (a pixel whose |z| rounds
  to the other side of the Weideman / continued-fraction switch takes the
  other approximation; measured 47 of 81,920 pixels for the DLA profile).
The CUDA kernel is held against the twin in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu.ops import voigt as JV
from gpy_dla_detection_tpu.ops.voigt_pallas import absorption_from_unit_tau_pallas
from gpy_dla_detection_tpu_torch.data.samples import generate_dla_samples
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops import voigt as TV
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    absorption_tail,
    absorption_tail_reference,
)
from gpy_dla_detection_tpu_torch.params import Parameters

torch.set_num_threads(2)

TOL_VS_PALLAS = 1e-6
TOL_VS_F64 = 1e-6
TOL_F64 = 1e-10
TOL_F32 = 2e-6
F32_OUTLIER_SHARE = 1e-3


@pytest.fixture(scope="module")
def grid_and_samples():
    """A spectrum's padded grid at full width (P = 1,286) and 600 of the
    reference's DLA samples mapped into its search range."""
    params = Parameters(num_dla_samples=600)
    spec = synthetic_spectrum(params, synthetic_learned_model(params), 3.1, seed=4)
    samples = generate_dla_samples(params)
    z = spec.min_z_dla + (spec.max_z_dla - spec.min_z_dla) * samples.offset_samples
    return spec.padded_wavelengths, z, samples.nhi_samples


# 523: not a multiple of 512 nor of 8 (the Pallas kernel pads it); 16: an
# MCMC half-step of 32 walkers
@pytest.mark.parametrize("S", [523, 16])
def test_tail_twin_matches_pallas_and_f64(grid_and_samples, S):
    wl, z, nhi = grid_and_samples
    unit32 = TV.unit_lyman_optical_depth(
        torch.as_tensor(wl, dtype=torch.float32), torch.as_tensor(z[:S], dtype=torch.float32), 3
    )
    nhi32 = torch.as_tensor(nhi[:S], dtype=torch.float32)
    got = absorption_tail_reference(unit32, nhi32).numpy()
    assert got.shape == (S, wl.shape[0] - 6) and got.dtype == np.float32
    pallas = np.asarray(
        absorption_from_unit_tau_pallas(
            jnp.asarray(unit32.numpy()), jnp.asarray(nhi32.numpy()), interpret=True
        )
    )
    assert pallas.shape == got.shape
    assert np.abs(got - pallas).max() <= TOL_VS_PALLAS
    f64 = np.asarray(
        JV.absorption_from_unit_tau(
            jnp.asarray(unit32.numpy().astype(np.float64)),
            jnp.asarray(nhi32.numpy().astype(np.float64)),
        )
    )
    assert np.abs(got - f64).max() <= TOL_VS_F64
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-6


def test_cpu_wrapper_runs_the_twin_without_counting(grid_and_samples):
    wl, z, nhi = grid_and_samples
    unit = TV.unit_lyman_optical_depth(
        torch.as_tensor(wl, dtype=torch.float32), torch.as_tensor(z[:40], dtype=torch.float32), 3
    )
    nhi32 = torch.as_tensor(nhi[:40], dtype=torch.float32)
    _build.reset_launch_counts()
    assert torch.equal(absorption_tail(unit, nhi32), absorption_tail_reference(unit, nhi32))
    assert _build.launch_counts["absorption_tail"] == 0


def test_absorption_from_unit_tau_dispatch(grid_and_samples):
    wl, z, nhi = grid_and_samples
    unit = TV.unit_lyman_optical_depth(torch.as_tensor(wl), torch.as_tensor(z[:8]), 3)
    # walkers x absorbers: the leading axes are flattened into K5's rows
    u32 = unit.float().reshape(2, 4, -1)
    n32 = torch.as_tensor(nhi[:8], dtype=torch.float32).reshape(2, 4)
    got = TV.absorption_from_unit_tau(u32, n32)
    assert got.shape == (2, 4, wl.shape[0] - 6)
    want = absorption_tail_reference(u32.reshape(8, -1), n32.reshape(8))
    assert torch.equal(got.reshape(8, -1), want)
    with pytest.raises(TypeError):
        TV.absorption_from_unit_tau(unit.half(), torch.as_tensor(nhi[:8]).half())


def _check(got, jax_fn, dtype):
    """float64: within TOL_F64 of JAX float64.  float32: held to JAX
    float64 as JAX float32 is, and to JAX float32 on all but
    F32_OUTLIER_SHARE of the pixels."""
    f64 = jax_fn(np.float64)
    if dtype == np.float64:
        assert np.abs(got - f64).max() <= TOL_F64
        return f64
    jax32 = jax_fn(np.float32)
    err_port = np.abs(got.astype(np.float64) - f64).max()
    err_jax = np.abs(jax32.astype(np.float64) - f64).max()
    assert err_port <= 1.5 * max(err_jax, TOL_F32), (err_port, err_jax)
    assert np.mean(np.abs(got - jax32) > TOL_F32) <= F32_OUTLIER_SHARE
    return f64


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_voigt_absorption_matches_jax(grid_and_samples, dtype):
    wl, z, nhi = grid_and_samples
    jax_fn = lambda dt: np.asarray(
        JV.voigt_absorption(jnp.asarray(wl.astype(dt)), jnp.asarray(nhi[:64].astype(dt)),
                            jnp.asarray(z[:64].astype(dt)), 3, impl="exact")
    )
    got = TV.voigt_absorption(torch.as_tensor(wl.astype(dtype)),
                              torch.as_tensor(nhi[:64].astype(dtype)),
                              torch.as_tensor(z[:64].astype(dtype)), 3)
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    _check(got.numpy(), jax_fn, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_voigt_absorption_civ_matches_jax(grid_and_samples, dtype):
    wl, _, _ = grid_and_samples
    rng = np.random.default_rng(5)
    # CIV lines inside the grid: z such that 1548 (1 + z) spans it
    z = rng.uniform(wl[0] / 1548.2 - 1.0, wl[-1] / 1550.8 - 1.0, 40)
    n = 10 ** rng.uniform(12.9, 15.5, 40)
    sigma = rng.uniform(1e6, 8e6, 40)
    jax_fn = lambda dt: np.asarray(
        JV.voigt_absorption_civ(*[jnp.asarray(x.astype(dt)) for x in (wl, n, z, sigma)], 2)
    )
    got = TV.voigt_absorption_civ(
        *[torch.as_tensor(x.astype(dtype)) for x in (wl, n, z, sigma)], 2
    ).numpy()
    f64 = _check(got, jax_fn, dtype)
    assert f64.min() < 0.9  # the doublet absorbs inside the grid
