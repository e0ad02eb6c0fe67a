"""K1 (fused broadened Voigt absorption) in the PyTorch port.

The plain twin ``absorption_all_reference`` is held against the JAX
Pallas kernel ``absorption_all_pallas`` (interpret mode, poly=True) on
the regular and +-30% jittered grids of tests/test_voigt.py, and against
the float64 exact Voigt.  The CUDA kernel is held against the twin on the
card in tests/test_torch_kernels_gpu.py.

Tolerances (float32):
* twin vs the JAX kernel: <= 1e-6 absolute, tightened from the 1e-5
  budget (same formula and float32 constants; only the evaluation order
  and exp differ; measured 1.8e-7);
* twin vs the f64 exact oracle: <= 1e-4 absolute (the JAX kernel itself
  measures 4.7e-5: polynomial fit plus far-field truncation).

The poly=False twin (the Weideman rational and the continued fraction in
the windows, the reference's GPY_DLA_FUSED_POLY=0) is held against the
Pallas kernel with poly=False by the bounds tests/test_voigt.py gives two
float32 Weideman evaluations: near a line centre the float32 rational
builds a small Re w from O(1) terms, and column density times that
cancellation puts the interpret-mode Pallas kernel up to ~1e-3 of
absorption from the float64 truth (the twin, which rounds each operation
once in the stated order, stays within ~1e-6 of it).  So:
* mutual <= 5e-4 absolute on the DLA grids (F = 2; and F = 1 with the
  break on the same grids, where the break is redward of the limit);
  measured 1.8e-7 (DLA family) and 9.9e-5 / 3.5e-4 (subDLA family,
  regular / jittered);
* against the float64 exact profile, at most max(1.5 x the Pallas
  kernel's own error, 1e-4); measured twin 7.2e-6 / 7.7e-7 (DLA / subDLA
  family) on both grids, against the Pallas kernel's 7.2e-6 / 9.9e-5
  (regular) and 7.1e-6 / 3.5e-4 (jittered);
* with the break at the LLS search's width (logNHI 17.5-20.5, the
  inputs of tests/test_voigt.py::test_absorption_all_pallas_lls_break),
  the mutual bound of that test, 2.5e-3 (measured 9.1e-4 / 9.4e-4, regular
  / jittered), and the same truth anchor (twin 7.2e-7 / 1.4e-6 against the
  Pallas kernel's 9.1e-4 / 9.4e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu import constants as C
from gpy_dla_detection_tpu.ops.voigt import (
    _unit_lyman_series_optical_depth,
    instrumental_broadening,
    voigt_absorption_lls,
)
from gpy_dla_detection_tpu.ops.voigt_pallas import absorption_all_pallas
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    absorption_all,
    absorption_all_reference,
)

torch.set_num_threads(2)

TOL_JAX_KERNEL = 1e-6
TOL_TRUTH = 1e-4
TOL_WEIDEMAN = 5e-4  # two float32 Weideman evaluations (tests/test_voigt.py)
TOL_WEIDEMAN_LLS = 2.5e-3  # the same at LLS column densities (its LLS test)



def _grids_and_samples(P=300, S=24, seed=3):
    """The inputs of tests/test_voigt.py::test_absorption_all_pallas_
    matches_windowed: a regular log grid, its +-30% jittered twin, and
    redshift / column-density samples for the DLA and subDLA families."""
    rng = np.random.default_rng(seed)
    base = 1215.67 * 3.9 * 10 ** (1e-4 * np.arange(P))
    steps = np.diff(base) * (1.0 + 0.3 * rng.uniform(-1, 1, P - 1))
    jittered = base[0] + np.concatenate([[0.0], np.cumsum(steps)])
    z = rng.uniform(2.9, 3.8, S).astype(np.float32)
    nhi_dla = (10 ** rng.uniform(20, 22, S)).astype(np.float32)
    nhi_sub = (10 ** rng.uniform(19.5, 20.3, S)).astype(np.float32)
    return {"regular": base, "jittered": jittered}, z, (nhi_dla, nhi_sub)


@pytest.mark.parametrize("grid_name", ["regular", "jittered"])
def test_twin_matches_jax_kernel_and_truth(grid_name):
    grids, z, nhis = _grids_and_samples()
    wl = grids[grid_name].astype(np.float32)
    want = absorption_all_pallas(
        jnp.asarray(wl), jnp.asarray(z), tuple(jnp.asarray(n) for n in nhis), 3,
        interpret=True, poly=True,
    )
    got = absorption_all_reference(
        torch.as_tensor(wl), torch.as_tensor(z),
        tuple(torch.as_tensor(n) for n in nhis), 3,
    )
    tau64 = _unit_lyman_series_optical_depth(
        jnp.asarray(wl.astype(np.float64)), jnp.asarray(z.astype(np.float64)),
        3, C.THERMAL_SIGMA_CGS,
    )
    for g, w, n in zip(got, want, nhis):
        assert g.shape == (z.shape[0], wl.shape[0] - 6)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL_JAX_KERNEL)
        truth = np.asarray(
            instrumental_broadening(
                jnp.exp(-jnp.asarray(n.astype(np.float64))[:, None] * tau64)
            )
        )
        np.testing.assert_allclose(
            g.numpy().astype(np.float64), truth, rtol=0, atol=TOL_TRUTH
        )


def _truth(wl, z, nhi, lls_break):
    """The float64 exact profile of the JAX package (with the break: its
    exact voigt_absorption_lls)."""
    wl64, z64 = jnp.asarray(wl.astype(np.float64)), jnp.asarray(z.astype(np.float64))
    n64 = jnp.asarray(nhi.astype(np.float64))
    if lls_break:
        return np.asarray(voigt_absorption_lls(wl64, n64, z64, 3, impl="exact"))
    tau64 = _unit_lyman_series_optical_depth(wl64, z64, 3, C.THERMAL_SIGMA_CGS)
    return np.asarray(instrumental_broadening(jnp.exp(-n64[:, None] * tau64)))


def _check_weideman_twin(wl, z, nhis, lls_break, tol):
    want = absorption_all_pallas(
        jnp.asarray(wl), jnp.asarray(z), tuple(jnp.asarray(n) for n in nhis), 3,
        interpret=True, lls_break=lls_break, poly=False,
    )
    got = absorption_all_reference(
        torch.as_tensor(wl), torch.as_tensor(z), tuple(torch.as_tensor(n) for n in nhis), 3,
        lls_break=lls_break, poly=False,
    )
    assert len(got) == len(nhis)
    for g, w, n in zip(got, want, nhis):
        assert g.shape == (z.shape[0], wl.shape[0] - 6) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
        truth = _truth(wl, z, n, lls_break)
        e_twin = np.abs(g.numpy().astype(np.float64) - truth).max()
        e_pallas = np.abs(np.asarray(w, np.float64) - truth).max()
        assert e_twin <= max(1.5 * e_pallas, TOL_TRUTH), (e_twin, e_pallas)


@pytest.mark.parametrize("lls_break", [False, True])
@pytest.mark.parametrize("grid_name", ["regular", "jittered"])
def test_weideman_twin_matches_jax_kernel_and_truth(grid_name, lls_break):
    """poly=False on the grids of tests/test_voigt.py: both families, and
    the DLA family alone with the break on (the grid lies redward of the
    limit, so this holds the break's code path to zero)."""
    grids, z, nhis = _grids_and_samples()
    wl = grids[grid_name].astype(np.float32)
    _check_weideman_twin(wl, z, nhis[:1] if lls_break else nhis, lls_break, TOL_WEIDEMAN)


@pytest.mark.parametrize("grid_name", ["regular", "jittered"])
def test_weideman_twin_with_the_break_at_the_lls_width(grid_name):
    """poly=False with the break inside the grid: P = 1,664 from 850 A rest
    at z = 3.2, LLS column densities (logNHI 17.5-20.5), and its +-30%
    jittered twin."""
    rng = np.random.default_rng(5)
    P, S = 1664, 16
    wl = 850.0 * 4.2 * 10 ** (1e-4 * np.arange(P))
    if grid_name == "jittered":
        steps = np.diff(wl) * (1.0 + 0.3 * rng.uniform(-1, 1, P - 1))
        wl = wl[0] + np.concatenate([[0.0], np.cumsum(steps)])
    z = rng.uniform(3.0, 3.6, S).astype(np.float32)
    nhi = (10 ** rng.uniform(17.5, 20.5, S)).astype(np.float32)
    _check_weideman_twin(wl.astype(np.float32), z, (nhi,), True, TOL_WEIDEMAN_LLS)


def test_cpu_wrapper_runs_the_twin_without_counting():
    grids, z, nhis = _grids_and_samples(S=8)
    wl = torch.as_tensor(grids["regular"].astype(np.float32))
    _build.reset_launch_counts()
    got = absorption_all(wl, torch.as_tensor(z[:8]), (torch.as_tensor(nhis[0][:8]),))
    want = absorption_all_reference(
        wl, torch.as_tensor(z[:8]), (torch.as_tensor(nhis[0][:8]),)
    )
    assert torch.equal(got[0], want[0])
    got = absorption_all(wl, torch.as_tensor(z[:8]), (torch.as_tensor(nhis[0][:8]),), poly=False)
    want = absorption_all_reference(
        wl, torch.as_tensor(z[:8]), (torch.as_tensor(nhis[0][:8]),), poly=False
    )
    assert torch.equal(got[0], want[0])
    assert not any(_build.launch_counts.values())


def test_wrapper_rejects_float64():
    wl = torch.linspace(4000.0, 5000.0, 64, dtype=torch.float64)
    with pytest.raises(TypeError):
        absorption_all(wl, torch.full((4,), 3.0, dtype=torch.float64),
                       (torch.full((4,), 1e20, dtype=torch.float64),))
