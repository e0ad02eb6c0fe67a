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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu import constants as C
from gpy_dla_detection_tpu.ops.voigt import (
    _unit_lyman_series_optical_depth,
    instrumental_broadening,
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


def test_cpu_wrapper_runs_the_twin_without_counting():
    grids, z, nhis = _grids_and_samples(S=8)
    wl = torch.as_tensor(grids["regular"].astype(np.float32))
    _build.reset_launch_counts()
    got = absorption_all(wl, torch.as_tensor(z[:8]), (torch.as_tensor(nhis[0][:8]),))
    want = absorption_all_reference(
        wl, torch.as_tensor(z[:8]), (torch.as_tensor(nhis[0][:8]),)
    )
    assert torch.equal(got[0], want[0])
    assert _build.launch_counts["absorption_all"] == 0


def test_wrapper_rejects_float64():
    wl = torch.linspace(4000.0, 5000.0, 64, dtype=torch.float64)
    with pytest.raises(TypeError):
        absorption_all(wl, torch.full((4,), 3.0, dtype=torch.float64),
                       (torch.full((4,), 1e20, dtype=torch.float64),))
