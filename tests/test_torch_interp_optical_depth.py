"""Interpolation, mean-flux optical depth and the per-spectrum model of
the PyTorch port against the JAX package, in float64 (1e-13 relative:
the same arithmetic, order for order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu.data.spectrum import stack
from gpy_dla_detection_tpu.models.learned import build_spectrum_model as J_build
from gpy_dla_detection_tpu.ops import interp as JI
from gpy_dla_detection_tpu.ops import optical_depth as JO
from gpy_dla_detection_tpu.params import Parameters
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
from gpy_dla_detection_tpu_torch.models.learned import (
    LearnedModel,
    build_spectrum_model,
)
from gpy_dla_detection_tpu_torch.ops import interp as TI
from gpy_dla_detection_tpu_torch.ops import optical_depth as TO

torch.set_num_threads(2)

RTOL = 1e-13


@pytest.mark.parametrize("ndim", [1, 2])
def test_interp_uniform_matches(ndim):
    rng = np.random.default_rng(0)
    values = rng.normal(size=(200,) if ndim == 1 else (200, 5))
    xq = rng.uniform(900.0, 1260.0, size=(3, 400))  # includes out-of-range
    want = np.asarray(JI.interp_uniform(911.75, 0.25, jnp.asarray(values), jnp.asarray(xq)))
    got = TI.interp_uniform(911.75, 0.25, torch.as_tensor(values), torch.as_tensor(xq))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("ndim", [1, 2])
def test_interp_matches(ndim):
    rng = np.random.default_rng(1)
    xg = np.sort(rng.uniform(0.0, 10.0, 300))
    values = rng.normal(size=(300,) if ndim == 1 else (300, 4))
    xq = rng.uniform(-1.0, 11.0, 500)
    xq[:3] = xg[:3]  # exact grid hits exercise searchsorted's right side
    want = np.asarray(JI.interp(jnp.asarray(xg), jnp.asarray(values), jnp.asarray(xq)))
    got = TI.interp(torch.as_tensor(xg), torch.as_tensor(values), torch.as_tensor(xq))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-15)


def test_optical_depth_and_suppression_match():
    wl = 3600.0 * 10 ** (1e-4 * np.arange(2000))
    z = np.array([2.4, 3.1])[:, None, None]
    args = (3.65, 0.0023)
    want = np.asarray(JO.effective_optical_depth(jnp.asarray(wl), *args, jnp.asarray(z), 31))
    got = TO.effective_optical_depth(torch.as_tensor(wl), *args, torch.as_tensor(z), 31)
    assert got.shape == (2, 2000, 31)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    want_a = np.asarray(
        JO.mean_flux_suppression(jnp.asarray(wl), *args, jnp.asarray(z), 31)
    )
    got_a = TO.mean_flux_suppression(torch.as_tensor(wl), *args, torch.as_tensor(z), 31)
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=RTOL, atol=0)


@pytest.mark.parametrize("suppress", [True, False])
def test_spectrum_model_matches_batched(suppress):
    params = Parameters(k=6, suppress_mean_flux=suppress)
    learned = synthetic_learned_model(params)
    spectra = [
        synthetic_spectrum(params, learned, z, seed=i) for i, z in enumerate((2.7, 3.3))
    ]
    batch = stack(spectra)
    want = J_build(learned, batch, params)
    got = build_spectrum_model(
        LearnedModel.from_numpy(learned, "cpu", torch.float64),
        to_torch(batch, "cpu", torch.float64),
        params,
    )
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-300, err_msg=name
        )
