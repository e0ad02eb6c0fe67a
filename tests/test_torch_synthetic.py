"""The port's numpy-only synthetic generators are bit-identical to the
JAX package's (gpy_dla_detection_tpu/data/synthetic.py) for the same
seed, and the learned-model carry-over keeps every array."""

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.data import synthetic as J
from gpy_dla_detection_tpu.params import Parameters
from gpy_dla_detection_tpu_torch.data import synthetic as T
from gpy_dla_detection_tpu_torch.models.learned import FIELDS, LearnedModel

torch.set_num_threads(2)


@pytest.mark.parametrize("k,seed", [(20, 0), (6, 3)])
def test_learned_model_identical(k, seed):
    params = Parameters(k=k)
    want = J.synthetic_learned_model(params, seed=seed)
    got = T.synthetic_learned_model(params, seed=seed)
    assert got._fields == want._fields == FIELDS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


def test_prior_catalog_and_grid_identical():
    params = Parameters()
    want = J.synthetic_prior_catalog(params, num_quasars=300, seed=4)
    got = T.synthetic_prior_catalog(params, num_quasars=300, seed=4)
    np.testing.assert_array_equal(got.z_qsos, want.z_qsos)
    np.testing.assert_array_equal(got.dla_ind, want.dla_ind)
    assert got.less_ind(3.0) == want.less_ind(3.0)
    np.testing.assert_array_equal(T.synthetic_sdss_grid(), J.synthetic_sdss_grid())


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"dlas": [(2.8, 21.2)]},
        {"dlas": [(2.7, 20.5), (2.9, 19.0)], "with_lls_break": True},
        {"with_omega_noise": True, "masked_fraction": 0.05},
    ],
)
def test_observation_and_spectrum_identical(kw):
    params = Parameters(k=6)
    learned_j = J.synthetic_learned_model(params)
    learned_t = T.synthetic_learned_model(params)
    for g, w in zip(
        T.synthetic_observation(params, learned_t, 3.1, seed=5, **kw),
        J.synthetic_observation(params, learned_j, 3.1, seed=5, **kw),
    ):
        np.testing.assert_array_equal(g, w)
    got = T.synthetic_spectrum(params, learned_t, 3.1, seed=5, **kw)
    want = J.synthetic_spectrum(params, learned_j, 3.1, seed=5, **kw)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_learned_model_carry_over(dtype):
    params = Parameters(k=6)
    learned = J.synthetic_learned_model(params)
    module = LearnedModel.from_numpy([np.asarray(f) for f in learned], "cpu", dtype)
    buffers = dict(module.named_buffers())
    assert list(buffers) == list(FIELDS)
    for name, f in zip(FIELDS, learned):
        t = buffers[name]
        assert t.dtype == dtype and t.shape == np.shape(f)
        np.testing.assert_array_equal(t.numpy(), np.asarray(f).astype(t.numpy().dtype))
    assert module.to(torch.float64).M.dtype == torch.float64


@pytest.mark.parametrize("dlas", [None, [(2.7, 21.0)]])
def test_write_speclite_bytes_equal_the_test_writer(tmp_path, dlas):
    """``write_speclite`` writes the bytes of ``tests/test_fits.py``'s
    writer on the float32 columns the JAX package's scripts pass it, and
    the port's reader gives the observation back at float32."""
    from gpy_dla_detection_tpu_torch.data.fits import read_spec

    from .test_fits import _write_speclite

    params = Parameters()
    wl, fx, nv, pm = T.synthetic_observation(params, T.synthetic_learned_model(params), 3.0,
                                             seed=1, dlas=dlas)
    pm = pm | (np.arange(wl.size) % 97 == 0)
    got = T.write_speclite(tmp_path / "port.fits", wl, fx, nv, pm)
    _write_speclite(str(tmp_path / "jax.fits"), fx.astype(np.float32),
                    np.log10(wl).astype(np.float32), (1.0 / nv).astype(np.float32),
                    np.where(pm, 1 << 24, 0).astype(np.int32))
    assert got == str(tmp_path / "port.fits")
    assert (tmp_path / "port.fits").read_bytes() == (tmp_path / "jax.fits").read_bytes()
    wl_r, fx_r, _, pm_r = read_spec(got)
    np.testing.assert_allclose(wl_r, wl, rtol=1e-6)
    np.testing.assert_array_equal(fx_r, fx.astype(np.float32))
    np.testing.assert_array_equal(pm_r, pm)
