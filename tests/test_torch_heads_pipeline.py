"""The LLS and CIV heads' in-flight window (``utils.pipeline``) against
their synchronous runs and the JAX package's many-paths.

* ``lls_inference_many`` and ``civ_inference_many`` at ``max_in_flight``
  0, 1 and the default (2 and 4, the reference's) give the same results
  bit for bit, float32 (the kernels' twins) and float64, the generator
  consumed in stream order, over batches with a short last one;
* in float64 they agree with the JAX package's ``lls_inference_many`` and
  ``civ_inference_many`` on the same spectra: the LLS search at one level
  (no resampling draw, so the two generators do not enter) to 1e-9
  relative, the tolerance of ``tests/test_torch_lls.py``; the CIV head to
  1e-9 relative, ``tests/test_torch_civ.py``'s ``REL_F64_MANY_VS_JAX``.
"""

import jax
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.data.spectrum import preprocess as J_preprocess
from gpy_dla_detection_tpu.data.synthetic import synthetic_learned_model as J_learned
from gpy_dla_detection_tpu.models import civ as JCIV
from gpy_dla_detection_tpu.models import lls as JL
from gpy_dla_detection_tpu.params import CIVParameters as JCIVParameters
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
from gpy_dla_detection_tpu_torch.data.synthetic import (
    civ_doublet_transmission,
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.models import civ as TCIV
from gpy_dla_detection_tpu_torch.models import lls as TL
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
from gpy_dla_detection_tpu_torch.params import CIVParameters, Parameters

torch.set_num_threads(2)

REL_F64 = 1e-9
LLS_KW = dict(num_dla_samples=64, min_lambda=850.0, num_pixels_padded=1664, k=6)
CIV_KW = dict(num_civ_samples=80, k=6)
# (z_qso, observation seed, injected absorber or None); five spectra in
# batches of 2, the last one short
LLS_SPECTRA = ((3.1, 3, None), (3.2, 4, (2.98, 18.6)), (3.0, 5, None), (3.3, 6, (3.1, 19.5)),
               (3.15, 7, None))
CIV_SPECTRA = ((2.1, 11, None), (2.2, 12, (2.1, 14.3, 2.5e6)), (2.25, 13, None),
               (2.05, 14, (1.95, 14.4, 3e6)), (2.15, 15, None))


@pytest.fixture(scope="module")
def lls_case():
    params = Parameters(**LLS_KW)
    arrays = synthetic_learned_model(params)
    obs = [(z, synthetic_observation(params, arrays, z, seed=seed,
                                     dlas=None if lls is None else [lls], with_lls_break=True))
           for z, seed, lls in LLS_SPECTRA]
    return params, arrays, obs


@pytest.fixture(scope="module")
def civ_case():
    params = CIVParameters(**CIV_KW)
    arrays = synthetic_learned_model(params)
    obs = []
    for z, seed, civ in CIV_SPECTRA:
        wl, flux, nv, mask = synthetic_observation(params, arrays, z, seed)
        if civ is not None:
            flux = flux * civ_doublet_transmission(wl, *civ)
        obs.append((z, (wl, flux, nv, mask)))
    return params, arrays, obs


def _lls_run(lls_case, dtype, max_lya, **kw):
    params, arrays, obs = lls_case
    learned = LearnedModel.from_numpy(arrays, "cpu", dtype)
    specs = (preprocess(*o, z, params) for z, o in obs)
    return TL.lls_inference_many(learned, specs, TL.generate_lya_samples(params.num_dla_samples),
                                 torch.Generator().manual_seed(5), max_lya, params,
                                 batch_size=2, **kw)


def _lls_bits(out):
    return [(null, *[np.asarray(f).tobytes() for f in res]) for null, res in out]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lls_window_bit_for_bit(lls_case, dtype):
    want = _lls_bits(_lls_run(lls_case, dtype, 2, max_in_flight=0))
    assert len(want) == len(LLS_SPECTRA)
    for window in (1, None):
        kw = {} if window is None else {"max_in_flight": window}
        assert _lls_bits(_lls_run(lls_case, dtype, 2, **kw)) == want, window


def test_lls_many_matches_jax_many(lls_case):
    params, arrays, obs = lls_case
    got = _lls_run(lls_case, torch.float64, 1)
    jparams = JParameters(**LLS_KW)
    want = JL.lls_inference_many(
        J_learned(jparams), [J_preprocess(*o, z, jparams) for z, o in obs],
        JL.generate_lya_samples(params.num_dla_samples), jax.random.PRNGKey(0), 1, jparams,
        batch_size=2)
    assert len(got) == len(want)
    for (null, res), (j_null, j_res) in zip(got, want):
        np.testing.assert_allclose(null, float(j_null), rtol=REL_F64)
        for name in ("log_evidences", "map_z_dlas", "map_log_nhis"):
            np.testing.assert_allclose(getattr(res, name), np.asarray(getattr(j_res, name)),
                                       rtol=REL_F64, atol=0, err_msg=name)
        g, w = res.sample_log_likelihoods, np.asarray(j_res.sample_log_likelihoods)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=REL_F64, atol=0)
    p = [1.0 - TL.lls_model_posteriors(null, res.log_evidences)[0] for null, res in got]
    assert p[1] > 0.9 and p[3] > 0.9 and max(p[0], p[2], p[4]) < 0.1


def _civ_run(civ_case, dtype, **kw):
    params, arrays, obs = civ_case
    learned = LearnedModel.from_numpy(arrays, "cpu", dtype)
    specs = (preprocess(*o, z, params) for z, o in obs)
    return TCIV.civ_inference_many(learned, specs, TCIV.generate_civ_samples(params), params,
                                   batch_size=2, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_civ_window_bit_for_bit(civ_case, dtype):
    want = _civ_run(civ_case, dtype, max_in_flight=0)
    assert len(want) == len(CIV_SPECTRA)
    for window in (1, None):
        kw = {} if window is None else {"max_in_flight": window}
        assert _civ_run(civ_case, dtype, **kw) == want, window


def test_civ_many_matches_jax_many(civ_case):
    params, arrays, obs = civ_case
    got = _civ_run(civ_case, torch.float64)
    jparams = JCIVParameters(**CIV_KW)
    want = JCIV.civ_inference_many(J_learned(jparams),
                                   [J_preprocess(*o, z, jparams) for z, o in obs],
                                   JCIV.generate_civ_samples(jparams), jparams, batch_size=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float64), rtol=REL_F64,
                               atol=0)
    assert got[1][0] > 0.9 and got[3][0] > 0.9
