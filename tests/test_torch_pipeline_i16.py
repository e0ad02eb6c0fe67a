"""The QMC evidences with compact profile storage (``abs_dtype=torch.int16``)
in the PyTorch port, against the JAX package's ``GPY_DLA_ABS_DTYPE=i16``
(``jnp.int16``) and ``i16p`` (``jnp.int32``: packed pairs of the same codes).

Inputs: two synthetic spectra (one with a DLA), S = 128 samples, k = 8, a
model window of 1,090-1,215.75 A (N = 512); the LLS profile at the LLS
search's window (850 A, N = 1,664: the Lyman-limit break of an absorber in
the search range lies in the window only if the window spans 850 A to
past 1,133 A) with S = 64.  The same resampling indices go to both sides.

* float64, every configuration (``voigt_impl``, which float64 runs exactly)
  and the LLS profile: log evidences within 1e-6 absolute, per-sample log
  likelihoods within 1e-9 relative where finite and NaN in the same
  places, MAP chains equal, against the JAX run with int16 and with int32
  storage.
* float32 (the kernels' twins): the port's int16 storage against its own
  float32 storage within the reference's own bounds
  (tests/test_pipeline_conformance.py::test_i16_profile_storage_accuracy):
  |d log evidence| < 0.02, rms d ll < 0.02, the same finite samples, MAP z
  within 1e-6.
* ``process_batch`` (both families from one profile evaluation) and
  ``process_spectrum``, and ``lls_inference_many``, with ``abs_dtype``
  equal the per-spectrum ``qmc_log_evidences``.
"""

from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpy_dla_detection_tpu.models.evidence import qmc_log_evidences as J_qmc
from gpy_dla_detection_tpu.models.learned import build_spectrum_model as J_build
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.models import lls as TL
from gpy_dla_detection_tpu_torch.models.evidence import VOIGT_IMPLS, qmc_log_evidences
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, build_spectrum_model
from gpy_dla_detection_tpu_torch.models.pipeline import process_spectrum, sample_tensors
from gpy_dla_detection_tpu_torch.ops.kernel_config import profile_store_dtype
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch
from gpy_dla_detection_tpu_torch.params import Parameters

torch.set_num_threads(2)

S = 128
S_LLS = 64
MAX_DLAS = 3
ABS_EVIDENCE = 1e-6
REL_LL = 1e-9
# the reference's own int16-vs-f32 storage bounds
I16_EVIDENCE = 0.02
I16_RMS_LL = 0.02
I16_MAP_Z = 1e-6

DLA_PARAMS = dict(num_dla_samples=S, k=8, min_lambda=1090.0, num_pixels_padded=512)
LLS_PARAMS = dict(num_dla_samples=S_LLS, k=8, min_lambda=850.0, num_pixels_padded=1664)
# (z_qso, observation seed, injected (z, logNHI) or None)
DLA_SPECTRA = ((3.0, 0, None), (3.2, 1, (2.9, 21.2)))
LLS_SPECTRA = ((3.1, 3, None), (3.2, 4, (2.98, 18.6)))
JAX_STORES = {"i16": jnp.int16, "i16p": jnp.int32}


@partial(jax.jit, static_argnames=("params", "max_k", "profile", "abs_dtype"))
def _jax_qmc(learned, spec, offsets, log_nhi, nhi, base, params, max_k, profile, abs_dtype):
    model = J_build(learned, spec, params)
    return J_qmc(model, offsets, log_nhi, nhi, jax.random.PRNGKey(0), max_k, params,
                 base_inds_override=base, profile=profile, abs_dtype=abs_dtype)


def _inputs(kw, spectra_spec, samples, with_lls_break, seed):
    params, jparams = Parameters(**kw), JParameters(**kw)
    arrays = synthetic_learned_model(params)
    spectra = [
        synthetic_spectrum(params, arrays, z, seed=sd, dlas=None if d is None else [d],
                           with_lls_break=with_lls_break)
        for z, sd, d in spectra_spec
    ]
    n = samples.offset_samples.shape[0]
    base = np.random.default_rng(seed).integers(0, n, size=(len(spectra), MAX_DLAS - 1, n))
    return params, jparams, arrays, spectra, samples, base


@pytest.fixture(scope="module")
def dla_inputs():
    return _inputs(DLA_PARAMS, DLA_SPECTRA, generate_dla_samples(Parameters(**DLA_PARAMS)),
                   False, 11)


@pytest.fixture(scope="module")
def lls_inputs():
    return _inputs(LLS_PARAMS, LLS_SPECTRA, TL.generate_lya_samples(S_LLS), True, 7)


def _jax_results(inputs, store, profile):
    _, jparams, arrays, spectra, samples, base = inputs
    learned = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), arrays)
    put = lambda x: jnp.asarray(np.asarray(x), jnp.float64)
    return [
        jax.tree_util.tree_map(np.asarray, _jax_qmc(
            learned, jax.tree_util.tree_map(jnp.asarray, spec), put(samples.offset_samples),
            put(samples.log_nhi_samples), put(samples.nhi_samples), jnp.asarray(b, jnp.int32),
            jparams, MAX_DLAS, profile, store))
        for spec, b in zip(spectra, base)
    ]


@pytest.fixture(scope="module")
def jax_dla(dla_inputs):
    return {name: _jax_results(dla_inputs, st, "dla") for name, st in JAX_STORES.items()}


@pytest.fixture(scope="module")
def jax_lls(lls_inputs):
    return {name: _jax_results(lls_inputs, st, "lls") for name, st in JAX_STORES.items()}


def _port_results(inputs, dtype, abs_dtype, profile, voigt_impl="windowed"):
    params, _, arrays, spectra, samples, base = inputs
    learned = LearnedModel.from_numpy(arrays, "cpu", dtype)
    samples_t = sample_tensors(samples, "cpu", dtype)
    out = []
    for spec, b in zip(spectra, base):
        model = build_spectrum_model(learned, to_torch(spec, "cpu", dtype), params)
        out.append(qmc_log_evidences(
            model, *samples_t, torch.Generator().manual_seed(0), MAX_DLAS, params,
            base_inds_override=torch.as_tensor(b), voigt_impl=voigt_impl, profile=profile,
            abs_dtype=abs_dtype))
    return out


def _assert_matches_jax(got_all, want_all):
    for got, want in zip(got_all, want_all):
        np.testing.assert_allclose(got.log_evidences.numpy(), want.log_evidences,
                                   rtol=0, atol=ABS_EVIDENCE)
        g, w = got.sample_log_likelihoods.numpy(), want.sample_log_likelihoods
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=REL_LL, atol=0)
        np.testing.assert_array_equal(got.map_z_dlas.numpy(), want.map_z_dlas)
        np.testing.assert_array_equal(got.map_log_nhis.numpy(), want.map_log_nhis)
        np.testing.assert_array_equal(got.base_sample_inds.numpy(), want.base_sample_inds)


@pytest.mark.parametrize("store", list(JAX_STORES))
@pytest.mark.parametrize("voigt_impl", VOIGT_IMPLS)
def test_float64_int16_matches_jax(dla_inputs, jax_dla, voigt_impl, store):
    got = _port_results(dla_inputs, torch.float64, torch.int16, "dla", voigt_impl)
    _assert_matches_jax(got, jax_dla[store])


@pytest.mark.parametrize("store", list(JAX_STORES))
def test_float64_int16_lls_profile_matches_jax(lls_inputs, jax_lls, store):
    got = _port_results(lls_inputs, torch.float64, profile_store_dtype(store), "lls")
    _assert_matches_jax(got, jax_lls[store])


def _assert_within_reference_bounds(i16_all, f32_all):
    for a, b in zip(i16_all, f32_all):
        ev16, ev32 = a.log_evidences.numpy(), b.log_evidences.numpy()
        assert np.all(np.abs(ev16 - ev32) < I16_EVIDENCE), ev16 - ev32
        l16, l32 = a.sample_log_likelihoods.numpy(), b.sample_log_likelihoods.numpy()
        finite = np.isfinite(l32)
        assert np.array_equal(finite, np.isfinite(l16))
        d = (l16 - l32)[finite].astype(np.float64)
        assert np.sqrt(np.mean(d * d)) < I16_RMS_LL
        np.testing.assert_allclose(a.map_z_dlas.numpy(), b.map_z_dlas.numpy(), rtol=0,
                                   atol=I16_MAP_Z, equal_nan=True)


@pytest.mark.parametrize("voigt_impl", VOIGT_IMPLS)
def test_float32_int16_within_reference_bounds_of_float32(dla_inputs, voigt_impl):
    """The kernels' twins: int16 codes encoded at K1's, K5's or K6's store
    and decoded in K2's, against float32 storage."""
    i16 = _port_results(dla_inputs, torch.float32, torch.int16, "dla", voigt_impl)
    f32 = _port_results(dla_inputs, torch.float32, None, "dla", voigt_impl)
    assert all(r.log_evidences.dtype == torch.float32 for r in i16)
    _assert_within_reference_bounds(i16, f32)


@pytest.mark.parametrize("voigt_impl", ["windowed", "exact", "windowed_unfused"])
def test_float32_int16_lls_within_reference_bounds_of_float32(lls_inputs, voigt_impl):
    i16 = _port_results(lls_inputs, torch.float32, torch.int16, "lls", voigt_impl)
    f32 = _port_results(lls_inputs, torch.float32, None, "lls", voigt_impl)
    _assert_within_reference_bounds(i16, f32)


def test_explicit_model_dtype_storage_is_the_default(dla_inputs):
    default = _port_results(dla_inputs, torch.float32, None, "dla")
    explicit = _port_results(dla_inputs, torch.float32, profile_store_dtype("f32"), "dla")
    for a, b in zip(default, explicit):
        assert torch.equal(a.log_evidences, b.log_evidences)
    with pytest.raises(TypeError):
        _port_results(dla_inputs, torch.float32, torch.float64, "dla")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("voigt_impl", ["windowed", "exact"])
def test_batch_and_spectrum_entry_points_equal_single_path(dla_inputs, dtype, voigt_impl):
    """process_batch computes both families in one profile evaluation (one
    K1 launch on the card) and process_spectrum each on its own; both equal
    qmc_log_evidences per spectrum and family."""
    params, _, arrays, spectra, samples, base = dla_inputs
    learned = LearnedModel.from_numpy(arrays, "cpu", dtype)
    sub = generate_subdla_samples(params)
    common = (learned, spectra, samples, sub, synthetic_prior_catalog(params), params,
              torch.Generator().manual_seed(0))
    batch = process_batch(*common, max_dlas=MAX_DLAS, base_inds_override=base,
                          voigt_impl=voigt_impl, abs_dtype=torch.int16)
    single = _port_results(dla_inputs, dtype, torch.int16, "dla", voigt_impl)
    sub_t = sample_tensors(sub, "cpu", dtype)
    for i, (spec, res, want) in enumerate(zip(spectra, batch, single)):
        np.testing.assert_array_equal(res.log_evidences_dla, want.log_evidences.numpy())
        np.testing.assert_array_equal(res.sample_log_likelihoods_dla,
                                      want.sample_log_likelihoods.numpy())
        np.testing.assert_array_equal(res.map_z_dlas, want.map_z_dlas.numpy())
        model = build_spectrum_model(learned, to_torch(spec, "cpu", dtype), params)
        sub_want = qmc_log_evidences(model, *sub_t, torch.Generator().manual_seed(0), 1, params,
                                     voigt_impl=voigt_impl, abs_dtype=torch.int16)
        np.testing.assert_array_equal(res.log_evidence_subdla,
                                      float(sub_want.log_evidences[0]))
        one = process_spectrum(learned, spec, samples, sub, common[4], params,
                               torch.Generator().manual_seed(0), MAX_DLAS,
                               base_inds_override=base[i], voigt_impl=voigt_impl,
                               abs_dtype=torch.int16)
        np.testing.assert_array_equal(one.log_evidences_dla, res.log_evidences_dla)
        np.testing.assert_array_equal(one.log_evidence_subdla, res.log_evidence_subdla)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lls_inference_many_int16_equals_single_path(lls_inputs, dtype):
    """The batched LLS search builds the spectra's models in one batch, so
    in float32 its sums over pixels round otherwise than the single path's
    (measured 2.1e-6 relative in the null evidence, with or without int16
    storage)."""
    params, _, arrays, spectra, samples, base = lls_inputs
    learned = LearnedModel.from_numpy(arrays, "cpu", dtype)
    rtol = 1e-5 if dtype == torch.float32 else 1e-10
    outs = TL.lls_inference_many(learned, iter(spectra), samples, torch.Generator().manual_seed(0),
                                 MAX_DLAS, params, batch_size=2, base_inds_override=base,
                                 abs_dtype=torch.int16)
    assert len(outs) == len(spectra)
    for spec, b, (null_ev, res) in zip(spectra, base, outs):
        null_one, one = TL.lls_log_evidences(learned, spec, samples,
                                             torch.Generator().manual_seed(0), MAX_DLAS, params,
                                             base_inds_override=b, abs_dtype=torch.int16)
        np.testing.assert_allclose(null_ev, float(null_one), rtol=rtol)
        np.testing.assert_allclose(res.log_evidences, one.log_evidences.numpy(), rtol=rtol)
        np.testing.assert_array_equal(res.base_sample_inds, b)
        g, w = res.sample_log_likelihoods, one.sample_log_likelihoods.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=rtol)


def test_i16_golden_fixture_layout_and_bound():
    """The full-width int16 fixture (scripts/make_torch_golden.py i16;
    replayed on the card by chip_smoke.py): keys, shapes, dtypes, the dla
    fixture's spectra, and its evidences within the reference's int16
    bound (0.02) of that fixture's float64-storage run, MAP chains equal."""
    data = Path(__file__).resolve().parent / "data"
    g, f = np.load(data / "torch_golden_i16.npz"), np.load(data / "torch_golden_fullscale.npz")
    n, k = 2, 4
    expect = {
        "z_qso": ((n,), np.float64), "obs_seed": ((n,), np.int64),
        "injected": ((n,), np.bool_), "log_evidence_null": ((n,), np.float64),
        "log_evidences_dla": ((n, k), np.float64), "log_evidence_subdla": ((n,), np.float64),
        "map_z_dlas": ((n, k, k), np.float64), "map_log_nhis": ((n, k, k), np.float64),
    }
    assert set(g.files) == set(expect)
    for key, (shape, dtype) in expect.items():
        assert g[key].shape == shape and g[key].dtype == dtype, key
    for key in ("z_qso", "obs_seed", "injected"):
        np.testing.assert_array_equal(g[key], f[key])
    for key in ("log_evidence_null", "log_evidences_dla", "log_evidence_subdla"):
        assert np.all(np.abs(g[key] - f[key]) < I16_EVIDENCE), key
    for key in ("map_z_dlas", "map_log_nhis"):
        np.testing.assert_array_equal(g[key], f[key])
    assert (data / "torch_golden_i16.npz").stat().st_size < 1 << 17
