"""The LLS search of the PyTorch port (``models/lls.py``, K1 with the
Lyman-limit break) against the JAX package.

Tolerances:
* the numpy parts (Lya samples and prior density, posteriors, the
  Fumagalli table) equal bit for bit: the same numpy code;
* K1's twin with ``lls_break`` vs the Pallas K1 in interpret mode
  (``lls_break=True``, poly=True) at the LLS width P = 1,664: 1e-6
  absolute (K1's tolerance; the break adds the same float32 operations in
  the same order; measured 3.0e-7), and vs the JAX float64 exact LLS
  profile: no further from it than the Pallas K1 itself plus 1e-6
  (both measure 9.1e-4, at an unsaturated Lyman-beta core of logNHI
  17.7: the per-line polynomial's own error), with the 99th percentile
  below 5e-5 as tests/test_voigt.py::test_absorption_all_pallas_lls_break
  requires;
* ``voigt_absorption_lls`` in float64 vs JAX float64: 1e-10 absolute;
* ``lls_log_evidences`` in float64 vs the JAX float64 run with the same
  resampling indices: evidences, per-sample lls (with NaN positions) and
  MAP chains at 1e-9 relative;
* float32 vs JAX float64: log evidences within 1e-4 of the largest
  |log evidence|, |dP(k >= 1)| <= 1e-3, the same argmax model;
* ``lls_inference_many`` equal to the single path with the same
  generator: 1e-10 relative on the null and 1e-8 on the evidences (the
  batch models all spectra in one pass).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpy_dla_detection_tpu.data.spectrum import preprocess as J_preprocess
from gpy_dla_detection_tpu.data.synthetic import synthetic_learned_model as J_learned
from gpy_dla_detection_tpu import constants as JC
from gpy_dla_detection_tpu.models import lls as JL
from gpy_dla_detection_tpu.ops import voigt as JV
from gpy_dla_detection_tpu.ops.voigt import voigt_absorption_lls as J_voigt_lls
from gpy_dla_detection_tpu.ops.voigt_pallas import absorption_all_pallas
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
    synthetic_prior_catalog,
)
from gpy_dla_detection_tpu_torch.models import lls as TL
from gpy_dla_detection_tpu_torch.models.evidence import single_absorber_profiles
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops import voigt as TV
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
from gpy_dla_detection_tpu_torch.ops.voigt import voigt_absorption_lls
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import absorption_all_reference
from gpy_dla_detection_tpu_torch.params import Parameters

from .test_torch_windowed_parts import record_window_tier

torch.set_num_threads(2)

TOL_JAX_KERNEL = 1e-6
TOL_UNFUSED_PROFILE = 1e-3
TOL_TRUTH_P99 = 5e-5
TOL_F64_PROFILE = 1e-10
REL_F64 = 1e-9
REL_F32_EVIDENCE = 1e-4
ABS_F32_P = 1e-3
S = 96
MAX_LYA = 3
# (z_qso, observation seed, injected (z_lls, logNHI) or None): the
# injected break at 911.76 A (1 + 2.98) lies inside the 850 A window
SPECTRA = ((3.1, 3, None), (3.2, 4, (2.98, 18.6)))


def _params(**kw):
    return dict(num_dla_samples=S, min_lambda=850.0, num_pixels_padded=1664, k=8, **kw)


@pytest.mark.parametrize("prior", ["garnett", "uniform"])
def test_lya_samples_and_pdf_bit_for_bit(prior):
    got, want = TL.generate_lya_samples(500, prior=prior), JL.generate_lya_samples(500, prior=prior)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    x = np.linspace(17.0, 23.2, 301)
    assert np.array_equal(TL.lya_log_nhi_pdf(x), JL.lya_log_nhi_pdf(x))
    assert np.array_equal(TL._lya_unnormalized_integral(17.2, x), JL._lya_unnormalized_integral(17.2, x))
    assert (TL.BOSS_TAU_0, TL.BOSS_BETA, TL.LYA_FLAT_BELOW) == (
        JL.BOSS_TAU_0, JL.BOSS_BETA, JL.LYA_FLAT_BELOW)


def _lls_grid(P=1664, S=16, seed=5):
    """The inputs of tests/test_voigt.py::test_absorption_all_pallas_lls_break:
    a grid reaching blueward of the Lyman limit at the LLS width."""
    rng = np.random.default_rng(seed)
    wl = (850.0 * 4.2 * 10 ** (1e-4 * np.arange(P))).astype(np.float32)
    z = rng.uniform(3.0, 3.6, S).astype(np.float32)
    nhi = (10 ** rng.uniform(17.5, 20.5, S)).astype(np.float32)
    return wl, z, nhi


def test_k1_twin_with_break_matches_pallas_and_truth():
    wl, z, nhi = _lls_grid()
    want = np.asarray(absorption_all_pallas(
        jnp.asarray(wl), jnp.asarray(z), (jnp.asarray(nhi),), 3,
        interpret=True, lls_break=True, poly=True,
    )[0])
    (got,) = absorption_all_reference(
        torch.as_tensor(wl), torch.as_tensor(z), (torch.as_tensor(nhi),), 3, lls_break=True
    )
    assert got.shape == (z.shape[0], wl.shape[0] - 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_JAX_KERNEL)
    truth = np.asarray(J_voigt_lls(
        jnp.asarray(wl.astype(np.float64)), jnp.asarray(nhi.astype(np.float64)),
        jnp.asarray(z.astype(np.float64)), 3, impl="exact",
    ))
    err = np.abs(got.numpy().astype(np.float64) - truth)
    assert err.max() <= np.abs(want - truth).max() + TOL_JAX_KERNEL
    assert np.quantile(err, 0.99) < TOL_TRUTH_P99
    # the break changes the profile blueward of each absorber's limit only
    (plain,) = absorption_all_reference(
        torch.as_tensor(wl), torch.as_tensor(z), (torch.as_tensor(nhi),), 3
    )
    red = wl[3:-3][None, :] > 911.7641 * (1.0 + z[:, None]) + 5.0
    assert torch.equal(got[torch.as_tensor(red)], plain[torch.as_tensor(red)])
    assert float((plain - got).max()) > 0.5


def test_lls_unfused_profile_matches_jax_windowed():
    """The unfused LLS profile against the JAX package's windowed one,
    ``nhi * _unit_lyman_series_optical_depth_windowed(...)`` plus the break
    (off the TPU JAX resolves "windowed" to exact, so the function is called
    directly): the placed unit tau within 2e-6 of its peak, as
    tests/test_torch_windowed_parts.py holds it; the profile's 99th
    percentile of |d| below TOL_TRUTH_P99 and its max below
    TOL_UNFUSED_PROFILE.  The max sits at unsaturated Lyman cores (logNHI
    17.5), where the two packages' float32 Weideman rationals round a
    tau of order 1 differently (measured 5.9e-4; the K1 test above sees
    9.1e-4 there against float64)."""
    wl, z, nhi = _lls_grid()
    unit_j = np.asarray(JV._unit_lyman_series_optical_depth_windowed(
        jnp.asarray(wl), jnp.asarray(z), 3, JC.THERMAL_SIGMA_CGS))
    rest = wl[None, :] / (1.0 + z[:, None])
    tau_j = nhi[:, None] * unit_j + np.where(
        rest > 911.7641, 0.0, nhi[:, None] / 10**17.2 * (rest / 911.7641) ** 3
    ).astype(np.float32)
    want = np.asarray(JV.instrumental_broadening(jnp.exp(-jnp.asarray(tau_j))))
    wl_t, z_t = torch.as_tensor(wl), torch.as_tensor(z)
    unit_t = TV.place_windows(TV.windowed_tau_parts(wl_t, z_t, 3))
    assert np.abs(unit_t.numpy() - unit_j).max() <= 2e-6 * np.abs(unit_j).max()
    _build.reset_launch_counts()
    (got,) = single_absorber_profiles(wl_t, z_t, (torch.as_tensor(nhi),), 3,
                                      "windowed_unfused", "lls")
    assert not any(_build.launch_counts.values())
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert err.max() <= TOL_UNFUSED_PROFILE and np.quantile(err, 0.99) < TOL_TRUTH_P99, (
        err.max(), np.quantile(err, 0.99))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_voigt_absorption_lls_matches_jax_exact(dtype):
    wl, z, nhi = _lls_grid(S=12)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    got = voigt_absorption_lls(
        torch.as_tensor(wl.astype(np_dtype)), torch.as_tensor(nhi.astype(np_dtype)),
        torch.as_tensor(z.astype(np_dtype)),
    )
    want = np.asarray(J_voigt_lls(
        jnp.asarray(wl.astype(np.float64)), jnp.asarray(nhi.astype(np.float64)),
        jnp.asarray(z.astype(np.float64)), 3, impl="exact",
    ))
    assert got.dtype == dtype
    # float32: the exact unit tau's float32 Weideman tier (K5's tests bound it)
    tol = TOL_F64_PROFILE if dtype == torch.float64 else 2.5e-3
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def lls_inputs():
    jparams, tparams = JParameters(**_params()), Parameters(**_params())
    jlearned = JL.with_boss_meanflux(J_learned(jparams))
    arrays = synthetic_learned_model(tparams)
    samples = TL.generate_lya_samples(S)
    jspecs, tspecs = [], []
    for z_qso, seed, lls in SPECTRA:
        obs = synthetic_observation(tparams, arrays, z_qso, seed=seed,
                                    dlas=None if lls is None else [lls], with_lls_break=True)
        jspecs.append(J_preprocess(*obs, z_qso, jparams))
        tspecs.append(preprocess(*obs, z_qso, tparams))
    base = np.random.default_rng(7).integers(0, S, size=(len(SPECTRA), MAX_LYA - 1, S))
    jax_results = [
        JL.lls_log_evidences(jlearned.astype(np.float64), spec, JL.generate_lya_samples(S),
                             jax.random.PRNGKey(0), MAX_LYA, jparams, base_inds_override=b)
        for spec, b in zip(jspecs, base)
    ]
    return tparams, arrays, samples, tspecs, base, jax_results


def _port_learned(arrays, dtype):
    return TL.with_boss_meanflux(LearnedModel.from_numpy(arrays, "cpu", dtype))


def _run_single(lls_inputs, dtype, voigt_impl, window_tier=True):
    params, arrays, samples, specs, base, _ = lls_inputs
    learned = _port_learned(arrays, dtype)
    return [
        TL.lls_log_evidences(learned, spec, samples, torch.Generator().manual_seed(0),
                             MAX_LYA, params, base_inds_override=b, voigt_impl=voigt_impl,
                             window_tier=window_tier)
        for spec, b in zip(specs, base)
    ]


def _p_absorber(null_ev, evs):
    return 1.0 - TL.lls_model_posteriors(float(null_ev), np.asarray(evs, np.float64))[0]


@pytest.mark.parametrize("voigt_impl", ["windowed", "exact", "windowed_unfused",
                                        "windowed_weideman"])
def test_lls_float64_matches_jax(lls_inputs, voigt_impl):
    """float64 is the exact path in every configuration."""
    for (null_ev, got), (j_null, want) in zip(_run_single(lls_inputs, torch.float64, voigt_impl),
                                              lls_inputs[-1]):
        np.testing.assert_allclose(float(null_ev), float(j_null), rtol=REL_F64)
        for name in ("log_evidences", "map_z_dlas", "map_log_nhis"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=REL_F64, atol=0, err_msg=name)
        g, w = got.sample_log_likelihoods.numpy(), np.asarray(want.sample_log_likelihoods)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=REL_F64, atol=0)
        np.testing.assert_array_equal(got.base_sample_inds.numpy(), np.asarray(want.base_sample_inds))


def _assert_lls_float32_matches_float64(results, jax_results):
    p_inj = []
    for (null_ev, got), (j_null, want) in zip(results, jax_results):
        got_all = np.concatenate([[float(null_ev)], got.log_evidences.numpy()]).astype(np.float64)
        want_all = np.concatenate([[float(j_null)], np.asarray(want.log_evidences)])
        scale = np.abs(want_all).max()
        np.testing.assert_allclose(got_all, want_all, rtol=0, atol=REL_F32_EVIDENCE * scale)
        p_got, p_want = _p_absorber(null_ev, got.log_evidences), _p_absorber(j_null, want.log_evidences)
        assert abs(p_got - p_want) <= ABS_F32_P
        assert np.argmax(TL.lls_model_posteriors(float(null_ev), got.log_evidences.numpy())) == \
            np.argmax(JL.lls_model_posteriors(float(j_null), np.asarray(want.log_evidences)))
        p_inj.append(p_got)
    assert p_inj[0] < 0.1 and p_inj[1] > 0.9  # the injected LLS is found


@pytest.mark.parametrize("voigt_impl", ["windowed", "exact", "windowed_unfused",
                                        "windowed_weideman"])
def test_lls_float32_matches_jax_float64(lls_inputs, voigt_impl):
    """float32: K1's twin with the break (windowed; windowed_weideman with
    the Weideman window), the exact unit tau plus the break and K5's twin
    (exact), or the placed windowed unit tau plus the break and K5's twin
    (windowed_unfused), against the JAX float64 run."""
    _assert_lls_float32_matches_float64(
        _run_single(lls_inputs, torch.float32, voigt_impl), lls_inputs[-1])


def test_lls_inference_many_windowed_weideman_matches_jax_float64(lls_inputs):
    """The batched LLS search in the Weideman-window configuration, float32,
    with the JAX run's resampling indices, against the JAX float64 run."""
    params, arrays, samples, specs, base, jax_results = lls_inputs
    outs = TL.lls_inference_many(
        _port_learned(arrays, torch.float32), iter(specs), samples, torch.Generator().manual_seed(0),
        MAX_LYA, params, batch_size=2, voigt_impl="windowed_weideman", base_inds_override=base)
    assert len(outs) == len(specs)
    for (_, got), b in zip(outs, base):
        np.testing.assert_array_equal(got.base_sample_inds, b)
    _assert_lls_float32_matches_float64(
        [(null_ev, res._replace(log_evidences=torch.as_tensor(res.log_evidences)))
         for null_ev, res in outs], jax_results)


@pytest.mark.parametrize("entry", ["single", "many"])
def test_lls_without_window_tier_float32_matches_jax_float64(lls_inputs, entry, monkeypatch):
    """The unfused configuration without the two-tier window (the
    reference's GPY_DLA_WINDOW_TIER=0, patched on the JAX side too),
    float32, through ``lls_log_evidences`` and ``lls_inference_many`` with
    the JAX run's resampling indices, against the JAX float64 run."""
    monkeypatch.setattr(JV, "WINDOW_TIER", False)
    seen = record_window_tier(monkeypatch)
    params, arrays, samples, specs, base, jax_results = lls_inputs
    if entry == "single":
        results = _run_single(lls_inputs, torch.float32, "windowed_unfused", window_tier=False)
    else:
        outs = TL.lls_inference_many(
            _port_learned(arrays, torch.float32), iter(specs), samples,
            torch.Generator().manual_seed(0), MAX_LYA, params, batch_size=2,
            voigt_impl="windowed_unfused", base_inds_override=base, window_tier=False)
        results = [(null_ev, res._replace(log_evidences=torch.as_tensor(res.log_evidences)))
                   for null_ev, res in outs]
    assert seen == [False] * len(specs)  # one parts build a spectrum, without the tier
    _assert_lls_float32_matches_float64(results, jax_results)


def test_lls_inference_many_matches_single_path(lls_inputs):
    params, arrays, samples, specs, _, _ = lls_inputs
    learned = _port_learned(arrays, torch.float64)
    specs3 = specs + specs[:1]
    outs = TL.lls_inference_many(learned, iter(specs3), samples,
                                 torch.Generator().manual_seed(9), 2, params, batch_size=2)
    assert len(outs) == 3
    gen = torch.Generator().manual_seed(9)
    for spec, (null_ev, result) in zip(specs3, outs):
        ne_ref, res_ref = TL.lls_log_evidences(learned, spec, samples, gen, 2, params)
        assert isinstance(null_ev, float) and isinstance(result.log_evidences, np.ndarray)
        np.testing.assert_allclose(null_ev, float(ne_ref), rtol=1e-10)
        np.testing.assert_allclose(result.log_evidences, res_ref.log_evidences.numpy(), rtol=1e-8)
        np.testing.assert_array_equal(result.base_sample_inds, res_ref.base_sample_inds.numpy())


@pytest.mark.parametrize("counts", [None, (500, 5000)])
def test_lls_posteriors_equal(counts):
    kw = {} if counts is None else dict(num_dlas=counts[0], num_quasars=counts[1])
    for evs in (np.array([-95.0, -101.0, np.nan]), np.array([-120.0, -99.5])):
        got = TL.lls_model_posteriors(-100.0, evs, **kw)
        assert np.array_equal(got, JL.lls_model_posteriors(-100.0, evs, **kw))
        np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-12)
    nd, nq = synthetic_prior_catalog(Parameters()).less_ind(3.2)
    assert np.array_equal(TL.lls_model_posteriors(-10.0, np.array([-9.0]), nd, nq),
                          JL.lls_model_posteriors(-10.0, np.array([-9.0]), nd, nq))


def test_boss_meanflux_and_fumagalli_table(tmp_path):
    arrays = synthetic_learned_model(Parameters())
    learned = LearnedModel.from_numpy(arrays, "cpu", torch.float64)
    boss = TL.with_boss_meanflux(learned)
    assert float(boss.prev_tau_0) == 0.00554 and float(boss.prev_beta) == 3.182
    assert float(learned.prev_tau_0) == 0.0023  # the original is untouched
    assert boss.M is learned.M and boss.mu.dtype == torch.float64
    path = tmp_path / "table_data_full.txt"
    path.write_text("# header line\n" * 15 + "J0001+0001 10.5 -1.2 3.61 5.2 1 0 1 3.55\n"
                    "J0002+0002 11.0 0.4 3.80 8.0 1 1 0 -1.0\nshort line\n")
    got, want = TL.load_fumagalli_table(str(path)), JL.load_fumagalli_table(str(path))
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_lls_golden_fixture_layout():
    """Keys, shapes and dtypes of the full-width LLS fixture (written by
    scripts/make_torch_golden.py lls; replayed on the card by chip_smoke.py)."""
    from pathlib import Path

    path = Path(__file__).resolve().parent / "data" / "torch_golden_lls.npz"
    g = np.load(path)
    n, k, s = 2, 4, 10000
    expect = {
        "z_qso": ((n,), np.float64), "obs_seed": ((n,), np.int64),
        "injected": ((n,), np.bool_), "lls_z": ((n,), np.float64),
        "lls_log_nhi": ((n,), np.float64), "base_inds": ((n, k - 1, s), np.int16),
        "log_evidence_null": ((n,), np.float64), "log_evidences_lls": ((n, k), np.float64),
        "map_z_lls": ((n, k, k), np.float64), "map_log_nhis": ((n, k, k), np.float64),
        "model_posteriors": ((n, k + 1), np.float64),
    }
    assert set(g.files) == set(expect)
    for key, (shape, dtype) in expect.items():
        assert g[key].shape == shape and g[key].dtype == dtype, key
    assert list(g["injected"]) == [False, True]
    assert 0 <= int(g["base_inds"].min()) and int(g["base_inds"].max()) < s
    # the injected break lies inside the 850 A model window
    assert 911.7641 * (1 + g["lls_z"][1]) > 850.0 * (1 + g["z_qso"][1])
    np.testing.assert_allclose(g["model_posteriors"].sum(axis=1), 1.0, rtol=1e-12)
    assert g["model_posteriors"][0, 0] > 0.9 and g["model_posteriors"][1, 0] < 0.1
    assert path.stat().st_size < 300 * 1024
