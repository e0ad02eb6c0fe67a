"""The PyTorch port's catalog slice end to end against the JAX package.

* float64 (the port's exact plain path) through ``process_batch`` vs the
  JAX ``process_spectrum`` with the same forced resampling indices:
  evidences, per-sample lls, NaN positions, MAP chains, posteriors and
  p_dla agree to 1e-9 relative.
* float32 (the kernel twins on the CPU) vs the JAX float64 run: log
  evidences within 1e-4 of the spectrum's largest |log evidence|,
  |dp_dla| <= 1e-3, same argmax model.
* the same two comparisons in the exact-Voigt configuration
  (``voigt_impl="exact"``: exact unit optical depth + K5's twin), and the
  float32 one with the Weideman window (``voigt_impl="windowed_weideman"``);
* a chi-square test of the port's own resampler;
* a subprocess that blocks ``jax`` and the JAX package and still imports
  the port and runs its slice and an MCMC chain (the card's machine has
  no JAX);
* the shape of the full-width golden fixture the card is held to.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.stats import chisquare

import jax

from gpy_dla_detection_tpu.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu.models.pipeline import process_spectrum as J_process_spectrum
from gpy_dla_detection_tpu.params import Parameters
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.models.evidence import _draw_base_indices
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
from gpy_dla_detection_tpu_torch.models.pipeline import process_spectrum
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_fullscale.npz"
S = 128
MAX_DLAS = 3
REL_F64 = 1e-9
REL_F32_EVIDENCE = 1e-4
ABS_F32_P_DLA = 1e-3


@pytest.fixture(scope="module")
def slice_inputs():
    params = Parameters(num_dla_samples=S, k=8)
    learned = synthetic_learned_model(params)
    spectra = [
        synthetic_spectrum(params, learned, 3.0, seed=0),
        synthetic_spectrum(params, learned, 3.2, seed=1, dlas=[(2.9, 21.2)]),
    ]
    base = np.random.default_rng(11).integers(0, S, size=(2, MAX_DLAS - 1, S))
    jax_results = [
        J_process_spectrum(
            learned, spec, generate_dla_samples(params), generate_subdla_samples(params),
            synthetic_prior_catalog(params), params, jax.random.PRNGKey(0),
            max_dlas=MAX_DLAS, base_inds_override=b,
        )
        for spec, b in zip(spectra, base)
    ]
    return params, learned, spectra, base, jax_results


def _run_port(slice_inputs, dtype, voigt_impl="windowed"):
    params, learned, spectra, base, _ = slice_inputs
    return process_batch(
        LearnedModel.from_numpy(learned, "cpu", dtype), spectra,
        generate_dla_samples(params), generate_subdla_samples(params),
        synthetic_prior_catalog(params), params, torch.Generator().manual_seed(0),
        max_dlas=MAX_DLAS, base_inds_override=base, voigt_impl=voigt_impl,
    )


def _assert_float64_matches(results, jax_results):
    for got, want in zip(results, jax_results):
        for name in ("log_evidence_null", "log_evidences_dla", "log_evidence_subdla",
                     "map_z_dlas", "map_log_nhis", "p_dla"):
            np.testing.assert_allclose(
                getattr(got, name), np.asarray(getattr(want, name)),
                rtol=REL_F64, atol=0, err_msg=name,
            )
        for name in ("sample_log_likelihoods_dla", "sample_log_likelihoods_subdla"):
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
            np.testing.assert_allclose(g, w, rtol=REL_F64, atol=0, err_msg=name)
        np.testing.assert_array_equal(got.base_sample_inds, np.asarray(want.base_sample_inds))
        np.testing.assert_allclose(
            got.selection.model_posteriors, want.selection.model_posteriors,
            rtol=REL_F64, atol=1e-300,
        )


def _assert_float32_matches_float64(results, jax_results):
    names = ("log_evidence_null", "log_evidences_dla", "log_evidence_subdla")
    for got, want in zip(results, jax_results):
        # relative to the spectrum's evidence scale: a log evidence is a
        # sum over pixels and may cross zero, its error does not shrink there
        scale = max(np.abs(np.asarray(getattr(want, n))).max() for n in names)
        for name in names:
            np.testing.assert_allclose(
                np.asarray(getattr(got, name), np.float64), np.asarray(getattr(want, name)),
                rtol=0, atol=REL_F32_EVIDENCE * scale, err_msg=name,
            )
        assert abs(got.p_dla - want.p_dla) <= ABS_F32_P_DLA
        assert np.argmax(got.selection.model_posteriors) == np.argmax(
            want.selection.model_posteriors
        )


def test_float64_slice_matches_jax(slice_inputs):
    _assert_float64_matches(_run_port(slice_inputs, torch.float64), slice_inputs[-1])


def test_float32_slice_matches_jax_float64(slice_inputs):
    _assert_float32_matches_float64(_run_port(slice_inputs, torch.float32), slice_inputs[-1])


def test_windowed_weideman_configuration_float32_matches_jax_float64(slice_inputs):
    """voigt_impl="windowed_weideman" (the reference's GPY_DLA_FUSED_POLY=0)
    in float32: K1's twin with the Weideman rational and the continued
    fraction in the windows, against the JAX float64 run, as the default
    configuration is held."""
    _assert_float32_matches_float64(
        _run_port(slice_inputs, torch.float32, "windowed_weideman"), slice_inputs[-1])


def test_exact_configuration_float64_matches_jax(slice_inputs):
    """voigt_impl="exact" (the reference's GPY_DLA_FAST_VOIGT=0): in float64
    the same exact profiles as the default, held to the same 1e-9."""
    _assert_float64_matches(_run_port(slice_inputs, torch.float64, "exact"), slice_inputs[-1])


def test_exact_configuration_float32_matches_jax_float64(slice_inputs):
    """voigt_impl="exact" in float32: the exact unit optical depth in the
    float32 Faddeeva tiers and K5's twin per family, against the JAX
    float64 run (which off the TPU is the exact configuration)."""
    results = _run_port(slice_inputs, torch.float32, "exact")
    _assert_float32_matches_float64(results, slice_inputs[-1])
    windowed = _run_port(slice_inputs, torch.float32)
    for e, w in zip(results, windowed):  # a different float32 profile path
        assert not np.array_equal(e.log_evidences_dla, w.log_evidences_dla)


def test_process_spectrum_equals_batch_entry(slice_inputs):
    params, learned, spectra, base, _ = slice_inputs
    batch = _run_port(slice_inputs, torch.float64)
    single = process_spectrum(
        LearnedModel.from_numpy(learned, "cpu", torch.float64), spectra[1],
        generate_dla_samples(params),
        generate_subdla_samples(params), synthetic_prior_catalog(params), params,
        torch.Generator().manual_seed(0), max_dlas=MAX_DLAS, base_inds_override=base[1],
    )
    np.testing.assert_allclose(single.log_evidences_dla, batch[1].log_evidences_dla, rtol=1e-12)
    assert single.p_dla == pytest.approx(batch[1].p_dla, rel=1e-12)


def test_resampler_chi_square():
    """Multinomial parent draws follow the normalized weights."""
    rng = np.random.default_rng(0)
    probs = torch.as_tensor(rng.uniform(0.0, 1.0, 50) ** 3)
    probs[7] = 0.0  # a zero-weight parent is never drawn
    g = torch.Generator().manual_seed(1)
    counts = np.zeros(50)
    for _ in range(400):
        counts += np.bincount(_draw_base_indices(g, probs).numpy(), minlength=50)
    assert counts[7] == 0
    expected = probs.numpy() / probs.numpy().sum() * counts.sum()
    keep = expected > 0
    assert chisquare(counts[keep], expected[keep]).pvalue > 1e-3


def test_port_runs_without_jax():
    """With ``jax`` and the JAX package blocked (the card's machine has
    neither; the port keeps its own copies of the numpy modules), the
    port imports and runs its float32 slice in its three Voigt
    configurations, the LLS search and a short DLA chain on the CPU (the
    kernels' twins)."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
torch.set_num_threads(2)
from gpy_dla_detection_tpu_torch.params import Parameters
from gpy_dla_detection_tpu_torch.data.samples import generate_dla_samples, generate_subdla_samples
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model, synthetic_prior_catalog, synthetic_spectrum)
from gpy_dla_detection_tpu_torch.models.absorber_mcmc import run_dla_mcmc
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, build_spectrum_model
from gpy_dla_detection_tpu_torch.models.lls import generate_lya_samples, lls_inference_many
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch
params = Parameters(num_dla_samples=64, k=6)
learned = synthetic_learned_model(params)
spectra = [synthetic_spectrum(params, learned, 3.0, seed=2, dlas=[(2.7, 21.0)])]
module = LearnedModel.from_numpy(learned, "cpu", torch.float32)
for impl in ("windowed", "exact", "windowed_unfused"):
    res = process_batch(module, spectra, generate_dla_samples(params),
        generate_subdla_samples(params), synthetic_prior_catalog(params), params,
        torch.Generator().manual_seed(0), max_dlas=2, voigt_impl=impl)
    assert np.isfinite(res[0].log_evidences_dla).all() and np.isfinite(res[0].log_evidence_null)
model = build_spectrum_model(module, to_torch(spectra[0], "cpu", torch.float32), params)
chain, lps, acc = run_dla_mcmc(model, params, torch.Generator().manual_seed(1),
    nwalkers=8, nsamples=20)
assert chain.shape == (20, 8, 2) and torch.isfinite(lps[-1]).all() and 0 < float(acc) < 1
lls_params = Parameters(num_dla_samples=64, k=6, min_lambda=850.0, num_pixels_padded=1664)
lls_arrays = synthetic_learned_model(lls_params)
lls_spectra = [synthetic_spectrum(lls_params, lls_arrays, 3.0, seed=2)]
(null_ev, lls_res), = lls_inference_many(
    LearnedModel.from_numpy(lls_arrays, "cpu", torch.float32), lls_spectra,
    generate_lya_samples(64), torch.Generator().manual_seed(2), 2, lls_params)
assert np.isfinite(null_ev) and np.isfinite(lls_res.log_evidences).all()
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu"))]
assert loaded == [], loaded
print("ok", res[0].p_dla, float(acc))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_golden_fixture_layout():
    """Keys, shapes and dtypes of the full-width fixture (written by
    scripts/make_torch_golden.py; replayed on the card by chip_smoke.py)."""
    g = np.load(GOLDEN)
    n, k, s = 2, 4, Parameters().num_dla_samples
    expect = {
        "z_qso": ((n,), np.float64), "obs_seed": ((n,), np.int64),
        "injected": ((n,), np.bool_), "dla_z": ((n,), np.float64),
        "dla_log_nhi": ((n,), np.float64), "base_inds": ((n, k - 1, s), np.uint16),
        "log_evidence_null": ((n,), np.float64), "log_evidences_dla": ((n, k), np.float64),
        "log_evidence_subdla": ((n,), np.float64), "map_z_dlas": ((n, k, k), np.float64),
        "map_log_nhis": ((n, k, k), np.float64), "model_posteriors": ((n, k + 2), np.float64),
        "p_dla": ((n,), np.float64),
    }
    assert set(g.files) == set(expect)
    for key, (shape, dtype) in expect.items():
        assert g[key].shape == shape and g[key].dtype == dtype, key
    assert list(g["injected"]) == [False, True]
    assert int(g["base_inds"].max()) < s
    assert GOLDEN.stat().st_size < 1 << 20
