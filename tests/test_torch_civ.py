"""The CIV QMC head of the PyTorch port (``models/civ.py``) against the JAX
package (``gpy_dla_detection_tpu/models/civ.py``).

Tolerances:
* the QMC samples and the two-model posterior equal bit for bit: the
  same numpy code;
* float64 null and CIV evidences vs JAX float64 on the same model: 1e-10
  relative (the same algorithm; only summation orders differ);
* float32 (K5's, K2's and K3's twins) vs JAX float64: within 1e-4 of the
  largest |log evidence|, the catalog's float32 gate, and the same
  decision;
* ``civ_inference_many`` equal to the single path in float64 to 1e-10
  relative (the batch builds all its models in one pass), and to the JAX
  package's own ``civ_inference_many`` to 1e-9.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu import constants as JC
from gpy_dla_detection_tpu.data.spectrum import preprocess as J_preprocess
from gpy_dla_detection_tpu.data.synthetic import synthetic_learned_model as J_learned
from gpy_dla_detection_tpu.models import civ as JCIV
from gpy_dla_detection_tpu.models.learned import SpectrumModel as JSpectrumModel
from gpy_dla_detection_tpu.params import CIVParameters as JCIVParameters
from gpy_dla_detection_tpu_torch.data.synthetic import (
    civ_doublet_transmission,
    synthetic_civ_spectrum,
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.models import civ as TCIV
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, SpectrumModel
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.params import CIVParameters

torch.set_num_threads(2)

REL_F64 = 1e-10
REL_F64_MANY_VS_JAX = 1e-9
REL_F32_EVIDENCE = 1e-4
GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_civ.npz"


@pytest.mark.parametrize("num_samples", [None, 600])
def test_civ_samples_and_posterior_bit_for_bit(num_samples):
    got = TCIV.generate_civ_samples(CIVParameters(), num_samples)
    want = JCIV.generate_civ_samples(JCIVParameters(), num_samples)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for null_ev, civ_ev, prior in ((-100.0, -95.0, 0.5), (-100.0, -101.5, 0.2), (3.0, 3.0, 0.9)):
        assert TCIV.civ_model_posterior(null_ev, civ_ev, prior) == JCIV.civ_model_posterior(
            null_ev, civ_ev, prior)


def _reference_doublet(wl, z_civ, log_n, sigma):
    """The injection of tests/test_accuracy_gates.py on the JAX package's
    constants (what scripts/make_torch_golden.py civ multiplies in)."""
    from scipy.special import wofz

    tau = np.zeros_like(wl)
    for l in range(2):
        lam_c = JC.CIV_WAVELENGTHS_CM[l] * 1e8 * (1 + z_civ)
        vel = (wl - lam_c) * (JC.SPEED_OF_LIGHT_CGS / lam_c)
        zz = (vel + 1j * JC.CIV_LORENTZIAN_WIDTHS[l]) / (np.sqrt(2) * sigma)
        tau += 10.0**log_n * JC.CIV_LEADING_CONSTANTS[l] * np.real(wofz(zz)) / (
            np.sqrt(2 * np.pi) * sigma)
    return np.exp(-tau)


@pytest.mark.parametrize("index", [1, 3, 5, 7])
def test_civ_doublet_transmission_matches_the_reference_injection(index):
    """The port's injection (chip_smoke.py's CIV spectra) against the
    golden writer's, on the golden's doublets and the port's observed
    grids: 1e-13 relative (the same formula on copied constants)."""
    g = np.load(GOLDEN)
    z, seed = float(g["z_qso"][index]), int(g["obs_seed"][index])
    civ = (float(g["civ_z"][index]), float(g["civ_log_n"][index]), float(g["civ_sigma"][index]))
    params = CIVParameters()
    wl = synthetic_observation(params, synthetic_learned_model(params), z, seed)[0]
    want = _reference_doublet(wl, *civ)
    assert want.min() < 0.5  # the doublet lies on the grid
    np.testing.assert_allclose(civ_doublet_transmission(wl, *civ), want, rtol=1e-13, atol=0)


def _injected_model():
    """The flat-continuum model with an injected doublet of
    tests/test_lls_civ.py::test_civ_qmc_evidence_detects_doublet, as numpy
    float64 fields in SpectrumModel order."""
    rng = np.random.default_rng(0)
    z_qso, n, N = 2.2, 700, 768
    wl = 1311.0 * (1 + z_qso) * 10 ** (1e-4 * np.arange(n + 6))
    mu = np.ones(n)
    M = np.stack([np.sin(np.arange(n) / 40.0 + i) * 0.05 for i in range(5)], axis=1)
    v = np.full(n, 0.03**2)
    flux = mu + M @ rng.normal(size=5) + np.sqrt(v) * rng.normal(size=n)
    absorption = np.convolve(
        civ_doublet_transmission(wl, 2.05, 14.2, 2.5e6), JC.INSTRUMENT_PROFILE, "valid")
    pad = N - n
    return dict(
        padded_wavelengths=np.concatenate([wl, wl[-1] * 10 ** (1e-4 * np.arange(1, pad + 1))]),
        y=np.concatenate([flux * absorption, np.zeros(pad)]),
        v=np.concatenate([v, np.ones(pad)]),
        mask=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        mu=np.concatenate([mu, np.zeros(pad)]),
        M=np.vstack([M, np.zeros((pad, 5))]),
        omega2=np.zeros(N),
        z_qso=np.asarray(z_qso),
        min_z_dla=np.asarray(1.95),
        max_z_dla=np.asarray(2.17),
    )


@pytest.fixture(scope="module")
def injected():
    fields = _injected_model()
    params = CIVParameters(num_civ_samples=600, num_pixels_padded=768)
    jmodel = JSpectrumModel(**{k: jnp.asarray(v) for k, v in fields.items()})
    samples = JCIV.generate_civ_samples(JCIVParameters(num_civ_samples=600))
    j_null = float(JCIV.civ_null_log_evidence(jmodel))
    j_civ, j_lls = JCIV.civ_qmc_log_evidence(jmodel, samples, params)
    return fields, params, (j_null, float(j_civ), np.asarray(j_lls))


def _port_model(fields, dtype):
    return SpectrumModel(**{
        k: torch.as_tensor(v if v.dtype == bool else v.astype(
            np.float64 if dtype == torch.float64 else np.float32))
        for k, v in fields.items()
    })


def test_civ_evidences_float64_match_jax(injected):
    fields, params, (j_null, j_civ, j_lls) = injected
    model = _port_model(fields, torch.float64)
    samples = TCIV.generate_civ_samples(params)
    null_ev = TCIV.civ_null_log_evidence(model)
    civ_ev, lls = TCIV.civ_qmc_log_evidence(model, samples, params)
    assert civ_ev.dtype == torch.float64 and lls.shape == (600,)
    np.testing.assert_allclose(float(null_ev), j_null, rtol=REL_F64)
    np.testing.assert_allclose(float(civ_ev), j_civ, rtol=REL_F64)
    np.testing.assert_allclose(lls.numpy(), j_lls, rtol=REL_F64)


def test_civ_evidences_float32_match_jax_float64(injected):
    """float32 runs K5's twin (the doublet's exp and convolution) and K2's
    and K3's twins; the doublet is found as by the JAX package."""
    fields, params, (j_null, j_civ, _) = injected
    model = _port_model(fields, torch.float32)
    _build.reset_launch_counts()
    null_ev = float(TCIV.civ_null_log_evidence(model))
    civ_ev, lls = TCIV.civ_qmc_log_evidence(model, TCIV.generate_civ_samples(params), params)
    assert lls.dtype == torch.float32 and not any(_build.launch_counts.values())
    scale = max(abs(j_null), abs(j_civ))
    assert abs(null_ev - j_null) <= REL_F32_EVIDENCE * scale
    assert abs(float(civ_ev) - j_civ) <= REL_F32_EVIDENCE * scale
    assert float(civ_ev) > null_ev + 5.0
    assert TCIV.civ_model_posterior(null_ev, float(civ_ev)) > 0.99


@pytest.fixture(scope="module")
def civ_spectra():
    params = CIVParameters(num_civ_samples=200)
    arrays = synthetic_learned_model(params)
    todo = ((2.1, 11, None), (2.2, 12, (2.1, 14.3, 2.5e6)), (2.25, 13, None))
    specs = [synthetic_civ_spectrum(params, arrays, z, seed, civ) for z, seed, civ in todo]
    return params, arrays, specs, todo


def test_civ_inference_many_matches_single_path_and_jax(civ_spectra):
    params, arrays, specs, todo = civ_spectra
    learned = LearnedModel.from_numpy(arrays, "cpu", torch.float64)
    samples = TCIV.generate_civ_samples(params)
    outs = TCIV.civ_inference_many(learned, iter(specs), samples, params, batch_size=2)
    assert len(outs) == 3
    for spec, (p, null_ev, civ_ev) in zip(specs, outs):
        ne_ref, ce_ref = TCIV.civ_log_evidences(learned, spec, samples, params)
        assert isinstance(null_ev, float) and isinstance(civ_ev, float)
        np.testing.assert_allclose(null_ev, float(ne_ref), rtol=REL_F64)
        np.testing.assert_allclose(civ_ev, float(ce_ref), rtol=REL_F64)
        assert p == TCIV.civ_model_posterior(null_ev, civ_ev)
    # the JAX package's own many-path on the same observations
    jparams = JCIVParameters(num_civ_samples=200)
    jlearned = J_learned(jparams)
    jspecs = []
    for z, seed, civ in todo:
        wl, flux, nv, mask = synthetic_observation(params, arrays, z, seed)
        if civ is not None:
            flux = flux * civ_doublet_transmission(wl, *civ)
        jspecs.append(J_preprocess(wl, flux, nv, mask, z, jparams))
    want = JCIV.civ_inference_many(jlearned, jspecs, JCIV.generate_civ_samples(jparams),
                                   jparams, batch_size=4)
    np.testing.assert_allclose(np.asarray(outs), np.asarray(want, np.float64),
                               rtol=REL_F64_MANY_VS_JAX, atol=0)
    assert outs[1][0] > 0.9  # the injected doublet


def test_civ_inference_many_float32_launch_free_on_the_cpu(civ_spectra):
    """float32 on the CPU: the twins, no kernel launch counted; within the
    float32 gate of the float64 run."""
    params, arrays, specs, _ = civ_spectra
    samples = TCIV.generate_civ_samples(params)
    _build.reset_launch_counts()
    got = TCIV.civ_inference_many(LearnedModel.from_numpy(arrays, "cpu", torch.float32),
                                  specs, samples, params)
    assert not any(_build.launch_counts.values())
    want = TCIV.civ_inference_many(LearnedModel.from_numpy(arrays, "cpu", torch.float64),
                                   specs, samples, params)
    for (p, n, c), (p64, n64, c64) in zip(got, want):
        scale = max(abs(n64), abs(c64))
        assert abs(n - n64) <= REL_F32_EVIDENCE * scale
        assert abs(c - c64) <= REL_F32_EVIDENCE * scale
        assert abs(p - p64) <= 1e-3


def test_civ_golden_fixture_layout():
    """Keys, shapes and dtypes of the full-width CIV fixture (written by
    scripts/make_torch_golden.py civ; replayed on the card by
    chip_smoke.py), and its spectra as the port regenerates them."""
    g = np.load(GOLDEN)
    n = 8
    expect = {
        "z_qso": np.float64, "obs_seed": np.int64, "injected": np.bool_,
        "civ_z": np.float64, "civ_log_n": np.float64, "civ_sigma": np.float64,
        "log_evidence_null": np.float64, "log_evidence_civ": np.float64, "p_civ": np.float64,
    }
    assert set(g.files) == set(expect)
    for key, dtype in expect.items():
        assert g[key].shape == (n,) and g[key].dtype == dtype, key
    assert list(g["injected"]) == [bool(i % 2) for i in range(n)]
    assert np.isnan(g["civ_z"][~g["injected"]]).all()
    # each injected doublet lies in the search range of its spectrum
    params = CIVParameters()
    arrays = synthetic_learned_model(params)
    for z, seed, inj, zc in zip(g["z_qso"], g["obs_seed"], g["injected"], g["civ_z"]):
        spec = synthetic_civ_spectrum(params, arrays, float(z), int(seed))
        assert spec.flux.shape == (params.num_pixels_padded,)
        if inj:
            assert spec.min_z_dla < zc < spec.max_z_dla
    p = np.array([JCIV.civ_model_posterior(a, b) for a, b in
                  zip(g["log_evidence_null"], g["log_evidence_civ"])])
    np.testing.assert_array_equal(p, g["p_civ"])
