"""``scripts/accuracy_gates_torch.py`` against the JAX package on the same
seeded spectra (the gates' own observation streams), at a few spectra a
head and a few hundred samples, float64 on both sides:

* zQSO: the MAP redshifts of ``zqso_outputs`` equal the JAX package's
  ``inference_z_qso_many`` on the same observations (the float64 rule of
  ``tests/test_torch_zqso.py``);
* LLS: the null and the level-1 log evidence (no resampling draw, so the
  two generators do not enter) within 1e-9 relative, the LLS float64
  tolerance of ``tests/test_torch_lls.py``; the decision P(LLS|D) > 0.5
  equal on every spectrum whose JAX p_lls lies outside [0.4, 0.6] (the
  generators differ from level 2 on);
* CIV: (p_civ, null, CIV evidence) within 1e-9 relative of the JAX
  package's ``civ_inference_many``, ``tests/test_torch_civ.py``'s
  ``REL_F64_MANY_VS_JAX``;
* the report: the JAX script's keys and completeness bins
  (``ACCURACY.json``) and its pass/fail rule, and ``--device cuda``
  refused at parsing without a card.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.data.spectrum import preprocess as J_preprocess
from gpy_dla_detection_tpu.data.synthetic import synthetic_learned_model as J_learned
from gpy_dla_detection_tpu.models import civ as JCIV
from gpy_dla_detection_tpu.models import lls as JL
from gpy_dla_detection_tpu.models import zqso as JZ
from gpy_dla_detection_tpu.params import CIVParameters as JCIVParameters
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu.params import ZParameters as JZParameters

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
REL_F64 = 1e-9
N = 6
SAMPLES = 300


@pytest.fixture(scope="module")
def gates():
    spec = importlib.util.spec_from_file_location(
        "accuracy_gates_torch", ROOT / "scripts" / "accuracy_gates_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_zqso_z_map_equals_jax(gates):
    got = gates.zqso_outputs(4, "cpu", torch.float64, SAMPLES)
    z_true, learned, obs = gates.zqso_observations(4)
    jparams = JZParameters(num_zqso_samples=SAMPLES)
    results, _ = JZ.inference_z_qso_many(
        JZ.ZLearnedModel(*learned),
        [JZ.prepare_z_spectrum(*o, jparams.num_pixels_padded) for o in obs], jparams)
    np.testing.assert_array_equal(got["z_true"], z_true)
    np.testing.assert_array_equal(got["z_map"], np.array([r[0] for r in results]))
    assert (np.abs(got["z_map"] - z_true) < 0.5).all()


def test_lls_level_one_and_decisions_match_jax(gates):
    got = gates.lls_outputs(N, "cpu", torch.float64, SAMPLES)
    jparams = JParameters()
    injected, log_nhis, _, obs = gates.lls_observations(N, jparams)
    out = JL.lls_inference_many(
        J_learned(jparams), [J_preprocess(*o, z, jparams) for z, o in obs],
        JL.generate_lya_samples(num_samples=SAMPLES), jax.random.PRNGKey(0), 2, jparams)
    j_null = np.array([float(n) for n, _ in out])
    j_evs = np.stack([np.asarray(r.log_evidences, np.float64) for _, r in out])
    j_p = np.array([1.0 - JL.lls_model_posteriors(a, b)[0] for a, b in zip(j_null, j_evs)])
    np.testing.assert_array_equal(got["injected"], injected)
    np.testing.assert_array_equal(got["log_nhis"], log_nhis)
    np.testing.assert_allclose(got["null"], j_null, rtol=REL_F64, atol=0)
    np.testing.assert_allclose(got["log_evidences"][:, 0], j_evs[:, 0], rtol=REL_F64, atol=0)
    clear = (j_p < 0.4) | (j_p > 0.6)
    assert clear.sum() >= N - 1
    np.testing.assert_array_equal((got["p_lls"] > 0.5)[clear], (j_p > 0.5)[clear])


def test_civ_outputs_match_jax(gates):
    got = gates.civ_outputs(N, "cpu", torch.float64, SAMPLES)
    jparams = JCIVParameters(num_civ_samples=SAMPLES)
    injected, _, _, obs = gates.civ_observations(N, jparams)
    want = JCIV.civ_inference_many(J_learned(jparams),
                                   [J_preprocess(*o, z, jparams) for z, o in obs],
                                   JCIV.generate_civ_samples(jparams), jparams)
    np.testing.assert_array_equal(got["injected"], injected)
    np.testing.assert_allclose(np.c_[got["p_civ"], got["null"], got["civ"]],
                               np.asarray(want, np.float64), rtol=REL_F64, atol=0)


def test_report_keys_and_rule_as_the_jax_script(gates, tmp_path, capsys):
    out = tmp_path / "acc.json"
    report, ok = gates.main(["--device", "cpu", "--n-zqso", "2", "--n-lls", "4", "--n-civ", "4",
                             "--num-samples", "200", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    want = json.loads((ROOT / "ACCURACY.json").read_text())
    for gate in ("zqso", "lls", "civ"):
        assert set(report[gate]) == set(want[gate]), gate
    for gate in ("lls", "civ"):
        assert list(report[gate]["completeness_curve"]) == list(want[gate]["completeness_curve"])
    assert report["card"] == "cpu" and ok == gates.gates_pass(report)
    assert gates.gates_pass({k: want[k] for k in ("zqso", "lls", "civ")})
    assert ("GATES: PASS" if ok else "GATES: FAIL") in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            gates.main(["--out", str(out)])
        assert e.value.code == 2
