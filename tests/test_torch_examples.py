"""The port's four examples (``examples/*_torch.py``) at reduced sizes on
the CPU (float64), their figures written into ``tmp_path``:

* ``zqso_demo_torch``: every MAP redshift within 0.5 of the truth and
  equal to the JAX package's ``inference_z_qso`` on the same observations
  (the float64 rule of ``tests/test_torch_zqso.py``);
* ``demo_synthetic_torch``: the training loss falls, the injected DLA is
  found and the clean spectrum not, the chain and the MAP-absorbed mean
  finite;
* ``civ_mcmc_demo_torch``: the injected doublet is found;
* ``lls_walkthrough_torch``: the prior integrates to 1 within 1e-6, the
  injected absorber is found at its redshift;
* a run that would draw stops at its argument parsing where matplotlib
  does not import (exit 2, the message naming ``--no-plots``, nothing
  written), and with ``--no-plots`` runs without importing it.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.models import zqso as JZ
from gpy_dla_detection_tpu.params import ZParameters as JZParameters
from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_z_observation

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ZQSO_SAMPLES = 300
# each example's reduced run on the CPU: its arguments, and the option
# naming its output directory (None: a positional argument)
EXAMPLES = {
    "zqso_demo_torch": (["--num-samples", str(ZQSO_SAMPLES)], None),
    "demo_synthetic_torch": (["--num-spectra", "2", "--num-samples", "100", "--train-iters",
                              "3", "--mcmc-steps", "16"], "--out-dir"),
    "civ_mcmc_demo_torch": (["--num-samples", "300", "--mcmc-steps", "40"], None),
    "lls_walkthrough_torch": (["--num-samples", "1000"], None),
}
FIGURES = {
    "zqso_demo_torch": ["zqso_scan.png"],
    "demo_synthetic_torch": ["corner.png", "dla_model.png"],
    "civ_mcmc_demo_torch": ["civ_corner.png"],
    "lls_walkthrough_torch": ["lls_fit.png", "lls_prior.png", "lls_samples.png"],
}


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _argv(name, out, *extra):
    args, out_option = EXAMPLES[name]
    where = [out_option, str(out)] if out_option else [str(out)]
    return [*where, "--device", "cpu", *args, *extra]


def _run(name, out, *extra):
    return _example(name).main(_argv(name, out, *extra))


def test_zqso_demo_matches_jax(tmp_path):
    z_maps = _run("zqso_demo_torch", tmp_path)
    jparams = JZParameters(num_zqso_samples=ZQSO_SAMPLES)
    want = []
    for z_true in (2.5, 3.1, 4.0):
        learned, obs = synthetic_z_observation(z_true, seed=1)
        want.append(JZ.inference_z_qso(JZ.ZLearnedModel(*learned),
                                       JZ.prepare_z_spectrum(*obs, jparams.num_pixels_padded),
                                       jparams)[0])
    assert z_maps == want
    assert np.all(np.abs(np.array(z_maps) - [2.5, 3.1, 4.0]) < 0.5)
    assert sorted(p.name for p in tmp_path.iterdir()) == FIGURES["zqso_demo_torch"]


def test_demo_synthetic(tmp_path):
    out = _run("demo_synthetic_torch", tmp_path)
    losses = out["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    (clean, injected) = out["results"]
    assert out["injected"][0] is None and out["injected"][1] is not None
    assert injected.p_dla > 0.5 and clean.p_dla < 0.5
    assert np.isfinite(out["chain"]).all() and out["chain"].shape == (16, 32, 2)
    assert np.isfinite(out["fit"]).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == FIGURES["demo_synthetic_torch"]


def test_civ_mcmc_demo(tmp_path):
    out = _run("civ_mcmc_demo_torch", tmp_path)
    assert out["p_civ"] > 0.5
    assert np.isfinite(out["chain"]).all() and 0.0 < out["acceptance"] < 1.0
    assert sorted(p.name for p in tmp_path.iterdir()) == FIGURES["civ_mcmc_demo_torch"]


def test_lls_walkthrough(tmp_path):
    out = _run("lls_walkthrough_torch", tmp_path)
    assert abs(out["norm"] - 1.0) < 1e-6
    assert out["p_lls"] > 0.99 and abs(out["map_z"] - 3.15) < 0.02
    assert np.isfinite(out["fit"]).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == FIGURES["lls_walkthrough_torch"]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_drawing_needs_matplotlib_and_no_plots_does_not(name, tmp_path, monkeypatch, capsys):
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the import raises
    module = _example(name)
    with pytest.raises(SystemExit) as e:
        module.main(_argv(name, tmp_path / "refused"))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "draws with matplotlib, which does not import here" in err and "--no-plots" in err
    assert not (tmp_path / "refused").exists()
    if name == "zqso_demo_torch":  # the quickest: run it without matplotlib
        module.main(_argv(name, tmp_path / "quiet", "--no-plots"))
        assert list((tmp_path / "quiet").iterdir()) == []
        assert sys.modules["matplotlib"] is None
