"""The port's CLI twins end to end on the CPU against the JAX CLIs.

The same synthetic speclite FITS files (one name in the list missing) go
through ``gpy_dla_detection_tpu.run_bayes_select`` / ``run_find_lls`` /
``run_civ`` and their twins in ``gpy_dla_detection_tpu_torch`` with
``--device cpu``, and the HDF5 files are compared dataset by dataset:

* at float64 (the JAX CLI's raw transport and exact configuration off the
  TPU, the port's exact path): the same names, shapes and dtypes, every
  number within ``REL_F64`` of its dataset's largest magnitude (the
  probabilities within twice that of the largest |log evidence|), NaN
  where the other has NaN, and ``base_sample_inds``, ``qso_list`` and
  ``all_exceptions`` equal.  Chained levels draw from different PRNGs, so
  the JAX catalog's resampling indices are fed to the twin by wrapping its
  ``dispatch_batch`` (catalog) or ``lls_inference_many`` (LLS) in the test;
* the port's float32 catalog (the kernels' twins) against the JAX float64
  catalog at the golden tolerance: log evidences within ``REL_F32`` of the
  spectrum's largest |log evidence|, |dp_dla| <= 1e-3, the same argmax.

Also: checkpoint and resume bit for bit, the refusal of another
``--batch-size``, ``--no-sample-lls``, the metrics sidecar, the reference's
``GPY_DLA_*`` flags as arguments (``cli_config``), the systematic
resampler through the CLI, ``--device cuda`` without a card, and the three
twins in a process where ``jax`` and the JAX package cannot be imported.
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu import run_bayes_select as J_rbs
from gpy_dla_detection_tpu import run_civ as J_civ
from gpy_dla_detection_tpu import run_find_lls as J_lls
from gpy_dla_detection_tpu.models import lls as J_lls_model
from gpy_dla_detection_tpu_torch import cli_config
from gpy_dla_detection_tpu_torch import run_bayes_select as T_rbs
from gpy_dla_detection_tpu_torch import run_civ as T_civ
from gpy_dla_detection_tpu_torch import run_find_lls as T_lls
from gpy_dla_detection_tpu_torch.data.synthetic import (
    civ_doublet_transmission,
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.params import CIVParameters, Parameters
from gpy_dla_detection_tpu_torch.utils.metrics import read_metrics

from .test_fits import _write_speclite

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
S = 60
Z_QSOS = (2.9, 3.15, 3.3, 2.8, 3.05)
MISSING = "spec-0001-55555-9999.fits"  # listed, never written
REL_F64 = 1e-10
REL_F32 = 1e-4
ABS_F32_P_DLA = 1e-3
PER_SAMPLE = ("sample_log_likelihoods_dla", "sample_log_likelihoods_lls", "base_sample_inds")
EXACT = ("base_sample_inds", "qso_list", "all_exceptions")
PROBABILITIES = ("model_posteriors", "p_dlas", "p_no_dlas", "p_civs")


def _write(path, wl, flux, nv, pm):
    _write_speclite(
        str(path), flux.astype(np.float32), np.log10(wl).astype(np.float32),
        (1.0 / nv).astype(np.float32), np.where(pm, 1 << 24, 0).astype(np.int32),
    )
    return str(path)


@pytest.fixture(scope="module")
def spectra(tmp_path_factory):
    """Five DLA-catalog spectra (odd ones with a DLA at z_qso - 0.3,
    logNHI 21.2) and the missing name; two CIV spectra, the second with a
    doublet."""
    d = tmp_path_factory.mktemp("fits")
    params = Parameters(num_dla_samples=S)
    learned = synthetic_learned_model(params)
    files = [
        _write(d / f"spec-0001-55555-{i:04d}.fits", *synthetic_observation(
            params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i % 2 else None))
        for i, z in enumerate(Z_QSOS)
    ]
    files.insert(3, str(d / MISSING))
    zs = list(Z_QSOS[:3]) + [3.1] + list(Z_QSOS[3:])
    civ_params = CIVParameters(num_civ_samples=S)
    civ_learned = synthetic_learned_model(civ_params)
    civ_files = []
    for i, civ in enumerate((None, (2.05, 14.4, 2.5e6))):
        wl, fx, nv, pm = synthetic_observation(civ_params, civ_learned, 2.2, seed=5 + i)
        if civ is not None:
            fx = fx * civ_doublet_transmission(wl, *civ)
        civ_files.append(_write(d / f"spec-0004-55555-{i:04d}.fits", wl, fx, nv, pm))
    return d, files, [str(z) for z in zs], civ_files


def _catalog_argv(spectra, out, max_dlas, *extra):
    _, files, zs, _ = spectra
    return ["--qso_list", *files, "--z_qso_list", *zs, "--max_dlas", str(max_dlas),
            "--num-samples", str(S), "--batch-size", "2", "--output", str(out), *extra]


@pytest.fixture(scope="module")
def jax_catalogs(spectra):
    """The JAX CLI's float64 catalogs at max_dlas 1 and 3."""
    d = spectra[0]
    out = {}
    for max_dlas in (1, 3):
        out[max_dlas] = d / f"jax_{max_dlas}.h5"
        J_rbs.main(_catalog_argv(spectra, out[max_dlas], max_dlas, "--dtype", "float64"))
    return out


def _feed_jax_indices(monkeypatch, jax_file):
    """Wrap the twin's ``dispatch_batch`` so that each batch replays the
    JAX catalog's resampling indices of its spectra, in catalog order."""
    with h5py.File(jax_file) as f:
        inds = f["base_sample_inds"][()].transpose(0, 2, 1)  # (n, max_dlas - 1, S)
    real, taken = T_rbs.dispatch_batch, []

    def feeding(inputs, specs, *args, **kw):
        first = len(taken)
        taken.extend(range(first, first + len(specs)))
        kw["base_inds_override"] = inds[first:first + len(specs)]
        return real(inputs, specs, *args, **kw)

    monkeypatch.setattr(T_rbs, "dispatch_batch", feeding)
    return taken


def _datasets(path):
    with h5py.File(path) as f:
        return {name: f[name][()] for name in f}


def _assert_same_catalog(got_path, want_path, rel=REL_F64, exact=EXACT):
    """Names, shapes and dtypes equal; ``exact`` datasets and integers
    equal; NaN where the other has NaN; every other number within ``rel``
    of its dataset's largest magnitude, except the probabilities: a
    posterior's error is at most twice the log evidences' absolute error,
    so they are held to ``2 rel`` of the catalog's largest |log evidence|."""
    got, want = _datasets(got_path), _datasets(want_path)
    assert sorted(got) == sorted(want)
    evidence_scale = max(np.abs(w).max() for n, w in want.items()
                         if n.startswith("log_likelihoods") or n == "log_evidences")
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape, g.dtype, w.dtype)
        if name in exact or g.dtype.kind not in "fc":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        scale = np.nanmax(np.abs(w)) if np.isfinite(w).any() else 0.0
        atol = 2 * rel * evidence_scale if name in PROBABILITIES else rel * scale
        np.testing.assert_allclose(g, w, rtol=rel, atol=atol, err_msg=name)


@pytest.mark.parametrize("max_dlas", [1, 3])
def test_catalog_cli_matches_jax_float64(spectra, jax_catalogs, monkeypatch, max_dlas):
    """Dataset by dataset at float64; at max_dlas 3 with the JAX indices."""
    out = spectra[0] / f"torch_{max_dlas}.h5"
    taken = _feed_jax_indices(monkeypatch, jax_catalogs[max_dlas]) if max_dlas > 1 else None
    T_rbs.main(_catalog_argv(spectra, out, max_dlas, "--dtype", "float64", "--device", "cpu"))
    if taken is not None:
        assert taken == list(range(len(Z_QSOS)))
    _assert_same_catalog(out, jax_catalogs[max_dlas])
    with h5py.File(out) as f:
        assert list(f["all_exceptions"][()]) == [3]
        assert f["p_dlas"][()][[1, 3]].min() > 0.5  # the injected DLAs


def test_catalog_cli_float32_matches_jax_float64(spectra, jax_catalogs, monkeypatch):
    """The port's float32 catalog (the kernels' twins on the CPU) against
    the JAX float64 one with the same indices, at the golden tolerance."""
    out = spectra[0] / "torch_f32.h5"
    _feed_jax_indices(monkeypatch, jax_catalogs[3])
    T_rbs.main(_catalog_argv(spectra, out, 3, "--device", "cpu"))
    got, want = _datasets(out), _datasets(jax_catalogs[3])
    np.testing.assert_array_equal(got["base_sample_inds"], want["base_sample_inds"])
    assert got["log_likelihoods_dla"].dtype == np.float32
    names = ("log_likelihoods_no_dla", "log_likelihoods_lls", "log_likelihoods_dla")
    for i in range(len(Z_QSOS)):
        ev = lambda d: np.concatenate([np.ravel(d[n][i]) for n in names]).astype(np.float64)
        scale = np.abs(ev(want)).max()
        np.testing.assert_allclose(ev(got), ev(want), rtol=0, atol=REL_F32 * scale)
        assert abs(got["p_dlas"][i] - want["p_dlas"][i]) <= ABS_F32_P_DLA
        assert np.argmax(got["model_posteriors"][i]) == np.argmax(want["model_posteriors"][i])


@pytest.fixture(scope="module")
def checkpointed(spectra):
    """The port's float32 catalog at max_dlas 2 with --checkpoint."""
    out = spectra[0] / "ckpt.h5"
    argv = _catalog_argv(spectra, out, 2, "--device", "cpu", "--checkpoint")
    T_rbs.main(argv)
    return argv, out, _datasets(out)


def _assert_bitwise(got, want):
    """Every dataset of ``got`` equal to ``want``'s, bit for bit."""
    for name, g in got.items():
        np.testing.assert_array_equal(g, want[name], err_msg=name)
        assert g.dtype == want[name].dtype, name


def test_checkpoint_resume_bit_for_bit(spectra, checkpointed, monkeypatch):
    """Deleting one part file and rerunning recomputes that batch alone,
    and the catalog equals the uninterrupted run's bit for bit; another
    --batch-size is refused."""
    argv, out, first = checkpointed
    parts = sorted(p for p in os.listdir(spectra[0]) if p.startswith("ckpt.h5.part"))
    assert len(parts) == 3  # batches of 2: [0, 1], [2, missing], [4, 5]
    calls = []
    os.remove(spectra[0] / parts[1])
    os.remove(out)
    real = T_rbs.dispatch_batch
    monkeypatch.setattr(T_rbs, "dispatch_batch",
                        lambda *a, **kw: calls.append(len(a[1])) or real(*a, **kw))
    T_rbs.main(argv)
    assert calls == [1]  # only the batch whose part went
    resumed = _datasets(out)
    assert sorted(resumed) == sorted(first)
    _assert_bitwise(resumed, first)

    bad = list(argv)
    bad[bad.index("--batch-size") + 1] = "4"
    with pytest.raises(SystemExit, match="different --batch-size"):
        T_rbs.main(bad)


def test_no_sample_lls_bit_for_bit(spectra, checkpointed):
    """Catalog-lite: evidences, MAPs and posteriors bit for bit the full
    run's; the three per-sample datasets absent."""
    _, _, full = checkpointed
    out = spectra[0] / "lite.h5"
    T_rbs.main(_catalog_argv(spectra, out, 2, "--device", "cpu", "--no-sample-lls"))
    lite = _datasets(out)
    assert not set(PER_SAMPLE) & set(lite) and set(PER_SAMPLE) <= set(full)
    assert sorted(lite) == sorted(set(full) - set(PER_SAMPLE))
    _assert_bitwise(lite, full)


def test_metrics_sidecar_events(checkpointed):
    _, out, _ = checkpointed
    events = read_metrics(str(out) + ".metrics.jsonl")
    # the sidecar appends: the checkpointed run's events come first
    kinds = [e["event"] for e in events]
    events = events[:kinds.index("run_end") + 1]
    kinds = kinds[:len(events)]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("spectrum_failed") == 1 and kinds.count("batch_done") == 3
    config = events[0]["config"]
    assert config == dict(num_spectra=len(Z_QSOS) + 1, max_dlas=2, batch_size=2,
                          num_samples=S, dtype="float32", devices=1)
    assert events[-1]["spectra_processed"] == len(Z_QSOS) and events[-1]["spectra_failed"] == 1
    batches = [e for e in events if e["event"] == "batch_done"]
    assert [b["spectra_done"] for b in batches] == [2, 3, 5]
    assert all(b["spectra_per_sec"] > 0 and b["span_seconds"] >= 0 for b in batches)


def test_systematic_resampler_through_the_cli(spectra, monkeypatch):
    """GPY_DLA_RESAMPLER=systematic reaches the draws: the injected DLAs
    are still found, and every chained level's indices are one rotation of
    an ascending comb."""
    monkeypatch.setenv("GPY_DLA_RESAMPLER", "systematic")
    out = spectra[0] / "sys.h5"
    T_rbs.main(_catalog_argv(spectra, out, 3, "--device", "cpu"))
    got = _datasets(out)
    assert got["p_dlas"][[1, 3]].min() > 0.5
    for row in got["base_sample_inds"].transpose(0, 2, 1).reshape(-1, S):
        assert int(np.sum(np.diff(row.astype(np.int64)) < 0)) <= 1


@pytest.mark.parametrize("env, want", [
    ({}, cli_config.KernelOptions()),
    ({"GPY_DLA_FAST_VOIGT": "0", "GPY_DLA_FUSED_ABS": "0"}, cli_config.KernelOptions("exact")),
    ({"GPY_DLA_FUSED_ABS": "0", "GPY_DLA_FUSED_POLY": "0"},
     cli_config.KernelOptions("windowed_unfused")),
    ({"GPY_DLA_FUSED_POLY": "0"}, cli_config.KernelOptions("windowed_weideman")),
    ({"GPY_DLA_WINDOW_TIER": "0", "GPY_DLA_FUSED_ABS": "0"},
     cli_config.KernelOptions("windowed_unfused", window_tier=False)),
    ({"GPY_DLA_ABS_DTYPE": "i16"}, cli_config.KernelOptions(abs_dtype=torch.int16)),
    ({"GPY_DLA_ABS_DTYPE": "i16p"}, cli_config.KernelOptions(abs_dtype=torch.int16)),
    ({"GPY_DLA_ABS_DTYPE": "f32"}, cli_config.KernelOptions()),
    ({"GPY_DLA_RESAMPLER": "systematic"}, cli_config.KernelOptions(resampler="systematic")),
    ({"GPY_DLA_USE_PALLAS": "0"}, cli_config.KernelOptions(use_kernels=False)),
])
def test_kernel_flags_map_to_arguments(env, want):
    assert cli_config.kernel_options(torch.float32, env) == want
    # float64 is the conformance path: it keeps its own storage
    assert cli_config.kernel_options(torch.float64, env) == want._replace(abs_dtype=None)


@pytest.mark.parametrize("env, message", [
    ({"GPY_DLA_ABS_DTYPE": "bf16"}, "GPY_DLA_ABS_DTYPE must be 'f32', 'i16' or 'i16p', got 'bf16'"),
    ({"GPY_DLA_RESAMPLER": "stratified"},
     "GPY_DLA_RESAMPLER must be 'multinomial' or 'systematic', got 'stratified'"),
])
def test_kernel_flags_refuse_bad_values(env, message, spectra, monkeypatch, capsys):
    with pytest.raises(ValueError) as e:
        cli_config.kernel_options(torch.float32, env)
    assert str(e.value) == message
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit) as e:
        T_rbs.run(_catalog_argv(spectra, spectra[0] / "bad.h5", 1, "--device", "cpu"))
    assert e.value.code == 2 and message in capsys.readouterr().err


@pytest.mark.parametrize("module", [T_rbs, T_lls, T_civ], ids=["catalog", "lls", "civ"])
def test_cuda_without_a_card_fails(module, spectra, monkeypatch, capsys):
    """``--device cuda`` (the default) without a card exits non-zero before
    anything runs: no spectrum read, nothing dispatched, no file written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    read = []
    monkeypatch.setattr(module, "spec_reader", lambda release: read.append(release))
    out = spectra[0] / f"nocard_{module.__name__.rsplit('.', 1)[1]}.h5"
    files, zs = (spectra[3][:1], ["2.2"]) if module is T_civ else (spectra[1][:1], spectra[2][:1])
    with pytest.raises(SystemExit) as e:
        module.main(["--qso_list", *files, "--z_qso_list", *zs, "--output", str(out)])
    assert e.value.code != 0 and "no CUDA device" in capsys.readouterr().err
    assert read == [] and not os.path.exists(out) and not os.path.exists(f"{out}.metrics.jsonl")


def test_float64_on_the_card_is_refused(spectra, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as e:
        T_rbs.run(_catalog_argv(spectra, spectra[0] / "f64.h5", 1, "--dtype", "float64"))
    assert e.value.code == 2 and "float64 runs on the CPU only" in capsys.readouterr().err


def _lls_argv(spectra, out, max_lya):
    _, files, zs, _ = spectra
    keep = [i for i, f in enumerate(files) if MISSING not in f][:3]
    return ["--qso_list", *[files[i] for i in keep], "--z_qso_list", *[zs[i] for i in keep],
            "--max-lya", str(max_lya), "--num-samples", str(S), "--output", str(out)]


@pytest.mark.parametrize("max_lya", [1, 2])
def test_lls_cli_matches_jax_float64(spectra, monkeypatch, max_lya):
    """The LLS catalog at float64 (``--device cpu``); at max_lya 2 with the
    resampling indices the JAX run drew, fed to the twin's search."""
    d = spectra[0]
    jax_outs = []
    real_jax = J_lls_model.lls_inference_many
    monkeypatch.setattr(J_lls_model, "lls_inference_many",
                        lambda *a, **kw: jax_outs.extend(real_jax(*a, **kw)) or jax_outs)
    J_lls.main(_lls_argv(spectra, d / f"jax_lls_{max_lya}.h5", max_lya))
    inds = np.stack([np.asarray(r.base_sample_inds) for _, r in jax_outs])
    real_port = T_lls.lls_inference_many
    monkeypatch.setattr(T_lls, "lls_inference_many",
                        lambda *a, **kw: real_port(*a, base_inds_override=inds, **kw))
    T_lls.main(_lls_argv(spectra, d / f"torch_lls_{max_lya}.h5", max_lya) + ["--device", "cpu"])
    _assert_same_catalog(d / f"torch_lls_{max_lya}.h5", d / f"jax_lls_{max_lya}.h5",
                         exact=("qso_list",))


def test_civ_cli_matches_jax_float64(spectra, capsys):
    """The CIV catalog's p_civs and log evidences at float64; the doublet
    is found; ``--mcmc-steps`` runs the chain (a smoke)."""
    d, civ_files = spectra[0], spectra[3]
    argv = ["--qso_list", *civ_files, "--z_qso_list", "2.2", "2.2", "--num-samples", str(S)]
    J_civ.main(argv + ["--output", str(d / "jax_civ.h5")])
    T_civ.main(argv + ["--output", str(d / "torch_civ.h5"), "--device", "cpu"])
    _assert_same_catalog(d / "torch_civ.h5", d / "jax_civ.h5", exact=("qso_list",))
    with h5py.File(d / "torch_civ.h5") as f:
        assert f["p_civs"][0] < 0.5 < f["p_civs"][1] and f["log_evidences"].shape == (2, 2)
    capsys.readouterr()
    out = T_civ.run(argv[:2] + ["--z_qso_list", "2.2", "--num-samples", str(S),
                                "--mcmc-steps", "8", "--device", "cpu"])
    assert np.isfinite(out.arrays["log_evidences"]).all()
    assert "MCMC: z = " in capsys.readouterr().out


def test_cli_twins_run_without_jax(spectra):
    """With ``jax`` and the JAX package blocked, the three twins run on the
    CPU and write their catalogs."""
    d, files, zs, civ_files = spectra
    keep = [i for i, f in enumerate(files) if MISSING not in f][:2]
    common = ["--qso_list", *[files[i] for i in keep], "--z_qso_list",
              *[zs[i] for i in keep], "--num-samples", str(S), "--device", "cpu"]
    runs = {
        "run_bayes_select": common + ["--max_dlas", "2", "--output", str(d / "nojax_c.h5")],
        "run_find_lls": common + ["--max-lya", "2", "--output", str(d / "nojax_l.h5")],
        "run_civ": ["--qso_list", civ_files[1], "--z_qso_list", "2.2", "--num-samples", str(S),
                    "--device", "cpu", "--output", str(d / "nojax_v.h5")],
    }
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
for name, argv in {runs!r}.items():
    importlib.import_module("gpy_dla_detection_tpu_torch." + name).main(argv)
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu"))]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    for name in ("nojax_c.h5", "nojax_l.h5", "nojax_v.h5"):
        with h5py.File(d / name) as f:
            assert len(f["qso_list"][()]) >= 1
