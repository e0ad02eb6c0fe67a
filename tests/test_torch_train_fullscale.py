"""The port's reference-scale training script against the JAX package's.

``scripts/train_fullscale_torch.py`` against ``scripts/train_fullscale.py``
and ``gpy_dla_detection_tpu.models.training`` on the CPU, both scripts
loaded by path:

* the chunked, shifted objective in float64 at ``Parameters(k=4)``, Q =
  24, chunks 1, 3 and 4: the restored value against JAX's float64
  ``total_objective`` (rtol 1e-10), the five gradient blocks against
  ``jax.grad`` (within 1e-8 of each block's max|g|); the checkpointed
  chunks' twin calls (a chunk's forward twice, its backward once);
* the same objective in float32 against the JAX script's own
  ``chunked_objective_factory``: the value within 1e-5 of sum|loss_i|,
  the gradients within 1e-4 of each block's max|g|;
* ``mean_spectrum_loss``, ``stage_split``, ``generate_observations`` (bit
  for bit) and the ``--cache`` npz across the packages;
* ``fit_two_stage``'s restart: two optimizers, stage B starting where
  stage A ended;
* ``detection_gate`` at a reduced ``Parameters`` with a perturbed model:
  the null-evidence deltas within 1e-4 of max|log evidence| of JAX's
  float32 gate; the sampled fields by type and range (the PRNGs differ);
* ``main`` on the CPU end to end, and its refusal without a card;
* ``scripts/train_throughput_torch.py`` at Q = 16, 2 iterations.
"""

import ast
import importlib.util
import json
import os
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.data import synthetic as JSyn
from gpy_dla_detection_tpu.models import training as JT
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch.data import synthetic as TSyn
from gpy_dla_detection_tpu_torch.models import training as TT
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
from gpy_dla_detection_tpu_torch.ops import logmvn_kernels as LK
from gpy_dla_detection_tpu_torch.params import Parameters

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT_SCRIPT = ROOT / "scripts" / "train_fullscale_torch.py"
JAX_SCRIPT = ROOT / "scripts" / "train_fullscale.py"
THROUGHPUT_SCRIPT = ROOT / "scripts" / "train_throughput_torch.py"
Q = 24
K = 4
F64 = torch.float64
REL_VALUE_F64 = 1e-10
REL_GRAD_F64 = 1e-8  # of each block's max|g|
REL_VALUE_F32 = 1e-5  # of sum|loss_i|
REL_GRAD_F32 = 1e-4  # of each block's max|g|
REL_GATE_NULL = 1e-4  # of max|log evidence|, float32 against float32


def _load(path: Path, name: str):
    """The script at ``path`` as a fresh module; the environment and
    ``sys.path`` (which the scripts extend) are restored after."""
    env, path_before = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path_before
    return mod


@lru_cache(maxsize=None)
def port_script():
    return _load(PORT_SCRIPT, "train_fullscale_torch_under_test")


@lru_cache(maxsize=None)
def jax_script():
    return _load(JAX_SCRIPT, "train_fullscale_under_test")


@lru_cache(maxsize=None)
def _problem():
    """Q spectra from the generating model at k = 4 through the port's
    generation, preparation and initialization (float64): the fields of
    the initial parameters and the fit's arrays."""
    params = Parameters(k=K)
    learned = TSyn.synthetic_learned_model(params)
    wl, fx, nv, pm, zs = port_script().generate_observations(params, learned, Q)
    train = TT.prepare_training_set(params, wl, fx, nv, pm, zs)
    mu, p0 = TT.initialize(params, train, "cpu", F64)
    arrays = (np.where(train.mask, train.flux - mu, 0.0), train.lya_1pz,
              train.noise_variance, train.mask, train.zqso_1pz)
    return p0.numpy(), arrays


def _port(dtype):
    fields, arrays = _problem()
    p = TT.TrainingParams.from_numpy(fields, "cpu", dtype)
    return p, [torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else dtype)
               for a in arrays]


def _jax(dtype):
    fields, arrays = _problem()
    jp = JT.TrainingParams(*[jnp.asarray(f, dtype) for f in fields])
    return jp, tuple(jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, dtype)
                     for a in arrays)


def _grads(p):
    return {n: getattr(p, n).grad.double().numpy() for n in TT.PARAM_FIELDS}


def _assert_grads(got: dict, want, rel):
    for name in TT.PARAM_FIELDS:
        w = np.asarray(getattr(want, name), np.float64)
        err = np.abs(got[name] - w).max() / np.abs(w).max()
        assert err <= rel, (name, err)


@pytest.mark.parametrize("chunks", [1, 3, 4])
def test_chunked_objective_float64_matches_jax(chunks, monkeypatch):
    """The restored chunked value equals JAX's float64 total_objective and
    its gradients ``jax.grad``'s; under non-reentrant checkpointing each
    chunk runs K3's twin twice (the forward and its recomputation) and the
    adjoint's once."""
    m = port_script()
    p, t = _port(F64)
    shift = m.mean_spectrum_loss((p, *t), Parameters(k=K), chunks)
    calls = {"forward": 0, "backward": 0}
    forward, backward = LK._ChainLoglik.forward, LK._ChainLoglik.backward

    def counted(name, fn):
        def wrapper(ctx, *args):
            calls[name] += 1
            return fn(ctx, *args)
        return staticmethod(wrapper)

    monkeypatch.setattr(LK._ChainLoglik, "forward", counted("forward", forward))
    monkeypatch.setattr(LK._ChainLoglik, "backward", counted("backward", backward))
    value = m.chunked_objective_factory(chunks, shift)(p, *t, Parameters(k=K))
    value.backward()
    assert value.dtype == F64
    assert calls == {"forward": 2 * chunks, "backward": chunks}

    jp, ja = _jax(jnp.float64)
    jparams = JParameters(k=K)
    want, g_want = jax.value_and_grad(lambda pp: JT.total_objective(pp, *ja, jparams))(jp)
    np.testing.assert_allclose(float(value.detach()) + Q * shift, float(want),
                               rtol=REL_VALUE_F64)
    _assert_grads(_grads(p), g_want, REL_GRAD_F64)


def test_chunked_objective_refuses_uneven_chunks():
    p, t = _port(F64)
    with pytest.raises(ValueError, match="do not split into 5 chunks"):
        port_script().chunked_objective_factory(5, 0.0)(p, *t, Parameters(k=K))


@pytest.mark.parametrize("chunks", [1, 3, 4])
def test_chunked_objective_float32_matches_jax_script(chunks):
    """In float32, the port's chunked objective against the JAX script's
    (a ``jax.checkpoint`` scan with a float32 carry) at the same shift."""
    m, jm = port_script(), jax_script()
    params, jparams = Parameters(k=K), JParameters(k=K)
    jp, ja = _jax(jnp.float32)
    shift = jm.mean_spectrum_loss((jp, *ja), jparams, chunks)
    want, g_want = jax.value_and_grad(
        lambda pp: jm.chunked_objective_factory(chunks, shift)(pp, *ja, jparams))(jp)
    jp64, ja64 = _jax(jnp.float64)
    losses = np.asarray(JT.batched_spectrum_losses(jp64, *ja64, params.num_forest_lines))

    p, t = _port(torch.float32)
    value = m.chunked_objective_factory(chunks, shift)(p, *t, params)
    value.backward()
    assert value.dtype == torch.float32
    assert abs(float(value.detach()) - float(want)) <= REL_VALUE_F32 * np.abs(losses).sum()
    _assert_grads(_grads(p), g_want, REL_GRAD_F32)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mean_spectrum_loss_matches_jax(dtype):
    m, jm = port_script(), jax_script()
    p, t = _port(getattr(torch, dtype))
    got = m.mean_spectrum_loss((p, *t), Parameters(k=K), 3)
    jp, ja = _jax(getattr(jnp, dtype))
    want = jm.mean_spectrum_loss((jp, *ja), JParameters(k=K), 3)
    np.testing.assert_allclose(got, want, rtol=1e-10 if dtype == "float64" else 1e-6)


@pytest.mark.parametrize("single_stage", [False, True])
@pytest.mark.parametrize("iters", [1, 6, 100, 101, 500, 2000])
def test_stage_split_is_the_jax_rule(iters, single_stage):
    """``scripts/train_fullscale.py:317-321``: all iterations in one stage
    with --single-stage, else stage A min(iters, max(100, iters // 5))."""
    stage_a = iters if single_stage else min(iters, max(100, iters // 5))
    assert port_script().stage_split(iters, single_stage) == (stage_a, iters - stage_a)


def test_generate_observations_bit_for_bit():
    params, jparams = Parameters(), JParameters()
    got = port_script().generate_observations(params, TSyn.synthetic_learned_model(params), 8)
    want = jax_script().generate_observations(jparams, JSyn.synthetic_learned_model(jparams), 8)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 8
        for a, b in zip(g, w):
            assert np.array_equal(a, b)


def test_cache_loads_across_packages(tmp_path):
    """A cache the port writes loads as the JAX script's ``TrainingSet``,
    and one written as the JAX script writes it (``np.savez`` of
    ``TrainingSet._asdict()``) loads in the port without regenerating."""
    m, jm = port_script(), jax_script()
    params, jparams = Parameters(k=K), JParameters(k=K)
    ours = tmp_path / "port.npz"
    train, t_gen, _ = m.training_set(params, TSyn.synthetic_learned_model(params), 8, str(ours))
    with np.load(ours) as f:
        loaded = JT.TrainingSet(**{k: f[k] for k in JT.TrainingSet._fields})
    for name in JT.TrainingSet._fields:
        assert np.array_equal(getattr(loaded, name), getattr(train, name)), name

    theirs = tmp_path / "jax.npz"
    want = JT.prepare_training_set(
        jparams, *jm.generate_observations(jparams, JSyn.synthetic_learned_model(jparams), 8))
    np.savez(theirs, **want._asdict())
    got, t_gen, t_prep = m.training_set(params, None, 8, str(theirs))
    assert (t_gen, t_prep) == (0.0, 0.0)
    for name in JT.TrainingSet._fields:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


def test_fit_two_stage_restarts_at_stage_a_end(monkeypatch):
    """Two stages of two iterations in float64: a fresh L-BFGS state each,
    stage B's shift the mean loss at stage A's optimum, stage B's first
    value the true loss there, and the loss falls."""
    m = port_script()
    built = []

    class CountedState(TT.LBFGSState):
        def __init__(self, *args, **kwargs):
            built.append(self)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(TT, "LBFGSState", CountedState)
    params = Parameters(k=K)
    p0, t = _port(F64)
    p, values, stages = m.fit_two_stage(p0, t, params, 2, 2, chunks=3)
    assert len(built) == 2 and len(stages) == 2 and values.shape == (4,)
    assert all(s.evaluations >= 2 for s in stages)
    assert [len(s.evaluations_by_iteration) for s in stages] == [2, 2]
    assert np.isfinite(values).all() and values[-1] < values[0]
    # stage B starts at stage A's end (the same deterministic two
    # iterations): its first value is the true loss there, and so is its
    # start loss, Q times its shift (the mean loss) plus the priors
    p_a, _, _ = m.fit_two_stage(p0, t, params, 2, 0, chunks=3)
    end = float(TT.total_objective(p_a, *t, params).detach())
    np.testing.assert_allclose(stages[1].values[0], end, rtol=1e-10)
    np.testing.assert_allclose(stages[1].start_loss, end, rtol=1e-10)
    np.testing.assert_allclose(stages[0].start_loss, values[0], rtol=1e-10)
    assert stages[1].values[0] <= stages[0].values[-1]


def test_detection_gate_null_evidences_match_jax_float32():
    """The gate with a perturbed model at a reduced ``Parameters``: the
    null-evidence deltas (trained minus generating) within 1e-4 of
    max|log evidence| of the JAX script's float32 gate; the sampled
    numbers by type and range (the PRNGs differ)."""
    params = Parameters(num_dla_samples=64, k=6)
    jparams = JParameters(num_dla_samples=64, k=6)
    true_np = TSyn.synthetic_learned_model(params)
    bump = dict(M=true_np.M * 1.1, log_omega=true_np.log_omega + 0.05)
    trained = LearnedModel.from_numpy(true_np._replace(**bump), "cpu", torch.float32)
    got = port_script().detection_gate(params, trained, true_np, n=4)

    jtrue = JSyn.synthetic_learned_model(jparams)
    want = jax_script().detection_gate(jparams, jtrue._replace(**bump), jtrue, n=4)

    scale = np.abs(got["null_log_evidence_true"]).max()
    for key in ("null_evidence_delta_trained_minus_true_mean",
                "null_evidence_delta_trained_minus_true_max_abs"):
        assert abs(got[key] - want[key]) <= REL_GATE_NULL * scale, (key, got[key], want[key])
    assert got["null_evidence_delta_trained_minus_true_max_abs"] > 0  # the perturbation shows
    assert set(want) <= set(got)
    assert got["n_injected"] == want["n_injected"] == 2
    for key in ("detection_rate_p0.9", "false_positive_rate_p0.5"):
        assert isinstance(got[key], float) and 0.0 <= got[key] <= 1.0
    for key in ("map_z_abs_err_median", "map_z_abs_err_max"):
        assert got[key] is None or (isinstance(got[key], float) and got[key] >= 0.0)
    assert len(got["null_log_evidence_trained"]) == len(got["null_log_evidence_true"]) == 2


def _jax_artifact_keys() -> set:
    """The keys of the JAX script's artifact dict literal, from its source."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "artifact" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no artifact dict in the JAX script")


def test_main_on_the_cpu_writes_the_artifact(tmp_path):
    out = tmp_path / "train.json"
    artifact = port_script().main([
        "--device", "cpu", "--num-spectra", "32", "--chunks", "4", "--iters", "4",
        "--gate-n", "0", "--output", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(artifact))
    want = _jax_artifact_keys() - {"backend"} | {"device"}
    assert want <= set(artifact)
    assert artifact["device"] == "cpu"
    values = artifact["loss_trajectory_downsampled"]["values"]
    assert len(values) == 4 and np.isfinite(values).all() and values[-1] < values[0]
    assert artifact["shift_schedule"]["stage_b_iters"] == 0  # 4 iterations: one stage
    assert artifact["evaluations_per_iteration"] >= 1
    assert artifact["detection_gate_with_trained_model"] is None


def test_main_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_script().main(["--num-spectra", "8", "--output", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_train_throughput_smoke(monkeypatch, capsys):
    """The throughput twin at Q = 16, 2 iterations, on the CPU: both
    objectives fit, and at the start their values agree (the batched one
    adds the priors, which vanish there: tau_0 and beta start at the
    priors' means)."""
    monkeypatch.setenv("TRAIN_Q", "16")
    monkeypatch.setenv("TRAIN_ITERS", "2")
    mod = _load(THROUGHPUT_SCRIPT, "train_throughput_torch_under_test")
    result = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "batched objective" in out and "vmapped objective" in out
    assert result["Q"] == 16 and result["iters"] == 2
    for name in ("batched", "vmapped"):
        assert result[name]["ms_per_iteration"] > 0
        assert np.isfinite(result[name]["values"]).all()
    np.testing.assert_allclose(result["batched"]["values"][0], result["vmapped"]["values"][0],
                               rtol=1e-5)
