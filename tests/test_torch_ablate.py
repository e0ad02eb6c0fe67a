"""K7, the likelihood-ablation kernel group of the PyTorch port
(``ops/logmvn_ablate.py``), against ``scripts/kernel_ablate.py``'s Pallas
kernels in interpret mode, under the script's own stage names.

The script is loaded as a fresh module per test with its globals set to a
small problem (S = 400, N = 128, BS = 200) and its ``pl`` replaced by a
namespace whose ``pallas_call`` runs in interpret mode; nothing in the
script is edited.  Every stage runs at k = 4 and at the odd k = 5 (the
rank-2 chain variants ``xt2`` and ``xtp2c`` need an even k).

Tolerances (anchored to float64, as ``test_twins_match_jax_kernel_interpret``
in tests/test_torch_logmvn.py):
* each twin's max |error| against a float64 composition of the same
  inputs may reach 1.5x the larger of the JAX kernel's own max error and
  the reference's float32 budget (3.8e-3 on |ll| ~ 1.1e4,
  ops/logmvn_pallas.py:206-210) applied to the largest term the stage
  sums: a stage's value is a difference of terms far larger than itself
  (the matmul stage's |ll| ~ 30 is a sum of terms ~ 1e3), and float32
  rounds the terms;
* the median |twin - JAX kernel| stays within 2e-6 of that term scale;
* ``chain_nodot`` is wrong on purpose and has no float64 composition of
  its own: its twin run in float64 is the anchor, NaN positions equal.
The CUDA kernels are held against the twins in
tests/test_torch_kernels_gpu.py.
"""

import functools
import importlib.util
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from gpy_dla_detection_tpu.ops.logmvn_pallas import _packed_maps as jax_packed_maps
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops.logmvn import LOG_2PI, pair_basis
from gpy_dla_detection_tpu_torch.ops.logmvn_ablate import (
    CHAIN_LAYOUTS,
    STAGES,
    ablation_chain,
    flat_chain_reference,
    logmvn_ablate,
    logmvn_ablate_reference,
    logmvn_decoupled,
    logmvn_flat_chain,
)

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "kernel_ablate.py"
S, N, BS = 400, 128, 200
S_T = 10240  # the transposed variants' padded sample count (the script's)
KS = (4, 5)
REL_F32_BUDGET = 3.8e-3 / 1.1e4
REL_VS_JAX_KERNEL = 2e-6


@pytest.fixture
def ablate(monkeypatch, tmp_path):
    """A loader of the JAX script at the small problem, in interpret mode;
    the environment, ``sys.path`` and the module are restored after."""

    def load(k):
        var = "JAX_COMPILATION_CACHE_DIR"  # the script setdefaults it
        monkeypatch.setenv(var, os.environ.get(var, str(tmp_path)))
        monkeypatch.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location("kernel_ablate_under_test", SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.S, mod.N, mod.K, mod.BS = S, N, k, BS
        mod.pl = types.SimpleNamespace(
            pallas_call=functools.partial(pl.pallas_call, interpret=True),
            BlockSpec=pl.BlockSpec,
        )
        return mod

    return load


@functools.lru_cache(maxsize=None)
def _inputs(k):
    """The script's input recipe (main, :625-642) at the small size, with
    a tenth of the pixels masked."""
    rng = np.random.default_rng(k)
    mask = (rng.uniform(size=N) > 0.1).astype(np.float64)
    rows = np.stack([
        rng.normal(1, 0.3, N), rng.normal(1, 0.3, N),
        rng.uniform(0.05, 0.2, N), rng.uniform(0.05, 0.2, N), mask,
    ]).astype(np.float32)
    M = rng.normal(0, 0.2, (N, k)).astype(np.float32)
    Mp = (M[:, :, None] * M[:, None, :]).reshape(N, k * k)
    a = rng.uniform(0.5, 1.0, (S, N)).astype(np.float32)
    return rows, M, Mp, a


def _terms_f64(rows, M, a):
    """Float64 elementwise assembly with the kernels' masking."""
    y, mu, om, v, mask = rows.astype(np.float64)
    valid = mask > 0
    a = np.where(valid, a.astype(np.float64), 1.0)
    d_inv = mask / (om * a * a + v)
    delta = np.where(valid, y - mu * a, 0.0)
    w, r = a * a * d_inv, a * delta * d_inv
    quad0 = (delta * delta * d_inv).sum(1)
    logdet0 = -np.log(d_inv + ~valid).sum(1)
    return d_inv, w, r, quad0, logdet0, mask.sum()


def _stage_f64(stage, rows, M, Mp, a):
    """(value, term scale) of a stage in float64: the value the stage
    computes, and the largest magnitude among the terms it sums."""
    d_inv, w, r, quad0, logdet0, n = _terms_f64(rows, M, a)
    code = STAGES[stage]
    M64, Mp64 = M.astype(np.float64), Mp.astype(np.float64)
    B, u = w @ Mp64, r @ M64
    if code == STAGES["elementwise"]:
        terms = (quad0, logdet0, (w + r).sum(1))
    elif code == STAGES["elementwise_nolog"]:
        terms = (quad0, (d_inv + w + r).sum(1))
    elif code == STAGES["matmul"]:
        terms = (quad0, logdet0, B.sum(1), u.sum(1))
    elif code == STAGES["full"]:
        k = M.shape[1]
        L = np.linalg.cholesky(np.eye(k) + B.reshape(-1, k, k))
        t = np.linalg.solve(L, u[:, :, None])[:, :, 0]
        logdet = 2 * np.log(np.diagonal(L, axis1=1, axis2=2)).sum(1)
        value = -0.5 * (quad0 - (t * t).sum(1) + logdet0 + logdet + n * LOG_2PI)
        scale = max(np.abs(x).max() for x in (quad0, (t * t).sum(1), logdet0 + logdet))
        return value, max(scale, n * LOG_2PI)
    else:  # chain_nodot: its own recurrence, run in float64
        value = logmvn_ablate_reference(
            stage, *[torch.as_tensor(x.astype(np.float64)) for x in (rows, M, Mp, a)]
        ).numpy()
        return value, np.abs(quad0).max() + np.abs(logdet0).max() + n * LOG_2PI
    return sum(terms), max(np.abs(x).max() for x in terms)


def _assert_held_to_f64(got, jax_kernel, f64, scale):
    nan = np.isnan(f64)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.isnan(jax_kernel), nan)
    got, jax_kernel, f64 = got[~nan], jax_kernel[~nan], f64[~nan]
    err_twin = np.abs(got.astype(np.float64) - f64).max()
    err_jax = np.abs(jax_kernel.astype(np.float64) - f64).max()
    assert err_twin <= 1.5 * max(err_jax, REL_F32_BUDGET * scale), (err_twin, err_jax, scale)
    assert np.median(np.abs(got - jax_kernel)) <= REL_VS_JAX_KERNEL * scale


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_twin_matches_jax_kernel_interpret(ablate, stage, k):
    """Every ``make_kernel`` stage: the stage kernel's twin against the
    Pallas kernel (``build(stage)``) on the same inputs."""
    rows, M, Mp, a = _inputs(k)
    want = np.asarray(ablate(k).build(stage)(*map(jnp.asarray, (rows, M, Mp, a))))[:, 0]
    got = logmvn_ablate(stage, *map(torch.as_tensor, (rows, M, Mp, a)))
    assert got.dtype == torch.float32 and got.shape == (S,)
    _assert_held_to_f64(got.numpy(), want, *_stage_f64(stage, rows, M, Mp, a))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("stage", ["decoupled_200", "decoupled_tri_200"])
def test_decoupled_twins_match_jax_kernels_interpret(ablate, stage, k):
    """``build_decoupled``: K2's twin with the flat basis (``ka``), then
    the flat chain's twin (``kb``), against the two Pallas kernels."""
    rows, M, Mp, a = _inputs(k)
    parts = stage.split("_")
    f = ablate(k).build_decoupled(int(parts[-1]), tri="tri" in parts)
    want = np.asarray(f(*map(jnp.asarray, (rows, M, Mp, a))))[:, 0]
    got = logmvn_decoupled(*map(torch.as_tensor, (rows, M, Mp, a)))
    _assert_held_to_f64(got.numpy(), want, *_stage_f64("full", rows, M, Mp, a))


@functools.lru_cache(maxsize=None)
def _chain_inputs(k):
    """The script's chain inputs (chain_inputs, :660-684): SPD B = G G^T
    plus a diagonal jitter, flat (S, k^2), with u and misc."""
    r2 = np.random.default_rng(k)
    G = r2.normal(0, 1.0, (S, k, 6))
    Bm = np.einsum("ska,sla->skl", G, G) + np.eye(k) * r2.uniform(1.0, 3.0, (S, 1, 1))
    Bf = Bm.reshape(S, k * k).astype(np.float32)
    uf = r2.normal(0, 1.0, (S, k)).astype(np.float32)
    mf = r2.normal(0, 10.0, (S, 2)).astype(np.float32)
    return Bf, uf, mf


def _chain_f64(Bf, uf, mf):
    k = uf.shape[1]
    L = np.linalg.cholesky(np.eye(k) + Bf.astype(np.float64).reshape(-1, k, k))
    t = np.linalg.solve(L, uf.astype(np.float64)[:, :, None])[:, :, 0]
    logdet = 2 * np.log(np.diagonal(L, axis1=1, axis2=2)).sum(1)
    m = mf.astype(np.float64)
    value = -0.5 * (m[:, 0] - (t * t).sum(1) + m[:, 1] + logdet)
    return value, max(np.abs(m).max(), np.abs((t * t).sum(1)).max(), np.abs(logdet).max())


@pytest.mark.parametrize(
    "k,variant",
    [(4, v) for v in sorted(CHAIN_LAYOUTS)]
    + [(5, v) for v in sorted(CHAIN_LAYOUTS) if v not in ("xt2", "xtp2c")],
)
def test_chain_variant_twins_match_jax_kernels_interpret(ablate, k, variant):
    """``build_chain_only``: each variant's port on its own layout
    (row, transposed padded to S_T with identity systems, packed) against
    the Pallas kernel on the same SPD systems."""
    Bf, uf, mf = _chain_inputs(k)
    f = ablate(k).build_chain_only(BS, variant)
    layout = CHAIN_LAYOUTS[variant]
    if layout == "transposed":
        pad = S_T - S
        eye = np.broadcast_to(np.eye(k, dtype=np.float32).reshape(1, k * k), (pad, k * k))
        ins = [np.ascontiguousarray(np.concatenate([x, p]).T) for x, p in (
            (Bf, eye), (uf, np.zeros((pad, k), np.float32)), (mf, np.zeros((pad, 2), np.float32)))]
        want = np.asarray(f(*map(jnp.asarray, ins))).reshape(-1)[:S]
        got = ablation_chain(variant, *map(torch.as_tensor, ins))
        assert got.shape == (S_T,)
        got = got[:S]
    elif layout == "packed":
        cols, rows_ = jax_packed_maps(k)
        packed = Bf[:, [j * k + a for j, a in zip(cols, rows_)]]
        idx = [np.asarray(v, np.int32)[:, None] for v in (cols, rows_)]
        want = np.asarray(f(*map(jnp.asarray, (packed, uf, mf, *idx)))).reshape(-1)
        got = ablation_chain(variant, *map(torch.as_tensor, (packed, uf, mf)))
    else:
        want = np.asarray(f(*map(jnp.asarray, (Bf, uf, mf)))).reshape(-1)
        got = ablation_chain(variant, *map(torch.as_tensor, (Bf, uf, mf)))
    _assert_held_to_f64(got.numpy(), want, *_chain_f64(Bf, uf, mf))


def test_cpu_wrappers_run_the_twins_without_counting():
    """On CPU tensors every K7 wrapper is its twin and counts nothing."""
    rows, M, Mp, a = map(torch.as_tensor, _inputs(4))
    Bf, uf, mf = map(torch.as_tensor, _chain_inputs(4))
    _build.reset_launch_counts()
    for stage in STAGES:
        assert torch.equal(logmvn_ablate(stage, rows, M, Mp, a),
                           logmvn_ablate_reference(stage, rows, M, Mp, a))
    assert torch.equal(logmvn_flat_chain(Bf, uf, mf), flat_chain_reference(Bf, uf, mf))
    assert torch.equal(logmvn_flat_chain(Bf.T, uf.T, mf.T, transposed=True),
                       flat_chain_reference(Bf, uf, mf))
    assert torch.equal(logmvn_decoupled(rows, M, pair_basis(M), a),
                       logmvn_ablate_reference("full", rows, M, pair_basis(M), a))
    assert not any(_build.launch_counts.values())
    with pytest.raises(ValueError, match="unknown stage"):
        logmvn_ablate("full_bf16", rows, M, Mp, a)
