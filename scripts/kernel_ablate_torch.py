#!/usr/bin/env python3
"""Stage-by-stage ablation of the Woodbury likelihood (K2 + K3) on one
CUDA card: the PyTorch port's counterpart of scripts/kernel_ablate.py,
with its defaults (S = 10,000 samples, N = 1,280 pixels, k = 20, inputs
from ``np.random.default_rng(0)``) and its stage names.

Run from the repository root:

    python3 scripts/kernel_ablate_torch.py [stage ...] [accuracy]

Stages: the stage kernel's ``elementwise``, ``elementwise_nolog``,
``matmul`` (and ``matmul_default``, ``matmul_split``), ``full`` (and
``full_split``, ``full_split2``, ``full_tri``, ``full_tri_split``,
``full_ilp2``), ``chain_nodot``; ``decoupled_<bs>`` and
``decoupled_tri_<bs>`` (K2 with the flat basis, then the flat chain);
``chain_<variant>_<bs>`` with variant ``row``, ``xt``, ``xt2``, ``T_full``,
``T_tri`` (the flat chain; ``T_*`` on the transposed layout padded to
10,240 samples) or ``xtp``, ``xtp2c`` (K3 on the packed triangle).  With
no stage: ``elementwise elementwise_nolog matmul full_split2
chain_xtp2c_2000``, then ``accuracy``.

For each stage it prints ``<stage> <ms> ms/call device``: the kernels'
device time per call from ``torch.profiler`` over 30 calls cycling
through 8 inputs (4 for the chain stages), after a warm-up call checked
against the stage's twin, in a window that holds every launch of the
calls (``ops/timing.py``).  The stage kernel is timed on the packed basis
(``logmvn_ablate_packed``): its own time, without the gather of the
packed columns that the flat-basis entry makes from ``matmul`` on.
Beside ``matmul`` it prints K2's own device time on the same inputs
(its packed basis, its block), and two library yardsticks, on no path of
the port: ``torch.matmul`` (cuBLAS SGEMM, float32, TF32 off) of the same
product w [Mp | M], and of K2's packed product (k(k+1)/2 + k columns).
``accuracy`` holds ``full``, ``decoupled`` and K2 + K3 against a float64
composition on the card at full width.
"""

from __future__ import annotations

import functools
import itertools
import subprocess
import sys
from pathlib import Path


class _Blocked:
    """The port stands alone: refuse to find JAX and the JAX package, so
    that an import of either fails loudly.  An import hook, not None in
    sys.modules, which scipy's array-API helpers look up and fail on (this
    script is also loaded into chip_smoke.py's process)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "gpy_dla_detection_tpu"):
            raise ImportError(f"{name} is blocked: the port stands alone")
        return None


sys.meta_path.insert(0, _Blocked())
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from gpy_dla_detection_tpu_torch.ops.logmvn import LOG_2PI, pair_basis  # noqa: E402
from gpy_dla_detection_tpu_torch.ops.logmvn_ablate import (  # noqa: E402
    CHAIN_LAYOUTS,
    STAGES,
    ablation_chain,
    logmvn_ablate,
    logmvn_ablate_packed,
    logmvn_ablate_reference,
    logmvn_decoupled,
    logmvn_flat_chain_reference,
)
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (  # noqa: E402
    assemble_reference,
    logmvn_cap,
    logmvn_chain,
    logmvn_chain_reference,
    packed_flat_columns,
    packed_pair_basis,
)
from gpy_dla_detection_tpu_torch.ops.timing import device_ms as profiled_ms  # noqa: E402

S, N, K = 10000, 1280, 20
S_T = 10240  # the transposed layout's padded sample count (the JAX script's)
REPS = 30
DEFAULT_STAGES = ["elementwise", "elementwise_nolog", "matmul", "full_split2",
                  "chain_xtp2c_2000"]
REL_TWIN = 2e-6  # |dll| <= REL_TWIN * max|ll|, kernel vs twin (K2/K3's card tolerance)
# the reference kernel's float32 budget on |ll| ~ 1.1e4 (ops/logmvn_pallas.py:206-210)
BUDGET_MEDIAN, BUDGET_MAX = 7.4e-4, 3.8e-3


@functools.lru_cache(maxsize=None)
def likelihood_inputs(device, seed=0, n_inputs=8, a_low=0.5):
    """rows (5, N), M (N, K), flat Mp (N, K^2) and ``n_inputs`` absorption
    arrays (S, N), drawn as the JAX script draws them (main, :625-642)."""
    rng = np.random.default_rng(seed)
    rows = np.stack([
        rng.normal(1, 0.3, N), rng.normal(1, 0.3, N),
        rng.uniform(0.05, 0.2, N), rng.uniform(0.05, 0.2, N), np.ones(N),
    ]).astype(np.float32)
    M = rng.normal(0, 0.2, (N, K)).astype(np.float32)
    Mp = (M[:, :, None] * M[:, None, :]).reshape(N, K * K)
    put = lambda x: torch.as_tensor(x, device=device)
    a_list = [put(rng.uniform(a_low, 1.0, (S, N)).astype(np.float32)) for _ in range(n_inputs)]
    return put(rows), put(M), put(Mp), a_list


@functools.lru_cache(maxsize=None)
def chain_inputs(layout, seed, device):
    """The JAX script's chain-only inputs (chain_inputs, :660-698): SPD
    B = G G^T plus a diagonal jitter, u, misc; flat (S, K^2), transposed
    (K^2, S_T) padded with identity systems, or the packed triangle."""
    r2 = np.random.default_rng(seed)
    G = r2.normal(0, 1.0, (S, K, 6))
    Bm = np.einsum("ska,sla->skl", G, G) + np.eye(K) * r2.uniform(1.0, 3.0, (S, 1, 1))
    Bf = Bm.reshape(S, K * K).astype(np.float32)
    uf = r2.normal(0, 1.0, (S, K)).astype(np.float32)
    mf = r2.normal(0, 10.0, (S, 2)).astype(np.float32)
    if layout == "transposed":
        pad = S_T - S
        eye = np.broadcast_to(np.eye(K, dtype=np.float32).reshape(1, K * K), (pad, K * K))
        Bf = np.concatenate([Bf, eye])
        uf = np.concatenate([uf, np.zeros((pad, K), np.float32)])
        mf = np.concatenate([mf, np.zeros((pad, 2), np.float32)])
        Bf, uf, mf = (np.ascontiguousarray(x.T) for x in (Bf, uf, mf))
    elif layout == "packed":
        Bf = np.ascontiguousarray(Bf[:, list(packed_flat_columns(K))])
    return tuple(torch.as_tensor(x, device=device) for x in (Bf, uf, mf))


def stage_runner(stage, device):
    """(kernel call, twin call, list of input tuples) of one stage name.
    ``chain_nodot`` is a stage of the stage kernel, not a chain variant
    (the JAX script's main would take it for one and fail to parse it)."""
    if stage.startswith("chain_") and stage not in STAGES:
        variant, _bs = stage[len("chain_"):].rsplit("_", 1)
        if variant not in CHAIN_LAYOUTS:
            raise SystemExit(f"unknown chain variant {variant!r}: {sorted(CHAIN_LAYOUTS)}")
        layout = CHAIN_LAYOUTS[variant]
        ins = [chain_inputs(layout, s, device) for s in range(4)]
        twin = logmvn_chain_reference if layout == "packed" else functools.partial(
            logmvn_flat_chain_reference, transposed=layout == "transposed")
        return (lambda *x: ablation_chain(variant, *x)), twin, ins
    rows, M, Mp, a_list = likelihood_inputs(device)
    ins = [(rows, M, Mp, a) for a in a_list]
    if stage.startswith("decoupled"):
        parts = stage.split("_")
        if parts[1:-1] not in ([], ["tri"]) or not parts[-1].isdigit():
            raise SystemExit(f"unknown stage {stage!r}: decoupled[_tri]_<bs>")
        return logmvn_decoupled, (lambda *x: logmvn_ablate_reference("full", *x)), ins
    if stage not in STAGES:
        raise SystemExit(f"unknown stage {stage!r}; choose from {sorted(STAGES)}, "
                         "decoupled[_tri]_<bs>, chain_<variant>_<bs>")
    return ((lambda *x: logmvn_ablate(stage, *x)),
            (lambda *x: logmvn_ablate_reference(stage, *x)), ins)


def max_rel_diff(got, want):
    """max |got - want| over max |want|, NaN positions required equal."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    return float((got - want)[~nan].abs().max() / want[~nan].abs().max())


def device_ms(fn, inputs, kernels=1, reps=REPS):
    """Device ms per call (the profiler's, ``ops/timing.py``) over ``reps``
    calls cycling through ``inputs``; ``kernels`` launches a call."""
    it = itertools.cycle(inputs)
    return profiled_ms(lambda: fn(*next(it)), kernels=kernels, reps=reps)[0]


def library_yardsticks(device):
    """torch.matmul (cuBLAS SGEMM) of w [Mp | M] and of K2's packed
    product, on the inputs' w: yardsticks only, on no path of the port."""
    rows, M, Mp, a_list = likelihood_inputs(device)
    ws = [(assemble_reference(rows, a)[1],) for a in a_list]
    flat = torch.cat([Mp, M], dim=1).contiguous()
    packed = torch.cat([packed_pair_basis(M), M], dim=1).contiguous()
    return {
        f"torch.matmul w [Mp, M] ({flat.shape[1]} columns)":
            device_ms(lambda w: torch.matmul(w, flat), ws, kernels=None),
        f"torch.matmul w [Mp_packed, M] ({packed.shape[1]} columns, K2's product)":
            device_ms(lambda w: torch.matmul(w, packed), ws, kernels=None),
    }


def accuracy(device):
    """full, decoupled and K2 + K3 against a float64 composition on the
    card (the JAX script's accuracy(), :756-796): median and max |dll|."""
    rows, M, Mp, (a,) = likelihood_inputs(device, seed=1, n_inputs=1, a_low=0.3)
    y, mu, om, v, _ = rows.double()
    a64, M64 = a.double(), M.double()
    d = om * a64 * a64 + v
    delta = y - mu * a64
    Bm = torch.eye(K, dtype=torch.float64, device=device) + (
        (a64 * a64 / d) @ pair_basis(M64)).reshape(S, K, K)
    u64 = (a64 * delta / d) @ M64
    L = torch.linalg.cholesky(Bm)
    t = torch.linalg.solve_triangular(L, u64[:, :, None], upper=False)[:, :, 0]
    quad = (delta * delta / d).sum(1) - (t * t).sum(1)
    logdet = torch.log(d).sum(1) + 2 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
    want = -0.5 * (quad + logdet + N * LOG_2PI)
    got = {
        "full": logmvn_ablate("full", rows, M, Mp, a),
        "decoupled": logmvn_decoupled(rows, M, Mp, a),
        "K2+K3": logmvn_chain(*logmvn_cap(rows, M, packed_pair_basis(M), a)),
    }
    out = {}
    for name, ll in got.items():
        err = (ll.double() - want).abs()
        out[name] = (float(err.median()), float(err.max()))
    return out, float(want.abs().max())


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablate_torch: no CUDA device (torch.cuda.is_available() is False)")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    stages = argv or DEFAULT_STAGES
    print(f"card {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"S={S} N={N} k={K} | TF32 {torch.backends.cuda.matmul.allow_tf32}", flush=True)
    if any(s.startswith(("chain_", "decoupled")) for s in stages):
        print("the <bs> suffix is the TPU's block rows; the CUDA kernels choose their own "
              "(K2 and the stage kernel from cap_geometry, K3 from chain_geometry and the "
              "flat chain from flat_chain_geometry, a warp a sample)", flush=True)
    for stage in stages:
        if stage == "accuracy":
            continue  # after the timings, as the JAX script runs it
        fn, twin, ins = stage_runner(stage, device)
        got, want = fn(*ins[0]), twin(*ins[0])
        if got.shape[0] != S:  # the transposed layout's padding
            got, want = got[:S], want[:S]
        err = max_rel_diff(got, want)
        if not err <= REL_TWIN:
            raise SystemExit(f"{stage}: kernel vs twin max|dll|/max|ll| {err:.3e} > {REL_TWIN}")
        own = next((n for n, c in STAGES.items() if c == STAGES.get(stage)), stage)
        note = f" (on the card the same float32 function as {own})" if own != stage else ""
        if stage in STAGES:  # the stage kernel alone, on the packed basis
            fn = functools.partial(logmvn_ablate_packed, stage)
            ins = [(r, M, packed_pair_basis(M), a) for r, M, _, a in ins]
        ms = device_ms(fn, ins, kernels=2 if stage.startswith("decoupled") else 1)
        print(f"{stage:<20} {ms:7.3f} ms/call device | vs twin "
              f"{err:.2e} of max|ll|{note}", flush=True)
        if STAGES.get(stage) == STAGES["matmul"]:
            # K2 itself on the same inputs: its own block and width, against
            # which the stages' split of the work is read
            rows, M, Mp, a_list = likelihood_inputs(device)
            packed = packed_pair_basis(M)
            ms = device_ms(lambda a: logmvn_cap(rows, M, packed, a), [(a,) for a in a_list])
            print(f"  K2 (logmvn_cap, packed basis, {packed.shape[1] + K} columns) "
                  f"{ms:7.3f} ms/call device", flush=True)
            for name, ms in library_yardsticks(device).items():
                print(f"  library yardstick, on no path: {name} {ms:7.3f} ms/call device",
                      flush=True)
    if not argv or "accuracy" in argv:
        errs, scale = accuracy(device)
        for name, (med, mx) in errs.items():
            print(f"{name:<9} vs f64: median {med:.3e} max {mx:.3e} (reference budget median "
                  f"{BUDGET_MEDIAN} max {BUDGET_MAX} on |ll| ~ 1.1e4; max|ll| here {scale:.4g})",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
