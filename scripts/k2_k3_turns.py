#!/usr/bin/env python3
"""K2 and K3 of two checkouts of the repository, in turns on one CUDA card:
their device times and whether their outputs agree bit for bit, so that a
change to the kernels' shared code is held to the earlier build on the
same card in the same call.

Run from the repository root:

    python3 scripts/k2_k3_turns.py BASE CHANGED

BASE and CHANGED are checkouts of the repository (the root itself, or an
unpacked ``git archive`` of another commit).  The script runs BASE,
CHANGED, CHANGED, BASE, each in a process of its own that imports that
checkout's port (building its kernels there) and draws that checkout's
K2 problem (``ops/cap_geometry_sweep.problem``: S = 10,000, k = 20,
packed basis, seed 7) at N = 1,280 with 0 and 3 chained streams and at N
= 1,664, with the profiles as float32 and as int16 codes.  It times K2
(``logmvn_cap``) at each of the six and K3 (``logmvn_chain``) on K2's
float32 output at N = 1,280, by the profiler over 50 launches with every
launch recorded (this checkout's ``ops/timing.py``, loaded on its own).
The wide bases follow: k = 54 (one column past K2's block at N = 1,280)
and 65 (one past K3's warp chain), S = 10,000, N = 1,280, 3 chained
streams, float32 and int16 (the construction of
``tests/test_torch_kernels_gpu.py``, seed k): K2's device ms at each (every
device record of a call), K3's on K2's float32 output, and the likelihood
K3 gives on each checkout's own K2 output.  It prints each turn's device ms, then for each output
whether the two checkouts' are equal bit for bit, and for the wide
likelihoods (whose arithmetic a redesign may change) the largest |dll|
between the checkouts beside the largest |ll| (through a temporary
directory, removed at the end).  K3's adjoint (``logmvn_chain_grad``)
follows on the GP training's own inputs (that checkout's
``woodbury_inputs`` of ``synthetic_training_problem``, R = 1,217, 31
forest lines, seed k): at k = 20 with a training chunk's Qc = 4,064
spectra and at k = 65 (its wide kernel) with Q = 4,096, its device ms and
each output's (dB, du, dmisc) largest |d| against the twin in float64 on
the card over that output's largest magnitude; the two checkouts' dB are
not expected to agree bit for bit.  Each turn also prints the seconds its
checkout's kernel library took to build (``_build.build``; the first turn
of each checkout builds it, the second finds it built) and, from the
build's log, ptxas's compile seconds by source.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TIMING = Path(__file__).resolve().parent.parent / "gpy_dla_detection_tpu_torch" / "ops" / "timing.py"
SHAPES = {"N1280": (1280, 0), "N1280_3streams": (1280, 3), "N1664": (1664, 0)}
WIDE_KS = (54, 65)
ADJOINT_SHAPES = ((20, 4064), (65, 4096))  # (k, spectra)


def wide_problem(k, device, np, torch):
    """tests/test_torch_kernels_gpu.py's construction at S = 10,000, N =
    1,280, 3 chained streams, seed k: rows, M, the packed basis, A, streams."""
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import packed_pair_basis

    rng = np.random.default_rng(k)
    S, N = 10_000, 1280
    put = lambda x: torch.as_tensor(x, device=device)
    M = (rng.normal(size=(N, k)) / np.sqrt(k) * 0.1).astype(np.float32)
    y = (1 + 0.1 * rng.normal(size=N)).astype(np.float32)
    mu = np.ones(N, np.float32)
    omega2 = rng.uniform(0.01, 0.05, N).astype(np.float32)
    v = rng.uniform(0.02, 0.1, N).astype(np.float32)
    mask = rng.uniform(size=N) > 0.1
    A = np.exp(-rng.random((S, N))).astype(np.float32)
    extra = [np.exp(-0.3 * rng.random((S, N))).astype(np.float32) for _ in range(3)]
    rows = put(np.stack([y, mu, omega2, v, mask.astype(np.float32)]))
    return rows, put(M), packed_pair_basis(put(M)), put(A), [put(e) for e in extra]


def worker(root: Path, out: Path) -> None:
    sys.modules["jax"] = None  # the port stands alone; fail loudly if reached
    sys.modules["gpy_dla_detection_tpu"] = None
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from gpy_dla_detection_tpu_torch.ops import _build
    from gpy_dla_detection_tpu_torch.ops.cap_geometry_sweep import problem
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import logmvn_cap, logmvn_chain
    from gpy_dla_detection_tpu_torch.ops.voigt import encode_profile_store

    spec = importlib.util.spec_from_file_location("turns_timing", TIMING)
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    if not torch.cuda.is_available():
        raise SystemExit("k2_k3_turns: no CUDA device")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    (lib,) = _build.build("kernels")
    build = {"seconds": time.perf_counter() - t0, "ptxas_seconds": {
        sec.split("\n")[0].strip(): sum(map(float, re.findall(r"Compile time = ([\d.]+) ms", sec))) / 1e3
        for sec in lib.with_suffix(".log").read_text().split("== ")[1:]}}
    i16 = lambda x: encode_profile_store(x, torch.int16)
    times, arrays = {}, {}
    for name, (N, n_extra) in SHAPES.items():
        rows, M, Mp, A, extra = problem(N, n_extra, device, np.random.default_rng(7))
        for store, (a, ex) in (("f32", (A, extra)), ("i16", (i16(A), [i16(e) for e in extra]))):
            cap = logmvn_cap(rows, M, Mp, a, ex)
            times[f"K2_{store}_{name}"] = timing.device_ms(lambda: logmvn_cap(rows, M, Mp, a, ex))[0]
            arrays.update({f"{store}_{name}_{x}": v for x, v in zip(("B", "u", "misc"), cap)})
            if store == "f32" and name == "N1280":
                arrays[f"{store}_{name}_ll"] = logmvn_chain(*cap)
                times["K3_f32_N1280"] = timing.device_ms(lambda: logmvn_chain(*cap))[0]
    for k in WIDE_KS:
        rows, M, Mp, A, extra = wide_problem(k, device, np, torch)
        for store, (a, ex) in (("f32", (A, extra)), ("i16", (i16(A), [i16(e) for e in extra]))):
            cap = logmvn_cap(rows, M, Mp, a, ex)
            # every device record of the wrapper (the wide kernel's padded
            # basis is laid out by a fill and two copies)
            times[f"K2_{store}_k{k}"] = timing.device_ms(
                lambda: logmvn_cap(rows, M, Mp, a, ex), kernels=None)[0]
            arrays[f"wide_{store}_k{k}_ll"] = logmvn_chain(*cap)
            if store == "f32":
                times[f"K3_f32_k{k}"] = timing.device_ms(lambda: logmvn_chain(*cap))[0]
        del cap
    from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_training_problem
    from gpy_dla_detection_tpu_torch.models import training as TT
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
        logmvn_chain_grad,
        logmvn_chain_grad_reference,
    )

    errors = {}
    for k, Q in ADJOINT_SHAPES:
        fields, train = synthetic_training_problem(Q, 1217, k, seed=k)
        p = TT.TrainingParams.from_numpy(fields, device)
        with torch.no_grad():
            B, u, misc = TT.woodbury_inputs(p, *(torch.as_tensor(x, device=device) for x in train),
                                            31)
        g = torch.as_tensor(np.random.default_rng(Q).normal(size=Q).astype(np.float32),
                            device=device)
        got = logmvn_chain_grad(B, u, misc, g)
        want = logmvn_chain_grad_reference(*(x.double() for x in (B, u, misc, g)))
        errors[f"adjoint_k{k}_Q{Q}"] = [float((a.double() - b).abs().max() / b.abs().max())
                                        for a, b in zip(got, want)]
        times[f"K3grad_k{k}_Q{Q}"] = timing.device_ms(lambda: logmvn_chain_grad(B, u, misc, g))[0]
        arrays[f"adjoint_k{k}_Q{Q}_dB"] = got[0]
    np.savez(out, **{k: v.cpu().numpy() for k, v in arrays.items()})
    print(json.dumps({"root": str(root), "card": torch.cuda.get_device_name(0), **times,
                      "errors_vs_float64": errors, "build": build}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("changed", type=Path)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:  # base is the checkout, changed the output file
        worker(args.base.resolve(), args.changed)
        return
    import numpy as np

    tmp = tempfile.TemporaryDirectory()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card {card}", flush=True)
    files = {}
    for turn, (tag, root) in enumerate([("base", args.base), ("changed", args.changed),
                                        ("changed", args.changed), ("base", args.base)]):
        out = Path(tmp.name) / f"{turn}_{tag}.npz"
        res = subprocess.run([sys.executable, __file__, "--worker", str(root), str(out)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"k2_k3_turns: {tag} run failed:\n{res.stdout}{res.stderr}")
        times = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"turn {turn} {tag}: " + ", ".join(
            f"{n} {v:.4f} ms" for n, v in times.items() if n.startswith("K")) + "; K3's adjoint "
            "vs the float64 twin (dB/du/dmisc): " + ", ".join(
            f"{n} " + "/".join(f"{r:.2e}" for r in v)
            for n, v in times["errors_vs_float64"].items()), flush=True)
        b = times["build"]
        print(f"turn {turn} {tag}: kernel library build {b['seconds']:.1f} s; ptxas s by source: "
              + ", ".join(f"{n} {t:.1f}" for n, t in b["ptxas_seconds"].items()), flush=True)
        files.setdefault(tag, out)
    base, changed = np.load(files["base"]), np.load(files["changed"])
    for name in base.files:
        same = np.array_equal(base[name], changed[name], equal_nan=True)
        diff = float(np.nanmax(np.abs(base[name].astype(np.float64) - changed[name])))
        scale = (f", max |.| {float(np.nanmax(np.abs(base[name]))):.6g}"
                 if name.startswith(("wide_", "adjoint_")) else "")
        print(f"{name}: bitwise equal {same}, max |d| {diff:.3e}{scale}", flush=True)
    tmp.cleanup()


if __name__ == "__main__":
    main()
