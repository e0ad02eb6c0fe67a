#!/usr/bin/env python3
"""K5 and K6 of two checkouts of the repository, in turns on one CUDA card:
their device times and whether their outputs agree bit for bit, so that a
redesign of the absorption tail is held to the earlier build on the same
card in the same call.

Run from the repository root:

    python3 scripts/k5_k6_turns.py BASE CHANGED

BASE and CHANGED are checkouts of the repository (the root itself, or an
unpacked ``git archive`` of another commit).  The script runs BASE,
CHANGED, CHANGED, BASE, each in a process of its own that imports that
checkout's port (building its kernels there) and calls its wrappers
(``absorption_tail``, K5; ``absorption_windowed``, K6) on the same inputs:
the windowed unit optical depth of seeded redshifts on a log-uniform grid
(``windowed_tau_parts``, L = 3), placed for K5.  K5 at 10,000 rows of P =
1,286 (the exact catalog configuration), 1,670 (the LLS search) and 774
(the CIV head), and at the MCMC half-step's 16 rows of 1,286; K6 at 10,000
and 16 rows of P = 1,286 (1,408 padded); each in float32 and int16
storage.  Device ms by the profiler over 50 calls with every launch
recorded (this checkout's ``ops/timing.py``, loaded on its own; "not
measured" where the profiler lost records in every window).  It prints
each turn's device ms, the mean of each side's two turns and the change
against the base, then for each output whether the two checkouts' are
equal bit for bit (through a temporary directory, removed at the end).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

TIMING = Path(__file__).resolve().parent.parent / "gpy_dla_detection_tpu_torch" / "ops" / "timing.py"
# name -> (kernel, rows, P)
CASES = {
    "K5_10000x1286": ("K5", 10_000, 1286),
    "K5_16x1286": ("K5", 16, 1286),
    "K5_10000x1670": ("K5", 10_000, 1670),
    "K5_10000x774": ("K5", 10_000, 774),
    "K6_10000x1286": ("K6", 10_000, 1286),
    "K6_16x1286": ("K6", 16, 1286),
}


def worker(root: Path, out: Path) -> None:
    sys.modules["jax"] = None  # the port stands alone; fail loudly if reached
    sys.modules["gpy_dla_detection_tpu"] = None
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from gpy_dla_detection_tpu_torch.ops.voigt import place_windows, windowed_tau_parts
    from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
        absorption_tail,
        absorption_windowed,
    )

    spec = importlib.util.spec_from_file_location("turns_timing", TIMING)
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    if not torch.cuda.is_available():
        raise SystemExit("k5_k6_turns: no CUDA device")
    device = torch.device("cuda", 0)
    times, arrays = {}, {}
    for name, (kernel, S, P) in CASES.items():
        rng = np.random.default_rng(3)
        wl = torch.as_tensor((1215.67 * 2.9 * 10 ** (1e-4 * np.arange(P))).astype(np.float32),
                             device=device)
        z = torch.as_tensor(rng.uniform(1.9, 3.3, S).astype(np.float32), device=device)
        nhi = torch.as_tensor((10 ** rng.uniform(20, 23, S)).astype(np.float32), device=device)
        parts = windowed_tau_parts(wl, z, 3)
        unit = place_windows(parts).contiguous()
        for store, dtype in (("f32", None), ("i16", torch.int16)):
            if kernel == "K5":
                fn = lambda: absorption_tail(unit, nhi, dtype)
            else:
                fn = lambda: absorption_windowed(parts, nhi, dtype)
            arrays[f"{name}_{store}"] = fn()
            try:
                times[f"{name}_{store}"] = timing.device_ms(fn)[0]
            except RuntimeError:
                times[f"{name}_{store}"] = None
    np.savez(out, **{k: v.cpu().numpy() for k, v in arrays.items()})
    print(json.dumps({"root": str(root), "card": torch.cuda.get_device_name(0), **times}))


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
    files, turns = {}, []
    for turn, (tag, root) in enumerate([("base", args.base), ("changed", args.changed),
                                        ("changed", args.changed), ("base", args.base)]):
        out = Path(tmp.name) / f"{turn}_{tag}.npz"
        res = subprocess.run([sys.executable, __file__, "--worker", str(root), str(out)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"k5_k6_turns: {tag} run failed:\n{res.stdout}{res.stderr}")
        times = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append((tag, times))
        show = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        print(f"turn {turn} {tag}: " + ", ".join(
            f"{n} {show(v)}" for n, v in times.items() if n.startswith("K")), flush=True)
        files.setdefault(tag, out)
    for name in (n for n in turns[0][1] if n.startswith("K")):
        side = {tag: [t[name] for g, t in turns if g == tag] for tag in ("base", "changed")}
        if any(v is None for vs in side.values() for v in vs):
            print(f"{name}: not measured in every turn", flush=True)
            continue
        b, c = (sum(side[t]) / 2 for t in ("base", "changed"))
        spread = max(abs(side["base"][0] - side["base"][1]),
                     abs(side["changed"][0] - side["changed"][1]))
        print(f"{name}: base {b:.4f} ms, changed {c:.4f} ms ({c / b - 1:+.1%}), spread between "
              f"a side's turns {spread:.4f} ms", flush=True)
    base, changed = np.load(files["base"]), np.load(files["changed"])
    for name in base.files:
        same = np.array_equal(base[name], changed[name])
        diff = float(np.max(np.abs(base[name].astype(np.float64) - changed[name])))
        print(f"{name}: bitwise equal {same}, max |d| {diff:.3e}", flush=True)
    tmp.cleanup()


if __name__ == "__main__":
    main()
