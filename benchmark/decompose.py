"""Where a cell's host time and launches go, by the program's own spans.

    python3 benchmark/decompose.py --workload <cell> --seeds <n> [<n> ...] [--out <file>]

For each seed, in one process (the kernels are built once): the cell's
inputs from the seed, its warm-up, then the cell's traced amount of work
(``trace_batches`` or ``trace_scans``) three times: plain, inside
``timing.recording()`` alone, and profiled with the program's spans
recorded (``harness/spans.py``).  Prints one JSON line per seed: the
per-layer quantities of ``harness.spans.readings``, host ms, launches and
idle time a spectrum by span, the share of kernel records put down to a
span, the breakdown with its idle gaps named by the program and as the
benchmark names them, where the longest gaps lie, the driver's dispatch ms
a spectrum in each of the three passes, and the cost of one ``span()``
with recording off and on.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def window(program, kind: str, n: int, span=None) -> tuple[int, float]:
    """Run ``n`` batches (scans) of the cell's window: (spectra completed,
    the driver's host seconds in dispatch)."""
    got = [0, 0.0]
    if kind == "catalog":
        def on_done(c):
            got[0] += len(c.batch.members)
            got[1] += c.batch.dispatch_s

        program.window(on_done, batches=n, span=span)
    else:
        def on_done(i, t0, dispatch_s, lls, t_done):
            got[0] += 1
            got[1] += dispatch_s

        program.window(on_done, scans=n, span=span)
    return got[0], got[1]


def span_cost_ns(calls: int = 100_000) -> dict:
    """ns a ``with span(...)`` block costs, recording off and on."""
    from gpy_dla_detection_tpu_torch.utils import timing

    def timed():
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with timing.span("gpy.cost"):
                pass
        return (time.perf_counter_ns() - t0) / calls

    off = timed()
    with timing.recording(limit=calls):
        on = timed()
    return {"off": off, "on": on}


def longest_gaps(pt, top: int = 10) -> list:
    """[ms from the stretch's start, ms long, ms to its end, the record
    ending it (None at the stretch's end), whether its launch was found]
    of the longest idle gaps, in the breakdown's order."""
    from harness import spans

    gaps = sorted(spans.gaps_with_records(pt.trace), key=lambda g: g[0] - g[1])[:top]
    t = pt.trace
    return [[(a - t.start) / 1e3, (b - a) / 1e3, (t.end - b) / 1e3,
             r and r.name[:60], r in pt.launches] for a, b, r in gaps]


def decompose(cell, driver, seed: int, device) -> dict:
    import torch

    from gpy_dla_detection_tpu_torch.utils import timing
    from harness import spans
    from harness import trace as tr

    cfg, traffic = cell.config, cell.traffic
    kind = traffic["driver"]
    inputs = driver.make_inputs(cfg, traffic, seed)
    if kind == "catalog":
        program = driver.Program(cfg, traffic, inputs, seed, device)
        n, warm = traffic["trace_batches"], {"batches": traffic["warm_batches"]}
    else:
        program = driver.Program(cfg, traffic, inputs, device)
        n, warm = traffic["trace_scans"], {"scans": traffic["warm_scans"]}
    try:
        program.window(lambda *a: None, **warm)
        torch.cuda.synchronize(device)
        units, plain_s = window(program, kind, n)
        with timing.recording() as recorded:
            _, recorded_s = window(program, kind, n)
        torch.cuda.synchronize(device)
        with spans.profiled(device) as box:
            traced_units, traced_s = window(
                program, kind, n,
                span=lambda name: torch.profiler.record_function("bench." + name))
    finally:
        if kind == "catalog":
            program.close()
    pt = box[0]
    table = spans.by_span(pt, traced_units)
    dispatch = "gpy.dispatch" if kind == "catalog" else "gpy.scan_dispatch"
    parts = ("model_host_ms_per_spectrum", "profiles_host_ms_per_spectrum",
             "resample_host_ms_per_spectrum", "likelihood_host_ms_per_spectrum",
             "level_host_ms_per_spectrum")
    read = spans.readings(pt, traced_units)
    out = {
        "workload": cell.name, "seed": seed, "spectra": traced_units,
        "readings": read,
        "by_span": table,
        "attributed_share": spans.attributed_share(pt),
        "unattributed": spans.unattributed(pt)[:8],
        "breakdown": spans.breakdown(pt),
        "bench_idle_gaps": tr.breakdown(pt.trace)["idle_gaps"],
        "longest_gaps": longest_gaps(pt),
        "dispatch_ms_per_spectrum": {
            "plain": 1e3 * plain_s / max(units, 1),
            "recording": 1e3 * recorded_s / max(units, 1),
            "traced": 1e3 * traced_s / max(traced_units, 1),
            "traced_span": table.get(dispatch, {}).get("host_ms"),
            "recording_span": spans.total_us(spans.on_clock(recorded, 0), dispatch)
            / 1e3 / max(units, 1),
        },
        "span_cost_ns": span_cost_ns(),
    }
    if kind == "catalog" and read:
        whole = table[dispatch]["host_ms"]
        summed = (sum(read[p] for p in parts) + table["gpy.readback"]["host_ms"]
                  + table[dispatch]["self_ms"])
        out["dispatch_sum_gap"] = (summed - whole) / whole
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", help="also append each line to this file")
    args = p.parse_args(argv)
    import torch

    from harness import layout

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = layout.find_cell(args.workload)
    driver = layout.load_driver(cell.traffic)
    device = torch.device("cuda", 0)
    from gpy_dla_detection_tpu_torch.ops import _build

    _build.load_library("kernels")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    for seed in args.seeds:
        line = json.dumps(decompose(cell, driver, seed, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
