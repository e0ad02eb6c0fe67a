"""One run of one benchmark cell of the PyTorch port (``gpy_dla_detection_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's configuration, traffic mix,
driver and per-layer metric readers are found by name from
``BENCHMARK.json`` (``harness/layout.py``); an end-to-end metric named
``<quantity>.<tag>`` (one cell's own bound) is the driver's ``<quantity>``.
The run makes its inputs from the seed, warms up (set-up, reported as
``setup_s``, counted from the process's start), measures for
``--seconds``, and with ``--trace 1`` then profiles a fixed stretch of the
same traffic and reads the per-layer metrics from it.  Once the window has closed it reads the peak device
memory, frees the program's state and judges a sample of what the window
completed against the plain reference under ``reference/``.  It prints each
number compared beside its limit as the last lines of standard error, and
one JSON object as the last line of standard output.

It measures only on a CUDA card: with no card, or fewer than the cell asks
for, it exits with 2 and prints no result.  The kernels' build directory
(inside the checkout, ``csrc/build/``), ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` stay inside the checkout.  A run that finds ``jax``,
``jaxlib``, ``flax`` or the JAX package loaded once the window has closed
exits with 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "gpy_dla_detection_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name is forbidden, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_lines(chips: int) -> list[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        out = [f"nvidia-smi unavailable: {e}"]
    return out[:chips]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, seed, seconds, trace, device, t_start=T_START):
    """Run the cell's driver and read its per-layer metrics: (Outcome, units)."""
    from harness import layout

    driver = layout.load_driver(cell.traffic)
    out = driver.run(cell, seed, seconds, bool(trace), device, t_start, log)
    if trace:
        readings = out.metrics.pop("readings")
        metrics = {}
        for m in cell.per_layer:
            value = layout.load_metric(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = value
        out.metrics = metrics
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        # a cell's end-to-end metric "<quantity>.<tag>" is the driver's <quantity>
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        out.metrics = {name: out.metrics[name.split(".")[0]] for name in units}
    return out, units


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
    os.environ["USE_FLAX"] = "0"
    from harness import layout
    from harness.result import print_checks, result_line

    try:
        cell = layout.find_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        log(f"error: {e}")
        return 2
    chips = cell.workload["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: the cell asks for {chips} CUDA card(s); "
            f"cuda available {torch.cuda.is_available()}, {torch.cuda.device_count()} found")
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    log(f"card: {'; '.join(card_lines(chips))} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | usable cores {len(os.sched_getaffinity(0))}")
    from harness.counts import PEAKS_LINE

    log(PEAKS_LINE)
    out, units = measure(cell, args.seed, args.seconds, args.trace, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"error: loaded in this process: {', '.join(found)}")
        return 3
    log(f"memory_peak_bytes {out.memory_peak_bytes}; attempted {out.attempted}, "
        f"failed {out.failed}, correct {out.correct}")
    print(result_line(out, units), flush=True)
    print_checks(out.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
