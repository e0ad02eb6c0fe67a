"""The readings a cell's limits are set from: the program's and the control's.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process (the kernels are built once): the cell's inputs
from the seed, a warm-up, a window of ``--seconds`` at the cell's load, then
each number compared over the sampled spectra twice: for the program's
results, and for the control, the reference in TF32 put in the program's
place on the same spectra.  Prints one line per seed and, at the end, the
largest program reading and the smallest control reading of each number as
JSON.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from harness import layout

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = layout.find_cell(args.workload)
    driver = layout.load_driver(cell.traffic)
    rows = driver.calibrate(cell, args.seeds, args.seconds, torch.device("cuda", 0),
                            lambda m: print(m, flush=True))
    names = sorted(rows[0][1])
    summary = {n: {"program_max": max(r[1][n] for r in rows),
                   "control_min": min(r[2][n] for r in rows)} for n in names}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "summary": summary,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
