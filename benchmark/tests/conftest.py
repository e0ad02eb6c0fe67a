"""The benchmark's CPU tests: the benchmark's packages and the repo root on the path."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
