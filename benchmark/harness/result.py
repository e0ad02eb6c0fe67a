"""What a run measured, and the one line it prints.

A driver returns an :class:`Outcome`; ``run.py`` turns it into the result
line.  Per-layer metrics are read from the traced stretch's
:class:`Readings` by the readers under ``metrics/``.
"""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field

# the port's own kernels (csrc/), by a piece of their profiler names
PORT_KERNELS = ("absorption_all_kernel", "tail_kernel", "logmvn_cap", "logmvn_chain",
                "logmvn_ablate", "flat_chain")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def is_k1(name: str) -> bool:
    return "absorption_all_kernel" in name


def is_k2(name: str) -> bool:
    return "logmvn_cap" in name


def is_k3(name: str) -> bool:
    return "logmvn_chain" in name and "grad" not in name


@dataclass
class Readings:
    """The traced stretch and what the driver counted over it.

    ``units`` is the work the stretch completed (spectra); ``values`` holds
    the driver's own counts under names the readers know: host seconds a
    spectrum in the calls into a layer over the measured window, where no
    profiler slows the host (``dispatch_s_per_spectrum``,
    ``finalize_s_per_spectrum``, ``scan_dispatch_s_per_spectrum``), the least seconds of each kernel's work with the
    launches it assumes (``least_s`` and ``launches``: {"k1": ...}), the
    least seconds of a whole step per spectrum (``step_least_s``) and the
    window's ``spectra_per_s`` and ``p95_latency_ms``."""

    trace: object
    units: int
    values: dict = field(default_factory=dict)


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict  # name -> value
    kind: str
    count: int
    memory_peak_bytes: int
    checks: list  # (name, value, limit): each number compared, beside its limit
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` (linear between order statistics)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)



def result_line(out: Outcome, units: dict) -> str:
    """The JSON object of the last line of standard output."""
    line = {
        "correct": bool(out.correct),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in out.metrics.items()},
        "device": {"platform": "gpu", "kind": out.kind, "count": out.count,
                   "memory_peak_bytes": int(out.memory_peak_bytes)},
    }
    if out.busy_s is not None:
        line["device"]["busy_s"] = out.busy_s
        line["device"]["window_s"] = out.window_s
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return json.dumps(line)


def print_checks(checks) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for name, value, limit in checks:
        state = "ok" if value <= limit else "FAILS"
        print(f"compared {name} {value!r} limit {limit!r} {state}", file=sys.stderr, flush=True)
