"""Tracing and per-stage timing.

The port of ``gpy_dla_detection_tpu/utils/timing.py``: a ``StageTimer``
accumulates named wall-clock stages (a copy), ``trace`` wraps
``torch.profiler`` and writes a Chrome trace (viewable in Perfetto or
``chrome://tracing``), and ``block_and_time`` times a call with the card
synchronised around it.  ``card_line`` names the card a time was taken on.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulating named-stage wall-clock timer."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<30} {t:8.3f}s  ({c} calls, {t / c * 1e3:8.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block (the CPU, and the card where there
    is one); on exit the Chrome trace is written to ``log_dir/trace.json``.

    :return: (as the context's value) the path of the trace file.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def _synchronize(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def block_and_time(fn, *args, repeats: int = 3, device="cuda", **kw):
    """(result, best_seconds) of ``fn(*args, **kw)`` over ``repeats`` timed
    calls after an untimed first one; on a CUDA ``device`` the card is
    synchronised before each call starts and before its clock stops."""
    out = fn(*args, **kw)
    best = float("inf")
    for _ in range(repeats):
        _synchronize(device)
        t0 = time.perf_counter()
        fn(*args, **kw)
        _synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return out, best


def card_line(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (a
    card below its maximum power runs slower under load, so every time is
    kept beside them); ``"cpu"`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return lines[device.index or 0]
