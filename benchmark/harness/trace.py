"""The traced stretch of a run: ``torch.profiler`` over a fixed amount of
work, read into device records, host spans and their overlap.

Spans are the benchmark's own ``record_function`` ranges around its calls
into the program, on the thread that drives the run; they share the
profiler's clock with the device records.  The profiler can miss the first
kernels after it starts, so the stretch first runs a sentinel kernel (8 x
~1.3 ms of ``torch.cuda._sleep``) and waits for it; its records are left
out (the arithmetic of ``ops/timing.union_busy_ms`` and
``prime_profiler``, copied).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import NamedTuple

SENTINEL = "spin_kernel"
STRETCH = "bench.stretch"  # the span around the whole traced stretch
COPY_WORDS = ("memcpy", "memset")


class Record(NamedTuple):
    name: str
    start: float  # us, the profiler's clock
    end: float


class Trace(NamedTuple):
    """What a traced stretch recorded."""

    records: list  # device records (kernels, copies), the sentinel's left out
    spans: list  # (name, start, end) of the benchmark's host spans
    start: float  # us: the stretch's span
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self) -> list:
        return [r for r in self.records if not any(w in r.name.lower() for w in COPY_WORDS)]


@contextlib.contextmanager
def profiled(device):
    """Profile the block on ``device`` (CPU and CUDA activities), the
    sentinel run first; the context's value is a list that holds the
    :class:`Trace` once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box = []
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(2_500_000)
        torch.cuda.synchronize(device)
        with torch.profiler.record_function(STRETCH):
            yield box
            torch.cuda.synchronize(device)
    box.append(read(prof))


def read(prof) -> Trace:
    import torch

    cpu = torch.autograd.DeviceType.CPU
    records, spans = [], []
    start = end = None
    for e in prof.events():
        if e.device_type != cpu:
            if not e.is_user_annotation and SENTINEL not in e.name:
                records.append(Record(e.name, e.time_range.start, e.time_range.end))
        elif e.name == STRETCH:
            start, end = e.time_range.start, e.time_range.end
        elif e.name.startswith("bench."):
            spans.append((e.name[len("bench."):], e.time_range.start, e.time_range.end))
    if start is None:
        raise RuntimeError("the profiler recorded no stretch span")
    records = [r for r in records if r.end > start and r.start < end]
    return Trace(sorted(records, key=lambda r: r.start), sorted(spans, key=lambda s: s[1]),
                 start, end)


def busy_s(trace: Trace) -> float:
    """Seconds in which at least one device record ran (each moment once)."""
    total, reached = 0.0, float("-inf")
    for r in trace.records:
        s, e = max(r.start, trace.start), min(r.end, trace.end)
        if e > reached:
            total += e - max(s, reached)
            reached = e
    return total / 1e6


def idle_gaps(trace: Trace) -> list:
    """(start, end) in us of every stretch of the window with no device record."""
    gaps, reached = [], trace.start
    for r in trace.records:
        if r.start > reached:
            gaps.append((reached, r.start))
        reached = max(reached, r.end)
    if trace.end > reached:
        gaps.append((reached, trace.end))
    return gaps


def _span_at(spans, t: float) -> str:
    """The innermost benchmark span open on the host at ``t``."""
    best, best_start = "host, between the benchmark's spans", float("-inf")
    for name, s, e in spans:
        if s <= t <= e and s > best_start:
            best, best_start = name, s
    return best


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time and the longest idle
    gaps, each named by the host span open at its middle."""
    by_name = defaultdict(float)
    for r in trace.records:
        by_name[r.name] += (r.end - r.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_span_at(trace.spans, 0.5 * (a + b)), (b - a) / 1e6] for a, b in gaps]}


def device_seconds(trace: Trace, test) -> tuple[int, float]:
    """(records, seconds) of the kernels whose name passes ``test``."""
    hits = [r for r in trace.kernels() if test(r.name)]
    return len(hits), sum(r.end - r.start for r in hits) / 1e6
