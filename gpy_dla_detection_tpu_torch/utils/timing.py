"""Tracing and per-stage timing.

The port of ``gpy_dla_detection_tpu/utils/timing.py``: a ``StageTimer``
accumulates named wall-clock stages (a copy), ``trace`` wraps
``torch.profiler`` and writes a Chrome trace (viewable in Perfetto or
``chrome://tracing``), and ``block_and_time`` times a call with the card
synchronised around it.  ``card_line`` names the card a time was taken on.

``span(name)`` marks a stage of the program where its work happens (the
``gpy.*`` spans of ``parallel/batch`` and ``models/``).  It records nothing
unless a ``recording()`` block is open, and then, on any thread, the span's
name, its thread's native id, its parent (the innermost span open on the
same thread) and its ``time.time_ns()`` bounds, the clock
``torch.profiler`` stamps its events in.  Off, a span costs one flag read
and enters no profiler code.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import subprocess
import threading
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


class Recording(list):
    """The spans of one :func:`recording` block, in the order they were
    entered, filled when the block ends: ``(name, thread, parent, start_ns,
    end_ns)``, with ``thread`` the native id of the span's thread
    (``threading.get_native_id()``, the id the profiler gives its CPU
    events) and ``parent`` the index of the enclosing span of that thread,
    or -1.  ``dropped`` counts the spans past the block's ``limit`` and
    those still open when it ended (their ``end_ns`` is None)."""

    dropped: int = 0


_NULL_SPAN = contextlib.nullcontext()
_recording = False  # the one flag a span reads while no block is open
_slots: list = []  # the open block's entries, [name, thread, parent, start, end]
_next_index = itertools.count().__next__
_threads = threading.local()  # per thread: its native id and its open spans


class _Span:
    __slots__ = ("name", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        local = _threads.__dict__
        stack = local.get("stack")
        if stack is None:
            stack = local["stack"] = []
            local["tid"] = threading.get_native_id()
        slots, index = _slots, _next_index()  # the counter is atomic under the GIL
        self.entry = None
        if index < len(slots):
            self.entry = slots[index] = [self.name, local["tid"], stack[-1] if stack else -1,
                                         time.time_ns(), None]
        stack.append(index)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _threads.stack.pop()
        if self.entry is not None:
            self.entry[4] = end
        return False


def span(name: str):
    """A context manager that records the block as the stage ``name`` while
    a :func:`recording` block is open; otherwise the shared null context."""
    if not _recording:
        return _NULL_SPAN
    return _Span(name)


@contextlib.contextmanager
def recording(limit: int = 200_000):
    """Record every :func:`span` entered, on any thread, while the block is
    open, up to ``limit`` spans.

    :return: (as the context's value) a :class:`Recording`, filled when the
        block ends.
    """
    global _recording, _slots, _next_index
    if _recording:
        raise RuntimeError("a recording block is already open")
    out = Recording()
    _slots, _next_index = [None] * limit, itertools.count().__next__
    _recording = True
    try:
        yield out
    finally:
        _recording = False
        entered = _next_index()
        slots, _slots = _slots, []
        kept = [e or [None, None, -1, None, None] for e in slots[:min(entered, limit)]]
        out.extend(tuple(e) for e in kept)
        out.dropped = max(entered - limit, 0) + sum(e[4] is None for e in kept)


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
