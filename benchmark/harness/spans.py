"""The program's own spans in a traced stretch, on the device records' clock.

The port marks its stages with ``utils.timing.span`` (``gpy.dispatch``,
``gpy.level``, ``gpy.select``, ...) and records them, on every thread,
inside a ``timing.recording()`` block, stamped with ``time.time_ns()``:
the clock the profiler stamps its events in.  Less the profile's
``trace_start_ns()``, in microseconds, they lie on the stretch's clock
(:func:`on_clock`) with no anchor to fit.

Each device record is put down to the launch it came from
(:func:`read_launches`, from the profile's own events): the CUDA runtime
call that shares the record's correlation id, its start and its thread
(its device resource id, the thread's native id, which the program's spans
carry too); where no runtime call is found, the op its linked correlation
id names.  A kernel launched outside any op (the port's own, through
``ctypes``) has only its runtime call.  The innermost program span open on that thread at that
moment is the stage that launched the record.

:func:`readings` gives the per-layer quantities of the catalog's dispatch,
:func:`by_span` its host time and launches by span, and :func:`breakdown`
the traced stretch's breakdown with each idle gap named by the program's
spans.  A stretch whose recorder dropped a span is refused.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import NamedTuple

from harness.result import is_port_kernel
from harness.trace import STRETCH, Trace, _span_at, idle_gaps, read
from harness.trace import breakdown as bench_breakdown

# the spans the per-layer readings take apart
MODEL, PROFILES, LEVEL = "gpy.model", "gpy.profiles", "gpy.level"
RESAMPLE, LIKELIHOOD, SELECT = "gpy.resample", "gpy.likelihood", "gpy.select"


class Span(NamedTuple):
    name: str
    thread: int  # the thread's native id
    parent: int  # index of the enclosing span of the same thread, or -1
    start: float  # us, the stretch's clock
    end: float


class Launch(NamedTuple):
    thread: int  # native id of the thread that launched the record
    at: float  # us, the stretch's clock


class ProgramTrace(NamedTuple):
    """A traced stretch with the program's spans and each record's launch."""

    trace: Trace
    spans: list  # Span, in the order they were entered
    launches: dict  # Record -> Launch, for the records whose launch was found


def on_clock(recorded, trace_start_ns: int) -> list:
    """The spans of a ``timing.Recording`` in us from ``trace_start_ns``;
    a recording that dropped spans is refused."""
    if recorded.dropped:
        raise ValueError(f"the recorder dropped {recorded.dropped} spans: the stretch is not read")
    return [Span(n, t, p, (s - trace_start_ns) / 1e3, (e - trace_start_ns) / 1e3)
            for n, t, p, s, e in recorded]


def read_launches(events, trace_start_ns: int) -> dict:
    """(start, end) in us of each device record -> its :class:`Launch`.

    :param events: the profile's own events (``kineto_results.events()``),
        which carry the correlation ids on every torch version.
    """
    from torch.autograd import DeviceType

    us = lambda ns: (ns - trace_start_ns) / 1e3
    ops, calls = {}, {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name().startswith("cu"):  # a CUDA runtime or driver call
            calls[e.correlation_id()] = e
        elif e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = e
    launches = {}
    for e in events:
        if e.device_type() == DeviceType.CPU or e.is_user_annotation():
            continue
        by = calls.get(e.correlation_id()) or ops.get(e.linked_correlation_id() or None)
        if by is not None:
            launches[(us(e.start_ns()), us(e.end_ns()))] = Launch(
                by.device_resource_id(), us(by.start_ns()))
    return launches


def program_trace(trace: Trace, spans: list, launches: dict) -> ProgramTrace:
    """Key each launch by the trace's own record."""
    found = {}
    for r in trace.records:
        launch = launches.get((r.start, r.end))
        if launch is not None:
            found[r] = launch
    return ProgramTrace(trace, spans, found)


@contextlib.contextmanager
def profiled(device):
    """As ``harness.trace.profiled``, with the program's spans recorded over
    the stretch, and only it; the context's value is a list that holds the
    :class:`ProgramTrace` once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpy_dla_detection_tpu_torch.utils import timing

    box = []
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(2_500_000)
        torch.cuda.synchronize(device)
        with torch.profiler.record_function(STRETCH), timing.recording() as recorded:
            yield box
            torch.cuda.synchronize(device)
    results = prof.profiler.kineto_results
    start_ns = results.trace_start_ns()
    box.append(program_trace(read(prof), on_clock(recorded, start_ns),
                             read_launches(results.events(), start_ns)))


class Threads:
    """The spans of each thread, for the innermost span open at a moment."""

    def __init__(self, spans: list):
        self.spans = spans
        self.of = defaultdict(list)  # thread -> indices, by start
        for i, s in enumerate(spans):
            self.of[s.thread].append(i)
        for idx in self.of.values():
            idx.sort(key=lambda i: spans[i].start)
        self.starts = {t: [spans[i].start for i in idx] for t, idx in self.of.items()}

    def innermost(self, thread, t: float):
        """The innermost span of ``thread`` open at ``t``, or None.  A
        thread's spans nest, so it is the last to start at or before ``t``
        or the first of its enclosing spans still open."""
        idx = self.of.get(thread)
        if not idx:
            return None
        k = bisect.bisect_right(self.starts[thread], t) - 1
        i = idx[k] if k >= 0 else -1
        while i >= 0 and self.spans[i].end < t:
            i = self.spans[i].parent
        return self.spans[i] if i >= 0 else None

    def within(self, thread, t: float, name: str) -> bool:
        """Whether a span ``name`` of ``thread`` is open at ``t``."""
        s = self.innermost(thread, t)
        while s is not None:
            if s.name == name:
                return True
            s = self.spans[s.parent] if s.parent >= 0 else None
        return False


def _union_us(intervals) -> float:
    total, reached = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reached:
            total += e - max(s, reached)
            reached = e
    return total


def total_us(spans: list, name: str) -> float:
    return sum(s.end - s.start for s in spans if s.name == name)


def self_us(spans: list, name: str) -> float:
    """The spans ``name`` less the union of their children."""
    children = defaultdict(list)
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            children[s.parent].append((max(s.start, p.start), min(s.end, p.end)))
    return sum(s.end - s.start - _union_us(children[i])
               for i, s in enumerate(spans) if s.name == name)


def _launcher(pt: ProgramTrace, threads: Threads, record):
    launch = pt.launches.get(record)
    return None if launch is None else threads.innermost(launch.thread, launch.at)


def glue_launches(pt: ProgramTrace) -> int:
    """Kernels that are not the port's own (copies left out) launched while
    a ``gpy.level`` span was open on the launching thread."""
    threads = Threads(pt.spans)
    n = 0
    for r in pt.trace.kernels():
        launch = pt.launches.get(r)
        if (launch is not None and not is_port_kernel(r.name)
                and threads.within(launch.thread, launch.at, LEVEL)):
            n += 1
    return n


def idle_under_pct(pt: ProgramTrace, name: str) -> float | None:
    """Share of the stretch's device idle time during which a span ``name``
    was open, in percent."""
    gaps = idle_gaps(pt.trace)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    opened = [(s.start, s.end) for s in pt.spans if s.name == name]
    under = sum(_union_us([(max(a, s), min(b, e)) for s, e in opened if s < b and e > a])
                for a, b in gaps)
    return 100.0 * under / idle


def readings(pt: ProgramTrace, units: int) -> dict:
    """The per-layer quantities of the catalog's dispatch, a spectrum each."""
    if not units:
        return {}
    ms = lambda us: us / 1e3 / units
    s = pt.spans
    out = {
        "model_host_ms_per_spectrum": ms(self_us(s, MODEL)),
        "profiles_host_ms_per_spectrum": ms(total_us(s, PROFILES)),
        "resample_host_ms_per_spectrum": ms(total_us(s, RESAMPLE)),
        "likelihood_host_ms_per_spectrum": ms(total_us(s, LIKELIHOOD)),
        "level_host_ms_per_spectrum": ms(self_us(s, LEVEL)),
        "glue_launches_per_spectrum": glue_launches(pt) / units,
        "idle_under_select_pct": idle_under_pct(pt, SELECT),
    }
    return {k: v for k, v in out.items() if v is not None}


def by_span(pt: ProgramTrace, units: int) -> dict:
    """For each span name: spans, host ms (whole and self) and kernel
    launches (the port's own and the rest, put down to the innermost span
    open at their launch) and the device's idle time ended by the records
    launched in it, a spectrum each; what no span holds counts under
    ``None``."""
    threads = Threads(pt.spans)
    table = {}
    for name in sorted({s.name for s in pt.spans}):
        table[name] = {"spans": sum(s.name == name for s in pt.spans) / units,
                       "host_ms": total_us(pt.spans, name) / 1e3 / units,
                       "self_ms": self_us(pt.spans, name) / 1e3 / units,
                       "port_launches": 0.0, "glue_launches": 0.0, "idle_ms": 0.0}
    table["None"] = {"port_launches": 0.0, "glue_launches": 0.0, "idle_ms": 0.0}
    for r in pt.trace.kernels():
        s = _launcher(pt, threads, r)
        key = "port_launches" if is_port_kernel(r.name) else "glue_launches"
        table[s.name if s is not None else "None"][key] += 1.0 / units
    for a, b, r in gaps_with_records(pt.trace):
        s = _launcher(pt, threads, r)
        table[s.name if s is not None else "None"]["idle_ms"] += (b - a) / 1e3 / units
    return table


def attributed_share(pt: ProgramTrace) -> float | None:
    """Share of the stretch's kernel records put down to a program span."""
    kernels = pt.trace.kernels()
    if not kernels:
        return None
    threads = Threads(pt.spans)
    return sum(_launcher(pt, threads, r) is not None for r in kernels) / len(kernels)


def unattributed(pt: ProgramTrace) -> list:
    """[name, launching thread or None, records] of the kernel records put
    down to no program span, most frequent first."""
    threads = Threads(pt.spans)
    counts = defaultdict(int)
    for r in pt.trace.kernels():
        if _launcher(pt, threads, r) is None:
            launch = pt.launches.get(r)
            counts[(r.name[:80], launch and launch.thread)] += 1
    return sorted(([n, t, c] for (n, t), c in counts.items()), key=lambda x: -x[2])


def gaps_with_records(trace: Trace) -> list:
    """``harness.trace.idle_gaps`` with the record ending each (None for
    the last, if the stretch ends idle)."""
    gaps, reached = [], trace.start
    for r in trace.records:
        if r.start > reached:
            gaps.append((reached, r.start, r))
        reached = max(reached, r.end)
    if trace.end > reached:
        gaps.append((reached, trace.end, None))
    return gaps


def _gap_name(pt: ProgramTrace, threads: Threads, a: float, b: float, ending) -> str:
    mid = 0.5 * (a + b)
    launch = pt.launches.get(ending)
    first = threads.innermost(launch.thread, launch.at) if launch is not None else None
    parts = [first.name if first is not None else _span_at(pt.trace.spans, mid)]
    for thread in sorted(threads.of):
        if launch is None or thread != launch.thread:
            s = threads.innermost(thread, mid)
            if s is not None:
                parts.append(s.name)
    return " | ".join(parts)


def breakdown(pt: ProgramTrace, top: int = 10) -> dict:
    """``harness.trace.breakdown``, each idle gap named by the innermost
    program span open, at its launch, on the thread that launched the
    record ending the gap, then `` | `` and the innermost span of each
    other thread open at the gap's middle; by the benchmark's own span
    where no program span was open at that launch."""
    out = bench_breakdown(pt.trace, top)
    threads = Threads(pt.spans)
    gaps = sorted(gaps_with_records(pt.trace), key=lambda g: g[0] - g[1])[:top]
    out["idle_gaps"] = [[_gap_name(pt, threads, a, b, r), (b - a) / 1e6] for a, b, r in gaps]
    return out
