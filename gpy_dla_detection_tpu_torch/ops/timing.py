"""Device time of a call, by the profiler, with its kernels counted.

Where a kernel is shorter than its wrapper's host time, CUDA events around
back-to-back calls measure the host; the profiler's CUPTI records give the
kernels' own time.  The profiler can lose records on the card, a whole
window or some of its launches, which would read as a time too low: so a
window counts only when it holds exactly the kernel launches the calls
make, and is taken again otherwise.

The losses come at a window's start: on the card the profiler can miss
the kernels launched first after it starts.  So each window, and any
profiled run that reads its records, first runs a sentinel kernel for
~10 ms and waits for it (:func:`prime_profiler`); the sentinel's records
are left out.  ``tests/test_torch_kernels_gpu.py::
test_device_ms_windows_hold_every_launch`` holds twenty windows in a row
to every launch.

A kernel longer than its launch's host time can be timed more simply, by
CUDA events around back-to-back calls (:func:`events_ms`).

Used by ``chip_smoke.py``, ``scripts/k2_k3_turns.py`` and the kernels'
sweeps (``ops/*_sweep.py``); needs only ``torch``, so a script may load this
file on its own.
"""

from __future__ import annotations

import torch

SENTINEL_KERNEL = "spin_kernel"  # the kernel of torch.cuda._sleep
SENTINEL_LAUNCHES = 8
SENTINEL_CYCLES = 2_500_000  # ~1.3 ms of spin a launch, ~10 ms in all


def prime_profiler() -> None:
    """Run the sentinel kernel ``SENTINEL_LAUNCHES`` times and wait for it,
    under a profiler just started, so that its records of the kernels
    after it are complete; leave out records whose name holds
    ``SENTINEL_KERNEL``.  A single ~1 ms sentinel was not always enough:
    a window of K2 at k = 54 still lost a launch after it."""
    for _ in range(SENTINEL_LAUNCHES):
        torch.cuda._sleep(SENTINEL_CYCLES)
    torch.cuda.synchronize()


def _window(fn, reps: int):
    """(device records, their device us, the CUDA events' span in ms) of
    ``reps`` back-to-back calls, the sentinel's left out."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prime_profiler()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    records = [e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CPU
               and SENTINEL_KERNEL not in e.key]
    return (sum(e.count for e in records), sum(e.self_device_time_total for e in records),
            start.elapsed_time(end))


def union_busy_ms(prof) -> float:
    """Milliseconds in which at least one device record of the profiled run
    ``prof`` ran: the union of the records' intervals, the sentinel's and
    the user annotations' left out (``Optimizer.step#LBFGS.step`` is a
    device-side range over a whole step, idle time included).  Unlike a
    sum of the records' times it counts a moment once however many records
    overlap it."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and not e.is_user_annotation and SENTINEL_KERNEL not in e.name)
    total, reached = 0.0, float("-inf")
    for start, end in spans:
        if end > reached:
            total += end - max(start, reached)
            reached = end
    return total / 1e3


def device_ms(fn, kernels: int | None = 1, reps: int = 50,
              tries: int = 3) -> tuple[float, float]:
    """Milliseconds a call of ``fn()`` over ``reps`` back-to-back calls,
    after a warm-up: the profiler's kernel time, and the CUDA events' span
    of the calls (the host's time where it exceeds the kernels').

    :param kernels: the device records (kernels, copies, fills) one call
        makes, or None for a library call whose count is not known: the
        count of one profiled call.  A window holding other than ``reps *
        kernels`` of them is taken again, up to ``tries`` windows, and then
        this raises.
    """
    for _ in range(3):
        fn()
    if kernels is None:
        kernels = _window(fn, 1)[0]
    seen = []
    for _ in range(tries):
        count, us, span = _window(fn, reps)
        seen.append(count)
        if count == reps * kernels and count > 0:
            return us / 1e3 / reps, span / reps
    raise RuntimeError(
        f"the profiler recorded {seen} device records in {tries} windows of {reps} calls, "
        f"not {reps * kernels}")


def events_ms(fn, reps: int = 50) -> float:
    """Milliseconds a call of ``fn()`` by CUDA events around ``reps``
    back-to-back calls, after a warm-up: the device time of a kernel that
    is longer than its launch's host time."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
