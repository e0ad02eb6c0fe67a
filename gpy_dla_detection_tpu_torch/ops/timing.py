"""Device time of a call, by the profiler, with its kernels counted.

Where a kernel is shorter than its wrapper's host time, CUDA events around
back-to-back calls measure the host; the profiler's CUPTI records give the
kernels' own time.  The profiler can lose records on the card, a whole
window or some of its launches, which would read as a time too low: so a
window counts only when it holds exactly the kernel launches the calls
make, and is taken again otherwise.

Used by ``chip_smoke.py`` and ``scripts/k2_k3_turns.py``; needs only
``torch``, so a script may load this file on its own.
"""

from __future__ import annotations

import torch


def _window(fn, reps: int):
    """(device records, their device us, the CUDA events' span in ms) of
    ``reps`` back-to-back calls."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    records = [e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CPU]
    return (sum(e.count for e in records), sum(e.self_device_time_total for e in records),
            start.elapsed_time(end))


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
