"""ops/timing.py's window check, on the CPU with the profiled window
stubbed: a window counts only when it holds every device record of its
calls; it is taken again otherwise, and then the timing raises."""

import pytest

from gpy_dla_detection_tpu_torch.ops import timing


def stub_windows(monkeypatch, windows):
    """Each profiled window returns the next (records, device us, span ms)."""
    it = iter(windows)
    calls = []

    def window(fn, reps):
        calls.append(reps)
        return next(it)

    monkeypatch.setattr(timing, "_window", window)
    return calls


def test_a_full_window_gives_the_time_a_call(monkeypatch):
    calls = stub_windows(monkeypatch, [(100, 2_000.0, 10.0)])
    assert timing.device_ms(lambda: None, kernels=2, reps=50) == (2_000.0 / 1e3 / 50, 10.0 / 50)
    assert calls == [50]


@pytest.mark.parametrize("lost", [50, 1, 49])
def test_a_window_that_lost_records_is_taken_again(monkeypatch, lost):
    """A window short of launches (all, one, or most lost) would read as a
    time too low: the next window is used."""
    calls = stub_windows(monkeypatch, [(50 - lost, 1_000.0, 5.0), (50, 1_500.0, 5.0)])
    assert timing.device_ms(lambda: None, reps=50)[0] == 1_500.0 / 1e3 / 50
    assert calls == [50, 50]


def test_extra_records_are_refused_too(monkeypatch):
    """A call that launches more than it was said to (a hidden copy or
    fill) is not timed as if it were its kernels."""
    stub_windows(monkeypatch, [(51, 1.0, 1.0)] * 3)
    with pytest.raises(RuntimeError, match=r"\[51, 51, 51\]"):
        timing.device_ms(lambda: None, reps=50)


def test_every_window_short_raises(monkeypatch):
    stub_windows(monkeypatch, [(0, 0.0, 1.0), (48, 9.0, 1.0), (49, 9.0, 1.0)])
    with pytest.raises(RuntimeError, match="not 50"):
        timing.device_ms(lambda: None, reps=50, tries=3)


def test_an_unknown_count_is_taken_from_one_call(monkeypatch):
    """kernels=None (a library call): the count of one profiled call."""
    calls = stub_windows(monkeypatch, [(2, 9.0, 1.0), (100, 400.0, 2.0)])
    assert timing.device_ms(lambda: None, kernels=None, reps=50)[0] == 400.0 / 1e3 / 50
    assert calls == [1, 50]


def test_warm_up_calls_run_first(monkeypatch):
    stub_windows(monkeypatch, [(50, 50.0, 1.0)])
    ran = []
    timing.device_ms(lambda: ran.append(1), reps=50)
    assert len(ran) == 3  # the stubbed window makes no calls of its own


def test_busy_time_is_the_union_of_the_device_intervals():
    """Overlapping and nested device records count once; CPU records, the
    sentinel's and user annotations (a device-side range over a whole
    optimizer step) not at all."""
    from types import SimpleNamespace

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(start, end, device=cuda, name="kernel", annotation=False):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                               device_type=device, name=name, is_user_annotation=annotation)

    prof = SimpleNamespace(events=lambda: [
        event(0, 100), event(50, 150), event(60, 70), event(300, 400),
        event(0, 1_000, device=cpu), event(500, 900, name=timing.SENTINEL_KERNEL),
        event(0, 2_000, name="Optimizer.step#LBFGS.step", annotation=True)])
    assert timing.union_busy_ms(prof) == (150 + 100) / 1e3
    assert timing.union_busy_ms(SimpleNamespace(events=lambda: [])) == 0.0
