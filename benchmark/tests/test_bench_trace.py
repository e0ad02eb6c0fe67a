"""The traced stretch's arithmetic and the per-layer readers, on a made-up
trace (the profiler itself needs the card)."""

import pytest

from harness import layout
from harness.result import Readings
from harness.trace import Record, Trace, breakdown, busy_s, idle_gaps

K2 = "void (anonymous namespace)::logmvn_cap_kernel<32, 16, float>(float const*)"
K3 = "void (anonymous namespace)::logmvn_chain_kernel<32>(float const*)"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
COPY = "Memcpy DtoH (Device -> Pinned)"


def made_up():
    # a 100 us stretch: two overlapping kernels, a gap, a copy, a kernel, a gap
    records = [Record(K2, 0.0, 30.0), Record(ELEM, 20.0, 40.0), Record(COPY, 50.0, 55.0),
               Record(K3, 55.0, 70.0)]
    spans = [("dispatch", 38.0, 52.0), ("wait", 70.0, 100.0)]
    return Trace(records, spans, 0.0, 100.0)


def test_busy_gaps_and_breakdown():
    t = made_up()
    assert busy_s(t) == pytest.approx(60e-6)
    assert idle_gaps(t) == [(40.0, 50.0), (70.0, 100.0)]
    b = breakdown(t)
    assert b["device_ops"][0] == [K2, pytest.approx(30e-6)]
    assert b["idle_gaps"] == [["wait", pytest.approx(30e-6)], ["dispatch", pytest.approx(10e-6)]]
    assert len(t.kernels()) == 3


def test_readers():
    r = Readings(made_up(), 2, {
        "dispatch_s_per_spectrum": 0.006, "finalize_s_per_spectrum": 0.0004,
        "least_s": {"k2": 15e-6, "k3": 3e-6}, "launches": {"k2": 1, "k3": 1},
        "step_least_s": 1e-3, "spectra_per_s": 50.0, "p95_latency_ms": 120.5})
    read = lambda name: layout.load_metric(name).read(r)
    assert read("dispatch_ms_per_spectrum") == pytest.approx(6.0)
    assert read("finalize_ms_per_spectrum") == pytest.approx(0.4)
    assert read("launches_per_spectrum") == pytest.approx(1.5)
    assert read("plain_device_ms_per_spectrum") == pytest.approx(10e-3)
    assert read("k2_roofline_pct") == pytest.approx(50.0)
    assert read("k3_roofline_pct") == pytest.approx(20.0)
    assert read("k1_roofline_pct") is None  # no K1 in this stretch: left out, never 0
    assert read("device_idle_pct") == pytest.approx(40.0)
    assert read("mfu_pct") == pytest.approx(5.0)
    assert read("mfu_pct.zqso") == pytest.approx(5.0)
    assert read("p95_latency_ms.catalog_host") == pytest.approx(120.5)
    assert read("zqso_dispatch_ms_per_spectrum") is None


def test_a_lost_record_scales_the_least_time():
    r = Readings(made_up(), 2, {"least_s": {"k2": 15e-6}, "launches": {"k2": 2}})
    assert layout.load_metric("k2_roofline_pct").read(r) == pytest.approx(25.0)
