"""The program's spans in a traced stretch (``harness/spans.py``), on a
made-up stretch with spans on two threads: the per-layer quantities,
launches put down by correlation, the idle gaps named by the program, and
the refusal of a stretch whose recorder dropped spans."""

import pytest

from harness import spans
from harness.trace import Record, Trace, breakdown

K1 = "void absorption_all_kernel<true>(float const*)"
K2 = "void (anonymous namespace)::logmvn_cap_kernel<32, 16, float>(float const*)"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
GATHER = "void at::native::index_elementwise_kernel<128, 4>"
COPY = "Memcpy DtoH (Device -> Pinned)"
MAIN, FIN = 101, 202

# a 100 us stretch: one batch's dispatch on MAIN, a finalize on FIN
SPANS = [
    spans.Span("gpy.dispatch", MAIN, -1, 0.0, 100.0),  # 0
    spans.Span("gpy.model", MAIN, 0, 0.0, 10.0),  # 1
    spans.Span("gpy.profiles", MAIN, 0, 10.0, 20.0),  # 2
    spans.Span("gpy.level", MAIN, 0, 20.0, 50.0),  # 3
    spans.Span("gpy.likelihood", MAIN, 3, 22.0, 40.0),  # 4
    spans.Span("gpy.level", MAIN, 0, 50.0, 90.0),  # 5
    spans.Span("gpy.resample", MAIN, 5, 50.0, 60.0),  # 6
    spans.Span("gpy.likelihood", MAIN, 5, 60.0, 80.0),  # 7
    spans.Span("gpy.readback", MAIN, 0, 90.0, 98.0),  # 8
    spans.Span("gpy.finalize", FIN, -1, 30.0, 70.0),  # 9
    spans.Span("gpy.select", FIN, 9, 35.0, 65.0),  # 10
]
# (record, launched at): a glue kernel in the model, K1 in the profiles, K2
# in a likelihood, glue in a level's own time, a gather in a resample, glue
# after a likelihood, a copy in the readback
RECORDS = [(Record(ELEM, 2.0, 5.0), 1.0), (Record(K1, 12.0, 15.0), 11.0),
           (Record(K2, 41.0, 44.0), 30.0), (Record(ELEM, 45.0, 47.0), 44.0),
           (Record(GATHER, 56.0, 58.0), 55.0), (Record(ELEM, 85.0, 88.0), 85.0),
           (Record(COPY, 95.0, 97.0), 91.0)]
BENCH_SPANS = [("dispatch", 0.0, 99.0), ("wait", 99.0, 100.0)]


def made_up(program_spans=SPANS):
    trace = Trace([r for r, _ in RECORDS], BENCH_SPANS, 0.0, 100.0)
    return spans.ProgramTrace(trace, program_spans,
                              {r: spans.Launch(MAIN, at) for r, at in RECORDS})


def test_readings_by_hand():
    got = spans.readings(made_up(), 2)
    ms = lambda us: us / 1e3 / 2
    assert got["model_host_ms_per_spectrum"] == pytest.approx(ms(10))
    assert got["profiles_host_ms_per_spectrum"] == pytest.approx(ms(10))
    assert got["resample_host_ms_per_spectrum"] == pytest.approx(ms(10))
    assert got["likelihood_host_ms_per_spectrum"] == pytest.approx(ms(18 + 20))
    # the levels less their children: 30 - 18, 40 - (10 + 20)
    assert got["level_host_ms_per_spectrum"] == pytest.approx(ms(12 + 10))
    # glue launched inside a level: the level's own, the resample's gather,
    # after the likelihood; not K2, not the model's, not the copy
    assert got["glue_launches_per_spectrum"] == pytest.approx(3 / 2)
    # idle 2 + 7 + 26 + 1 + 9 + 27 + 7 + 3 = 82 us; under the select (35-65):
    # 6 + 1 + 9 + 7 = 23
    assert got["idle_under_select_pct"] == pytest.approx(100 * 23 / 82)


def test_dispatch_is_the_sum_of_its_parts():
    pt, units = made_up(), 2
    got, table = spans.readings(pt, units), spans.by_span(pt, units)
    parts = sum(v for k, v in got.items() if k.endswith("_host_ms_per_spectrum"))
    whole = table["gpy.dispatch"]["host_ms"]
    assert table["gpy.dispatch"]["self_ms"] == pytest.approx(2 / 1e3 / units)
    assert parts + table["gpy.readback"]["host_ms"] + table["gpy.dispatch"]["self_ms"] \
        == pytest.approx(whole)
    assert table["gpy.profiles"]["port_launches"] == pytest.approx(0.5)
    assert table["gpy.likelihood"]["port_launches"] == pytest.approx(0.5)
    assert table["gpy.level"]["glue_launches"] == pytest.approx(1.0)
    assert spans.attributed_share(pt) == 1.0


def test_the_innermost_span_walks_up_past_closed_children():
    threads = spans.Threads(SPANS)
    assert threads.innermost(MAIN, 85.0).name == "gpy.level"  # its likelihood ended at 80
    assert threads.innermost(MAIN, 99.0).name == "gpy.dispatch"
    assert threads.innermost(FIN, 20.0) is None and threads.innermost(FIN, 66.0).name == \
        "gpy.finalize"
    assert threads.within(MAIN, 55.0, "gpy.level") and not threads.within(MAIN, 15.0, "gpy.level")


def test_breakdown_names_gaps_by_the_launching_thread_then_the_others():
    got = spans.breakdown(made_up(), top=20)
    bench = breakdown(made_up().trace, top=20)
    assert got["device_ops"] == bench["device_ops"]
    assert [g[1] for g in got["idle_gaps"]] == [g[1] for g in bench["idle_gaps"]]
    assert got["idle_gaps"] == [
        ["gpy.level", pytest.approx(27e-6)],  # launched after the second likelihood
        ["gpy.likelihood", pytest.approx(26e-6)],  # K2, launched in the first likelihood
        ["gpy.resample | gpy.select", pytest.approx(9e-6)],
        ["gpy.profiles", pytest.approx(7e-6)],
        ["gpy.readback", pytest.approx(7e-6)],
        ["dispatch | gpy.dispatch", pytest.approx(3e-6)],  # no record ends it
        ["gpy.model", pytest.approx(2e-6)],
        ["gpy.level | gpy.select", pytest.approx(1e-6)],
    ]


def test_without_program_spans_the_gaps_keep_the_benchmark_names():
    got = spans.breakdown(made_up([]))
    assert got == breakdown(made_up().trace)
    assert spans.readings(made_up([]), 2)["glue_launches_per_spectrum"] == 0


def test_a_stretch_that_dropped_spans_is_refused():
    class Recording(list):
        dropped = 0

    rec = Recording([("gpy.dispatch", MAIN, -1, 5_000, 9_000)])
    assert spans.on_clock(rec, 1_000) == [spans.Span("gpy.dispatch", MAIN, -1, 4.0, 8.0)]
    rec.dropped = 1
    with pytest.raises(ValueError, match="dropped 1"):
        spans.on_clock(rec, 1_000)


class Event:
    """A profile event as ``kineto_results.events()`` gives it (times in ns)."""

    def __init__(self, name, corr, linked, start_us, device="cuda", thread=0, annotation=False):
        from torch.autograd import DeviceType

        self.values = {"name": name, "correlation_id": corr, "linked_correlation_id": linked,
                       "start_ns": int(1e3 * start_us) + T0, "device_resource_id": thread,
                       "end_ns": int(1e3 * (start_us + 2)) + T0,
                       "is_user_annotation": annotation,
                       "device_type": DeviceType.CPU if device == "cpu" else DeviceType.CUDA}

    def __getattr__(self, name):
        return lambda: self.values[name]


T0 = 1_792_000_000_000_000_000  # the profile's trace_start_ns


def test_launches_by_correlation():
    events = [
        Event("aten::add", 7, 0, 10.0, "cpu", MAIN),  # an op
        Event("cudaLaunchKernel", 900, 7, 12.0, "cpu", MAIN),  # its runtime call
        Event(ELEM, 900, 7, 20.0),  # the kernel it launched
        Event("cudaLaunchKernel", 901, 0, 14.0, "cpu", MAIN),  # a launch outside any op
        Event(K2, 901, 0, 30.0),  # ... the port's kernel it launched
        Event("aten::index", 8, 0, 15.0, "cpu", FIN),  # an op on another thread
        Event(GATHER, 902, 8, 40.0),  # whose runtime call is missing
        Event(ELEM, 903, 99, 50.0),  # linked to nothing recorded
        Event(K1, 904, 0, 60.0),  # launched by nothing recorded
        Event("bench.dispatch", 9, 0, 1.0, "cuda", annotation=True),  # a range on the card
    ]
    got = spans.read_launches(events, T0)
    assert got == {(20.0, 22.0): spans.Launch(MAIN, 12.0), (30.0, 32.0): spans.Launch(MAIN, 14.0),
                   (40.0, 42.0): spans.Launch(FIN, 15.0)}
    trace = Trace([Record(ELEM, 20.0, 22.0), Record(K2, 30.0, 32.0), Record(ELEM, 50.0, 52.0)],
                  [], 0.0, 60.0)
    pt = spans.program_trace(trace, [], got)
    assert pt.launches == {trace.records[0]: spans.Launch(MAIN, 12.0),
                           trace.records[1]: spans.Launch(MAIN, 14.0)}


def test_idle_time_goes_to_the_span_that_launched_the_record_ending_it():
    table = spans.by_span(made_up(), 1)
    # gaps: 0-2 (model), 5-12 (profiles), 15-41 (likelihood), 44-45 (level),
    # 47-56 (resample), 58-85 (level), 88-95 (the copy, a readback), 97-100 (none)
    want = {"gpy.model": 2, "gpy.profiles": 7, "gpy.likelihood": 26, "gpy.level": 28,
            "gpy.resample": 9, "gpy.readback": 7, "None": 3, "gpy.dispatch": 0}
    for name, us in want.items():
        assert table[name]["idle_ms"] == pytest.approx(us / 1e3), name
    assert spans.unattributed(made_up()) == []
