"""The port's span recorder (``utils.timing.span`` / ``recording``) and the
spans of the catalog and zQSO paths, on the CPU.

* the span tree of one catalog batch (B = 2, max_dlas = 4, the DLA and
  subDLA samples sharing their offsets): one ``gpy.dispatch`` holding one
  ``gpy.model``, B ``gpy.profiles``, 5B ``gpy.level`` (each holding its
  ``gpy.likelihood``, and the chained ones a ``gpy.resample``) and one
  ``gpy.readback``; ``gpy.finalize`` holding ``gpy.select``;
* a batch finalized on a pool thread records its spans under that
  thread's native id;
* the zQSO exact scan: one ``gpy.scan_dispatch`` holding a
  ``gpy.scan_chunk`` per ``EXACT_CHUNK`` candidates, then ``gpy.scan_wait``;
* off, ``span()`` is the shared null context, records nothing and enters
  no profiler code; the outputs are equal bit for bit with recording on
  and off;
* the bound, the dropped count and the refusal of a second block;
* the clock: a span around a ``record_function`` range, put on a CPU
  profile's clock as the benchmark's harness does, contains the range.
"""

import concurrent.futures
import math
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu_torch.data import synthetic as TSyn
from gpy_dla_detection_tpu_torch.data.samples import generate_dla_samples, generate_subdla_samples
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.models import zqso as TZ
from gpy_dla_detection_tpu_torch.parallel.batch import (
    device_put_inputs,
    dispatch_batch,
    finalize_batch,
)
from gpy_dla_detection_tpu_torch.params import Parameters, ZParameters
from gpy_dla_detection_tpu_torch.utils import timing

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
S = 50
B = 2
MAX_DLAS = 4
# the spans of one batch's dispatch and finalize
TREE = {"gpy.dispatch": 1, "gpy.model": 1, "gpy.profiles": B, "gpy.level": 5 * B,
        "gpy.resample": (MAX_DLAS - 1) * B, "gpy.likelihood": 5 * B, "gpy.readback": 1,
        "gpy.finalize": 1, "gpy.select": 1}


@pytest.fixture(scope="module")
def batch():
    params = Parameters(num_dla_samples=S, k=8)
    learned = synthetic_learned_model(params)
    spectra = [synthetic_spectrum(params, learned, z, seed=i, dlas=[(z - 0.3, 21.0)] if i else None)
               for i, z in enumerate((2.9, 3.3))]
    dla, sub = generate_dla_samples(params), generate_subdla_samples(params)
    inputs = device_put_inputs(learned, dla, sub, "cpu", torch.float32)
    assert inputs.shared_offsets
    return params, spectra, sub, synthetic_prior_catalog(params), inputs


def _run(batch, finalize=None):
    params, spectra, sub, prior, inputs = batch
    out = dispatch_batch(inputs, spectra, params, torch.Generator().manual_seed(5), MAX_DLAS)
    if finalize is None:
        return finalize_batch(out, spectra, sub, prior, MAX_DLAS)
    return finalize(finalize_batch, out, spectra, sub, prior, MAX_DLAS)


def _names(recorded):
    return Counter(s[0] for s in recorded)


def _parent(recorded, s):
    return recorded[s[2]] if s[2] >= 0 else None


def _assert_nested(recorded):
    """Every span lies within its parent, on its parent's thread."""
    for s in recorded:
        p = _parent(recorded, s)
        if p is not None:
            assert p[1] == s[1] and p[3] <= s[3] and s[4] <= p[4], (s, p)


def test_catalog_batch_span_tree(batch):
    with timing.recording() as recorded:
        _run(batch)
    assert recorded.dropped == 0
    assert _names(recorded) == TREE
    _assert_nested(recorded)
    parent = lambda s: (_parent(recorded, s) or ("",))[0]
    want = {"gpy.dispatch": "", "gpy.model": "gpy.dispatch", "gpy.profiles": "gpy.dispatch",
            "gpy.level": "gpy.dispatch", "gpy.resample": "gpy.level",
            "gpy.likelihood": "gpy.level", "gpy.readback": "gpy.dispatch",
            "gpy.finalize": "", "gpy.select": "gpy.finalize"}
    for s in recorded:
        assert parent(s) == want[s[0]], s
    assert {s[1] for s in recorded} == {threading.get_native_id()}
    # each level: its likelihood, and from the second DLA level on a resample first
    levels = [i for i, s in enumerate(recorded) if s[0] == "gpy.level"]
    kids = [[recorded[j][0] for j, c in enumerate(recorded) if c[2] == i] for i in levels]
    assert Counter(map(tuple, kids)) == {("gpy.likelihood",): 2 * B,
                                        ("gpy.resample", "gpy.likelihood"): (MAX_DLAS - 1) * B}


def test_finalize_thread_records_its_spans(batch):
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    worker = pool.submit(threading.get_native_id).result()
    assert worker != threading.get_native_id()
    with timing.recording() as recorded:
        _run(batch, lambda fn, *a: pool.submit(fn, *a).result())
    pool.shutdown()
    assert recorded.dropped == 0
    threads = {s[0]: s[1] for s in recorded}
    assert threads["gpy.finalize"] == threads["gpy.select"] == worker
    assert threads["gpy.dispatch"] == threads["gpy.level"] == threading.get_native_id()
    _assert_nested(recorded)


def test_zqso_exact_scan_spans(monkeypatch):
    learned, obs = TSyn.synthetic_z_observation(3.2, seed=0, k=5, obs_seed=4)
    spec = TZ.prepare_z_spectrum(*obs, 5632)
    Z = 250
    monkeypatch.setattr(TZ, "EXACT_CHUNK", 100)
    with timing.recording() as recorded:
        _, rb = TZ.dispatch_scan(learned.to("cpu", torch.float32), spec,
                                 ZParameters(num_zqso_samples=Z), method="exact")
        rb.result()
    assert recorded.dropped == 0
    assert _names(recorded) == {"gpy.scan_dispatch": 1, "gpy.scan_chunk": math.ceil(Z / 100),
                                "gpy.scan_wait": 1}
    assert all(recorded[s[2]][0] == "gpy.scan_dispatch"
               for s in recorded if s[0] == "gpy.scan_chunk")
    assert recorded[-1][0] == "gpy.scan_wait" and recorded[-1][2] == -1
    _assert_nested(recorded)


def test_span_off_records_nothing_and_enters_no_profiler(batch, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span entered profiler code")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    assert timing.span("gpy.dispatch") is timing.span("gpy.level") is timing._NULL_SPAN
    with timing.recording() as recorded:
        pass
    _run(batch)
    assert recorded == [] and recorded.dropped == 0
    with timing.recording() as recorded:
        _run(batch)
    assert _names(recorded) == TREE


def _fields(results):
    for r in results:
        for name in ("log_evidence_null", "log_evidences_dla", "log_evidence_subdla",
                     "sample_log_likelihoods_dla", "sample_log_likelihoods_subdla",
                     "base_sample_inds", "map_z_dlas", "map_log_nhis"):
            yield name, np.asarray(getattr(r, name))
        yield "log_posteriors", np.asarray(r.selection.log_posteriors)


def test_outputs_equal_with_recording_on_and_off(batch):
    off = _run(batch)
    with timing.recording():
        on = _run(batch)
    for (name, a), (_, b) in zip(_fields(off), _fields(on), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), name


def test_recording_bound_dropped_and_one_block_at_a_time():
    with timing.recording(limit=3) as recorded:
        with timing.span("a"):
            for name in "bcde":
                with timing.span(name):
                    pass
        with pytest.raises(RuntimeError):
            with timing.recording():
                pass
    assert [s[0] for s in recorded] == ["a", "b", "c"] and recorded.dropped == 2
    assert [s[2] for s in recorded] == [-1, 0, 0]
    assert all(s[3] <= s[4] for s in recorded)


def test_span_open_at_the_end_counts_as_dropped():
    with timing.recording() as recorded:
        held = timing.span("open")
        held.__enter__()
    held.__exit__(None, None, None)
    assert recorded[0][0] == "open" and recorded[0][4] is None and recorded.dropped == 1


def test_threads_record_concurrently_without_losing_a_span():
    """Many threads entering nested spans at a short switch interval: every
    span kept once, under its own thread and parent, none dropped."""
    workers, depth, rounds = 16, 3, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(rounds):
                with timing.span(f"a{i}"), timing.span(f"b{i}"), timing.span(f"c{i}"):
                    pass
            return threading.get_native_id()

        with timing.recording() as recorded:
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                tids = list(pool.map(work, range(workers), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert recorded.dropped == 0 and len(recorded) == workers * depth * rounds
    assert Counter(s[0] for s in recorded) == {
        f"{x}{i}": rounds for i in range(workers) for x in "abc"}
    _assert_nested(recorded)
    tid_of = {f"{x}{i}": t for i, t in enumerate(tids) for x in "abc"}
    for s in recorded:
        assert s[1] == tid_of[s[0]]
        assert s[2] == -1 if s[0][0] == "a" else recorded[s[2]][0] == chr(ord(s[0][0]) - 1) + s[0][1:]


def test_span_on_the_profile_clock_contains_its_range():
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from harness import spans
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.recording() as recorded:
            with timing.span("gpy.outer"):
                with record_function("inner"):
                    torch.ones(1000).sum()
    (outer,) = spans.on_clock(recorded, prof.profiler.kineto_results.trace_start_ns())
    (inner,) = [e for e in prof.events() if e.name == "inner"]
    assert outer.start <= inner.time_range.start <= inner.time_range.end <= outer.end
    assert outer.thread == threading.get_native_id()
