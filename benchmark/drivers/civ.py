"""The ``civ.window`` cell's runs: ``run_civ.py``'s in-flight window in one process.

Each batch of spectra is dispatched with ``models/civ.dispatch_civ_batch``,
its evidences and per-sample log-likelihoods queued to the host with
``utils/pipeline.start_readback``, and, once more than ``in_flight``
batches are queued, the oldest is read back (its readback event waited
on) and finalized with ``finalize_civ_batch``, on the one thread, as
``civ_inference_many`` runs them through ``pipelined_batches``; the
per-sample log-likelihoods are kept for the comparison.  The loop is
closed: a batch is dispatched when the window has room.

The spectra are a pool drawn once from the seed (quasar redshifts spread
over the traffic's range, a CIV doublet injected in every other one, in an
order the seed shuffles), cycled through the window.  Once the window has
closed a sample of the spectra it completed, drawn from the seed, is
judged against ``reference/civ.py``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import sys
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np

from drivers.catalog import Reservoir
from harness import counts, counts_civ, gen, gen_civ
from harness.result import Outcome, Readings, is_k2, is_k3, quantile
from reference import catalog as ref_catalog
from reference import civ as ref

KERNELS = {"k2": is_k2, "k3": is_k3}


class Inputs(NamedTuple):
    learned: gen.Learned
    samples: gen_civ.CIVSamples
    pool: list  # gen.CatalogSpectrum
    order: np.ndarray  # the pool's order of dispatch


def make_inputs(cfg: dict, traffic: dict, seed: int) -> Inputs:
    """Everything a run feeds the program and the reference, from ``seed``."""
    learned = gen_civ.civ_learned_model(cfg, gen.rng_for(seed, 1))
    pool, _ = gen_civ.civ_pool(cfg, traffic, learned, seed)
    return Inputs(learned, gen_civ.civ_samples(cfg), pool,
                  gen.rng_for(seed, 4).permutation(len(pool)))


@dataclasses.dataclass
class Batch:
    number: int
    members: list  # pool indices
    readback: object  # utils.pipeline.Readback
    t_dispatch: float
    dispatch_s: float


class Completed(NamedTuple):
    batch: Batch
    results: list  # (p_civ, null, civ) per spectrum, or None where the batch raised
    sample_lls: np.ndarray | None  # (B, S)
    finalize_s: float
    t_done: float


class Program:
    """The program under test, set up for one run: the port's CIV window
    over the pool."""

    def __init__(self, cfg, traffic, inputs: Inputs, device):
        import torch

        from gpy_dla_detection_tpu_torch.data.spectrum import Spectrum
        from gpy_dla_detection_tpu_torch.models import civ
        from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
        from gpy_dla_detection_tpu_torch.params import CIVParameters
        from gpy_dla_detection_tpu_torch.utils.pipeline import start_readback

        fields = {f.name for f in dataclasses.fields(CIVParameters)}
        self.params = CIVParameters(**{k: v for k, v in cfg.items() if k in fields})
        self.civ, self.cfg, self.traffic, self.inputs = civ, cfg, traffic, inputs
        self.start_readback = start_readback
        self.learned = LearnedModel.from_numpy(list(inputs.learned), device, torch.float32)
        self.samples = civ.civ_sample_tensors(civ.CIVSamples(*inputs.samples), self.learned)
        self.spectra = [Spectrum(*p) for p in inputs.pool]
        self.count = 0  # batches dispatched

    def dispatch(self) -> Batch:
        B, n = self.traffic["batch_size"], len(self.spectra)
        members = [int(self.inputs.order[(self.count * B + j) % n]) for j in range(B)]
        t0 = time.perf_counter()
        rb = self.start_readback(self.civ.dispatch_civ_batch(
            self.learned, [self.spectra[i] for i in members], self.samples, self.params))
        t1 = time.perf_counter()
        self.count += 1
        return Batch(self.count - 1, members, rb, t0, t1 - t0)

    def window(self, on_done, until=None, batches=None, span=None):
        """Run the in-flight window, dispatching until the clock reaches
        ``until`` or ``batches`` have been dispatched, then drain it;
        ``on_done(Completed)`` sees every batch in order.  ``span`` wraps
        each call into the program (the traced stretch's spans)."""
        span = span or (lambda name: contextlib.nullcontext())
        inflight = collections.deque()
        sent = 0

        def drain():
            b = inflight.popleft()
            results = lls = None
            finalize_s = 0.0
            try:
                with span("wait"):
                    host = b.readback.result()
                t0 = time.perf_counter()
                with span("finalize"):
                    results = self.civ.finalize_civ_batch(host[0], self.traffic["p_civ_prior"])
                finalize_s, lls = time.perf_counter() - t0, host[1]
            except Exception as e:  # a failed batch counts its spectra as failed
                print(f"batch {b.number} raised {type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
            on_done(Completed(b, results, lls, finalize_s, time.perf_counter()))

        while (until is None or time.perf_counter() < until) and (
                batches is None or sent < batches):
            with span("dispatch"):
                inflight.append(self.dispatch())
            sent += 1
            while len(inflight) > self.traffic["in_flight"]:
                drain()
        while inflight:
            drain()


def answered(result) -> bool:
    """Whether a spectrum's two evidences are finite."""
    return math.isfinite(result[1]) and math.isfinite(result[2])


def judge(cfg, traffic, inputs: Inputs, sample, device, control=False) -> dict:
    """Each number over the sampled spectra: ``<gap>_gap``, the largest of
    a gap of ``reference.civ.compare``, and ``<gap>_rms``, its root mean
    square over every value of every sampled spectrum (inf where an answer
    is missing on one side).  The traffic's ``limits`` say which are
    compared.

    :param sample: [(pool index, (p_civ, null, civ), (S,) sample lls)].
    :param control: put the reference in float32 with TF32 products in the
        program's place (the control's readings).
    """
    prior = traffic["p_civ_prior"]
    total = {}
    for i, (_, null, civ), lls in sample:
        args = (inputs.learned, inputs.pool[i], inputs.samples, cfg, prior, device)
        if control:
            got = ref.reference_spectrum(*args, ref_catalog.CONTROL)
        else:
            got = ref.Result(null, civ, lls, ref.log_posteriors(null, civ, prior))
        for name, g in ref.compare(got, ref.reference_spectrum(*args)).items():
            total.setdefault(name, ref_catalog.Gaps()).merge(g)
    numbers = {}
    for name, t in total.items():
        numbers[f"{name}_gap"] = t.top
        numbers[f"{name}_rms"] = t.rms
    return numbers


def least(cfg, n: int) -> tuple[dict, dict, float]:
    """The least seconds of each kernel's work for ``n`` spectra, the
    launches that work assumes, and the least seconds of a spectrum's step."""
    S, N, k = cfg["num_civ_samples"], cfg["num_pixels_padded"], cfg["k"]
    k2, k3 = counts.k2_least_s(S, N, k, 0), counts.k3_least_s(S, k)
    return ({"k2": n * k2, "k3": n * k3}, {"k2": n, "k3": n},
            counts_civ.civ_step_least_s(S, N + 6, N, k))


def device_s_by_span(pt) -> dict:
    """Device seconds of the stretch's records by the innermost program span
    open at their launch on the launching thread (``"None"``: no span)."""
    from harness.spans import Threads

    threads, out = Threads(pt.spans), defaultdict(float)
    for rec in pt.trace.records:
        launch = pt.launches.get(rec)
        s = None if launch is None else threads.innermost(launch.thread, launch.at)
        out[s.name if s is not None else "None"] += (rec.end - rec.start) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> Outcome:
    import torch

    # the head's batch entry points: a program without them fails here, at once
    from gpy_dla_detection_tpu_torch.models.civ import dispatch_civ_batch  # noqa: F401

    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from gpy_dla_detection_tpu_torch.ops import _build

        _build.load_library("kernels")
    inputs = make_inputs(cfg, traffic, seed)
    program = Program(cfg, traffic, inputs, device)
    B = traffic["batch_size"]
    program.window(lambda c: None, batches=traffic["warm_batches"])
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")

    keep = Reservoir(traffic["check_spectra"], gen.rng_for(seed, 9))
    latencies, done, failed = [], [0], [0]
    host = {"dispatch": 0.0, "finalize": 0.0}
    t_open = time.perf_counter()
    t_close = t_open + seconds

    def on_done(c: Completed):
        if c.results is None:
            failed[0] += len(c.batch.members)
            return
        failed[0] += sum(not answered(r) for r in c.results)
        if c.t_done <= t_close:
            latencies.append(c.t_done - c.batch.t_dispatch)
            done[0] += len(c.results)
            host["dispatch"] += c.batch.dispatch_s
            host["finalize"] += c.finalize_s
            for j, (i, r) in enumerate(zip(c.batch.members, c.results)):
                keep.offer((i, r, c.sample_lls[j]))

    first = program.count
    program.window(on_done, until=t_close)
    attempted = (program.count - first) * B
    rate = done[0] / seconds
    p95 = 1e3 * quantile(latencies, 0.95)
    log(f"window: {done[0]} spectra in {len(latencies)} batches completed in {seconds} s; "
        f"{attempted} dispatched; batch latency ms median "
        f"{1e3 * float(np.median(latencies)) if latencies else math.nan}, p95 {p95}; host ms "
        f"a spectrum: dispatch {1e3 * host['dispatch'] / max(done[0], 1)}, "
        f"finalize {1e3 * host['finalize'] / max(done[0], 1)}")
    metrics = {"spectra_per_s": rate, "setup_s": setup_s}

    busy = window_s = breakdown = None
    if trace:
        from harness import spans
        from harness import trace as tr

        from gpy_dla_detection_tpu_torch.ops._build import launch_counts

        n = traffic["trace_batches"] * B
        before = dict(launch_counts)
        with spans.profiled(device) as box:
            program.window(lambda c: None, batches=traffic["trace_batches"],
                           span=lambda name: torch.profiler.record_function("bench." + name))
        pt = box[0]
        k_least, launches, step = least(cfg, n)
        counted = {k: v - before.get(k, 0) for k, v in launch_counts.items()
                   if v != before.get(k, 0)}
        log(f"traced stretch: {n} spectra; the port counted {counted}; the rooflines assume "
            f"{launches}; the profiler holds "
            + ", ".join(f"{k} {tr.device_seconds(pt.trace, t)[0]}" for k, t in KERNELS.items())
            + f"; kernel records put down to a program span: {spans.attributed_share(pt)}"
            + f"; to none: {spans.unattributed(pt)[:4]}")
        S, P = cfg["num_civ_samples"], cfg["num_pixels_padded"] + 6
        readings = Readings(pt.trace, n, {
            "dispatch_s_per_spectrum": host["dispatch"] / max(done[0], 1),
            "finalize_s_per_spectrum": host["finalize"] / max(done[0], 1),
            "p95_latency_ms": p95,
            "least_s": k_least, "launches": launches,
            "civ_profile_least_s": counts_civ.civ_profile_least_s(S, P),
            "program_trace": pt, "step_least_s": step, "spectra_per_s": rate})
        busy, window_s = tr.busy_s(pt.trace), pt.trace.window_s
        breakdown = spans.breakdown(pt)
        breakdown["device_s_by_span"] = device_s_by_span(pt)
        breakdown["attributed_share"] = spans.attributed_share(pt)
        metrics = {"readings": readings}
    memory = torch.cuda.max_memory_allocated(device) if cuda else 0
    del program
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(cfg, traffic, inputs, keep.items, device)
    limits = traffic["limits"]
    checks = [(name, numbers.get(name, math.inf), limits[name]) for name in limits]
    correct = bool(keep.items) and all(v <= lim for _, v, lim in checks)
    log(f"compared {len(keep.items)} spectra of {keep.seen} completed in the window; "
        + ", ".join(f"{k} {v!r}" for k, v in sorted(numbers.items())))
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    return Outcome(correct, attempted, failed[0], metrics, kind, 1, memory, checks,
                   busy, window_s, breakdown)


def calibrate(cell, seeds, seconds: float, device, log) -> list:
    """For each seed a short window at the cell's load, then the readings of
    the program's sampled spectra and of the control on the same spectra:
    [(seed, program's numbers, control's numbers)]."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    if torch.device(device).type == "cuda":
        from gpy_dla_detection_tpu_torch.ops import _build

        _build.load_library("kernels")
    rows = []
    for seed in seeds:
        inputs = make_inputs(cfg, traffic, seed)
        program = Program(cfg, traffic, inputs, device)
        keep = Reservoir(traffic["check_spectra"], gen.rng_for(seed, 9))
        program.window(lambda c: None, batches=traffic["warm_batches"])

        def on_done(c):
            for j, (i, r) in enumerate(zip(c.batch.members, c.results)):
                keep.offer((i, r, c.sample_lls[j]))

        program.window(on_done, until=time.perf_counter() + seconds)
        del program
        t0 = time.perf_counter()
        got = judge(cfg, traffic, inputs, keep.items, device)
        t1 = time.perf_counter()
        ctl = judge(cfg, traffic, inputs, keep.items, device, control=True)
        log(f"seed {seed}: program {got} control {ctl}; {keep.seen} spectra in the window, "
            f"judged {len(keep.items)} in {t1 - t0:.1f} s")
        rows.append((seed, got, ctl))
    return rows
