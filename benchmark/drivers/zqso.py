"""The zQSO driver: the redshift scan's in-flight window in one process.

``models/zqso.dispatch_scan`` enqueues one spectrum's scan over the
redshift grid (by the traffic's ``method``; "auto", the default every
entry point passes, takes the correlation scan on a log-uniform pixel grid
and the exact scan on any other, such as a linear one) and the copy of its (Z,) log likelihoods into a pinned
buffer behind an event; up to ``in_flight`` scans stay queued and the
oldest is drained with ``ScanReadback.result()`` (the loop of
``inference_z_qso_many``).  Closed loop: a scan is dispatched when one has
been drained.  The observations are a pool drawn once from the seed (a fixed
set of true redshifts in an order the seed shuffles), cycled through the
window.  Once it has closed, a sample of the scans it completed, drawn
from the seed, is judged against ``reference/zqso.py``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np

from drivers.catalog import Reservoir
from harness import counts, gen
from harness.result import Outcome, Readings, quantile
from reference import catalog as ref_catalog
from reference import zqso as ref


class Inputs(NamedTuple):
    learned: gen.ZLearned
    pool: list  # gen.ZObs
    order: np.ndarray


def make_inputs(cfg: dict, traffic: dict, seed: int) -> Inputs:
    learned = gen.z_learned_model(cfg, gen.rng_for(seed, 1))
    lo, hi = traffic["z_true"]
    grid = {k: traffic[k] for k in ("grid", "start", "step") if k in traffic}
    pool = [gen.pad_z_observation(*gen.z_observation(learned, z, gen.rng_for(seed, 3, i),
                                                     traffic["noise"], traffic["num_pixels"],
                                                     **grid),
                                  cfg["num_pixels_padded"])
            for i, z in enumerate(np.linspace(lo, hi, traffic["pool"]))]
    return Inputs(learned, pool, gen.rng_for(seed, 4).permutation(len(pool)))


class Program:
    """The port's zQSO scan window over the pool."""

    def __init__(self, cfg, traffic, inputs: Inputs, device):
        import torch

        from gpy_dla_detection_tpu_torch.models import zqso
        from gpy_dla_detection_tpu_torch.params import ZParameters

        fields = {f.name for f in dataclasses.fields(ZParameters)}
        self.params = ZParameters(**{k: v for k, v in cfg.items() if k in fields})
        self.zqso, self.cfg, self.traffic, self.inputs = zqso, cfg, traffic, inputs
        self.learned = zqso.ZLearnedModel(*inputs.learned).to(device, torch.float32)
        self.specs = [zqso.ZSpectrum(*o) for o in inputs.pool]
        self.count = 0

    def window(self, on_done, until=None, scans=None, span=None):
        span = span or (lambda name: contextlib.nullcontext())
        inflight = collections.deque()
        sent = 0

        def drain():
            i, t0, dispatch_s, rb = inflight.popleft()
            with span("wait"):
                lls = rb.result()
            on_done(i, t0, dispatch_s, lls, time.perf_counter())

        n = len(self.specs)
        while (until is None or time.perf_counter() < until) and (scans is None or sent < scans):
            i = int(self.inputs.order[self.count % n])
            t0 = time.perf_counter()
            with span("dispatch"):
                _, rb = self.zqso.dispatch_scan(self.learned, self.specs[i], self.params,
                                                self.cfg["z_qso_min"], self.cfg["z_qso_max"],
                                                self.traffic["method"])
            inflight.append((i, t0, time.perf_counter() - t0, rb))
            self.count += 1
            sent += 1
            if len(inflight) > self.traffic["in_flight"]:
                drain()
        while inflight:
            drain()


def judge(cfg, inputs: Inputs, sample, device, method: str, control=False) -> dict:
    """The largest of each compared number over the sampled scans
    [(pool index, the program's (Z,) log likelihoods)], against the
    reference of the scan ``method`` runs on the observation's grid; with
    ``control`` the TF32 reference stands in the program's place."""
    worst = {}
    for i, lls in sample:
        table = ref.takes_table(inputs.pool[i].wavelengths, method)
        truth = ref.scan(inputs.learned, inputs.pool[i], cfg, device, table=table)
        if control:
            lls = ref.scan(inputs.learned, inputs.pool[i], cfg, device, ref_catalog.CONTROL,
                           table=table)
        for name, value in ref.compare(lls, truth).items():
            worst[name] = max(worst.get(name, 0.0), value)
    return worst


def step_least_s(cfg, inputs: Inputs, method: str) -> float:
    """The least seconds of one scan, averaged over the pool: the
    correlation scan's (``counts.zqso_scan_least_s``) where ``method`` reads
    the table, else the exact scan's (``counts.zqso_exact_least_s``)."""
    obs = inputs.pool[0]
    P, k, O = obs.wavelengths.shape[0], cfg["k"], ref.SCAN_OVERSAMPLE
    if not ref.takes_table(obs.wavelengths, method):
        z = np.linspace(cfg["z_qso_min"], cfg["z_qso_max"], cfg["num_zqso_samples"])
        total = 0.0
        for o in inputs.pool:
            wl = np.sort(np.asarray(o.wavelengths)[np.asarray(o.valid)])
            lo = np.searchsorted(wl, cfg["min_lambda"] * (1.0 + z), side="left")
            hi = np.searchsorted(wl, cfg["max_lambda"] * (1.0 + z), side="right")
            total += counts.zqso_exact_least_s(z.shape[0], P, k, float(np.sum(hi - lo)))
        return total / len(inputs.pool)
    T = ref.flat_table(inputs.learned, ref.pixel_dlog(obs.wavelengths), P,
                       cfg["z_qso_min"], cfg["z_qso_max"])[5]
    nfft = 1 << int(np.ceil(np.log2((T + 1) // O + P + 2)))
    kp = k * (k + 1) // 2
    streams = 8 + 5 * k + 3 * kp
    return counts.zqso_scan_least_s(cfg["num_zqso_samples"], P, k, nfft, O, streams)


def _setup(cfg, traffic, seed, device):
    import torch

    if torch.device(device).type == "cuda":
        from gpy_dla_detection_tpu_torch.ops import _build

        _build.load_library("kernels")
    inputs = make_inputs(cfg, traffic, seed)
    program = Program(cfg, traffic, inputs, device)
    program.window(lambda *a: None, scans=traffic["warm_scans"])
    return inputs, program


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> Outcome:
    import torch

    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    inputs, program = _setup(cfg, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")

    keep = Reservoir(traffic["check_spectra"], gen.rng_for(seed, 9))
    latencies, failed, host = [], [0], [0.0]
    t_close = time.perf_counter() + seconds

    def on_done(i, t0, dispatch_s, lls, t_done):
        if not np.isfinite(lls).any():
            failed[0] += 1
        if t_done <= t_close:
            latencies.append(t_done - t0)
            host[0] += dispatch_s
            keep.offer((i, np.array(lls)))

    first = program.count
    program.window(on_done, until=t_close)
    attempted = program.count - first
    rate = len(latencies) / seconds
    log(f"window: {len(latencies)} scans completed in {seconds} s; {attempted} dispatched; "
        f"p95 over {len(latencies)} scan latencies")
    metrics = {"spectra_per_s": rate, "p95_latency_ms": 1e3 * quantile(latencies, 0.95),
               "setup_s": setup_s}
    busy = window_s = breakdown = None
    if trace:
        from harness import trace as tr

        with tr.profiled(device) as box:
            program.window(lambda *a: None, scans=traffic["trace_scans"],
                           span=lambda name: torch.profiler.record_function("bench." + name))
        t = box[0]
        n = traffic["trace_scans"]
        # the exact scan solves by the library, not K3
        corr = ref.takes_table(inputs.pool[0].wavelengths, traffic["method"])
        readings = Readings(t, n, {
            "scan_dispatch_s_per_spectrum": host[0] / max(len(latencies), 1),
            "least_s": {"k3": n * counts.k3_least_s(cfg["num_zqso_samples"], cfg["k"])} if corr else {},
            "launches": {"k3": n} if corr else {},
            "step_least_s": step_least_s(cfg, inputs, traffic["method"]), "spectra_per_s": rate})
        busy, window_s, breakdown = tr.busy_s(t), t.window_s, tr.breakdown(t)
        metrics = {"readings": readings}
    memory = torch.cuda.max_memory_allocated(device) if cuda else 0
    del program
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(cfg, inputs, keep.items, device, traffic["method"])
    limits = traffic["limits"]
    checks = [(name, numbers.get(name, math.inf), limits[name]) for name in limits]
    correct = bool(keep.items) and all(v <= lim for _, v, lim in checks)
    log(f"compared {len(keep.items)} scans of {keep.seen} completed in the window")
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    return Outcome(correct, attempted, failed[0], metrics, kind, 1, memory, checks,
                   busy, window_s, breakdown)


def calibrate(cell, seeds, seconds: float, device, log) -> list:
    """As ``drivers.catalog.calibrate``: per seed the program's readings
    over a short window at the cell's load, and the control's on the same
    spectra."""
    cfg, traffic = cell.config, cell.traffic
    rows = []
    for seed in seeds:
        inputs, program = _setup(cfg, traffic, seed, device)
        keep = Reservoir(traffic["check_spectra"], gen.rng_for(seed, 9))
        program.window(lambda i, t0, d, lls, t: keep.offer((i, np.array(lls))),
                       until=time.perf_counter() + seconds)
        del program
        t0 = time.perf_counter()
        got = judge(cfg, inputs, keep.items, device, traffic["method"])
        t1 = time.perf_counter()
        ctl = judge(cfg, inputs, keep.items, device, traffic["method"], control=True)
        log(f"seed {seed}: program {got} control {ctl}; {keep.seen} scans in the window, "
            f"judged {len(keep.items)} in {t1 - t0:.1f} s")
        rows.append((seed, got, ctl))
    return rows
