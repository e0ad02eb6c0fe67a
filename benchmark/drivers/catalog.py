"""The DLA catalog driver: the catalog CLI's in-flight window in one process.

Each batch of spectra is dispatched with ``parallel/batch.dispatch_batch``
on the main thread and finalized by ``finalize_batch`` on one finalize
thread (which waits on the batch's readback event), ``in_flight`` batches
at a time, as ``run_bayes_select.py`` runs them; the per-sample
log-likelihoods are read back (the CLI's default).  The loop is closed: a
batch is dispatched when the oldest of the window has been drained.

The spectra are a pool drawn once from the seed (a fixed set of quasar
redshifts, an injected DLA in every other one, in an order the seed
shuffles), cycled through the window.  Each batch's importance resampling
draws from a torch generator seeded from the run's seed and the batch's
number.  Once the window has closed a sample of the spectra it completed,
drawn from the seed, is judged against ``reference/catalog.py``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import math
import sys
import time
from typing import NamedTuple

import numpy as np

from harness import counts, gen
from harness.result import Outcome, Readings, is_k1, is_k2, is_k3, quantile
from reference import catalog as ref


KERNELS = {"k1": is_k1, "k2": is_k2, "k3": is_k3}


class Inputs(NamedTuple):
    learned: gen.Learned
    prior: tuple  # (z_qsos, dla_ind)
    dla: gen.Samples
    sub: gen.Samples
    z_lls: float
    z_dla: float
    pool: list  # gen.CatalogSpectrum
    order: np.ndarray  # the pool's order of dispatch


def make_inputs(cfg: dict, traffic: dict, seed: int) -> Inputs:
    """Everything a run feeds the program and the reference, from ``seed``."""
    learned = gen.learned_model(cfg, gen.rng_for(seed, 1))
    prior = gen.prior_catalog(gen.rng_for(seed, 2))
    dla = gen.dla_samples(cfg)
    sub, z_lls, z_dla = gen.subdla_samples(cfg)
    lo, hi = traffic["z_qso"]
    pool = []
    for i, z in enumerate(np.linspace(lo, hi, traffic["pool"])):
        dlas = ()
        if i % traffic["dla_every"] == traffic["dla_every"] - 1:
            dlas = ((traffic["dla_z0"] + traffic["dla_slope"] * (z - lo), traffic["dla_log_nhi"]),)
        obs = gen.observation(cfg, learned, z, gen.rng_for(seed, 3, i), dlas,
                              traffic["noise_level"], traffic["masked_fraction"])
        pool.append(gen.preprocess(cfg, *obs, z))
    order = gen.rng_for(seed, 4).permutation(len(pool))
    return Inputs(learned, prior, dla, sub, z_lls, z_dla, pool, order)


@dataclasses.dataclass
class Batch:
    number: int
    members: list  # pool indices
    gen_seed: int
    future: concurrent.futures.Future
    t_dispatch: float
    dispatch_s: float


class Completed(NamedTuple):
    batch: Batch
    results: list  # SpectrumResult, or None where the batch raised
    finalize_s: float
    t_done: float


class Program:
    """The program under test, set up for one run: the port's catalog
    window over the pool."""

    def __init__(self, cfg, traffic, inputs: Inputs, seed: int, device):
        import torch

        from gpy_dla_detection_tpu_torch.data.catalog import PriorCatalog
        from gpy_dla_detection_tpu_torch.data.samples import DLASamples, SubDLASamples
        from gpy_dla_detection_tpu_torch.data.spectrum import Spectrum
        from gpy_dla_detection_tpu_torch.parallel import batch as port_batch
        from gpy_dla_detection_tpu_torch.params import Parameters

        self.torch, self.port = torch, port_batch
        fields = {f.name for f in dataclasses.fields(Parameters)}
        self.params = Parameters(**{k: v for k, v in cfg.items() if k in fields})
        self.max_dlas = cfg["max_dlas"]
        self.voigt_impl = cfg["voigt_impl"]
        self.cfg, self.traffic, self.inputs, self.seed = cfg, traffic, inputs, seed
        self.device = torch.device(device)
        d = inputs.dla
        self.dla_s = DLASamples(d.offset_samples, d.log_nhi_samples, d.nhi_samples,
                                cfg["alpha"], cfg["uniform_min_log_nhi"],
                                cfg["uniform_max_log_nhi"], cfg["fit_min_log_nhi"])
        s = inputs.sub
        self.sub_s = SubDLASamples(s.offset_samples, s.log_nhi_samples, s.nhi_samples,
                                   inputs.z_lls, inputs.z_dla)
        self.prior = PriorCatalog.from_arrays(self.params, *inputs.prior)
        self.device_inputs = port_batch.device_put_inputs(
            list(inputs.learned), self.dla_s, self.sub_s, device=self.device)
        self.spectra = [Spectrum(*p) for p in inputs.pool]
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.count = 0  # batches dispatched

    def close(self):
        self.pool.shutdown()
        self.device_inputs = None

    def _finalize(self, out, specs):
        if self.device.type == "cuda":
            self.torch.cuda.set_device(self.device)
        if out.done is not None:
            out.done.synchronize()
        t0 = time.perf_counter()
        results = self.port.finalize_batch(out, specs, self.sub_s, self.prior, self.max_dlas)
        t1 = time.perf_counter()
        return results, t1 - t0, t1

    def dispatch(self) -> Batch:
        B, n = self.traffic["batch_size"], len(self.spectra)
        order = self.inputs.order
        members = [int(order[(self.count * B + j) % n]) for j in range(B)]
        gen_seed = gen.seed_for(self.seed, 7, self.count)
        generator = self.torch.Generator(device=self.device).manual_seed(gen_seed)
        specs = [self.spectra[i] for i in members]
        t0 = time.perf_counter()
        out = self.port.dispatch_batch(
            self.device_inputs, specs, self.params, generator, self.max_dlas,
            voigt_impl=self.voigt_impl, with_sample_lls=self.traffic["sample_lls"])
        t1 = time.perf_counter()
        future = self.pool.submit(self._finalize, out, specs)
        self.count += 1
        return Batch(self.count - 1, members, gen_seed, future, t0, t1 - t0)

    def window(self, on_done, until=None, batches=None, span=None):
        """Run the in-flight window, dispatching until the clock reaches
        ``until`` or ``batches`` have been dispatched, then drain it;
        ``on_done(Completed)`` sees every batch in order.  ``span`` wraps
        each call into the program (the traced stretch's spans)."""
        import contextlib

        span = span or (lambda name: contextlib.nullcontext())
        inflight = collections.deque()
        sent = 0

        def drain():
            b = inflight.popleft()
            with span("wait"):
                try:
                    results, fin_s, t_done = b.future.result()
                except Exception as e:  # a failed batch counts its spectra as failed
                    results, fin_s, t_done = None, 0.0, time.perf_counter()
                    print(f"batch {b.number} raised {type(e).__name__}: {e}", file=sys.stderr,
                          flush=True)
            on_done(Completed(b, results, fin_s, t_done))

        while True:
            if until is not None and time.perf_counter() >= until:
                break
            if batches is not None and sent >= batches:
                break
            with span("dispatch"):
                inflight.append(self.dispatch())
            sent += 1
            while len(inflight) >= self.traffic["in_flight"]:
                drain()
        while inflight:
            drain()


def answered(r) -> bool:
    """Whether a spectrum's evidences are all there: the null and subDLA
    evidences finite, and each DLA level's finite unless the pair cut left
    the level no sample (its likelihoods all NaN, as the model defines a
    dead level: the reference reads it so too)."""
    if not (math.isfinite(r.log_evidence_null) and math.isfinite(r.log_evidence_subdla)):
        return False
    dead = ~np.isfinite(r.sample_log_likelihoods_dla).any(axis=0)
    return bool(np.all(np.isfinite(r.log_evidences_dla) | dead))


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def outputs_of(result) -> ref.Outputs:
    """The program's answer for one spectrum, as the comparison reads it."""
    sel = result.selection
    lp = np.asarray(sel.log_posteriors, np.float64)
    top = np.nanmax(lp)
    return ref.Outputs(
        float(result.log_evidence_null), np.asarray(result.log_evidences_dla, np.float64),
        float(result.log_evidence_subdla), result.sample_log_likelihoods_dla,
        result.sample_log_likelihoods_subdla, result.base_sample_inds, result.map_z_dlas,
        result.map_log_nhis, lp - (top + np.log(np.nansum(np.exp(lp - top)))))


def judge(cfg, inputs: Inputs, sample, device, control=False) -> dict:
    """Each number over the sampled spectra: ``<gap>_gap``, the largest of
    a gap of ``reference.catalog.compare``, and ``<gap>_rms``, its root mean
    square over every value of every sampled spectrum (inf where an answer
    is missing on one side); ``draw_mismatch``,
    the largest share of parents the reference draws otherwise, and
    ``draw_mismatch_mean``.  The traffic's ``limits`` say which are compared.

    :param sample: [(pool index, generator seed, position in batch, result)].
    :param control: put the reference in TF32 in the program's place instead
        of judging the program's results (the control's readings).
    """
    draws = cfg["max_dlas"] - 1
    S = cfg["num_dla_samples"]
    total, mismatch = {}, []
    for pool_idx, gen_seed, pos, result in sample:
        uniforms = ref.replay_uniforms(gen_seed, pos, draws, S, device)
        spec = inputs.pool[pool_idx]
        args = (inputs.learned, spec, inputs.dla, inputs.sub, inputs.z_lls, inputs.z_dla,
                inputs.prior, cfg, device)
        if control:
            out = ref.control_outputs(ref.reference_spectrum(*args, ref.CONTROL,
                                                             uniforms=uniforms))
        else:
            out = outputs_of(result)
        truth = ref.reference_spectrum(*args, ref.REFERENCE, base_inds=out.base_inds,
                                       uniforms=uniforms)
        for name, g in ref.compare(out, truth).items():
            total.setdefault(name, ref.Gaps()).merge(g)
        mismatch.append(ref.draw_mismatch(out, truth))
    numbers = {}
    for name, t in total.items():
        numbers[f"{name}_gap"] = t.top
        numbers[f"{name}_rms"] = t.rms
    numbers["draw_mismatch"] = max(mismatch, default=0.0)
    numbers["draw_mismatch_mean"] = float(np.mean(mismatch)) if mismatch else 0.0
    return numbers


def k_least(cfg, program: Program, members) -> tuple[dict, dict, float]:
    """The least seconds of each kernel's work for the spectra ``members``
    (pool indices, repeats counted), the launches that work assumes, and the
    least seconds of the whole step a spectrum: K1 (its polynomial window,
    counted on each spectrum's own redshifts), then K2 and K3 on every
    level."""
    torch = program.torch
    S, N, k = cfg["num_dla_samples"], cfg["num_pixels_padded"], cfg["k"]
    levels = cfg["max_dlas"] + 1
    off = torch.as_tensor(program.inputs.dla.offset_samples, device=program.device).float()
    cache = {}
    per_k2 = sum(counts.k2_least_s(S, N, k, e) for e in range(cfg["max_dlas"])) \
        + counts.k2_least_s(S, N, k, 0)
    per_k3 = levels * counts.k3_least_s(S, k)
    profile = 0.0
    for i in members:
        if i not in cache:
            sp = program.inputs.pool[i]
            lo = torch.tensor(float(sp.min_z_dla), dtype=torch.float32, device=program.device)
            hi = torch.tensor(float(sp.max_z_dla), dtype=torch.float32, device=program.device)
            wl = torch.as_tensor(sp.padded_wavelengths, device=program.device).float()
            cache[i] = counts.least_s(*counts.k1_work(wl, lo + (hi - lo) * off, 2,
                                                      cfg["num_lines"]))
        profile += cache[i]
    n = len(members)
    least = {"k1": profile, "k2": n * per_k2, "k3": n * per_k3}
    launches = {"k1": n, "k2": n * levels, "k3": n * levels}
    return least, launches, (profile + n * (per_k2 + per_k3)) / n


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> Outcome:
    import torch

    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from gpy_dla_detection_tpu_torch.ops import _build

        _build.load_library("kernels")
    inputs = make_inputs(cfg, traffic, seed)
    program = Program(cfg, traffic, inputs, seed, device)
    B = traffic["batch_size"]
    try:
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
        halves = [0, 0]  # spectra completed in each half of the window

        def on_done(c: Completed):
            if c.results is None:
                failed[0] += len(c.batch.members)
                return
            failed[0] += sum(not answered(r) for r in c.results)
            if c.t_done <= t_close:
                latencies.append(c.t_done - c.batch.t_dispatch)
                done[0] += len(c.results)
                halves[c.t_done > t_open + seconds / 2] += len(c.results)
                host["dispatch"] += c.batch.dispatch_s
                host["finalize"] += c.finalize_s
                for pos, (i, r) in enumerate(zip(c.batch.members, c.results)):
                    keep.offer((i, c.batch.gen_seed, pos, r))

        first = program.count
        program.window(on_done, until=t_close)
        attempted = (program.count - first) * B
        rate = done[0] / seconds
        p95 = 1e3 * quantile(latencies, 0.95)
        log(f"window: {done[0]} spectra in {len(latencies)} batches completed in {seconds} s; "
            f"{attempted} dispatched; p95 over {len(latencies)} batch latencies; "
            f"spectra/s in the two halves {2 * halves[0] / seconds} and {2 * halves[1] / seconds}")
        metrics = {"spectra_per_s": rate, "p95_latency_ms": p95, "setup_s": setup_s}

        busy = window_s = breakdown = None
        if trace:
            from harness import trace as tr

            from gpy_dla_detection_tpu_torch.ops._build import launch_counts

            members = []
            before = dict(launch_counts)
            with tr.profiled(device) as box:
                program.window(lambda c: members.extend(c.batch.members),
                               batches=traffic["trace_batches"],
                               span=lambda name: torch.profiler.record_function("bench." + name))
            t = box[0]
            least, launches, per_spectrum = k_least(cfg, program, members)
            counted = {k: v - before.get(k, 0) for k, v in launch_counts.items()
                       if v != before.get(k, 0)}
            log(f"traced stretch: {len(members)} spectra; the port counted launches {counted}; "
                f"the rooflines assume {launches}; the profiler holds "
                + ", ".join(f"{k} {tr.device_seconds(t, test)[0]}" for k, test in KERNELS.items()))
            readings = Readings(t, len(members), {
                "dispatch_s_per_spectrum": host["dispatch"] / max(done[0], 1),
                "finalize_s_per_spectrum": host["finalize"] / max(done[0], 1),
                "least_s": least, "launches": launches,
                "step_least_s": per_spectrum, "spectra_per_s": rate,
                "p95_latency_ms": p95})
            busy, window_s, breakdown = tr.busy_s(t), t.window_s, tr.breakdown(t)
            metrics = {"readings": readings}
        memory = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        program.close()
    del program
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(cfg, inputs, keep.items, device)
    limits = traffic["limits"]
    checks = [(name, numbers.get(name, math.inf), limits[name]) for name in limits]
    correct = bool(keep.items) and all(v <= lim for _, v, lim in checks)
    log(f"compared {len(keep.items)} spectra of {keep.seen} completed in the window")
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
        program = Program(cfg, traffic, inputs, seed, device)
        keep = Reservoir(traffic["check_spectra"], gen.rng_for(seed, 9))
        try:
            program.window(lambda c: None, batches=traffic["warm_batches"])

            def on_done(c):
                for pos, (i, r) in enumerate(zip(c.batch.members, c.results)):
                    keep.offer((i, c.batch.gen_seed, pos, r))

            program.window(on_done, until=time.perf_counter() + seconds)
        finally:
            program.close()
        del program
        t0 = time.perf_counter()
        got = judge(cfg, inputs, keep.items, device)
        t1 = time.perf_counter()
        ctl = judge(cfg, inputs, keep.items, device, control=True)
        log(f"seed {seed}: program {got} control {ctl}; {keep.seen} spectra in the window, "
            f"judged {len(keep.items)} in {t1 - t0:.1f} s")
        rows.append((seed, got, ctl))
    return rows
