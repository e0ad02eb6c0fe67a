"""The plain reference against the port's CPU twins at a small size, the
control (the reference in TF32 in the program's place) coming out not
correct where the program is, and a run with its timed path broken coming
out not correct.

The runs here skip the harness's look for a card and drive the rest of a
run on the CPU (``run.measure``), where the port takes its kernels' plain
twins; the sizes are cut (S = 200 samples, Z = 300 redshifts) so that a
test run holds them."""

import math
import time

import numpy as np
import pytest
import torch
from scipy.special import wofz as scipy_wofz

import run
from drivers import catalog as dcat
from drivers import zqso as dz
from harness import gen, layout
from reference import catalog as ref
from reference import zqso as zref
from reference.faddeeva import wofz

SEED = 2**31 + 977
CPU = torch.device("cpu")
def small_catalog():
    cell = layout.find_cell("catalog.window")
    return cell._replace(config=dict(cell.config, num_dla_samples=200),
                         traffic=dict(cell.traffic, pool=4, batch_size=2, warm_batches=1,
                                      check_spectra=4))


LOG_GRID = {"grid": "log", "start": 3600.0, "step": 1e-4, "num_pixels": 4600}


def small_zqso(**grid):
    """``zqso.linear`` at 300 redshifts; with ``LOG_GRID`` the same on
    SDSS's log-uniform grid, where "auto" takes the correlation scan, which
    has no cell (see ``test_zqso_corr_scan_nan_where_the_median_is_negative``)."""
    cell = layout.find_cell("zqso.linear")
    return cell._replace(config=dict(cell.config, num_zqso_samples=300),
                         traffic=dict(cell.traffic, pool=3, in_flight=2, warm_scans=1,
                                      check_spectra=3, **grid))


@pytest.mark.parametrize("y", [4.7e-4, 1e-2, 0.5, 3.0])
def test_faddeeva_against_scipy(y):
    x = np.concatenate([np.linspace(-30, 30, 6001), np.linspace(-8000, 8000, 4001)])
    want = scipy_wofz(x + 1j * y)
    got = wofz(torch.tensor(x + 1j * y, dtype=torch.complex128)).numpy()
    assert np.max(np.abs(got.real - want.real) / np.abs(want.real)) < 1e-10
    assert np.max(np.abs(got - want)) < 1e-13


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, -3.0 - 2**-9, 1.0 + 2**-11 + 2**-13])
    assert ref.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0, -3.0 - 2**-9, 1.0 + 2**-10]


def test_catalog_program_agrees_and_the_control_does_not():
    cell = small_catalog()
    rows = dcat.calibrate(cell, [SEED], 0.5, CPU, lambda m: None)
    _, got, ctl = rows[0]
    limits = cell.traffic["limits"]
    assert all(got[n] <= limits[n] for n in limits), got
    assert any(ctl[n] > limits[n] for n in limits), ctl


def test_zqso_program_agrees_and_the_control_does_not():
    cell = small_zqso()
    rows = dz.calibrate(cell, [SEED], 0.5, CPU, lambda m: None)
    _, got, ctl = rows[0]
    limits = cell.traffic["limits"]
    assert all(got[n] <= limits[n] for n in limits), got
    assert any(ctl[n] > limits[n] for n in limits), ctl


@pytest.mark.parametrize("grid, table", [({}, False), (LOG_GRID, True)])
def test_auto_takes_the_scan_the_reference_follows(grid, table):
    """On the cell's linear grid "auto" takes the exact scan, on SDSS's
    log-uniform grid the correlation scan; the reference decides alike."""
    from gpy_dla_detection_tpu_torch.models import zqso

    cell = small_zqso(**grid)
    wl = dz.make_inputs(cell.config, cell.traffic, SEED).pool[0].wavelengths
    assert (zqso.detect_pixel_dlog(wl) is not None) == table
    assert zref.takes_table(wl, cell.traffic["method"]) == table


def test_zqso_corr_scan_nan_where_the_median_is_negative():
    """The fault that keeps the zQSO scan out of ``BENCHMARK.json``: the
    port's correlation scan (``models/zqso_corr``) returns NaN at every
    redshift whose normalization median is negative (its log det takes
    log(med)), where the reference and the port's exact scan, the second
    witness, are finite.  Elsewhere the correlation scan agrees with the
    reference."""
    from gpy_dla_detection_tpu_torch.models import zqso

    cell = small_zqso(**LOG_GRID)
    cfg = cell.config
    inputs = dz.make_inputs(cfg, cell.traffic, SEED)
    program = dz.Program(cfg, cell.traffic, inputs, CPU)
    z = np.linspace(cfg["z_qso_min"], cfg["z_qso_max"], cfg["num_zqso_samples"])
    faults = 0
    for i, obs in enumerate(inputs.pool):
        corr = zqso.dispatch_scan(program.learned, program.specs[i], program.params,
                                  cfg["z_qso_min"], cfg["z_qso_max"], "auto")[1].result()
        exact = zqso.dispatch_scan(program.learned, program.specs[i], program.params,
                                   cfg["z_qso_min"], cfg["z_qso_max"], "exact")[1].result()
        truth = zref.scan(inputs.learned, obs, cfg, CPU)
        w, v, f = obs.wavelengths, obs.valid, obs.flux
        lo = np.maximum(cfg["min_lambda"] * (1 + z), w[v].min())
        hi = np.minimum(cfg["max_lambda"] * (1 + z), w[v].max())
        rest = w[None] / (1 + z[:, None])
        norm = ((rest >= cfg["normalization_min_lambda"]) & (rest <= cfg["normalization_max_lambda"])
                & (w > lo[:, None]) & (w < hi[:, None]) & v)
        negative = np.array([np.median(f[m]) < 0 if m.any() else False for m in norm])
        assert np.array_equal(np.isnan(corr), negative & np.isfinite(truth))
        assert np.isfinite(exact[negative]).all() and np.isfinite(truth[negative]).all()
        ok = np.isfinite(corr)
        assert np.max(np.abs(corr[ok] - truth[ok])) < 0.5
        faults += int(negative.sum())
    assert faults > 0


def measure_small(cell):
    return run.measure(cell, SEED, 2.0, 0, CPU, time.perf_counter())


@pytest.mark.parametrize("small", [small_catalog, small_zqso])
def test_a_sound_run_is_correct(small):
    cell = small()
    out, units = measure_small(cell)
    assert out.correct and out.failed == 0 and out.attempted > 0
    assert set(out.metrics) == {m["name"] for m in cell.end_to_end}
    assert {u for n, u in units.items() if n.startswith("spectra_per_s")} == {"spectra/s"}


def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch):
    """The catalog's evidences moved by one nat where ``finalize_batch``
    produces them: the run comes out not correct."""
    from gpy_dla_detection_tpu_torch.parallel import batch

    real = batch.finalize_batch

    def altered(*a, **k):
        return [r._replace(log_evidences_dla=r.log_evidences_dla + 1.0) for r in real(*a, **k)]

    monkeypatch.setattr(batch, "finalize_batch", altered)
    assert not measure_small(small_catalog())[0].correct


def test_a_likelihood_altered_where_it_is_produced_is_caught(monkeypatch):
    """The catalog's per-sample likelihoods moved by a tenth of a nat."""
    from gpy_dla_detection_tpu_torch.parallel import batch

    real = batch.finalize_batch

    def altered(*a, **k):
        return [r._replace(sample_log_likelihoods_dla=r.sample_log_likelihoods_dla + 0.1)
                for r in real(*a, **k)]

    monkeypatch.setattr(batch, "finalize_batch", altered)
    assert not measure_small(small_catalog())[0].correct


def test_a_missing_level_is_caught(monkeypatch):
    """The last DLA level's evidence and sample likelihoods lost (NaN) where
    ``finalize_batch`` produces them, as if the level had been skipped: the
    run comes out not correct, though the reference's level is finite."""
    from gpy_dla_detection_tpu_torch.parallel import batch

    real = batch.finalize_batch

    def lost(*a, **k):
        out = []
        for r in real(*a, **k):
            ev, lls = r.log_evidences_dla.copy(), r.sample_log_likelihoods_dla.copy()
            ev[-1], lls[:, -1] = np.nan, np.nan
            out.append(r._replace(log_evidences_dla=ev, sample_log_likelihoods_dla=lls))
        return out

    monkeypatch.setattr(batch, "finalize_batch", lost)
    out = measure_small(small_catalog())[0]
    assert not out.correct
    assert math.isinf(dict((n, v) for n, v, _ in out.checks)["evidence_rms"])


def test_one_level_drawn_wrong_in_one_spectrum_is_caught(monkeypatch):
    """A wrong draw confined to one level of one of the spectra a run
    compares (the cell's 64): its parents drawn uniformly, the likelihoods
    computed on them as the program computes them.  The evidences agree on
    those parents; ``draw_mismatch_mean`` fails, its limit being under one
    such level's share of the 64 x 3 draws."""
    from gpy_dla_detection_tpu_torch.models import evidence

    cell = small_catalog()
    cfg, traffic = cell.config, cell.traffic
    limits = traffic["limits"]
    n = layout.find_cell("catalog.window").traffic["check_spectra"]
    real, calls = evidence._draw_base_indices, [0]

    def once_wrong(generator, probs, resampler="multinomial"):
        calls[0] += 1
        base = real(generator, probs, resampler)  # the generator moves on as it would
        if calls[0] == 2:  # the first spectrum's second chained level
            return torch.randint(0, base.shape[0], base.shape,
                                 generator=torch.Generator().manual_seed(1))
        return base

    monkeypatch.setattr(evidence, "_draw_base_indices", once_wrong)
    inputs = dcat.make_inputs(cfg, traffic, SEED)
    program = dcat.Program(cfg, traffic, inputs, SEED, CPU)
    sample = []
    try:
        program.window(lambda c: sample.extend(
            (i, c.batch.gen_seed, pos, r) for pos, (i, r) in enumerate(zip(c.batch.members,
                                                                           c.results))),
            batches=n // traffic["batch_size"])
    finally:
        program.close()
    assert len(sample) == n
    got = dcat.judge(cfg, inputs, sample, CPU)
    assert got["draw_mismatch_mean"] > limits["draw_mismatch_mean"], got
    assert all(got[k] <= limits[k] for k in limits if k != "draw_mismatch_mean"), got


def test_a_scan_altered_where_it_is_produced_is_caught(monkeypatch):
    from gpy_dla_detection_tpu_torch.models import zqso

    real = zqso.ScanReadback.result
    monkeypatch.setattr(zqso.ScanReadback, "result", lambda self: real(self) + 1.0)
    assert not measure_small(small_zqso())[0].correct


def test_the_draw_stage_by_itself():
    """The stage the reference takes from the program, the importance draw
    of the chained levels' parents, checked by itself: on the same weights
    and the same generator the port's draw and the reference's are equal."""
    from gpy_dla_detection_tpu_torch.models.evidence import _draw_base_indices

    rng = np.random.default_rng(5)
    for spread in (0.5, 5.0, 50.0):
        ll = torch.tensor(rng.normal(0, spread, 4000), dtype=torch.float32)
        valid = torch.tensor(rng.uniform(size=4000) < 0.9)
        logits = torch.where(valid, ll - ll.max(), -math.inf)
        probs = torch.exp(logits - logits.max())
        port = _draw_base_indices(torch.Generator().manual_seed(9), probs)
        u = torch.rand(4000, generator=torch.Generator().manual_seed(9), dtype=torch.float32)
        mine = ref.draw_parents(ll - ll.max(), valid, True, u)
        assert torch.equal(port, mine)


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for s in range(400):
        r = dcat.Reservoir(2, gen.rng_for(s, 9))
        for i in range(10):
            r.offer(i)
        picks += r.items
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 40 and counts.max() < 120


def test_a_dead_level_is_answered_and_a_lost_evidence_is_not():
    """``failed`` counts a non-finite evidence, but not at a level whose
    every sample the pair cut removed (the model's own NaN)."""
    from types import SimpleNamespace

    lls = np.zeros((5, 4))
    lls[:, 3] = np.nan
    r = SimpleNamespace(log_evidence_null=1.0, log_evidence_subdla=2.0,
                        log_evidences_dla=np.array([1.0, 2.0, 3.0, np.nan]),
                        sample_log_likelihoods_dla=lls)
    assert dcat.answered(r)
    r.log_evidences_dla = np.array([1.0, np.nan, 3.0, np.nan])
    assert not dcat.answered(r)
    r.log_evidences_dla, r.log_evidence_null = np.array([1.0, 2.0, 3.0, np.nan]), np.nan
    assert not dcat.answered(r)
