"""The port's zQSO head against the JAX package on the same seeded inputs.

``gpy_dla_detection_tpu_torch.models.{zqso,zqso_corr}`` against
``gpy_dla_detection_tpu.models.{zqso,zqso_corr}`` on the CPU, at k = 5 and
a few hundred candidate redshifts, spectra padded to P = 5,632:

* ``z_log_evidence`` and the exact scan in float64 to rtol 1e-8, the bound
  ``tests/test_zqso.py`` holds the JAX package to against the reference;
  the exact scan in float32 against JAX's float64 under the two rules
  below;
* the correlation scan's streams bit for bit before the FFT and their
  rFFT within float32 rounding (``REL_FFT`` of the largest magnitude);
* the correlation scan against JAX's (float32 FFTs and assembly, the
  spectrum's float64 tails on both sides): the same NaN pattern and
  argmax, every finite |dll| <= ``REL_GLOBAL`` of the largest finite |ll|
  (float32 FFTs of a different library round differently: far from the
  peak |ll| reaches ~1e5), and within +-0.2 of the peak |dll| <=
  ``NEAR_PEAK`` of the peak's margin over the rest of the grid (the rule
  of ``test_corr_scan_matches_shift_and_exact``);
* the row gather at s0(z) as ``jnp.take`` reads it, and scans at the
  grid's edges (a spectrum starting at 3,000 A with z up to 6.16, one
  ending near 13,000 A);
* K3's twin on the scan's own (B, u, misc) against JAX's
  ``batched_quad_logdet`` on ``I + _tri_to_full(B)`` and its assembly;
* the entry points, ported from ``tests/test_zqso.py``; the golden
  fixture's layout and inputs.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.data import synthetic as JSyn
from gpy_dla_detection_tpu.models import zqso as JZ
from gpy_dla_detection_tpu.models import zqso_corr as JZC
from gpy_dla_detection_tpu.ops import logmvn as JL
from gpy_dla_detection_tpu.params import ZParameters as JZParameters
from gpy_dla_detection_tpu_torch.data import synthetic as TSyn
from gpy_dla_detection_tpu_torch.models import zqso as TZ
from gpy_dla_detection_tpu_torch.models import zqso_corr as TZC
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.params import ZParameters

torch.set_num_threads(2)

K = 5
Z = 300
P = 5632
REL_F64 = 1e-8
REL_GLOBAL = 1e-4
NEAR_PEAK = 0.01
REL_FFT = 1e-6
GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_zqso.npz"


def _observation(z_true, obs_seed, k=K):
    """The port's learned model (numpy) and one padded observation."""
    learned, (wl, flux, nv, pm) = TSyn.synthetic_z_observation(
        z_true, seed=0, k=k, obs_seed=obs_seed)
    return learned, (wl, flux, nv, pm)


def _jax_model(learned):
    return JZ.ZLearnedModel(*learned)


def _specs(obs):
    return TZ.prepare_z_spectrum(*obs, P), JZ.prepare_z_spectrum(*obs, P)


@pytest.fixture(scope="module")
def model():
    learned, obs = _observation(3.2, 4)
    return learned, obs


def _assert_two_rules(got, want, grid, rel_global=REL_GLOBAL, near_peak=NEAR_PEAK):
    """The same NaN pattern and argmax; |dll| within ``rel_global`` of the
    largest finite |ll| everywhere, within ``near_peak`` of the peak's
    margin within +-0.2 of it."""
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    peak = np.nanargmax(want)
    assert np.nanargmax(got) == peak
    d = np.abs(got - want)
    assert d[fin].max() <= rel_global * np.abs(want[fin]).max(), d[fin].max()
    near = fin & (np.abs(grid - grid[peak]) < 0.2)
    far = fin & (np.abs(grid - grid[peak]) > 0.2)
    margin = want[peak] - want[far].max()
    assert margin > 0
    assert d[near].max() <= near_peak * margin, (d[near].max(), margin)


@pytest.mark.parametrize("z", [2.6, 3.2, 4.0])
def test_z_log_evidence_matches_jax_float64(model, z):
    learned, obs = model
    spec, jspec = _specs(obs)
    got = float(TZ.z_log_evidence(learned.to("cpu", torch.float64), spec, z, ZParameters(k=K)))
    want = float(JZ.z_log_evidence(_jax_model(learned), jspec, np.float64(z), JZParameters(k=K)))
    np.testing.assert_allclose(got, want, rtol=REL_F64)


def test_exact_scan_matches_jax_float64(model):
    learned, obs = model
    spec, jspec = _specs(obs)
    grid = TZ.sample_z_qsos(Z)
    t_model = learned.to("cpu", torch.float64)
    got = TZ.z_log_evidences(t_model, TZ.device_spectrum(spec, "cpu", torch.float64),
                             torch.as_tensor(grid), ZParameters(k=K)).numpy()
    want = np.asarray(JZ.z_log_evidences(_jax_model(learned), jspec, jnp.asarray(grid),
                                         JZParameters(k=K)))
    assert got.dtype == np.float64 and got.shape == (Z,)
    np.testing.assert_allclose(got, want, rtol=REL_F64)


def test_exact_scan_float32_within_the_two_rules(model):
    """The exact scan with the learned model, flux and noise in float32
    (the card's dtype) against JAX's float64."""
    learned, obs = model
    spec, jspec = _specs(obs)
    params = ZParameters(k=K, num_zqso_samples=Z)
    z32, got, grid = TZ.inference_z_qso(learned.to("cpu", torch.float32), spec, params,
                                        method="exact")
    z64, want, _ = JZ.inference_z_qso(_jax_model(learned), jspec,
                                      JZParameters(k=K, num_zqso_samples=Z), method="exact")
    assert got.dtype == np.float32 and z32 == z64
    _assert_two_rules(got.astype(np.float64), want, grid)


@pytest.fixture
def capture_jax_streams(monkeypatch):
    """The float32 streams JAX's ``build_corr_table`` hands its jitted
    rFFT, captured by wrapping ``jax.jit`` there."""
    captured = []

    def jit(fn, **kw):
        def call(s):
            captured.append(np.asarray(s))
            return fn(s)
        return call

    monkeypatch.setattr(JZC.jax, "jit", jit)
    return captured


def test_corr_streams_bit_for_bit_and_fft(model, capture_jax_streams):
    learned, obs = model
    pixel_dlog = TZ.detect_pixel_dlog(obs[0])
    params = ZParameters(k=K)
    want = JZC.build_corr_table(_jax_model(learned), pixel_dlog, P, JZParameters(k=K))
    (streams,) = capture_jax_streams
    got_streams, log_x0, dlog, k, nfft = TZC.corr_streams(learned, pixel_dlog, P, params)
    assert got_streams.dtype == np.float32 and np.array_equal(got_streams, streams)
    assert (log_x0, dlog, k, nfft) == (want.log_x0, want.dlog, want.k, want.nfft)
    table = TZC.build_corr_table(learned, pixel_dlog, P, params, device="cpu")
    assert table.stream_fft.dtype == torch.complex64
    want_fft = np.asarray(want.stream_fft)
    assert table.stream_fft.shape == want_fft.shape
    scale = np.abs(want_fft).max()
    assert np.abs(table.stream_fft.numpy() - want_fft).max() <= REL_FFT * scale


@pytest.mark.parametrize("z_true, obs_seed", [(3.2, 4), (2.16, 11), (4.4, 7)])
def test_corr_scan_matches_jax(z_true, obs_seed):
    learned, obs = _observation(z_true, obs_seed)
    spec, jspec = _specs(obs)
    params = ZParameters(num_zqso_samples=Z)
    _build.reset_launch_counts()
    z_t, got, grid = TZ.inference_z_qso(learned.to("cpu", torch.float64), spec, params,
                                        method="corr")
    assert not _build.launch_counts  # the CPU runs K3's twin
    z_j, want, _ = JZ.inference_z_qso(_jax_model(learned), jspec,
                                      JZParameters(num_zqso_samples=Z), method="corr")
    assert got.dtype == want.dtype == np.float64 and z_t == z_j
    _assert_two_rules(got, want, grid)


@pytest.mark.parametrize("method, chunk", [("corr", "CORR_CHUNK"), ("exact", "EXACT_CHUNK")])
def test_scan_in_chunks_equals_one_chunk(model, monkeypatch, method, chunk):
    """The per-z passes in chunks of 37 candidates (the last one short)
    give the scan of the grid in one chunk: each z is computed alone."""
    learned, obs = model
    spec, _ = _specs(obs)
    t_model = learned.to("cpu", torch.float64)
    params = ZParameters(num_zqso_samples=Z)
    module = TZC if method == "corr" else TZ
    monkeypatch.setattr(module, chunk, Z)
    _, whole, _ = TZ.inference_z_qso(t_model, spec, params, method=method)
    monkeypatch.setattr(module, chunk, 37)
    _, chunked, _ = TZ.inference_z_qso(t_model, spec, params, method=method)
    np.testing.assert_allclose(chunked, whole, rtol=1e-12, atol=0)


def test_take_rows_reads_as_jnp_take():
    nc, O, nfft = 3, 4, 8
    corr = torch.arange(nc * O * nfft, dtype=torch.float32).reshape(nc, O, nfft)
    L = O * nfft
    s0 = torch.tensor([-L - 1, -L, -L + 3, -1, 0, 5, 17, L - 1, L, L + 3])
    got = TZC.take_rows(corr, s0).numpy()
    flat = np.asarray(corr).transpose(2, 1, 0).reshape(L, nc)
    want = np.asarray(jnp.take(jnp.asarray(flat), jnp.asarray(s0.numpy()), axis=0)).T
    np.testing.assert_array_equal(got, want)


def _edge_observation(learned, z, wl):
    """A noisy draw from the model at ``z`` on the grid ``wl``."""
    rng = np.random.default_rng(17)
    rest = wl / (1 + z)
    mu = np.interp(rest, learned.rest_wavelengths, learned.mu)
    flux = mu + 0.08 * rng.normal(size=wl.shape)
    return wl, flux, np.full_like(wl, 0.08**2), np.zeros(wl.shape, bool)


@pytest.mark.parametrize("edge", ["first_pixel_at_3000", "last_pixel_near_13000"])
def test_corr_scan_at_the_grid_edges(model, edge):
    """s0(z) at its extremes: the bluest first pixel the table covers with
    z up to 6.16 (the smallest shift), and a spectrum ending near 13,000 A
    (the largest).  The port's scan is JAX's, with no NaN from the gather."""
    learned = model[0]
    n = P  # long enough that every z's normalization window is observed
    if edge == "first_pixel_at_3000":
        wl = TZ.SCAN_WL_BOUNDS[0] * 10 ** (1e-4 * np.arange(n))
        z = 5.9
    else:
        wl = 12_990.0 * 10 ** (-1e-4 * np.arange(n))[::-1]
        z = 2.3
    obs = _edge_observation(learned, z, wl)
    spec, jspec = _specs(obs)
    params = ZParameters(num_zqso_samples=Z)
    _, got, grid = TZ.inference_z_qso(learned.to("cpu", torch.float64), spec, params,
                                      method="corr")
    _, want, _ = JZ.inference_z_qso(_jax_model(learned), jspec,
                                    JZParameters(num_zqso_samples=Z), method="corr")
    assert np.isfinite(got).all() and np.isfinite(want).all()
    _assert_two_rules(got, want, grid)


def test_k3_twin_on_the_scans_own_inputs(model, monkeypatch):
    """The (B, u, misc) the scan hands K3: the packed B unpacks to JAX's
    ``I + _tri_to_full(B)`` bit for bit, and the twin's log likelihoods
    are JAX's ``batched_quad_logdet`` and assembly on them."""
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import unpack_capacitance

    learned, obs = model
    spec, _ = _specs(obs)
    seen = []
    real = TZC.logmvn_chain

    def chain(B, u, misc):
        out = real(B, u, misc)
        seen.append((B, u, misc, out))
        return out

    monkeypatch.setattr(TZC, "logmvn_chain", chain)
    TZ.inference_z_qso(learned.to("cpu", torch.float64), spec,
                       ZParameters(num_zqso_samples=Z), method="corr")
    ((B, u, misc, got),) = seen
    assert B.shape == (Z, K * (K + 1) // 2) and B.dtype == torch.float32 and B.is_contiguous()
    full = jnp.eye(K, dtype=jnp.float32)[None] + JZC._tri_to_full(jnp.asarray(B.numpy()), K)
    np.testing.assert_array_equal(unpack_capacitance(B, K).numpy(), np.asarray(full))
    quad, logdet = JL.batched_quad_logdet(full, jnp.asarray(u.numpy()))
    m = jnp.asarray(misc.numpy())
    want = np.asarray(-0.5 * (m[:, 0] - quad + m[:, 1] + logdet))
    assert want.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-6 * scale


def test_inference_recovers_redshift():
    learned, obs = _observation(3.37, 9)
    spec, _ = _specs(obs)
    z_map, _, _ = TZ.inference_z_qso(learned.to("cpu", torch.float64), spec,
                                     ZParameters(k=K, num_zqso_samples=400))
    assert abs(z_map - 3.37) < 0.05, z_map


def test_batch_redshift_accuracy():
    """8 of 8 spectra within 0.5 (the reference's acceptance criterion,
    tests/test_zqso.py:88-104), through ``inference_z_qso_many``."""
    rng = np.random.default_rng(3)
    z_trues = [float(rng.uniform(2.4, 4.6)) for _ in range(8)]
    learned = TSyn.synthetic_z_learned_model(0, K)
    specs = [TZ.prepare_z_spectrum(*_observation(z, 50 + i)[1], P)
             for i, z in enumerate(z_trues)]
    results, _ = TZ.inference_z_qso_many(learned.to("cpu", torch.float64), specs,
                                         ZParameters(k=K, num_zqso_samples=300))
    hits = sum(abs(z_map - z) < 0.5 for (z_map, _), z in zip(results, z_trues))
    assert hits == 8, [r[0] for r in results]


@pytest.mark.parametrize("z_true, obs_seed", [(3.2, 4), (2.16, 11)])
def test_corr_matches_exact_and_auto_is_corr(z_true, obs_seed):
    """The correlation scan picks the exact scan's MAP z (also at the
    low-z edge z_true = 2.16), with near-peak deviations under 1% of the
    peak's margin; "auto" is the correlation scan, bit for bit."""
    learned, obs = _observation(z_true, obs_seed)
    spec, _ = _specs(obs)
    params = ZParameters(num_zqso_samples=800)
    t_model = learned.to("cpu", torch.float64)
    z_c, lls_c, zg = TZ.inference_z_qso(t_model, spec, params, method="corr")
    z_e, lls_e, _ = TZ.inference_z_qso(t_model, spec, params, method="exact")
    assert z_c == z_e and abs(z_c - z_true) < 0.05
    fin = np.isfinite(lls_e) & np.isfinite(lls_c)
    peak = np.nanargmax(lls_e)
    near = fin & (np.abs(zg - zg[peak]) < 0.2)
    margin = lls_e[peak] - np.nanmax(np.where(np.abs(zg - zg[peak]) > 0.2,
                                              np.where(fin, lls_e, -np.inf), -np.inf))
    assert np.nanmax(np.abs(lls_c - lls_e)[near]) < 0.01 * margin
    _, lls_a, _ = TZ.inference_z_qso(t_model, spec, params, method="auto")
    np.testing.assert_array_equal(lls_a, lls_c)


def test_inference_method_validation(model):
    learned, obs = model
    t_model = learned.to("cpu", torch.float64)
    spec, _ = _specs(obs)
    params = ZParameters(num_zqso_samples=16)
    with pytest.raises(ValueError, match="unknown method"):
        TZ.inference_z_qso(t_model, spec, params, method="fast")
    with pytest.raises(ValueError, match=r"shift scan \(method='shift'\) is not ported.*"
                                         r"'corr'.*'exact'"):
        TZ.inference_z_qso(t_model, spec, params, method="shift")
    spec_lin = TZ.prepare_z_spectrum(np.linspace(3600, 9000, 1000), np.ones(1000),
                                     np.ones(1000), np.zeros(1000, bool), P)
    with pytest.raises(ValueError, match="log-uniform"):
        TZ.inference_z_qso(t_model, spec_lin, params, method="corr")
    # "auto" on a linear grid takes the exact scan
    _, lls, _ = TZ.inference_z_qso(t_model, spec_lin, params, method="auto")
    _, lls_e, _ = TZ.inference_z_qso(t_model, spec_lin, params, method="exact")
    np.testing.assert_array_equal(lls, lls_e)
    with pytest.raises(TypeError, match="ZLearnedModel.to"):
        TZ.inference_z_qso(learned, spec, params)


def test_inference_many_streams_bounded_and_nan_safe():
    """A generator consumed lazily with a window of one, a fully masked
    spectrum in it (an all-zero scan and a finite z_map), ``keep_lls``,
    and the single-spectrum path's results."""
    params = ZParameters(num_zqso_samples=200)
    learned = TSyn.synthetic_z_learned_model(0, K)
    t_model = learned.to("cpu", torch.float64)
    z_trues = [2.8, 3.4]
    specs = [TZ.prepare_z_spectrum(*_observation(z, 20 + i)[1], P)
             for i, z in enumerate(z_trues)]
    wl, flux, nv, pm = _observation(3.0, 30)[1]
    dead = TZ.prepare_z_spectrum(wl, flux, nv, np.ones(len(wl), bool), P)
    pulled = []

    def stream():
        for s in (specs[0], dead, specs[1]):
            pulled.append(1)
            yield s

    results, z_grid = TZ.inference_z_qso_many(t_model, stream(), params, keep_lls=True,
                                              max_in_flight=1)
    assert len(results) == 3 and len(pulled) == 3 and z_grid.shape == (200,)
    (z0, lls0), (z_dead, lls_dead), (z1, _) = results
    assert np.isfinite(z_dead) and np.allclose(lls_dead, 0.0)
    assert abs(z0 - z_trues[0]) < 0.1 and abs(z1 - z_trues[1]) < 0.1
    z_single, lls_single, _ = TZ.inference_z_qso(t_model, specs[0], params)
    assert z0 == z_single
    np.testing.assert_array_equal(lls0, lls_single)
    results2, _ = TZ.inference_z_qso_many(t_model, [specs[0]], params, keep_lls=False)
    assert results2[0][1] is None


def test_golden_fixture_layout_and_inputs():
    """tests/data/torch_golden_zqso.npz (scripts/make_torch_golden.py zqso;
    replayed on the card by chip_smoke.py phase 18): its layout, and the
    port's generators rebuild its spectra from its seeds (the flux probe
    bit for bit, JAX's generator likewise)."""
    g = np.load(GOLDEN)
    n = len(g["obs_seed"])
    Zg = ZParameters().num_zqso_samples
    assert n == 4 and int(g["k"]) == 20
    assert g["lls_corr"].shape == (n, Zg) and g["lls_exact"].shape == (1, Zg)
    assert g["z_map_corr"].shape == (n,) and g["z_map_exact"].shape == (1,)
    np.testing.assert_array_equal(g["z_grid"], TZ.sample_z_qsos(Zg))
    z_true = np.random.default_rng(int(g["z_seed"])).uniform(2.4, 4.6, n)
    np.testing.assert_array_equal(g["z_true"], z_true)
    # MAPs on the grid; the first spectrum's is JAX's own miss (5.3053 for
    # z_true 3.2509 by both scans), which the port must reproduce
    assert np.isin(g["z_map_corr"], g["z_grid"]).all()
    assert g["z_map_exact"][0] == g["z_map_corr"][0]
    step = int(g["flux_probe_step"])
    for i, (z, obs_seed) in enumerate(zip(z_true, g["obs_seed"])):
        _, (_, flux, _, _) = TSyn.synthetic_z_observation(
            float(z), seed=int(g["model_seed"]), k=int(g["k"]), obs_seed=int(obs_seed))
        _, (_, jflux, _, _) = JSyn.synthetic_z_observation(
            float(z), seed=int(g["model_seed"]), k=int(g["k"]), obs_seed=int(obs_seed))
        np.testing.assert_array_equal(flux[::step], g["flux_probe"][i])
        np.testing.assert_array_equal(flux, jflux)


# (k, redshifts, the case's special z): a ragged chunk is one no block of
# the kernel's redshifts (32 or 64) divides; "window" is a z whose model
# window holds no pixel (given a finite median), "median" a z whose
# normalization window is empty (median +inf)
CAP_CASES = {"k5": (5, 64, None), "k20": (20, 64, None), "k21": (21, 64, None),
             "ragged": (20, 37, None), "empty_window": (20, 40, "window"),
             "empty_normalization": (20, 40, "median")}


def _cap_inputs(k, C, special):
    """A float32 CPU spectrum and model at width k, C redshifts over the
    grid's range, and the scan's own cut and normalization median."""
    learned, obs = _observation(3.1, 12, k=k)
    spec = TZ.device_spectrum(TZ.prepare_z_spectrum(*obs, P), "cpu", torch.float32)
    model = learned.to("cpu", torch.float32)
    params = ZParameters(k=k)
    z = torch.linspace(2.3, 5.9, C, dtype=torch.float64)
    if special == "window":
        z[-1] = 20.0  # 910 A x 21 lies redward of the last pixel
    wl = spec.wavelengths
    max_obs = torch.minimum(params.max_lambda * (1.0 + z),
                            torch.max(torch.where(spec.valid, wl, -np.inf)))
    min_obs = torch.maximum(params.min_lambda * (1.0 + z),
                            torch.min(torch.where(spec.valid, wl, np.inf)))
    median = TZ._normalization_median(TZ._sorted_flux_view(spec), z[:, None], min_obs[:, None],
                                      max_obs[:, None], params)
    if special == "window":
        median[-1] = 1.0
    if special == "median":
        median[3] = np.inf
    return model, spec, params, z, median, min_obs, max_obs


@pytest.mark.parametrize("case", list(CAP_CASES))
def test_zqso_cap_twin_and_k3_twin_match_the_composition(case):
    """zqso_cap's twin and K3's twin, the exact scan's float32 CPU route,
    against the composition they replace (``interp_uniform`` +
    ``log_mvnpdf_low_rank``) on the same float32 inputs: the same
    non-finite pattern, every finite |dll| within 1e-6 of the largest |ll|
    (measured: 1.8e-7);
    a z whose window holds no pixel gives 0."""
    from gpy_dla_detection_tpu_torch.ops.interp import interp_uniform
    from gpy_dla_detection_tpu_torch.ops.logmvn import log_mvnpdf_low_rank
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
        logmvn_chain_reference,
        zqso_cap,
        zqso_cap_reference,
    )

    k, C, special = CAP_CASES[case]
    model, spec, params, z, median, min_obs, max_obs = _cap_inputs(k, C, special)
    args = (z, median, min_obs, max_obs, spec.wavelengths, spec.flux, spec.noise_variance,
            spec.valid, model.rest_wavelengths, model.mu, model.M, params.min_lambda,
            params.max_lambda)
    _build.reset_launch_counts()
    B, u, misc = zqso_cap(*args)
    assert not _build.launch_counts  # the CPU runs the twin
    for got, want in zip((B, u, misc), zqso_cap_reference(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert B.shape == (C, k * (k + 1) // 2) and u.shape == (C, k) and misc.shape == (C, 2)
    assert B.dtype == u.dtype == misc.dtype == torch.float32
    got = logmvn_chain_reference(B, u, misc).numpy()

    rest = spec.wavelengths / (1.0 + z[:, None])
    ind = ((rest >= params.min_lambda) & (rest <= params.max_lambda)
           & (spec.wavelengths > min_obs[:, None]) & (spec.wavelengths < max_obs[:, None])
           & spec.valid)
    med = median[:, None]
    x0 = model.rest_wavelengths[0]
    dx = model.rest_wavelengths[1] - model.rest_wavelengths[0]
    rest_q = rest.to(torch.float32)
    want = log_mvnpdf_low_rank(spec.flux / med, interp_uniform(x0, dx, model.mu, rest_q),
                               interp_uniform(x0, dx, model.M, rest_q),
                               spec.noise_variance / (med * med), ind).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() >= C - 1
    scale = np.abs(want[fin]).max()
    assert np.abs(got[fin].astype(np.float64) - want[fin]).max() <= 1e-6 * scale
    empty = ~ind.any(dim=1).numpy()
    assert (got[empty] == 0).all() and (special != "window" or empty[-1])
    if special == "median":
        assert not np.isfinite(got[3])


@pytest.mark.parametrize("dtype, k, route", [(torch.float32, 5, "twin"),
                                             (torch.float32, 33, "twin"),
                                             (torch.float64, 5, "basis")])
def test_exact_route_and_its_chunk(monkeypatch, dtype, k, route):
    """On the CPU a float32 model's exact scan takes the twins (any k) and
    a float64 one the composition, whose ``log_mvnpdf_low_rank`` the twins'
    route never calls; both form the basis, so both chunk at
    ``BASIS_CHUNK`` at most, whatever ``EXACT_CHUNK`` is."""
    learned, obs = _observation(3.1, 12, k=k)
    model = learned.to("cpu", dtype)
    assert TZ._exact_route(model) == route
    chunks, composed = [], []
    at, low_rank = TZ._z_log_evidences_at, TZ.log_mvnpdf_low_rank
    monkeypatch.setattr(TZ, "_z_log_evidences_at",
                        lambda *a: chunks.append(a[2].shape[0]) or at(*a))
    monkeypatch.setattr(TZ, "log_mvnpdf_low_rank",
                        lambda *a: composed.append(1) or low_rank(*a))
    monkeypatch.setattr(TZ, "BASIS_CHUNK", 40)
    spec = TZ.device_spectrum(TZ.prepare_z_spectrum(*obs, P), "cpu", dtype)
    z = torch.linspace(2.3, 5.9, 100, dtype=torch.float64)
    lls = TZ.z_log_evidences(model, spec, z, ZParameters(k=k))
    assert chunks == [40, 40, 20]
    assert len(composed) == (3 if route == "basis" else 0)
    assert lls.dtype == dtype and torch.isfinite(lls).sum() >= 90
