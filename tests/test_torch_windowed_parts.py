"""The unfused windowed configuration of the PyTorch port (K6 and the
windowed unit optical depth it places) against the JAX package.

Tolerances:
* ``_wofz_cf`` with the default depth and with 2 terms: 1e-6 relative in
  float32, 1e-13 in float64 (the same continued fraction; measured 1.2e-7
  and 2e-16);
* ``windowed_tau_parts`` vs ``_windowed_tau_parts``: the window starts
  ``c0`` equal (they are K6's input), and the placed unit optical depth
  within 2e-6 of the largest |tau|, the line-core peak (measured 2.9e-7;
  the port keeps only the float32 form).  A pointwise relative
  bound is ill-posed in float32: a pixel 1-2 px from a core gets a value
  ~1e-4 of the peak that the float32 Weideman rational builds out of O(1)
  terms, and the two packages round it differently (4.6e-4 relative
  measured on the jittered grid);
* K6's twin on the JAX package's own parts vs the Pallas K6 in
  interpret mode: 2e-6 relative, 1e-7 absolute on the profile, in [0, 1]
  (the same placement, exp and 7-tap sum; measured 1.2e-7);
* the catalog slice: float64 at 1e-9 relative of the JAX float64 run;
  float32 within 1e-4 of the spectrum's largest |log evidence|, |dp_dla|
  <= 1e-3 and the same argmax model (the slice tolerances of
  tests/test_torch_pipeline.py).
The CUDA kernel is held against the twin in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpy_dla_detection_tpu.ops.voigt as JV
from gpy_dla_detection_tpu import constants as JC
from gpy_dla_detection_tpu.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu.models.pipeline import process_spectrum as J_process_spectrum
from gpy_dla_detection_tpu.ops.faddeeva import _wofz_cf as J_wofz_cf
from gpy_dla_detection_tpu.ops.voigt_pallas import absorption_windowed_pallas
from gpy_dla_detection_tpu.params import Parameters
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.models import evidence as evidence_module
from gpy_dla_detection_tpu_torch.models.evidence import single_absorber_profiles
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops import voigt as TV
from gpy_dla_detection_tpu_torch.ops.faddeeva import RADIUS, _wofz_cf
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    absorption_windowed,
    absorption_windowed_reference,
)
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch

torch.set_num_threads(2)

REL_CF = {np.float32: 1e-6, np.float64: 1e-13}
REL_TAU = 2e-6
RTOL_K6, ATOL_K6 = 2e-6, 1e-7
S = 128
MAX_DLAS = 3
REL_F64 = 1e-9
REL_F32_EVIDENCE = 1e-4
ABS_F32_P_DLA = 1e-3


def _grids_and_redshifts(P=1286, S=400, seed=3):
    """A full-width log grid (P = 1,286 pads to 11 chunks), its +-30%
    jittered twin, and redshifts whose Lyman-alpha lines fall on it."""
    rng = np.random.default_rng(seed)
    base = 1215.67 * 2.9 * 10 ** (1e-4 * np.arange(P))
    steps = np.diff(base) * (1.0 + 0.3 * rng.uniform(-1, 1, P - 1))
    jittered = base[0] + np.concatenate([[0.0], np.cumsum(steps)])
    z = rng.uniform(1.9, 3.3, S)
    nhi = 10 ** rng.uniform(20, 22, S)
    return {"regular": base, "jittered": jittered}, z, nhi


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("terms", [None, 2])
def test_wofz_cf_matches_jax(dtype, terms):
    rng = np.random.default_rng(1)
    x = rng.uniform(RADIUS - 1.0, 300.0, 4000).astype(dtype)  # where the CF is used
    y = np.full_like(x, 1.6e-3 if dtype == np.float32 else 7.5e-4)
    got = _wofz_cf(torch.as_tensor(x), torch.as_tensor(y), terms=terms)
    want = J_wofz_cf(jnp.asarray(x), jnp.asarray(y), terms=terms)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REL_CF[dtype], atol=0)


def _parts_pair(wl, z, num_lines, window_tier, monkeypatch):
    monkeypatch.setattr(JV, "WINDOW_TIER", window_tier)
    want = JV._windowed_tau_parts(
        jnp.asarray(wl), jnp.asarray(z), num_lines, JC.THERMAL_SIGMA_CGS
    )
    got = TV.windowed_tau_parts(
        torch.as_tensor(wl), torch.as_tensor(z), num_lines, window_tier=window_tier
    )
    return got, want


@pytest.mark.parametrize("window_tier", [True, False])
@pytest.mark.parametrize("grid_name", ["regular", "jittered"])
def test_windowed_tau_parts_match_jax_float32(grid_name, window_tier, monkeypatch):
    grids, z, _ = _grids_and_redshifts()
    wl = grids[grid_name].astype(np.float32)
    got, want = _parts_pair(wl, z.astype(np.float32), 3, window_tier, monkeypatch)
    assert got.num_pixels == want.num_pixels == wl.shape[0]
    assert got.far.shape == want.far.shape and got.far.shape[1] % TV.CHUNK == 0
    assert got.corr.shape == want.corr.shape and got.c0.dtype == torch.int32
    np.testing.assert_array_equal(got.c0.numpy(), np.asarray(want.c0))
    tau_t = TV.place_windows(got).numpy().astype(np.float64)
    tau_j = np.asarray(JV._place_windows(want)).astype(np.float64)
    assert np.abs(tau_t - tau_j).max() <= REL_TAU * np.abs(tau_j).max()


def test_windowed_tau_parts_is_float32_only():
    """float64 takes the exact path: the port has no float64 windowed form."""
    grids, z, _ = _grids_and_redshifts(S=4)
    with pytest.raises(TypeError, match="float32"):
        TV.windowed_tau_parts(torch.as_tensor(grids["regular"]), torch.as_tensor(z), 3)


# 8 lines: the windows of the higher Lyman lines overlap, so the placement
# must add them one line after another
@pytest.mark.parametrize("num_lines", [3, 8])
@pytest.mark.parametrize("grid_name", ["regular", "jittered"])
def test_k6_twin_matches_pallas_interpret_on_jax_parts(grid_name, num_lines, monkeypatch):
    grids, z, nhi = _grids_and_redshifts(S=48)
    wl = grids[grid_name].astype(np.float32)
    monkeypatch.setattr(JV, "WINDOW_TIER", True)
    parts = JV._windowed_tau_parts(
        jnp.asarray(wl), jnp.asarray(z.astype(np.float32)), num_lines, JC.THERMAL_SIGMA_CGS
    )
    c0 = np.asarray(parts.c0)
    if num_lines == 8:
        assert np.any(np.abs(np.diff(np.sort(c0, axis=1), axis=1)) <= 1)  # overlaps occur
    nhi32 = nhi.astype(np.float32)
    want = np.asarray(absorption_windowed_pallas(parts, jnp.asarray(nhi32), interpret=True))
    tparts = TV.WindowedTauParts(
        torch.tensor(np.asarray(parts.far)), torch.tensor(np.asarray(parts.corr)),
        torch.tensor(c0), parts.num_pixels,
    )
    got = absorption_windowed_reference(tparts, torch.as_tensor(nhi32))
    assert got.shape == (z.shape[0], wl.shape[0] - 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_K6, atol=ATOL_K6)


def test_k6_wrapper_dispatch_on_the_cpu():
    grids, z, nhi = _grids_and_redshifts(S=8)
    wl = torch.as_tensor(grids["regular"].astype(np.float32))
    parts = TV.windowed_tau_parts(wl, torch.as_tensor(z.astype(np.float32)), 3)
    nhi32 = torch.as_tensor(nhi.astype(np.float32))
    _build.reset_launch_counts()
    assert torch.equal(absorption_windowed(parts, nhi32),
                       absorption_windowed_reference(parts, nhi32))
    assert _build.launch_counts["absorption_windowed"] == 0
    parts64 = TV.WindowedTauParts(parts.far.double(), parts.corr.double(), parts.c0,
                                  parts.num_pixels)
    with pytest.raises(TypeError):
        absorption_windowed(parts64, nhi32.double())
    # the LLS profile, unfused: the placed parts plus the break, then K5's
    # twin (the reference places the LLS windows outside K6)
    z_lls = torch.full((8,), 2.5)
    (got,) = single_absorber_profiles(wl, z_lls, (nhi32,), 3, "windowed_unfused", "lls")
    unit = TV.place_windows(TV.windowed_tau_parts(wl, z_lls, 3)) + TV.lyman_limit_unit_tau(wl, z_lls)
    assert torch.equal(got, TV.absorption_from_unit_tau(unit, nhi32))
    assert _build.launch_counts["absorption_windowed"] == 0


@pytest.fixture(scope="module")
def slice_inputs():
    params = Parameters(num_dla_samples=S, k=8)
    learned = synthetic_learned_model(params)
    spectra = [
        synthetic_spectrum(params, learned, 3.0, seed=0),
        synthetic_spectrum(params, learned, 3.2, seed=1, dlas=[(2.9, 21.2)]),
    ]
    base = np.random.default_rng(11).integers(0, S, size=(2, MAX_DLAS - 1, S))
    jax_results = [
        J_process_spectrum(
            learned, spec, generate_dla_samples(params), generate_subdla_samples(params),
            synthetic_prior_catalog(params), params, jax.random.PRNGKey(0),
            max_dlas=MAX_DLAS, base_inds_override=b,
        )
        for spec, b in zip(spectra, base)
    ]
    return params, learned, spectra, base, jax_results


def _run_unfused(slice_inputs, dtype, window_tier=True):
    params, learned, spectra, base, _ = slice_inputs
    return process_batch(
        LearnedModel.from_numpy(learned, "cpu", dtype), spectra,
        generate_dla_samples(params), generate_subdla_samples(params),
        synthetic_prior_catalog(params), params, torch.Generator().manual_seed(0),
        max_dlas=MAX_DLAS, base_inds_override=base, voigt_impl="windowed_unfused",
        window_tier=window_tier,
    )


def test_unfused_configuration_float64_matches_jax(slice_inputs):
    """In float64 the unfused configuration is the exact path, as the
    other two: the same 1e-9 against the JAX float64 run."""
    for got, want in zip(_run_unfused(slice_inputs, torch.float64), slice_inputs[-1]):
        for name in ("log_evidence_null", "log_evidences_dla", "log_evidence_subdla",
                     "map_z_dlas", "map_log_nhis", "p_dla"):
            np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                       rtol=REL_F64, atol=0, err_msg=name)
        g, w = got.sample_log_likelihoods_dla, np.asarray(want.sample_log_likelihoods_dla)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=REL_F64, atol=0)


@pytest.mark.parametrize("window_tier", [True, False])
def test_unfused_configuration_float32_matches_jax_float64(slice_inputs, window_tier,
                                                           monkeypatch):
    """float32: the windowed parts (with the two-tier window, and without
    it: the reference's GPY_DLA_WINDOW_TIER=0, patched on the JAX side
    too) and K6's twin per family, through ``process_batch``, against the
    JAX float64 run (which off the TPU is the exact configuration) on the
    same resampling indices."""
    monkeypatch.setattr(JV, "WINDOW_TIER", window_tier)
    seen = record_window_tier(monkeypatch)
    names = ("log_evidence_null", "log_evidences_dla", "log_evidence_subdla")
    results = _run_unfused(slice_inputs, torch.float32, window_tier)
    assert seen and set(seen) == {window_tier}  # one parts build a spectrum
    for got, want in zip(results, slice_inputs[-1]):
        scale = max(np.abs(np.asarray(getattr(want, n))).max() for n in names)
        for name in names:
            np.testing.assert_allclose(
                np.asarray(getattr(got, name), np.float64), np.asarray(getattr(want, name)),
                rtol=0, atol=REL_F32_EVIDENCE * scale, err_msg=name,
            )
        assert abs(got.p_dla - want.p_dla) <= ABS_F32_P_DLA
        assert np.argmax(got.selection.model_posteriors) == np.argmax(
            want.selection.model_posteriors
        )


def record_window_tier(monkeypatch):
    """The ``window_tier`` of every ``windowed_tau_parts`` call the catalog
    and the LLS search make (``models/evidence.py``), recorded around the
    real function (also used by tests/test_torch_lls.py)."""
    seen = []

    def parts(wavelengths, z_absorber, num_lines=3, window_tier=True):
        seen.append(window_tier)
        return TV.windowed_tau_parts(wavelengths, z_absorber, num_lines, window_tier)

    monkeypatch.setattr(evidence_module, "windowed_tau_parts", parts)
    return seen


@pytest.mark.parametrize("window_tier", [True, False])
def test_window_tier_reaches_the_unfused_profiles(window_tier, monkeypatch):
    """``window_tier`` reaches ``windowed_tau_parts`` in both profiles of
    the unfused configuration: each family's profile equals K6's twin (DLA)
    or K5's twin (LLS) on the parts made with the switch.  (In float32 the
    two-tier window gives the full window's bits on these grids: the
    2-term continued fraction off the strip rounds as the 5-term one; the
    switch moves the cost.)  The other configurations never build parts."""
    grids, z, nhi = _grids_and_redshifts(S=64)
    wl = torch.as_tensor(grids["jittered"].astype(np.float32))
    z32, nhi32 = torch.as_tensor(z.astype(np.float32)), torch.as_tensor(nhi.astype(np.float32))
    seen = record_window_tier(monkeypatch)
    for profile in ("dla", "lls"):
        (got,) = single_absorber_profiles(wl, z32, (nhi32,), 3, "windowed_unfused", profile,
                                          window_tier=window_tier)
        parts = TV.windowed_tau_parts(wl, z32, 3, window_tier)
        if profile == "dla":
            want = absorption_windowed_reference(parts, nhi32)
        else:
            want = TV.absorption_from_unit_tau(
                TV.place_windows(parts) + TV.lyman_limit_unit_tau(wl, z32), nhi32)
        assert torch.equal(got, want)
    assert seen == [window_tier, window_tier]
    for impl in ("windowed", "exact", "windowed_weideman"):
        single_absorber_profiles(wl, z32, (nhi32,), 3, impl, window_tier=window_tier)
    assert len(seen) == 2
