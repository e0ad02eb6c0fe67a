"""The absorber MCMC head of the PyTorch port against the JAX package.

* DLA and CIV log posteriors at fixed parameters, in and out of bounds:
  float64 within 1e-10 relative of JAX's (same algorithm; measured
  <= 6.2e-14), -inf on both sides out of bounds; float32 (K5's twin, the
  float32 Faddeeva tiers, the float32 Woodbury) against JAX float64
  within 1.5x JAX float32's own error on the same parameters, or 1e-6 of
  |log posterior| if larger: both round float32 sums of pixel terms far
  larger than a CIV posterior near zero (measured at worst: DLA port
  0.0104, JAX float32 0.0166; CIV port 0.0141, JAX float32 0.0140).
* One stretch-move half-step given the draws JAX's ``_stretch_half``
  makes from its key (recomputed here with ``jax.random``): equal to
  1e-14 relative, the same accept decisions.
* The sampler on a Gaussian target with a torch generator (the moments
  test of tests/test_mcmc.py), and a DLA chain at reduced steps that
  concentrates near the injected absorber.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.data.spectrum import astype as J_astype
from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model as J_learned_model,
    synthetic_spectrum as J_spectrum,
)
from gpy_dla_detection_tpu.models import absorber_mcmc as JA
from gpy_dla_detection_tpu.models.learned import build_spectrum_model as J_build
from gpy_dla_detection_tpu.models.mcmc import _stretch_half
from gpy_dla_detection_tpu.ops.logmvn import log_mvnpdf_low_rank as J_low_rank
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.models import absorber_mcmc as TA
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, build_spectrum_model
from gpy_dla_detection_tpu_torch.models.mcmc import (
    StretchDraws,
    autocorrelation_time,
    run_ensemble,
    stretch_half,
)
from gpy_dla_detection_tpu_torch.ops.logmvn import log_mvnpdf_low_rank
from gpy_dla_detection_tpu_torch.params import Parameters

torch.set_num_threads(2)

REL_F64 = 1e-10
REL_F32_FLOOR = 1e-6
Z_QSO = 3.05


@pytest.fixture(scope="module")
def spectrum():
    """One injected spectrum at full width, as JAX's float64 and float32
    models and the inputs of the port's."""
    params = JParameters()
    learned = J_learned_model(params)
    spec = J_spectrum(params, learned, Z_QSO, seed=7, dlas=[(2.8, 20.8)])
    jmodel = J_build(learned.astype(np.float64), spec, params)
    jmodel32 = J_build(learned.astype(np.float32), J_astype(spec, np.float32), params)
    return params, learned, spec, jmodel, jmodel32


def _port_model(spectrum, dtype):
    params, learned, spec = spectrum[:3]
    return build_spectrum_model(
        LearnedModel.from_numpy(learned, "cpu", dtype), to_torch(spec, "cpu", dtype), params
    )


def _dla_thetas(jmodel, k):
    lo, hi = float(jmodel.min_z_dla), float(jmodel.max_z_dla)
    frac = np.array([[0.2, 0.55], [0.7, 0.3], [0.5, 0.9], [0.95, 0.05]])[:, :k]
    nhi = np.array([[20.8, 21.4], [21.5, 20.2], [20.1, 22.0], [22.9, 20.5]])[:, :k]
    inside = np.concatenate([lo + (hi - lo) * frac, nhi], axis=1)
    outside = inside[:3].copy()
    outside[0, 0] = lo - 0.05  # z below the search range
    outside[1, k] = 23.2  # logNHI above the uniform prior's top
    outside[2, k] = 19.9  # logNHI below its bottom
    return inside, outside


def _civ_thetas(jmodel):
    lo, hi = float(jmodel.min_z_dla), float(jmodel.max_z_dla)
    inside = np.array([
        [lo + 0.02, 14.0, 3e6], [lo + 0.08, 15.5, 1.5e6],
        [lo + 0.5 * (hi - lo), 13.2, 7e6], [hi - 0.01, 19.0, 5e6],
    ])
    outside = inside[:3].copy()
    outside[0, 0] = hi + 0.01
    outside[1, 1] = 12.5
    outside[2, 2] = 9e6
    return inside, outside


def _check_posterior(got, thetas, inside_n, make_jax_fn, spectrum):
    """float64: within REL_F64 of JAX's.  float32: against JAX float64
    within 1.5x JAX float32's own error (or REL_F32_FLOOR |log posterior|).
    -inf out of bounds on both sides."""
    want = np.asarray(make_jax_fn(spectrum[3])(jnp.asarray(thetas)))
    assert np.isfinite(want[:inside_n]).all() and np.isneginf(want[inside_n:]).all()
    assert torch.isneginf(got[inside_n:]).all()
    g, w = got[:inside_n].numpy().astype(np.float64), want[:inside_n]
    if got.dtype == torch.float64:
        np.testing.assert_allclose(g, w, rtol=REL_F64, atol=0)
        return w
    want32 = np.asarray(
        make_jax_fn(spectrum[4])(jnp.asarray(thetas[:inside_n], jnp.float32))
    ).astype(np.float64)
    budget = np.maximum(np.abs(want32 - w).max(), REL_F32_FLOOR * np.abs(w))
    assert (np.abs(g - w) <= 1.5 * budget).all(), (np.abs(g - w), budget)
    return w


@pytest.mark.parametrize("k_dlas", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dla_log_posterior_matches_jax(spectrum, k_dlas, dtype):
    params, jmodel = spectrum[0], spectrum[3]
    inside, outside = _dla_thetas(jmodel, k_dlas)
    thetas = np.concatenate([inside, outside])
    got = TA.make_dla_log_posterior(_port_model(spectrum, dtype), params, k_dlas)(
        torch.as_tensor(thetas, dtype=dtype)
    )
    assert got.dtype == dtype and got.shape == (len(thetas),)
    _check_posterior(
        got, thetas, len(inside),
        lambda m: JA.make_dla_log_posterior(m, params, k_dlas), spectrum,
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_civ_log_posterior_matches_jax(spectrum, dtype):
    params, jmodel = spectrum[0], spectrum[3]
    inside, outside = _civ_thetas(jmodel)
    thetas = np.concatenate([inside, outside])
    got = TA.make_civ_log_posterior(_port_model(spectrum, dtype), params)(
        torch.as_tensor(thetas, dtype=dtype)
    )
    want = _check_posterior(
        got, thetas, len(inside), lambda m: JA.make_civ_log_posterior(m, params), spectrum
    )
    # the doublet near the grid's red end absorbs: not every walker sees
    # the absorber-free likelihood
    assert np.ptp(want) > 1.0


def test_log_nhi_prior_and_walker_batched_density_match_jax(spectrum):
    params = Parameters()
    x = np.linspace(19.5, 23.5, 81)
    np.testing.assert_allclose(
        TA.log_nhi_mixture_pdf(torch.as_tensor(x), params).numpy(),
        np.asarray(JA.log_nhi_mixture_pdf_jnp(jnp.asarray(x), params)), rtol=1e-14, atol=0,
    )
    # one low-rank density per walker, as JAX vmaps it
    jmodel = spectrum[3]
    rng = np.random.default_rng(2)
    a = np.exp(-rng.uniform(0, 0.5, (6, jmodel.y.shape[0])))
    y, mu, M = (np.asarray(jmodel.y), np.asarray(jmodel.mu), np.asarray(jmodel.M))
    v, o2, mask = np.asarray(jmodel.v), np.asarray(jmodel.omega2), np.asarray(jmodel.mask)
    want = np.asarray(jax.vmap(lambda ai: J_low_rank(y, mu * ai, M * ai[:, None],
                                                     o2 * ai**2 + v, mask))(jnp.asarray(a)))
    t = lambda x: torch.as_tensor(x)
    got = log_mvnpdf_low_rank(t(y), t(mu * a), t(M[None] * a[..., None]), t(o2 * a**2 + v),
                              t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    # a capacitance that is not positive definite gives NaN, not an error
    bad = log_mvnpdf_low_rank(t(y), t(mu), t(M), t(np.full_like(v, -1e-3)), t(mask))
    assert torch.isnan(bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stretch_half_equals_jax_given_its_draws(seed):
    """The port's half-step, fed the random numbers JAX's draws from its
    key, moves the walkers exactly as JAX does."""
    rng = np.random.default_rng(seed)
    W, D, a = 8, 3, 2.0
    active = rng.normal(size=(W, D))
    passive = rng.normal(size=(W, D))
    mean, std = np.array([0.5, -1.0, 2.0]), np.array([0.7, 1.5, 0.3])
    j_lp = lambda x: -0.5 * jnp.sum(((x - mean) / std) ** 2, axis=-1)
    t_lp = lambda x: -0.5 * torch.sum(((x - torch.as_tensor(mean)) / torch.as_tensor(std)) ** 2,
                                      dim=-1)
    lp_active = np.asarray(j_lp(jnp.asarray(active)))
    key = jax.random.PRNGKey(seed)
    want = _stretch_half(key, jnp.asarray(active), jnp.asarray(passive),
                         jnp.asarray(lp_active), j_lp, a)

    # the draws of JAX's _stretch_half, recomputed from its key
    k_z, k_pick, k_accept = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(k_z, (W,), jnp.float64))
    draws = StretchDraws(
        z=torch.as_tensor(((a - 1.0) * u + 1.0) ** 2 / a),
        partners=torch.as_tensor(np.array(jax.random.randint(k_pick, (W,), 0, W)),
                                 dtype=torch.int64),
        accept_u=torch.as_tensor(np.array(jax.random.uniform(k_accept, (W,), jnp.float64))),
    )
    got = stretch_half(torch.as_tensor(active), torch.as_tensor(passive),
                       torch.as_tensor(lp_active), t_lp, draws)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-14, atol=1e-15)
    assert 0 < int(want[2].sum()) < W  # some moves accepted, some not


def test_ensemble_samples_gaussian():
    """The stretch move reproduces the moments of an anisotropic 2-D
    Gaussian (tests/test_mcmc.py's target, with a torch generator)."""
    mean = torch.tensor([1.0, -2.0], dtype=torch.float64)
    std = torch.tensor([0.7, 2.5], dtype=torch.float64)
    log_prob = lambda x: -0.5 * torch.sum(((x - mean) / std) ** 2, dim=-1)
    g = torch.Generator().manual_seed(0)
    pos0 = mean + 0.1 * torch.randn((64, 2), generator=g, dtype=torch.float64)
    chain, lps, acc = run_ensemble(g, pos0, log_prob, num_steps=2000)
    assert chain.shape == (2000, 64, 2) and lps.shape == (2000, 64)
    assert 0.2 < float(acc) < 0.9, float(acc)
    samples = chain[500:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(0), mean.numpy(), atol=0.08)
    np.testing.assert_allclose(samples.std(0), std.numpy(), rtol=0.08)
    with pytest.raises(ValueError):
        run_ensemble(g, pos0[:3], log_prob, num_steps=1)


def test_autocorrelation_time_reasonable():
    rng = np.random.default_rng(0)
    rho = 0.9  # AR(1), tau = (1 + rho) / (1 - rho)
    x = np.zeros(20000)
    for i in range(1, len(x)):
        x[i] = rho * x[i - 1] + rng.normal()
    want = (1 + rho) / (1 - rho)
    assert 0.5 * want < autocorrelation_time(torch.as_tensor(x)) < 2.0 * want


def test_dla_chain_concentrates_near_the_injected_absorber():
    """16 walkers x 400 steps of the float32 DLA sampler on the CPU (the
    kernels' twins) at full width, started near the absorber as
    tests/test_mcmc.py starts JAX's."""
    params = Parameters()
    learned = synthetic_learned_model(params)
    z_dla, log_nhi = 2.82, 21.0
    spec = synthetic_spectrum(params, learned, Z_QSO, seed=11, dlas=[(z_dla, log_nhi)],
                              noise_level=0.05)
    model = build_spectrum_model(LearnedModel.from_numpy(learned, "cpu", torch.float32),
                                 to_torch(spec, "cpu", torch.float32), params)
    rng = np.random.default_rng(1)
    pos0 = torch.as_tensor(np.stack([z_dla + 0.01 * rng.normal(size=16),
                                     log_nhi + 0.3 * rng.normal(size=16)], axis=1),
                           dtype=torch.float32)
    chain, lps, acc = TA.run_dla_mcmc(model, params, torch.Generator().manual_seed(1),
                                      nwalkers=16, nsamples=400, initial_positions=pos0)
    assert chain.shape == (400, 16, 2) and chain.dtype == torch.float32
    assert torch.isfinite(lps[-1]).all()
    assert 0.05 < float(acc) < 0.95, float(acc)
    tail = chain[-100:].reshape(-1, 2).numpy()
    assert abs(np.median(tail[:, 0]) - z_dla) < 0.01, np.median(tail[:, 0])
    assert abs(np.median(tail[:, 1]) - log_nhi) < 0.3, np.median(tail[:, 1])


def test_default_starts_and_civ_chain_shapes(spectrum):
    params = spectrum[0]
    model = _port_model(spectrum, torch.float32)
    g = torch.Generator().manual_seed(3)
    chain, lps, acc = TA.run_dla_mcmc(model, params, g, k_dlas=2, nwalkers=6, nsamples=3)
    assert chain.shape == (3, 6, 4) and lps.shape == (3, 6)
    assert bool((chain[..., :2] > model.min_z_dla).all() & (chain[..., :2] < model.max_z_dla).all())
    chain, lps, acc = TA.run_civ_mcmc(model, params, g, nwalkers=6, nsamples=3)
    assert chain.shape == (3, 6, 3) and torch.isfinite(lps).all()
    assert bool((chain[..., 2] > 1e6).all() & (chain[..., 2] < 8e6).all())
