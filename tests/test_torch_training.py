"""The port's GP training against the JAX package on the same seeded inputs.

``gpy_dla_detection_tpu_torch.models.training`` against
``gpy_dla_detection_tpu.models.training`` on the CPU:

* ``spectrum_loss`` against scipy's dense MVN logpdf (rtol 1e-9, the bound
  ``tests/test_training.py`` holds the JAX package to);
* ``batched_spectrum_losses`` through ``chain_loglik`` (the route the card
  takes, here K3's and its adjoint's plain twins in float64) against JAX's
  in value (rtol 1e-10) and in its five gradient blocks against
  ``jax.grad`` (rtol 1e-8, atol 1e-10);
* K3's adjoint twin against ``torch.autograd`` through K3's twin in
  float64 at k = 1 to 65 (rtol 1e-10), both sides of the warp chain's row
  bounds;
* the float32 route against JAX float64 at the full width of the golden
  fixture (``tests/data/torch_golden_train.npz``), at the tolerances
  ``chip_smoke.py`` phase 19 holds the card to: losses within 1e-5 of
  max|loss|, each gradient block within 1e-3 of its max|g|;
* finite differences of ``total_objective``; the beta gradient where the
  Lyman indicator is 0 (lines past the quasar);
* ``initialize`` equal to JAX's; ``train_model`` in float64 recovering a
  synthetic GP; checkpoints across the packages; the callback schedule and
  early stop; float64 refused on a CUDA device; the fit's line search
  backtracking within an iteration and backing off from non-finite values.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

from gpy_dla_detection_tpu.models import training as JT
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch import constants as TC
from gpy_dla_detection_tpu_torch.data import synthetic as TSyn
from gpy_dla_detection_tpu_torch.models import training as TT
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    _packed_maps,
    chain_loglik,
    logmvn_chain_grad,
    logmvn_chain_grad_reference,
    logmvn_chain_reference,
)
from gpy_dla_detection_tpu_torch.params import Parameters

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_train.npz"
F64 = torch.float64
REL_LOSS_F32 = 1e-5  # of max|loss|, float32 against float64 (phase 19)
REL_GRAD_F32 = 1e-3  # of each block's max|g|, float32 against float64 (phase 19)


def _tiny_problem(seed=0, R=40, k=4):
    """One spectrum and parameters, as tests/test_training.py draws them."""
    rng = np.random.default_rng(seed)
    fields = (rng.normal(size=(R, k)) * 0.3, np.log(rng.uniform(0.05, 0.3, R)),
              np.log(0.1), np.log(0.0023), np.log(3.65))
    y = rng.normal(size=R)
    lya_1pz = np.linspace(3.0, 4.0, R)
    v = rng.uniform(0.01, 0.1, R)
    mask = rng.uniform(size=R) > 0.15
    return fields, y, lya_1pz, v, mask, np.float64(3.1)


def _batch(Q=5, R=40, k=4, seed=10):
    """Q spectra of ``_tiny_problem`` (masked flux, z_qso stepped by 0.1)
    and the last one's parameters."""
    rows = [_tiny_problem(seed=seed + q, R=R, k=k) for q in range(Q)]
    fields = rows[-1][0]
    arrays = (np.stack([np.where(r[4], r[1], 0.0) for r in rows]),
              np.stack([r[2] for r in rows]), np.stack([r[3] for r in rows]),
              np.stack([r[4] for r in rows]),
              np.asarray([r[5] + 0.1 * q for q, r in enumerate(rows)]))
    return fields, arrays


def _port(fields, arrays, dtype=F64):
    p = TT.TrainingParams.from_numpy(fields, "cpu", dtype)
    t = [torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else dtype) for a in arrays]
    return p, t


def _jax(fields, arrays):
    return JT.TrainingParams(*[jnp.asarray(f) for f in fields]), tuple(map(jnp.asarray, arrays))


def _grads(p):
    return {n: getattr(p, n).grad.double().numpy() for n in TT.PARAM_FIELDS}


def test_spectrum_loss_matches_dense_logpdf():
    """The masked Woodbury loss equals the dense MVN logpdf with the
    absorption-noise covariance built explicitly
    (reference: spectrum_loss_lyseries.m:14-69)."""
    fields, y, lya_1pz, v, mask, zqso = _tiny_problem()
    L = 31
    p, (yt, zt, vt, mt) = _port(fields, (np.where(mask, y, 0.0), lya_1pz, v, mask))
    got = float(TT.spectrum_loss(yt, zt, vt, mt, torch.tensor(zqso, dtype=F64), p, L)
                .detach())

    M0, log_omega, log_c_0, log_tau_0, log_beta = fields
    lam, osc = TC.LYMAN_WAVELENGTHS_A, TC.LYMAN_OSCILLATOR_STRENGTHS
    tau = np.exp(log_tau_0) * lya_1pz ** np.exp(log_beta)
    for i in range(1, L):
        one_pz = lam[0] * lya_1pz / lam[i]
        ind = one_pz - 1.0 <= zqso - 1.0
        scale = np.exp(log_tau_0) * lam[i] * osc[i] / (lam[0] * osc[0])
        tau = tau + np.where(ind, scale * (one_pz * ind) ** np.exp(log_beta), 0.0)
    d = v + np.exp(2.0 * log_omega) * (1.0 - np.exp(-tau) + np.exp(log_c_0)) ** 2
    M = M0[mask]
    cov = M @ M.T + np.diag(d[mask])
    ref = -multivariate_normal(mean=np.zeros(mask.sum()), cov=cov).logpdf(y[mask])
    np.testing.assert_allclose(got, ref, rtol=1e-9)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_batched_losses_and_gradients_match_jax(k):
    """The port's batched losses (packed basis, K3's and its adjoint's
    twins through chain_loglik) equal JAX's (flat basis, autodiff of the
    unrolled chain) in value and in the five gradient blocks, and the
    port's own per-spectrum reference in value."""
    fields, arrays = _batch(k=k)
    L = 31
    p, t = _port(fields, arrays)
    losses = TT.batched_spectrum_losses(p, *t, L)
    losses.sum().backward()
    jp, ja = _jax(fields, arrays)
    want = JT.batched_spectrum_losses(jp, *ja, L)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want), rtol=1e-10)
    per = torch.stack([TT.spectrum_loss(*[x[q] for x in t], p, L) for q in range(len(t[0]))])
    np.testing.assert_allclose(losses.detach().numpy(), per.detach().numpy(), rtol=1e-10)

    g_want = jax.grad(lambda pp: jnp.sum(JT.batched_spectrum_losses(pp, *ja, L)))(jp)
    got = _grads(p)
    for name in TT.PARAM_FIELDS:
        np.testing.assert_allclose(got[name], np.asarray(getattr(g_want, name)),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


def _chain_problem(k, S=7, dtype=F64):
    """A capacitance I + B with B = M^T D^-1 M over 3k + 5 pixels, packed."""
    rng = np.random.default_rng(k)
    N = 3 * k + 5
    M = rng.normal(size=(S, N, k)) * 0.3
    d_inv = rng.uniform(0.5, 5, size=(S, N))
    B = np.einsum("sni,sn,snj->sij", M, d_inv, M)
    cols, rows = (np.asarray(x) for x in _packed_maps(k))
    put = lambda x: torch.as_tensor(x, dtype=dtype)
    return (put(B[:, rows, cols]), put(rng.normal(size=(S, k))), put(rng.normal(size=(S, 2))),
            put(rng.normal(size=S)))


@pytest.mark.parametrize("k", [1, 5, 20, 21, 33, 64, 65])
def test_chain_grad_twin_matches_autograd(k):
    """K3's adjoint twin against torch.autograd through K3's twin (the
    unrolled chain reads the lower triangle only, so its gradient to a
    packed off-diagonal entry is the symmetric one doubled): rtol 1e-10,
    and 1e-14 of the output's largest magnitude for entries that cancel
    to near 0 (a float64 ulp of the terms they are summed from)."""
    B, u, misc, g = _chain_problem(k)
    leaves = [x.clone().requires_grad_() for x in (B, u, misc)]
    want = torch.autograd.grad((logmvn_chain_reference(*leaves) * g).sum(), leaves)
    got = logmvn_chain_grad_reference(B, u, misc, g)
    for name, a, b in zip(("B", "u", "misc"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-14 * float(b.abs().max()), err_msg=name)
    # the wrapper on CPU float32 tensors takes the same twin
    f32 = [x.float() for x in (B, u, misc, g)]
    for a, b in zip(logmvn_chain_grad(*f32), logmvn_chain_grad_reference(*f32)):
        assert torch.equal(a, b)


def test_chain_grad_twin_gives_nan_where_not_positive_definite():
    """A pivot that is not positive makes the sample's dB and du NaN, as
    K3's likelihood; the other samples and dmisc are untouched."""
    k = 6
    B, u, misc, g = _chain_problem(k, S=4)
    B[1, 0] = -5.0  # the first pivot
    B[2, 3 * k - 3] = -500.0  # the pivot of column 3
    dB, du, dmisc = logmvn_chain_grad_reference(B, u, misc, g)
    ll = logmvn_chain_reference(B, u, misc)
    bad = torch.isnan(ll)
    assert bad.tolist() == [False, True, True, False]
    assert torch.isnan(dB[bad]).all() and torch.isnan(du[bad]).all()
    assert torch.isfinite(dB[~bad]).all() and torch.isfinite(dmisc).all()


def test_chain_loglik_is_the_twins_on_the_cpu():
    """chain_loglik on CPU tensors: K3's twin forward, its adjoint's twin
    backward, in the tensors' own dtype, no kernel launched."""
    B, u, misc, g = _chain_problem(20)
    leaves = [x.clone().requires_grad_() for x in (B, u, misc)]
    before = dict(_build.launch_counts)
    ll = chain_loglik(*leaves)
    assert ll.dtype == F64 and torch.equal(ll.detach(), logmvn_chain_reference(B, u, misc))
    (ll * g).sum().backward()
    for leaf, want in zip(leaves, logmvn_chain_grad_reference(B, u, misc, g)):
        assert torch.equal(leaf.grad, want)
    assert dict(_build.launch_counts) == before


def _golden_training_set():
    g = np.load(GOLDEN)
    params = Parameters()
    truth = TSyn.synthetic_learned_model(params, seed=int(g["model_seed"]))
    train = TT.prepare_training_set(params, *TSyn.synthetic_training_lists(
        params, truth, g["z_qso"], int(g["obs_seed"]), float(g["noise_level"])), g["z_qso"])
    return g, params, train


def test_golden_fixture_layout_and_inputs():
    """tests/data/torch_golden_train.npz (scripts/make_torch_golden.py
    train; replayed on the card by chip_smoke.py phase 19): its layout, and
    the port's generators rebuild its training set (mu bit for bit)."""
    g, params, train = _golden_training_set()
    Q, R, k = len(g["z_qso"]), train.flux.shape[1], int(g["k"])
    assert (Q, R, k) == (64, 1217, 20) and params.num_forest_lines == 31
    np.testing.assert_array_equal(
        g["z_qso"], np.random.default_rng(int(g["z_seed"])).uniform(2.5, 3.6, Q))
    assert g["losses"].shape == (Q,) and g["grad_M"].shape == (R, k)
    assert g["grad_log_omega"].shape == (R,)
    assert all(g[f"grad_{n}"].shape == () for n in ("log_c_0", "log_tau_0", "log_beta"))
    mu, _ = TT.initialize(params, train, "cpu", F64)
    np.testing.assert_array_equal(mu, g["mu"])
    np.testing.assert_allclose(g["losses"].sum() + 0.5 * (
        ((params.initial_tau_0 - 0.0023) / 0.0007) ** 2
        + ((params.initial_beta - 3.65) / 0.21) ** 2), g["objective"], rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_golden_losses_and_gradients(dtype):
    """At the golden's full width (Q = 64, R = 1,217, k = 20, 31 lines),
    the port's route against JAX float64: float64 to rtol 1e-10 (losses)
    and 1e-8 (gradients); float32 within phase 19's tolerances."""
    g, params, train = _golden_training_set()
    mu, p = TT.initialize(params, train, "cpu", dtype)
    put = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt)
    args = (put(np.where(train.mask, train.flux - mu, 0.0)), put(train.lya_1pz),
            put(train.noise_variance), put(train.mask, torch.bool), put(train.zqso_1pz))
    losses = TT.batched_spectrum_losses(p, *args, params.num_forest_lines)
    obj = TT.total_objective(p, *args, params)
    obj.backward()
    got, want = losses.detach().double().numpy(), g["losses"]
    grads = _grads(p)
    if dtype == F64:
        np.testing.assert_allclose(got, want, rtol=1e-10)
        np.testing.assert_allclose(float(obj.detach()), float(g["objective"]), rtol=1e-10)
        for n in TT.PARAM_FIELDS:
            np.testing.assert_allclose(grads[n], g[f"grad_{n}"], rtol=1e-8, atol=1e-10)
        return
    assert np.abs(got - want).max() <= REL_LOSS_F32 * np.abs(want).max()
    for n in TT.PARAM_FIELDS:
        err = np.abs(grads[n] - g[f"grad_{n}"]).max()
        assert err <= REL_GRAD_F32 * np.abs(g[f"grad_{n}"]).max(), (n, err)


def test_gradients_match_finite_differences():
    """autograd of the objective vs central finite differences (the
    reference hand-derives its five blocks, spectrum_loss_lyseries.m:71-91)."""
    fields, y, lya_1pz, v, mask, zqso = _tiny_problem(seed=1)
    params = Parameters()
    p, args = _port(fields, (np.where(mask, y, 0.0)[None], lya_1pz[None], v[None],
                             mask[None], np.asarray([zqso])))
    loss = lambda pp: TT.total_objective(pp, *args, params)
    loss(p).backward()
    grads = _grads(p)

    def shifted(name, delta):
        q = TT.TrainingParams.from_numpy(p.numpy(), "cpu", F64)
        with torch.no_grad():
            getattr(q, name).add_(delta)
        return float(loss(q).detach())

    eps = 1e-6
    for name in ("log_c_0", "log_tau_0", "log_beta"):
        fd = (shifted(name, eps) - shifted(name, -eps)) / (2 * eps)
        np.testing.assert_allclose(grads[name], fd, rtol=1e-4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        i, j = rng.integers(0, 40), rng.integers(0, 4)
        dM = torch.zeros_like(p.M)
        dM[i, j] = eps
        fd = (shifted("M", dM) - shifted("M", -dM)) / (2 * eps)
        np.testing.assert_allclose(grads["M"][i, j], fd, rtol=1e-3, atol=1e-7)
    i = int(rng.integers(0, 40))
    dw = torch.zeros_like(p.log_omega)
    dw[i] = eps
    fd = (shifted("log_omega", dw) - shifted("log_omega", -dw)) / (2 * eps)
    np.testing.assert_allclose(grads["log_omega"][i], fd, rtol=1e-4, atol=1e-7)


def test_beta_gradient_with_lines_past_the_quasar():
    """Lines whose Lyman indicator is 0 (pixels past the quasar) add 0 to
    tau and 0 to the beta gradient (not 0 * log 0): the optical depth and
    its beta gradient equal JAX's, finite, with many zero indicators."""
    lya_1pz = np.linspace(2.5, 4.5, 64)[None].repeat(2, 0)
    zqso_1pz = np.asarray([3.0, 4.0])  # most higher-order lines past the quasar
    L = 31
    tau_0, beta = 0.0023, 3.65
    z_t = torch.as_tensor(lya_1pz)
    beta_t = torch.tensor(beta, dtype=F64, requires_grad=True)
    tau = TT._forest_optical_depth(z_t, torch.as_tensor(zqso_1pz), tau_0, beta_t, L)
    tau.sum().backward()
    tau_j, g_j = jax.value_and_grad(lambda b: jnp.sum(JT._forest_optical_depth(
        jnp.asarray(lya_1pz), jnp.asarray(zqso_1pz), tau_0, b, L)))(beta)
    lam = TC.LYMAN_WAVELENGTHS_A
    past = (lam[0] * lya_1pz[..., None] / lam[1:L] - 1.0) > zqso_1pz[:, None, None] - 1.0
    assert past.mean() > 0.3
    np.testing.assert_allclose(float(tau.sum()), float(tau_j), rtol=1e-13)
    assert np.isfinite(float(beta_t.grad))
    np.testing.assert_allclose(float(beta_t.grad), float(g_j), rtol=1e-12)


def _training_lists(params, n, model_seed, obs_seed, z_seed, lo, hi, normalize):
    """n spectra drawn from the synthetic model; both packages' lists are
    the port's generator's (bit for bit the reference's)."""
    truth = TSyn.synthetic_learned_model(params, seed=model_seed)
    z = np.random.default_rng(z_seed).uniform(lo, hi, n)
    if normalize:
        return truth, TSyn.synthetic_training_lists(params, truth, z, obs_seed, 0.05), z
    obs = [TSyn.synthetic_observation(params, truth, float(zi), seed=obs_seed + i,
                                      noise_level=0.05) for i, zi in enumerate(z)]
    return truth, tuple(list(x) for x in zip(*obs)), z


def test_initialize_and_prepare_equal_jax():
    """prepare_training_set (a copy) and initialize (host PCA) give JAX's
    arrays on the same lists, and the parameters carry over in its
    field order."""
    params = Parameters(k=5)
    _, lists, z = _training_lists(params, 8, 2, 700, 5, 2.5, 3.6, normalize=True)
    train = TT.prepare_training_set(params, *lists, z)
    jtrain = JT.prepare_training_set(JParameters(k=5), *lists, z)
    for f in jtrain._fields:
        np.testing.assert_array_equal(getattr(train, f), getattr(jtrain, f), err_msg=f)
    mu, p = TT.initialize(params, train, "cpu", F64)
    jmu, jp = JT.initialize(JParameters(k=5), jtrain)
    np.testing.assert_array_equal(mu, jmu)
    for name, got in zip(TT.PARAM_FIELDS, p.numpy()):
        np.testing.assert_array_equal(got, np.asarray(getattr(jp, name)), err_msg=name)
    assert all(getattr(p, n).dtype == F64 and getattr(p, n).device.type == "cpu"
               for n in TT.PARAM_FIELDS)


def test_train_model_recovers_synthetic_gp():
    """Train on spectra drawn from a known GP, on the CPU in float64: the
    objective falls by more than 1 and the learned mean is close to the
    truth (tests/test_training.py's gate)."""
    params = Parameters(k=6)
    truth, lists, z = _training_lists(params, 12, 3, 100, 0, 2.5, 3.6, normalize=True)
    train = TT.prepare_training_set(params, *lists, z)
    assert train.mask.sum() > 1000
    learned, losses = TT.train_model(params, train, num_iterations=30, device="cpu",
                                     dtype=F64)
    assert losses.dtype == np.float64 and losses.shape == (30,)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
    assert learned.M.dtype == F64 and learned.M.device.type == "cpu"
    covered = train.mask.sum(0) >= 8
    truth_mu = truth.mu / np.mean(truth.mu)
    got = learned.mu.numpy()
    got_mu = got / np.mean(got[covered])
    rel = np.abs(got_mu[covered] - truth_mu[covered]) / np.abs(truth_mu[covered])
    assert np.median(rel) < 0.15, np.median(rel)


def _small_train(k=4):
    params = Parameters(k=k)
    _, lists, z = _training_lists(params, 6, 5, 300, 1, 2.6, 3.4, normalize=False)
    return params, TT.prepare_training_set(params, *lists, z)


def test_checkpoints_chunked_and_across_packages(tmp_path):
    """Chunked training with checkpointing gives 10 values, then 5 more
    on resume; a checkpoint written by the JAX package resumes in the port
    (the same npz keys) and the port's in the JAX package."""
    params, train = _small_train()
    ckpt = str(tmp_path / "train.npz")
    _, losses1 = TT.train_model(params, train, num_iterations=10, device="cpu", dtype=F64,
                                checkpoint_path=ckpt, checkpoint_every=5)
    assert losses1.shape == (10,)
    _, losses2 = TT.train_model(params, train, num_iterations=15, device="cpu", dtype=F64,
                                checkpoint_path=ckpt, checkpoint_every=5)
    assert losses2.shape == (5,) and np.isfinite(losses2).all()
    p, mu, step = JT.load_training_checkpoint(ckpt)  # the port's, read by JAX
    assert step == 15 and np.asarray(p.M).shape == (train.flux.shape[1], 4)

    jckpt = str(tmp_path / "jax.npz")
    jmu, jp = JT.initialize(JParameters(k=4), train)
    JT.save_training_checkpoint(jckpt, jp, jmu, 7)
    tp, tmu, tstep = TT.load_training_checkpoint(jckpt, "cpu", F64)
    assert tstep == 7
    np.testing.assert_array_equal(tmu, jmu)
    for name, got in zip(TT.PARAM_FIELDS, tp.numpy()):
        np.testing.assert_array_equal(got, np.asarray(getattr(jp, name)))
    _, losses3 = TT.train_model(params, train, num_iterations=9, device="cpu", dtype=F64,
                                checkpoint_path=jckpt, checkpoint_every=5)
    assert losses3.shape == (2,) and np.isfinite(losses3).all()


def test_callback_schedule_and_early_stop():
    """callback(i, value) at i = 3, 7 of 8 iterations with values synced;
    returning True stops the fit; p0 stays as it was."""
    params, train = _small_train()
    mu, p0 = TT.initialize(params, train, "cpu", F64)
    put = lambda x, dt=F64: torch.as_tensor(np.asarray(x), dtype=dt)
    args = (put(np.where(train.mask, train.flux - mu, 0.0)), put(train.lya_1pz),
            put(train.noise_variance), put(train.mask, torch.bool), put(train.zqso_1pz))
    M0 = p0.M.detach().clone()
    calls = []
    p, values = TT.fit_lbfgs_stepwise(p0, *args, params, 8,
                                      callback=lambda i, v: calls.append((i, v)) or False,
                                      callback_every=4)
    assert [i for i, _ in calls] == [3, 7]
    assert [v for _, v in calls] == [values[3], values[7]]
    assert values.shape == (8,) and values[-1] < values[0]
    assert torch.equal(p0.M.detach(), M0) and not torch.equal(p.M.detach(), M0)
    _, stopped = TT.fit_lbfgs_stepwise(p0, *args, params, 8,
                                       callback=lambda i, v: i >= 5, callback_every=3)
    assert stopped.shape == (6,)
    np.testing.assert_array_equal(stopped, values[:6])
    _, plain = TT.fit_lbfgs(p0, *args, params, 8)
    np.testing.assert_array_equal(plain, values)


def test_train_model_refuses_float64_on_the_card(monkeypatch):
    """float64 on a CUDA device raises before anything is computed, and a
    missing card is not replaced by the CPU."""
    params, train = _small_train()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.train_model(params, train, num_iterations=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(TypeError, match="float32"):
        TT.train_model(params, train, num_iterations=1, device="cuda", dtype=F64)
    with pytest.raises(TypeError):
        TT.train_model(params, train, num_iterations=1, device="cpu", dtype=torch.float16)


def test_fit_line_search_backs_off_from_overshoots_and_non_finite_values():
    """A badly scaled sum of exp(x) - x whose value is NaN where any x
    passes its minimum by 0.5 (as an overflowing exp gives): quasi-Newton
    steps overshoot, and the strong-Wolfe search must backtrack within an
    iteration (torch's own evaluation budget at max_iter=1 leaves it none:
    the fit stalls at 11,324) and take a non-finite trial for no decrease
    (given NaN it extrapolates and fails).  Every value finite, none
    rising, the minimum reached."""
    params = Parameters(k=2)
    fields = (np.full((3, 2), -1.0), np.zeros(3), 0.5, -0.5, 1.0)
    p0 = TT.TrainingParams.from_numpy(fields, "cpu", F64)
    scale = torch.tensor([1e-2] * 6 + [1.0] * 3 + [1e2, 1e4, 3.0], dtype=F64)

    def objective(p, *_):
        x = torch.cat([p.M.reshape(-1), p.log_omega,
                       torch.stack([p.log_c_0, p.log_tau_0, p.log_beta])]) - 2.0
        return torch.where((x > 0.5).any(), torch.nan, torch.sum(scale * (torch.exp(x) - x)))

    _, values = TT.fit_lbfgs_stepwise(p0, None, None, None, None, None, params, 40,
                                      objective=objective)
    assert np.isfinite(values).all()
    assert (np.diff(values) <= 0).all()
    np.testing.assert_allclose(values[-1], float(scale.sum()), rtol=1e-6)
