"""The port's L-BFGS (``models/training.fit_lbfgs_stepwise`` over
``models/linesearch.strong_wolfe``) on the CPU:

* **the stall**: a float32 objective with a constant offset of -4e7 (the
  size of the reference-scale training loss) and a known minimiser.  Near
  the minimiser the offset's rounding hides the decrease Armijo's test asks
  for; torch's strong-Wolfe search then returns a step of 0, its memory
  never changes, and every later iteration repeats the search.  The port's
  search accepts optax's approximate-Wolfe decrease: the parameters move in
  every iteration until the gradient is small, and the fit ends at the
  minimiser;
* **the reference's outcome**: on a small float64 training problem the
  port's fit and the JAX package's optax fit, each run to convergence, end
  within rtol 1e-8 of each other in the objective;
* **unchanged where the search succeeds**: where every strong-Wolfe search
  meets its conditions, the iterates and values are
  ``torch.optim.LBFGS``'s at ``max_iter=1`` bit for bit (the recursion and
  search keep torch's operation order; carrying the accepted trial's value
  and gradient skips a re-evaluation that gives the same bits on the CPU);
* the decrease test itself against optax's ``_decrease_error`` formula.
"""

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.models import training as JT
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch.models import linesearch as LS
from gpy_dla_detection_tpu_torch.models import training as TT
from gpy_dla_detection_tpu_torch.params import Parameters

from .test_torch_training import _batch, _jax, _port, _small_train

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


def _flat(p):
    return torch.cat([p.M.reshape(-1), p.log_omega,
                      torch.stack([p.log_c_0, p.log_tau_0, p.log_beta])])


def _offset_quadratic(R=64, k=2, seed=0):
    """sum_i (c + a_i (x_i - x*_i)^2) in float32, the constants c summing to
    -4e7 and the curvatures a_i spread over 1 to 1e3; the start x* + N(0, 1)."""
    rng = np.random.default_rng(seed)
    D = R * k + R + 3
    x_star = rng.normal(size=D)
    a = 10 ** rng.uniform(0, 3, size=D)
    c = np.full(D, -4e7 / D)
    xs, at, ct = (torch.tensor(v, dtype=F32) for v in (x_star, a, c))
    seen = {}

    def objective(p, *_):
        seen["p"] = p
        return torch.sum(ct + at * (_flat(p) - xs) ** 2)

    x0 = x_star + rng.normal(size=D)
    fields = (x0[:R * k].reshape(R, k), x0[R * k:R * k + R], x0[-3], x0[-2], x0[-1])
    return (TT.TrainingParams.from_numpy(fields, "cpu", F32), objective, seen,
            Parameters(k=k), x_star, a)


def test_fit_moves_at_the_float32_floor_and_reaches_the_minimiser():
    """Every one of 200 iterations moves the parameters unless the gradient
    at its start is within 1e-5 of the starting gradient's max (the floor:
    the float32 iterate's resolution times the largest curvature), and the
    fit ends within 1e-3 of the minimiser (torch's search stalls ~2 away)."""
    p0, objective, seen, params, x_star, a = _offset_quadratic()
    iterates = []
    _, values = TT.fit_lbfgs_stepwise(
        p0, None, None, None, None, None, params, 200, objective=objective,
        callback=lambda i, v: iterates.append(_flat(seen["p"]).detach().clone()) and False,
        callback_every=1)
    starts = [_flat(p0).detach()] + iterates[:-1]  # the iterate each iteration starts from
    grad = lambda x: np.abs(2 * a * (x.double().numpy() - x_star)).max()
    g0 = grad(starts[0])
    still = [i for i in range(len(iterates))
             if torch.equal(iterates[i], starts[i]) and grad(starts[i]) > 1e-5 * g0]
    assert still == [], f"no move at iterations {still[:5]} with a gradient of " \
                        f"{[grad(starts[i]) / g0 for i in still[:5]]} of the start's"
    assert np.isfinite(values).all() and values[-1] < values[0]
    np.testing.assert_allclose(iterates[-1].double().numpy(), x_star, rtol=0, atol=1e-3)


def test_fit_ends_where_the_jax_packages_optax_fit_ends():
    """The training objective on 40 spectra of 12 pixels, k = 1, float64:
    160 iterations of each package's ``fit_lbfgs_stepwise`` converge (the
    last 10 values within 1e-10 of each other, relatively; both are there by
    iteration ~150), and the two end within rtol 1e-8 in the objective.  Their paths differ where optax's
    search differs from the strong-Wolfe search."""
    fields, arrays = _batch(Q=40, R=12, k=1)
    p0, targs = _port(fields, arrays)
    jp0, jargs = _jax(fields, arrays)
    _, got = TT.fit_lbfgs_stepwise(p0, *targs, Parameters(k=1), 160)
    _, want = JT.fit_lbfgs_stepwise(jp0, *jargs, JParameters(k=1), 160)
    for v in (got, want):
        assert np.isfinite(v).all()
        assert np.ptp(v[-10:]) <= 1e-10 * abs(v[-1])
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-8)


def _torch_lbfgs_fit(p0, objective, data, params, iters):
    """The fit as torch.optim.LBFGS runs it (strong-Wolfe, max_iter=1,
    twenty line-search evaluations, memory 10): the witness of what the
    port's L-BFGS keeps where every search succeeds."""
    import copy

    p = copy.deepcopy(p0)
    opt = torch.optim.LBFGS(p.parameters(), lr=1.0, max_iter=1, max_eval=1 + TT.LINE_SEARCH_STEPS,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = objective(p, *data, params)
        loss.backward()
        for q in p.parameters():
            q.grad = q.grad.contiguous()
        return loss.detach()

    values = [opt.step(closure).detach() for _ in range(iters)]
    return p, torch.stack(values).cpu().double().numpy()


def _exp_objective():
    """A badly scaled sum of exp(x) - x, as in
    ``test_fit_line_search_backs_off_from_overshoots_and_non_finite_values``
    but finite everywhere."""
    scale = torch.tensor([1e-2] * 6 + [1.0] * 3 + [1e2, 1e4, 3.0], dtype=F64)
    fields = (np.full((3, 2), -1.0), np.zeros(3), 0.5, -0.5, 1.0)

    def objective(p, *_):
        x = _flat(p) - 2.0
        return torch.sum(scale * (torch.exp(x) - x))

    return TT.TrainingParams.from_numpy(fields, "cpu", F64), objective, (None,) * 5, \
        Parameters(k=2), 40


def _training_case(dtype):
    params, train = _small_train()
    mu, p0 = TT.initialize(params, train, "cpu", dtype)
    put = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt)
    data = (put(np.where(train.mask, train.flux - mu, 0.0)), put(train.lya_1pz),
            put(train.noise_variance), put(train.mask, torch.bool), put(train.zqso_1pz))
    return p0, TT.total_objective, data, params, 30


@pytest.mark.parametrize("case", ["training_float64", "training_float32", "exp_float64"])
def test_trajectory_is_torch_lbfgs_where_every_search_succeeds(case, monkeypatch):
    """Every search of these fits meets the strong-Wolfe conditions with
    Armijo's test (none takes the approximate test or the fallback), and
    the port's values and final parameters equal torch.optim.LBFGS's bit
    for bit."""
    p0, objective, data, params, iters = {
        "training_float64": lambda: _training_case(F64),
        "training_float32": lambda: _training_case(F32),
        "exp_float64": _exp_objective,
    }[case]()
    approx_only = []
    decrease_ok = LS.decrease_ok

    def watched(f, gtd, t, f_new, gtd_new):
        ok = decrease_ok(f, gtd, t, f_new, gtd_new)
        if ok and f_new > f + LS.C1 * t * gtd:
            approx_only.append(t)
        return ok

    monkeypatch.setattr(LS, "decrease_ok", watched)
    p_got, got = TT.fit_lbfgs_stepwise(p0, *data, params, iters, objective=objective)
    p_want, want = _torch_lbfgs_fit(p0, objective, data, params, iters)
    assert approx_only == []
    np.testing.assert_array_equal(got, want)
    for a, b in zip(p_got.numpy(), p_want.numpy()):
        np.testing.assert_array_equal(a, b)


def test_decrease_test_is_optaxs():
    """``decrease_ok`` is ``_decrease_error <= 0`` of optax's zoom search
    (c1 = 1e-4, approx_dec_rtol = 1e-6) on values and slopes around a
    large value, where Armijo's test and the approximate test disagree."""
    def optax_error(f, gtd, t, f_new, gtd_new):
        armijo = f_new - f - LS.C1 * t * gtd
        approx = np.maximum(gtd_new - (2 * LS.C1 - 1.0) * gtd,
                            f_new - f - LS.APPROX_DEC_RTOL * abs(f))
        err = np.maximum(np.minimum(armijo, approx), 0.0)  # NaN propagates, as in jnp
        return np.inf if np.isnan(err) else err

    f, gtd = -4.2e7, -10.0
    cases = [(1.0, f - 1.0, -1.0),  # Armijo holds
             (1.0, f + 4.0, 2.0),  # within 42 of f, slope not steeply up: approximate
             (1.0, f + 4.0, 12.0),  # slope up past |gtd|: neither
             (1.0, f + 50.0, 2.0),  # past the relative tolerance: neither
             (0.5, f - 0.0004, -9.0),  # too little decrease, approximate holds
             (1.0, float("inf"), float("nan")), (1.0, f - 1.0, float("nan"))]
    for t, f_new, gtd_new in cases:
        want = optax_error(f, gtd, t, f_new, gtd_new) <= 0.0
        got = LS.decrease_ok(f, torch.tensor(gtd, dtype=F64), t, f_new,
                             torch.tensor(gtd_new, dtype=F64))
        assert got == want, (t, f_new, gtd_new)
    assert [LS.C1, LS.C2, LS.APPROX_DEC_RTOL] == [1e-4, 0.9, 1e-6]


def test_search_falls_back_to_the_lowest_decrease_then_the_last_finite_trial():
    """Along a line where no trial meets the curvature condition within the
    budget, the search returns the lowest trial that met the decrease test;
    where none did, the last finite trial; a step of 0 only when no trial
    was finite."""
    d = torch.tensor([1.0], dtype=F64)
    x = [torch.zeros(1, dtype=F64)]

    def search(phi, max_ls=3):
        """phi(t) -> (value, slope) along d from 0."""
        calls = []

        def obj_func(x_, t, d_):
            calls.append(float(t))
            v, s = phi(float(t))
            return v, torch.tensor([s], dtype=F64)

        f, s0 = phi(0.0)
        out = LS.strong_wolfe(obj_func, x, 1.0, d, f, torch.tensor([s0], dtype=F64),
                              torch.tensor(s0, dtype=F64), max_ls)
        return out, calls

    # a steep descent that never flattens: every trial decreases (Armijo)
    # but the slope stays below -c2 |slope0|; the lowest is the last
    (f_new, _, t, n), calls = search(lambda t: (-10.0 * t - t * t, -10.0 - 2 * t))
    assert n == len(calls) == 4 and t == calls[-1] and f_new == -10.0 * t - t * t
    # every trial rises far above the start: no decrease, the last finite trial
    (f_new, _, t, n), calls = search(lambda t: (0.0, -1.0) if t == 0.0 else (100.0 + t, 1.0))
    assert n == len(calls) and t == calls[-1] and t != 0 and f_new == 100.0 + t
    # nothing finite: stay at the start
    (f_new, _, t, n), calls = search(lambda t: (0.0, -1.0) if t == 0.0 else (np.inf, np.nan))
    assert t == 0 and f_new == 0.0 and n == len(calls) == 4
