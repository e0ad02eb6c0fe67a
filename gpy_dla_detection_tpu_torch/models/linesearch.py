"""The strong-Wolfe zoom line search of the port's L-BFGS, with optax's
approximate-Wolfe acceptance and its safe-or-last-step fallback.

The search is torch's cubic-interpolation strong-Wolfe search
(``_strong_wolfe`` and ``_cubic_interpolate`` in ``torch/optim/lbfgs.py``,
PyTorch 2.x, itself ported from torch7's ``optim/lswolfe.lua`` and
``polyinterp.lua``), copied here under PyTorch's BSD-3-Clause license
(Copyright (c) 2016- Facebook, Inc. and its contributors): the installed
torch keeps it private and ``torch.optim.LBFGS`` takes no other search.
Its arithmetic is kept as it was, so where every search succeeds the fit
follows torch's trajectory.  Two changes make it the reference's search
(``optax.lbfgs``'s ``scale_by_zoom_linesearch``, optax 0.2.x,
``optax/_src/linesearch.py``):

* **Acceptance.**  Wherever the search tests sufficient decrease it takes
  optax's ``_decrease_error``: the minimum of Armijo's error and Hager and
  Zhang's approximate-Wolfe error, the larger of ``slope_step - (2 c1 - 1)
  slope_init`` and ``value_step - value_init - approx_dec_rtol
  |value_init|``.  Near a minimum, where a float32 objective can no longer
  resolve Armijo's decrease, a step whose slope has not turned steeply
  uphill and whose value is within the relative tolerance still passes.  A
  NaN anywhere, or a value that is not finite, fails the test.
* **Fallback.**  When the search runs out of evaluations or its bracket
  collapses without meeting the strong-Wolfe conditions, it takes the
  lowest trial that met the decrease test, else the last finite trial, as
  optax's ``_try_safe_step``; torch's search returns the bracket's low
  end there, which is the start (a step of 0) when no trial decreased the
  value, and from then on every L-BFGS step repeats the same search.  Only
  trials that move the parameters count (``is_step``): a collapsed bracket
  ends at steps below the parameters' float32 resolution, whose value is
  the start's, and taking one would repeat the search as a step of 0
  does.  A step of 0 is taken only when no finite trial moved them.
"""

from __future__ import annotations

import math

import torch

# optax.lbfgs's zoom line search: Armijo's c1 (``slope_rtol``), the
# curvature c2 (``curv_rtol``) and the approximate decrease's relative
# tolerance (``approx_dec_rtol``); c1 and c2 are also torch's, as is the
# bracket's least width (``tolerance_change``, in units of max|d|)
C1 = 1e-4
C2 = 0.9
APPROX_DEC_RTOL = 1e-6
TOLERANCE_CHANGE = 1e-9


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """The minimiser of the cubic through two points with their values and
    slopes, clipped to ``bounds`` (torch's, unchanged)."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    # d1 = g1 + g2 - 3 (f1 - f2) / (x1 - x2); d2 = sqrt(d1^2 - g1 g2);
    # min_pos = x2 - (x2 - x1) (g2 + d2 - d1) / (g2 - g1 + 2 d2)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1**2 - g1 * g2
    if d2_square >= 0:
        d2 = d2_square.sqrt()
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def decrease_ok(f, gtd, t, f_new, gtd_new) -> bool:
    """optax's sufficient-decrease test, ``_decrease_error <= 0``:
    Armijo's ``f_new <= f + c1 t gtd`` (evaluated as torch's search
    evaluates it), or the approximate-Wolfe test ``gtd_new <= (2 c1 - 1)
    gtd`` and ``f_new <= f + approx_dec_rtol |f|``.  ``f`` and ``f_new``
    are host floats, ``gtd`` and ``gtd_new`` the slopes along the
    direction at the start and at the trial; any NaN fails, as optax maps
    a NaN error to +inf."""
    if not math.isfinite(f_new) or math.isnan(float(gtd_new)):
        return False
    if not f_new > (f + C1 * t * gtd):
        return True
    approx = float(gtd_new - (2 * C1 - 1.0) * gtd)
    return approx <= 0.0 and f_new - f - APPROX_DEC_RTOL * abs(f) <= 0.0


def strong_wolfe(obj_func, x, t, d, f, g, gtd, max_ls, is_step=None):
    """Torch's strong-Wolfe zoom search along ``d`` from step ``t``, with
    optax's decrease test and fallback (see the module docstring).

    ``obj_func(x, t, d)`` returns the value (a host float) and the flat
    gradient at ``x + t d``; ``f``, ``g`` and ``gtd`` are the value, flat
    gradient and slope at ``x``; ``max_ls`` bounds the evaluations.
    ``is_step(t)`` says whether the step ``t`` changes the parameters
    (default: ``t != 0``); the fallback takes only such steps.

    :return: ``(f_new, g_new, t, evaluations)``: the accepted step's value,
        gradient and length, and the evaluations the search took.
    """
    d_norm = d.abs().max()
    g = g.clone(memory_format=torch.contiguous_format)
    if is_step is None:
        is_step = lambda t_: t_ != 0  # noqa: E731
    # the lowest trial that met the decrease test, and the last finite one,
    # among the trials that moved the parameters
    best = last = None

    def record(t_, f_, g_, gtd_):
        nonlocal best, last
        if math.isfinite(f_) and is_step(t_):
            last = (t_, f_, g_)
            if decrease_ok(f, gtd, t_, f_, gtd_) and (
                    best is None or f_ < best[1]):
                best = (t_, f_, g_)

    # evaluate objective and gradient using initial step
    f_new, g_new = obj_func(x, t, d)
    ls_func_evals = 1
    gtd_new = g_new.dot(d)
    record(t, f_new, g_new, gtd_new)

    # bracket an interval containing a point satisfying the Wolfe criteria
    t_prev, f_prev, g_prev, gtd_prev = 0, f, g, gtd
    done = False
    ls_iter = 0
    while ls_iter < max_ls:
        # check conditions
        if not decrease_ok(f, gtd, t, f_new, gtd_new) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.clone(memory_format=torch.contiguous_format)]
            bracket_gtd = [gtd_prev, gtd_new]
            break

        if abs(gtd_new) <= -C2 * gtd:
            bracket = [t]
            bracket_f = [f_new]
            bracket_g = [g_new]
            done = True
            break

        if gtd_new >= 0:
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.clone(memory_format=torch.contiguous_format)]
            bracket_gtd = [gtd_prev, gtd_new]
            break

        # interpolate
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                               bounds=(min_step, max_step))

        # next step
        t_prev = tmp
        f_prev = f_new
        g_prev = g_new.clone(memory_format=torch.contiguous_format)
        gtd_prev = gtd_new
        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = g_new.dot(d)
        record(t, f_new, g_new, gtd_new)
        ls_iter += 1

    # reached max number of iterations?
    if ls_iter == max_ls:
        bracket = [0, t]
        bracket_f = [f, f_new]
        bracket_g = [g, g_new]

    # zoom phase: we now have a point satisfying the criteria, or a bracket
    # around it; refine the bracket until we find the point
    insuf_progress = False
    # find high and low points in bracket
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
    while not done and ls_iter < max_ls:
        # line-search bracket is so small
        if abs(bracket[1] - bracket[0]) * d_norm < TOLERANCE_CHANGE:
            break

        # compute new trial value
        t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0],
                               bracket[1], bracket_f[1], bracket_gtd[1])

        # test that we are making sufficient progress: if `t` is so close to
        # the boundary, mark insufficient progress, and if we made
        # insufficient progress in the last step too, or `t` is at one of
        # the boundaries, move `t` to 0.1 * len(bracket) away from the
        # nearest boundary point
        eps = 0.1 * (max(bracket) - min(bracket))
        if min(max(bracket) - t, t - min(bracket)) < eps:
            # interpolation close to boundary
            if insuf_progress or t >= max(bracket) or t <= min(bracket):
                # evaluate at 0.1 away from boundary
                if abs(t - max(bracket)) < abs(t - min(bracket)):
                    t = max(bracket) - eps
                else:
                    t = min(bracket) + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False

        # Evaluate new point
        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = g_new.dot(d)
        record(t, f_new, g_new, gtd_new)
        ls_iter += 1

        if not decrease_ok(f, gtd, t, f_new, gtd_new) or f_new >= bracket_f[low_pos]:
            # no sufficient decrease, or not lower than lowest point
            bracket[high_pos] = t
            bracket_f[high_pos] = f_new
            bracket_g[high_pos] = g_new.clone(memory_format=torch.contiguous_format)
            bracket_gtd[high_pos] = gtd_new
            low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] else (1, 0)
        else:
            if abs(gtd_new) <= -C2 * gtd:
                # Wolfe conditions satisfied
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                # old high becomes new low
                bracket[high_pos] = bracket[low_pos]
                bracket_f[high_pos] = bracket_f[low_pos]
                bracket_g[high_pos] = bracket_g[low_pos]
                bracket_gtd[high_pos] = bracket_gtd[low_pos]

            # new point becomes new low
            bracket[low_pos] = t
            bracket_f[low_pos] = f_new
            bracket_g[low_pos] = g_new.clone(memory_format=torch.contiguous_format)
            bracket_gtd[low_pos] = gtd_new

    if done:
        return bracket_f[low_pos], bracket_g[low_pos], bracket[low_pos], ls_func_evals
    # the search failed: optax's safe step, else its last step
    fallback = best if best is not None else last
    if fallback is None:  # no finite trial moved the parameters: stay
        return f, g, 0, ls_func_evals
    t, f_new, g_new = fallback
    return f_new, g_new, t, ls_func_evals
