"""Null-model GP training: learn (mu, M, log omega, c0, tau0, beta).

Port of ``gpy_dla_detection_tpu/models/training.py`` (the reference's
MATLAB training: learn_qso_model_meanflux.m:1-184, objective_lyseries.m,
spectrum_loss_lyseries.m):

* training spectra are interpolated once onto the shared rest grid on the
  host (:func:`prepare_training_set`, a copy of the reference's numpy),
  giving a fixed-shape (Q, R) flux matrix with a validity mask;
* every per-spectrum loss is a masked Woodbury log density: the packed
  capacitance matrices come from one (Q, R) x (R, k(k+1)/2) product, and
  the Q small Cholesky factorizations run on K3 with its adjoint kernel as
  the backward (``ops/logmvn_kernels.chain_loglik``); the five gradient
  blocks come from ``torch.autograd``;
* L-BFGS is ``torch.optim.LBFGS`` with a strong-Wolfe line search, one
  iteration a step (the reference uses optax's L-BFGS, whose zoom line
  search differs, so trajectories are not compared).

Everything runs on the card unless the caller asks for the CPU; float64 is
the CPU's conformance path and raises on the card.
"""

from __future__ import annotations

import copy
import os
from collections.abc import Iterable
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import constants as C
from ..ops.logmvn import LOG_2PI
from ..ops.logmvn_kernels import chain_loglik, packed_pair_basis
from ..params import Parameters
from .learned import LearnedModel

PARAM_FIELDS = ("M", "log_omega", "log_c_0", "log_tau_0", "log_beta")
# evaluations the line search may take an iteration, as optax's zoom search
# (``max_linesearch_steps``); torch.optim.LBFGS's own budget at max_iter=1
# (max_eval = 1, the iteration's first evaluation) would leave it none
LINE_SEARCH_STEPS = 20


class TrainingSet(NamedTuple):
    """Fixed-shape training data on the shared rest-wavelength grid."""

    rest_wavelengths: np.ndarray  # (R,)
    flux: np.ndarray  # (Q, R) mean-flux-lifted, centered later
    noise_variance: np.ndarray  # (Q, R) lifted variance
    mask: np.ndarray  # (Q, R) valid pixels
    lya_1pz: np.ndarray  # (Q, R) (1 + z_lya) per pixel
    zqso_1pz: np.ndarray  # (Q,) 1 + z_qso


class TrainingParams(nn.Module):
    """The optimized variables as parameters: ``M`` (R, k), ``log_omega``
    (R,) and the scalars ``log_c_0``, ``log_tau_0``, ``log_beta``."""

    def __init__(self, *tensors: torch.Tensor):
        super().__init__()
        if len(tensors) != len(PARAM_FIELDS):
            raise ValueError(f"expected {len(PARAM_FIELDS)} tensors, got {len(tensors)}")
        for name, value in zip(PARAM_FIELDS, tensors):
            setattr(self, name, nn.Parameter(value))

    @classmethod
    def from_numpy(
        cls, fields: Iterable, device="cuda", dtype: torch.dtype = torch.float32
    ) -> "TrainingParams":
        """The weight carry-over: the reference's ``TrainingParams`` fields
        as numpy arrays, in its field order, moved to ``device`` in
        ``dtype`` (the card in float32 by default), as copies: a fit
        updates its parameters in place."""
        return cls(*[torch.tensor(np.asarray(f), dtype=dtype, device=device) for f in fields])

    def numpy(self) -> tuple[np.ndarray, ...]:
        """Copies of the fields as float64 numpy arrays, in the reference's
        order."""
        return tuple(getattr(self, n).detach().to("cpu", torch.float64, copy=True).numpy()
                     for n in PARAM_FIELDS)


def _mean_flux_suppression_np(obs_wl, beta, tau_0, z_qso, num_forest_lines):
    """Host-numpy twin of ``ops.optical_depth.mean_flux_suppression`` for
    the one-time training-set preparation (a copy of the reference's)."""
    lam = np.asarray(C.LYMAN_WAVELENGTHS_A[:num_forest_lines], np.float64)
    osc = np.asarray(C.LYMAN_OSCILLATOR_STRENGTHS[:num_forest_lines], np.float64)
    one_plus_z = obs_wl[..., None] / lam  # (..., P, L)
    scale = tau_0 * osc / osc[0] * lam / lam[0]
    tau = scale * one_plus_z**beta * (one_plus_z - 1.0 <= z_qso)
    return np.exp(-np.sum(tau, axis=-1))


def prepare_training_set(
    params: Parameters,
    wavelengths_list,
    flux_list,
    noise_variance_list,
    pixel_mask_list,
    z_qsos,
) -> TrainingSet:
    """Interpolate observed spectra onto the rest grid and lift the
    Kim et al. mean flux (reference: learn_qso_model_meanflux.m:42-126).
    Host-side, runs once; a copy of the reference's."""
    rest_grid = np.arange(
        params.min_lambda, params.max_lambda + params.dlambda / 2, params.dlambda
    )
    R = rest_grid.shape[0]
    Q = len(wavelengths_list)

    flux_out = np.zeros((Q, R))
    var_out = np.ones((Q, R))
    mask_out = np.zeros((Q, R), dtype=bool)
    lya_1pz = np.ones((Q, R))

    for i in range(Q):
        wl = np.asarray(wavelengths_list[i], np.float64)
        fx = np.asarray(flux_list[i], np.float64)
        nv = np.asarray(noise_variance_list[i], np.float64)
        pm = np.asarray(pixel_mask_list[i], bool)
        z = float(z_qsos[i])

        rest = wl / (1.0 + z)
        good = (~pm) & np.isfinite(fx) & np.isfinite(nv)
        if not np.any(good):
            # one unusable spectrum contributes an all-masked row
            continue

        # linear interpolation onto the rest grid; grid points outside
        # the observed range or straddling bad pixels are masked
        f = np.interp(rest_grid, rest[good], fx[good], left=np.nan, right=np.nan)
        v = np.interp(rest_grid, rest[good], nv[good], left=np.nan, right=np.nan)
        in_range = (rest_grid >= rest[good].min()) & (rest_grid <= rest[good].max())
        ok = in_range & np.isfinite(f) & np.isfinite(v) & (v <= params.max_noise_variance)

        obs_wl = rest_grid * (1.0 + z)
        one_pz = obs_wl / C.LYA_WAVELENGTH_A  # 1 + z_lya per pixel

        # lift the mean-flux suppression over the full Lyman series, as
        # build_spectrum_model applies it at inference time
        a = _mean_flux_suppression_np(
            obs_wl, params.prev_beta, params.prev_tau_0, z,
            params.num_forest_lines,
        )

        flux_out[i, ok] = f[ok] / a[ok]
        var_out[i, ok] = v[ok] / a[ok] ** 2
        mask_out[i] = ok
        lya_1pz[i] = one_pz

    return TrainingSet(
        rest_wavelengths=rest_grid,
        flux=flux_out,
        noise_variance=var_out,
        mask=mask_out,
        lya_1pz=lya_1pz,
        zqso_1pz=1.0 + np.asarray(z_qsos, np.float64),
    )


def initialize(
    params: Parameters, train: TrainingSet, device="cuda", dtype: torch.dtype = torch.float32
) -> tuple[np.ndarray, TrainingParams]:
    """Empirical mean + PCA initialization
    (reference: learn_qso_model_meanflux.m:130-160), on the host.

    Rest-grid columns never observed by ANY training spectrum get finite
    placeholders (mu = 1, omega at the 1e-3 floor): their loss contribution
    is masked out, but a NaN parameter would poison L-BFGS's inner products
    and silently NaN the whole fit (np.maximum(nan, 1e-3) is nan).

    :return: (mu as a float64 numpy array, the parameters on ``device`` in
        ``dtype``).
    """
    counts = train.mask.sum(axis=0)
    safe = np.maximum(counts, 1)
    filled_flux = np.where(train.mask, train.flux, 0.0)
    mu = filled_flux.sum(axis=0) / safe
    mu = np.where(counts > 0, mu, 1.0)
    centered = np.where(train.mask, train.flux - mu, 0.0)

    # top-k principal components scaled by sqrt(eigenvalue)
    _, s, vt = np.linalg.svd(centered, full_matrices=False)
    Q = train.flux.shape[0]
    M0 = (vt[: params.k].T * (s[: params.k] / np.sqrt(Q)))

    var = (centered**2).sum(axis=0) / safe
    log_omega0 = np.log(np.maximum(np.sqrt(var), 1e-3))
    return mu, TrainingParams.from_numpy(
        (M0, log_omega0, np.log(params.initial_c_0), np.log(params.initial_tau_0),
         np.log(params.initial_beta)), device, dtype)


def _forest_optical_depth(lya_1pz, zqso_1pz, tau_0, beta, num_forest_lines: int):
    """Approximate Lyman-series optical depth from the Lya pixel redshifts
    via the oscillator-strength scaling relationship
    (reference: spectrum_loss_lyseries.m:22-44).

    A line past the quasar contributes 0, as the reference's ``(lyman_1pz *
    indicator) ** beta`` does; the power is taken on a base of 1 there, so
    its gradient in beta is 0 and not 0 * log(0)."""
    lam = [float(x) for x in C.LYMAN_WAVELENGTHS_A[:num_forest_lines]]
    osc = [float(x) for x in C.LYMAN_OSCILLATOR_STRENGTHS[:num_forest_lines]]
    tau_total = tau_0 * lya_1pz**beta
    for i in range(1, num_forest_lines):
        lyman_1pz = lam[0] * lya_1pz / lam[i]
        indicator = lyman_1pz - 1.0 <= zqso_1pz[..., None] - 1.0
        powered = torch.where(indicator, torch.where(indicator, lyman_1pz, 1.0) ** beta, 0.0)
        scale = tau_0 * lam[i] * osc[i] / (lam[0] * osc[0])
        tau_total = tau_total + scale * powered
    return tau_total


def _noise_variance(p: TrainingParams, lya_1pz, noise_variance, zqso_1pz,
                    num_forest_lines: int):
    """d = v + omega^2 (1 - exp(-tau) + c0)^2 over the rest grid."""
    omega2 = torch.exp(2.0 * p.log_omega)
    c_0 = torch.exp(p.log_c_0)
    tau_0 = torch.exp(p.log_tau_0)
    beta = torch.exp(p.log_beta)
    tau = _forest_optical_depth(lya_1pz, zqso_1pz, tau_0, beta, num_forest_lines)
    scaling = 1.0 - torch.exp(-tau) + c_0
    return noise_variance + omega2 * scaling**2


def spectrum_loss(
    y, lya_1pz, noise_variance, mask, zqso_1pz, p: TrainingParams,
    num_forest_lines: int,
):
    """Negative log likelihood of one centered spectrum:
        -log N(y; 0, MM' + diag(v + omega2 (1 - exp(-tau) + c0)^2))
    (reference: spectrum_loss_lyseries.m:14-69), by the library Cholesky
    and triangular solve: the per-spectrum reference the batched losses
    are held to.  Masked pixels drop out."""
    d = _noise_variance(p, lya_1pz, noise_variance, zqso_1pz, num_forest_lines)

    delta = torch.where(mask, y, 0.0)
    d_safe = torch.where(mask, d, 1.0)
    d_inv = torch.where(mask, 1.0 / d_safe, 0.0)

    k = p.M.shape[-1]
    D_inv_M = p.M * d_inv[..., None]
    B = torch.eye(k, dtype=y.dtype, device=y.device) + p.M.T @ D_inv_M
    L = torch.linalg.cholesky(B)
    u = p.M.T @ (d_inv * delta)
    t = torch.linalg.solve_triangular(L, u[:, None], upper=False)[:, 0]

    quad = torch.sum(delta * delta * d_inv) - torch.sum(t * t)
    log_det = torch.sum(torch.where(mask, torch.log(d_safe), 0.0)) + 2.0 * torch.sum(
        torch.log(torch.diagonal(L))
    )
    n = torch.sum(mask).to(y.dtype)
    return 0.5 * (quad + log_det + n * LOG_2PI)


def woodbury_inputs(
    p: TrainingParams, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz,
    num_forest_lines: int,
):
    """The per-spectrum inputs of K3's function: the packed (Q,
    k(k+1)/2) capacitances B (without the +I) from one (Q, R) x (R,
    k(k+1)/2) product against the packed lower-triangle pair basis of M, u
    from one (Q, R) x (R, k) product (``torch.matmul``; float32 on the card
    in full float32, TF32 off, as JAX's HIGHEST precision), and misc = (sum
    delta^2 d^-1, sum log d + n log 2 pi) over each spectrum's valid
    pixels."""
    d = _noise_variance(p, lya_1pz, noise_variance, zqso_1pz, num_forest_lines)  # (Q, R)

    delta = torch.where(mask, flux_centered, 0.0)
    d_safe = torch.where(mask, d, 1.0)
    d_inv = torch.where(mask, 1.0 / d_safe, 0.0)

    B = torch.matmul(d_inv, packed_pair_basis(p.M))  # (Q, k(k+1)/2)
    u = torch.matmul(d_inv * delta, p.M)  # (Q, k)
    n = torch.sum(mask, dim=-1).to(d.dtype)
    misc = torch.stack([
        torch.sum(delta * delta * d_inv, dim=-1),
        torch.sum(torch.where(mask, torch.log(d_safe), 0.0), dim=-1) + n * LOG_2PI,
    ], dim=1)
    return B, u, misc


def batched_spectrum_losses(
    p: TrainingParams, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz,
    num_forest_lines: int,
):
    """All per-spectrum negative log likelihoods as one batched
    computation: ``-chain_loglik`` of :func:`woodbury_inputs`, K3 forward
    and its adjoint kernel backward on the card, their plain twins on CPU
    tensors in the tensors' dtype.  Mathematically identical to
    :func:`spectrum_loss` on each spectrum.

    :return: (Q,) losses.
    """
    return -chain_loglik(*woodbury_inputs(p, flux_centered, lya_1pz, noise_variance, mask,
                                          zqso_1pz, num_forest_lines))


def total_objective(
    p: TrainingParams,
    flux_centered,
    lya_1pz,
    noise_variance,
    mask,
    zqso_1pz,
    params: Parameters,
):
    """Sum of per-spectrum losses plus the Gaussian priors on tau_0 and
    beta (reference: objective_lyseries.m:42-76)."""
    losses = batched_spectrum_losses(
        p, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz,
        params.num_forest_lines,
    )
    return torch.sum(losses) + kim_priors(p)


def kim_priors(p: TrainingParams):
    """The Kim et al. (2007) Gaussian priors on tau_0 and beta
    (reference: objective_lyseries.m:64-76)."""
    tau_0_mu, tau_0_sigma = 0.0023, 0.0007
    beta_mu, beta_sigma = 3.65, 0.21
    tau_0 = torch.exp(p.log_tau_0)
    beta = torch.exp(p.log_beta)
    return (0.5 * ((tau_0 - tau_0_mu) / tau_0_sigma) ** 2
            + 0.5 * ((beta - beta_mu) / beta_sigma) ** 2)


def fit_lbfgs_stepwise(
    p0: TrainingParams,
    flux_centered,
    lya_1pz,
    noise_variance,
    mask,
    zqso_1pz,
    params: Parameters,
    num_iterations: int = 200,
    objective=None,
    callback=None,
    callback_every: int = 50,
):
    """L-BFGS maximum-likelihood fit, one iteration a step (reference:
    minFunc's per-iteration loop, learn_qso_model.m:100-123):
    ``torch.optim.LBFGS`` with optax's memory of 10 and a strong-Wolfe line
    search of up to ``LINE_SEARCH_STEPS`` evaluations, ``max_iter=1``, one
    ``step`` an iteration.  A trial point whose objective is not finite
    counts as +inf, so the line search backs off from it, as optax's zoom
    search does.  ``p0`` is left as it is; the fit runs on a copy.

    ``objective`` overrides the loss (the signature of
    :func:`total_objective`); ``callback(i, value)`` is invoked every
    ``callback_every`` iterations, and returning True stops early.

    :return: ``(p_final, values)``, ``values`` the objective at the start
        of each iteration as a host float64 array.
    """
    obj = total_objective if objective is None else objective
    p = copy.deepcopy(p0)
    data = (flux_centered, lya_1pz, noise_variance, mask, zqso_1pz)
    opt = torch.optim.LBFGS(p.parameters(), lr=1.0, max_iter=1, max_eval=1 + LINE_SEARCH_STEPS,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = obj(p, *data, params)
        loss.backward()
        for q in p.parameters():  # LBFGS flattens each gradient by view
            q.grad = q.grad.contiguous()
        if not torch.isfinite(loss):  # LBFGS reads every value on the host
            # a trial point whose objective is not finite (an exp
            # overflowed): +inf is no decrease, and a NaN slope sends the
            # search's cubic step to bisection (given the NaN value, torch's
            # strong-Wolfe search would extrapolate; given +inf with a
            # finite slope, its cubic step is NaN)
            for q in p.parameters():
                q.grad.fill_(torch.nan)
            return torch.full_like(loss.detach(), torch.inf)
        return loss.detach()

    values = []
    for i in range(num_iterations):
        values.append(opt.step(closure).detach())
        if callback is not None and (i + 1) % callback_every == 0:
            if callback(i, float(values[-1])):
                break
    if not values:
        return p, np.zeros(0)
    return p, torch.stack(values).cpu().double().numpy()


def fit_lbfgs(
    p0: TrainingParams,
    flux_centered,
    lya_1pz,
    noise_variance,
    mask,
    zqso_1pz,
    params: Parameters,
    num_iterations: int = 200,
    objective=None,
):
    """L-BFGS maximum-likelihood fit (reference: minFunc L-BFGS,
    learn_qso_model_meanflux.m:161-162): :func:`fit_lbfgs_stepwise`
    without a callback (the reference's whole-scan variant is a JAX
    compilation choice; PyTorch runs eagerly)."""
    return fit_lbfgs_stepwise(p0, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz,
                              params, num_iterations, objective)


def save_training_checkpoint(path: str, p: TrainingParams, mu, step: int) -> None:
    """Step-granular training checkpoint, in the reference's npz keys, so
    a checkpoint written by either package resumes in the other."""
    np.savez(
        path,
        step=step,
        mu=np.asarray(mu),
        **dict(zip(PARAM_FIELDS, p.numpy())),
    )


def load_training_checkpoint(path: str, device="cuda", dtype: torch.dtype = torch.float32):
    """:return: (TrainingParams on ``device`` in ``dtype``, mu, step)"""
    with np.load(path) as f:
        p = TrainingParams.from_numpy([f[name] for name in PARAM_FIELDS], device, dtype)
        return p, f["mu"], int(f["step"])


def training_device(device, dtype: torch.dtype) -> torch.device:
    """The device of a fit: the card takes float32 only (K3 and its
    adjoint), and is not replaced by the CPU when it is missing."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); "
                               "pass device='cpu' to train on the CPU")
        if dtype != torch.float32:
            raise TypeError(f"training on the card runs float32, not {dtype}; float64 is "
                            "the CPU's (device='cpu')")
    elif dtype not in (torch.float32, torch.float64):
        raise TypeError(f"training runs float32 or float64, not {dtype}")
    return device


def train_model(
    params: Parameters,
    train: TrainingSet,
    num_iterations: int = 200,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
) -> tuple[LearnedModel, np.ndarray]:
    """Full training: init, optimize, package as a LearnedModel (on
    ``device`` in ``dtype``).

    With ``checkpoint_path`` + ``checkpoint_every``, optimization runs in
    chunks, persists the parameters after each chunk, and resumes from an
    existing checkpoint file (the reference's npz layout).

    :return: (learned_model, loss_history as a float64 numpy array)
    """
    device = training_device(device, dtype)
    start_step = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        p0, mu, start_step = load_training_checkpoint(checkpoint_path, device, dtype)
        print(f"[train] resuming from {checkpoint_path} at step {start_step}")
    else:
        mu, p0 = initialize(params, train, device, dtype)

    put = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    args = (
        put(np.where(train.mask, train.flux - mu, 0.0)),
        put(train.lya_1pz),
        put(train.noise_variance),
        put(train.mask, torch.bool),
        put(train.zqso_1pz),
    )

    if checkpoint_path and checkpoint_every:
        values_all = []
        p_final = p0
        step = start_step
        while step < num_iterations:
            chunk = min(checkpoint_every, num_iterations - step)
            p_final, values = fit_lbfgs(p_final, *args, params, chunk)
            values_all.append(values)
            step += chunk
            save_training_checkpoint(checkpoint_path, p_final, mu, step)
        values = np.concatenate(values_all) if values_all else np.zeros(0)
    else:
        p_final, values = fit_lbfgs(p0, *args, params, num_iterations)

    M, log_omega, log_c_0, log_tau_0, log_beta = p_final.numpy()
    learned = LearnedModel.from_numpy(
        (train.rest_wavelengths, mu, M, log_omega, log_c_0, log_tau_0, log_beta,
         np.float64(params.prev_tau_0), np.float64(params.prev_beta)),
        device, dtype,
    )
    return learned, values
