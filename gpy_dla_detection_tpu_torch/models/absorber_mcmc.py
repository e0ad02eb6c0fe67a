"""MCMC parameter estimation for DLA and CIV absorbers.

Port of ``gpy_dla_detection_tpu/models/absorber_mcmc.py``: batched
log-posterior functions over absorber parameters and the ensemble
sampler of ``models/mcmc.py`` (the reference's emcee-based
``DLAGP.run_mcmc`` / ``CIVGP.run_mcmc``; reference:
gpy_dla_detection/dla_gp.py:227-309, log_posterior_mcmc.py:17-96,
civ_gp.py:77-156, civ_log_posterior_mcmc.py:14-102).

Every posterior evaluation computes the walkers' exact unit optical
depths in PyTorch and their broadened profiles with K5
(``ops/voigt_kernels.absorption_tail``) on float32, then one batched
low-rank Woodbury log density per walker.  The chain runs on the device
of the ``SpectrumModel`` it is given.
"""

from __future__ import annotations

import math

import torch

from ..data.samples import _FIT_UPPER, GARNETT_FIT, LogNHIFit, _gaussian_fit_integral
from ..ops.logmvn import log_mvnpdf_low_rank
from ..ops.voigt import voigt_absorption, voigt_absorption_civ
from ..params import Parameters
from .learned import SpectrumModel
from .mcmc import run_ensemble


def log_nhi_mixture_pdf(
    log_nhi: torch.Tensor, params: Parameters, fit: LogNHIFit = GARNETT_FIT
) -> torch.Tensor:
    """The normalized logNHI prior density, the same mixture the QMC
    samples are drawn from (``data.samples.log_nhi_mixture_pdf``;
    reference: dla_samples.py:106-131)."""
    Z = float(_gaussian_fit_integral(params.fit_min_log_nhi, _FIT_UPPER, fit))
    fit_pdf = torch.exp(-fit.A * log_nhi**2 + fit.B * log_nhi + fit.C) / Z
    width = params.uniform_max_log_nhi - params.uniform_min_log_nhi
    # the indicator in the density's dtype (a where over two Python
    # scalars would round 1/width to the default float32)
    uniform = (
        (log_nhi >= params.uniform_min_log_nhi) & (log_nhi <= params.uniform_max_log_nhi)
    ).to(log_nhi.dtype) * (1.0 / width)
    return params.alpha * fit_pdf + (1.0 - params.alpha) * uniform


def make_dla_log_posterior(model: SpectrumModel, params: Parameters, k_dlas: int = 1):
    """Batched log posterior over theta = [z_1..z_k, logNHI_1..logNHI_k].

    Uniform prior on z in the spectrum's search range, the Garnett
    mixture prior on logNHI (reference: log_posterior_mcmc.py:17-96).

    :return: function (W, 2k) -> (W,), -inf out of bounds.
    """

    def log_prob(theta: torch.Tensor) -> torch.Tensor:
        z = theta[:, :k_dlas]
        log_nhi = theta[:, k_dlas:]
        in_bounds = torch.all(
            (z > model.min_z_dla)
            & (z < model.max_z_dla)
            & (log_nhi > params.uniform_min_log_nhi)
            & (log_nhi < params.uniform_max_log_nhi),
            dim=1,
        )
        lp = torch.sum(torch.log(log_nhi_mixture_pdf(log_nhi, params)), dim=1)
        absorption = torch.prod(
            voigt_absorption(
                model.padded_wavelengths, 10.0**log_nhi, z, params.num_lines
            ),
            dim=1,
        )  # (W, N)
        ll = log_mvnpdf_low_rank(
            model.y,
            model.mu * absorption,
            model.M * absorption[..., None],
            model.omega2 * absorption**2 + model.v,
            model.mask,
        )
        return torch.where(in_bounds, lp + ll, -math.inf)

    return log_prob


def run_dla_mcmc(
    model: SpectrumModel,
    params: Parameters,
    generator: torch.Generator,
    k_dlas: int = 1,
    nwalkers: int = 32,
    nsamples: int = 5000,
    initial_positions: torch.Tensor | None = None,
):
    """Sample the k-DLA posterior (reference: dla_gp.py:227-309).

    :param generator: drives the initial positions and the chain; on the
        model's device.
    :return: (chain (nsamples, W, 2k), log_probs (nsamples, W),
        acceptance rate), on the model's device.
    """
    dtype, device = model.y.dtype, model.y.device
    if initial_positions is None:
        rand = lambda: torch.rand(
            (nwalkers, k_dlas), generator=generator, dtype=dtype, device=device
        )
        z0 = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * rand()
        n0 = params.fit_min_log_nhi + 2.0 * rand()
        initial_positions = torch.cat([z0, n0], dim=1)
    log_prob_fn = make_dla_log_posterior(model, params, k_dlas)
    return run_ensemble(generator, initial_positions, log_prob_fn, nsamples)


def make_civ_log_posterior(
    model: SpectrumModel,
    params: Parameters,
    k_civ: int = 1,
    min_log_nciv: float = 12.88,
    max_log_nciv: float = 20.0,
    min_sigma: float = 1e6,
    max_sigma: float = 8e6,
):
    """Batched log posterior over theta = [z, logN, sigma] * k for CIV
    doublets; uniform priors, covariance without the absorption-noise
    term (reference: civ_gp.py:77-156, civ_log_posterior_mcmc.py:14-102).

    :return: function (W, 3k) -> (W,), -inf out of bounds.
    """

    def log_prob(theta: torch.Tensor) -> torch.Tensor:
        z = theta[:, 0::3]
        log_n = theta[:, 1::3]
        sigma = theta[:, 2::3]
        in_bounds = torch.all(
            (z > model.min_z_dla)
            & (z < model.max_z_dla)
            & (log_n > min_log_nciv)
            & (log_n < max_log_nciv)
            & (sigma > min_sigma)
            & (sigma < max_sigma),
            dim=1,
        )
        absorption = torch.prod(
            voigt_absorption_civ(model.padded_wavelengths, 10.0**log_n, z, sigma, 2),
            dim=1,
        )
        ll = log_mvnpdf_low_rank(
            model.y,
            model.mu * absorption,
            model.M * absorption[..., None],
            model.v,
            model.mask,
        )
        return torch.where(in_bounds, ll, -math.inf)

    return log_prob


def run_civ_mcmc(
    model: SpectrumModel,
    params: Parameters,
    generator: torch.Generator,
    k_civ: int = 1,
    nwalkers: int = 40,
    nsamples: int = 5000,
    min_log_nciv: float = 12.88,
    max_log_nciv: float = 20.0,
    min_sigma: float = 1e6,
    max_sigma: float = 8e6,
):
    """Sample the CIV posterior (reference: civ_gp.py:77-156).

    :param generator: on the model's device.
    :return: (chain (nsamples, W, 3k), log_probs (nsamples, W),
        acceptance rate), on the model's device.
    """
    dtype, device = model.y.dtype, model.y.device
    rand = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (nwalkers, k_civ), generator=generator, dtype=dtype, device=device
    )
    z0 = rand(model.min_z_dla, model.max_z_dla)
    n0 = rand(min_log_nciv, max_log_nciv)
    s0 = rand(min_sigma, max_sigma)
    pos = torch.stack([z0, n0, s0], dim=2).reshape(nwalkers, 3 * k_civ)
    log_prob_fn = make_civ_log_posterior(
        model, params, k_civ, min_log_nciv, max_log_nciv, min_sigma, max_sigma
    )
    return run_ensemble(generator, pos, log_prob_fn, nsamples)
