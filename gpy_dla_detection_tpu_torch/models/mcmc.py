"""Affine-invariant ensemble MCMC on one device.

Port of ``gpy_dla_detection_tpu/models/mcmc.py``: the Goodman & Weare
(2010) stretch move over a walker ensemble, advanced per step as two
half-updates (each half moves against the other), the replacement for
the reference's emcee (reference: gpy_dla_detection/dla_gp.py:227-309,
civ_gp.py:77-156).  The chain stays on the device of its walkers: the
random draws come from a ``torch.Generator`` on that device, the chain is
written into preallocated tensors, and nothing is read back per step.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch


class StretchDraws(NamedTuple):
    """The random numbers of one half-step."""

    z: torch.Tensor  # (W,) stretch factors, z ~ g(z) on [1/a, a]
    partners: torch.Tensor  # (W,) int64 indices into the passive half
    accept_u: torch.Tensor  # (W,) uniforms of the Metropolis test


def stretch_draws(
    generator: torch.Generator, W: int, n_passive: int, a: float, dtype: torch.dtype
) -> StretchDraws:
    """The three draws of one half-step on the generator's device:
    z ~ g(z) proportional to 1/sqrt(z) on [1/a, a] (by inversion), the
    partner of each walker, and the acceptance uniforms."""
    device = generator.device
    u = torch.rand(W, generator=generator, dtype=dtype, device=device)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partners = torch.randint(0, n_passive, (W,), generator=generator, device=device)
    accept_u = torch.rand(W, generator=generator, dtype=dtype, device=device)
    return StretchDraws(z, partners, accept_u)


def stretch_half(
    active: torch.Tensor,
    passive: torch.Tensor,
    log_prob_active: torch.Tensor,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    draws: StretchDraws,
):
    """One stretch-move update of the active half against the passive
    half, given its draws.

    :return: (new active (W, D), their log probabilities (W,), accepted
        mask (W,)).
    """
    D = active.shape[1]
    z = draws.z
    x_partner = passive.index_select(0, draws.partners)
    proposal = x_partner + z[:, None] * (active - x_partner)

    log_prob_new = log_prob_fn(proposal)
    log_accept = (D - 1.0) * torch.log(z) + log_prob_new - log_prob_active
    accept = torch.log(draws.accept_u) < log_accept

    new_active = torch.where(accept[:, None], proposal, active)
    new_log_prob = torch.where(accept, log_prob_new, log_prob_active)
    return new_active, new_log_prob, accept


def run_ensemble(
    generator: torch.Generator,
    initial_positions: torch.Tensor,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    num_steps: int,
    a: float = 2.0,
):
    """Run the stretch-move ensemble sampler.

    :param generator: drives every draw; on the walkers' device.
    :param initial_positions: (W, D) initial walker positions (W even).
    :param log_prob_fn: ``(W', D) -> (W',)`` log target.
    :param num_steps: chain length.
    :return: (chain (num_steps, W, D), log_probs (num_steps, W),
        acceptance rate as a 0-dim tensor), all on the walkers' device.
    """
    W, D = initial_positions.shape
    if W % 2:
        raise ValueError(f"the number of walkers must be even, got {W}")
    half = W // 2
    dtype, device = initial_positions.dtype, initial_positions.device

    chain = torch.empty((num_steps, W, D), dtype=dtype, device=device)
    log_probs = torch.empty((num_steps, W), dtype=dtype, device=device)
    n_accept = torch.zeros((), dtype=torch.int64, device=device)
    pos = initial_positions
    lp = log_prob_fn(pos)
    for i in range(num_steps):
        first, second = pos[:half], pos[half:]
        lp1, lp2 = lp[:half], lp[half:]
        first, lp1, acc1 = stretch_half(
            first, second, lp1, log_prob_fn,
            stretch_draws(generator, half, half, a, dtype),
        )
        second, lp2, acc2 = stretch_half(
            second, first, lp2, log_prob_fn,
            stretch_draws(generator, half, half, a, dtype),
        )
        pos = torch.cat([first, second])
        lp = torch.cat([lp1, lp2])
        chain[i] = pos
        log_probs[i] = lp
        n_accept += acc1.sum() + acc2.sum()
    return chain, log_probs, n_accept.to(dtype) / (num_steps * W)


def autocorrelation_time(chain_1d, c: float = 5.0) -> float:
    """Integrated autocorrelation time of one scalar chain (Sokal's
    adaptive windowing, as used by emcee's diagnostics); host numpy."""
    if isinstance(chain_1d, torch.Tensor):
        chain_1d = chain_1d.detach().cpu().numpy()
    x = np.asarray(chain_1d, dtype=np.float64)
    x = x - x.mean()
    n = len(x)
    f = np.fft.fft(x, n=2 * n)
    acf = np.fft.ifft(f * np.conj(f))[:n].real
    acf /= acf[0]
    taus = 2.0 * np.cumsum(acf) - 1.0
    window = np.arange(n) < c * taus
    if window.all():
        return float(taus[-1])
    m = np.argmin(window)
    return float(taus[m])
