"""The CIV doublet search's evidences for one spectrum, in plain PyTorch.

The reference the ``civ.window`` cell holds the program to.  It takes the
raw inputs the benchmark made (the learned GP's arrays, a preprocessed
spectrum, the QMC samples) and works out everything again: the GP
interpolated onto the spectrum (``reference.catalog.spectrum_model``; the
CIV window lies redwards of Lyman alpha, where the mean-flux suppression
is 1), the null evidence, each sample's doublet (the unit optical depth of
the two lines from the Faddeeva function at every pixel with the sample's
own broadening sigma, ``exp(-N tau)``, the 7-tap instrumental
convolution), every sample's Woodbury likelihood, the QMC evidence and the
two models' posteriors.

Departures from the upstream ``civ_gp.py`` (jibanCat/gpy_dla_detection):

* its QMC evidence is a TODO there (``civ_gp.py:248-250``); this follows
  the estimator of the JAX package and the port: the log-mean-exp of the
  per-sample likelihoods with the 1/S Occam factor;
* its covariance has no absorption-noise term (K + V, ``civ_gp.py:158-183``),
  as here (omega^2 = 0);
* the samples' sigma is free per sample (uniform on 1e6-8e6 cm/s, the
  MCMC prior's range, ``civ_gp.py:99-103``) and logN_CIV uniform on
  ``CIVParameters``' 12.88-14.5.

The inputs are taken as the program receives them, in the configuration's
float32 (the spectrum, the GP's arrays, the samples; the redshift samples
computed in float32 from the float32 search range as the program computes
them), so that every gap is the computation's; the CPU tests give float64
inputs to hold the port's float64 path to it.  ``Precision`` says how it
then computes: float64 (the reference) or float32 with its products in
TF32 (the control, ``reference.catalog.CONTROL``).  The TF32 switches of
``torch.backends`` are set off: every product here is in the precision
asked for.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import physics as C
from .catalog import REFERENCE, WEIGHT_NATS, Gaps, Precision, broaden, low_rank_ll, spectrum_model
from .faddeeva import wofz

SPEED_OF_LIGHT_CGS = C.SPEED_OF_LIGHT_CGS
# the CIV doublet (vacuum wavelengths, oscillator strengths, damping constants)
CIV_WAVELENGTHS_CM = np.array([1.5482040e-05, 1.5507810e-05])
CIV_OSC = np.array([0.189900, 0.094750])
CIV_GAMMAS = np.array([2.643e08, 2.628e08])
CIV_WAVELENGTHS_A = CIV_WAVELENGTHS_CM * 1e8
# pi e^2 f lambda / (m_e c) and the Lorentzian half width Gamma lambda / (4 pi)
CIV_LEADING = (np.pi * C.ELECTRON_CHARGE_ESU**2 * CIV_OSC * CIV_WAVELENGTHS_CM
               / (C.ELECTRON_MASS_G * C.SPEED_OF_LIGHT_CGS))
CIV_GAMMA_V = CIV_GAMMAS * CIV_WAVELENGTHS_CM / (4.0 * np.pi)


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def held(x, dtype=np.float32) -> np.ndarray:
    """``x`` as the program holds it: in ``dtype`` (booleans kept)."""
    x = np.asarray(x)
    return x if x.dtype == bool else x.astype(dtype)


def unit_tau(padded: torch.Tensor, z: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(S, P) doublet optical depth per unit column density at each sample's
    redshift ``z`` and broadening ``sigma`` [cm/s]."""
    cdt = torch.complex128 if padded.dtype == torch.float64 else torch.complex64
    inv = 1.0 / (math.sqrt(2.0) * sigma[:, None])
    tau = torch.zeros((z.shape[0], padded.shape[0]), dtype=padded.dtype, device=padded.device)
    for l in range(2):
        lam_c = float(CIV_WAVELENGTHS_A[l]) * (1.0 + z)[:, None]
        x = (padded - lam_c) * (SPEED_OF_LIGHT_CGS / lam_c) * inv
        arg = torch.complex(x, float(CIV_GAMMA_V[l]) * inv.expand_as(x)).to(cdt)
        tau = tau + float(CIV_LEADING[l]) / math.sqrt(math.pi) * inv * wofz(arg).real
    return tau


class Result(NamedTuple):
    null: float
    civ: float
    sample_lls: np.ndarray  # (S,), with the 1/S Occam factor
    log_post: np.ndarray  # (2,): log P(no CIV | D), log P(CIV | D)


def log_posteriors(null: float, civ: float, p_civ_prior: float) -> np.ndarray:
    """The two models' log posteriors, normalized in log space."""
    lp = np.array([null + math.log1p(-p_civ_prior), civ + math.log(p_civ_prior)])
    top = lp.max()
    return lp - (top + math.log(np.sum(np.exp(lp - top))))


def reference_spectrum(learned, spec, samples, cfg: dict, p_civ_prior: float, device,
                       prec: Precision = REFERENCE, chunk: int = 2500,
                       inputs=np.float32) -> Result:
    """The null and CIV evidences of one spectrum, its per-sample
    likelihoods and the two models' log posteriors (see the module's doc).

    :param learned, spec: the benchmark's arrays, rounded to ``inputs`` here.
    :param samples: (offset, log_nciv, nciv, sigma) arrays.
    :param inputs: the dtype the program receives its inputs in.
    """
    tf32_off()
    learned = type(learned)(*[held(a, inputs) for a in learned])
    spec = type(spec)(*[held(a, inputs) for a in spec])
    dt = prec.dtype
    model = spectrum_model(learned, spec, cfg, device, prec)
    d = model.v  # no absorption-noise term
    one = torch.ones_like(model.y)[None]
    null = float(low_rank_ll(model.y, model.mu[None], model.M, d[None], model.mask, one, prec)[0])
    put = lambda x: torch.as_tensor(held(x, inputs), device=device)
    lo, hi = put(spec.min_z_dla), put(spec.max_z_dla)
    z = (lo + (hi - lo) * put(samples[0])).to(dt)
    nciv, sigma = put(samples[2]).to(dt), put(samples[3]).to(dt)
    S, k = z.shape[0], model.M.shape[1]
    pairs = (model.M[:, :, None] * model.M[:, None, :]).reshape(model.M.shape[0], k * k)
    lls = []
    for s in range(0, S, chunk):
        tau = unit_tau(model.padded, z[s:s + chunk], sigma[s:s + chunk])
        a = broaden(torch.exp(-nciv[s:s + chunk, None] * tau))
        a = torch.where(model.mask, a, 1.0)
        lls.append(low_rank_ll(model.y, model.mu * a, model.M, d, model.mask, a, prec, pairs))
    ll = torch.cat(lls) - math.log(S)
    top = torch.max(ll)
    civ = float(top + torch.log(torch.mean(torch.exp(ll - top))))
    return Result(null, civ, ll.cpu().numpy(), log_posteriors(null, civ, p_civ_prior))


def compare(prog: Result, ref: Result) -> dict:
    """The gaps of one spectrum between the program's answers (or the
    control's) and the reference's, by name: the two evidences (null,
    CIV), the two models' normalized log posteriors (log P(CIV | D) alone
    reads ~0 on both sides for every doublet found, and its gap on a clean
    spectrum is the difference of the two evidences' gaps), and the
    per-sample likelihoods within ``WEIGHT_NATS`` of the reference's best."""
    ll = ref.sample_lls
    finite = np.isfinite(ll)
    near = finite & (ll >= (np.nanmax(ll) if finite.any() else 0.0) - WEIGHT_NATS)
    gaps = {"evidence": Gaps().add([prog.null, prog.civ], [ref.null, ref.civ]),
            "posterior": Gaps().add(prog.log_post, ref.log_post),
            "ll": Gaps().add(np.asarray(prog.sample_lls)[near], ll[near])}
    if np.any(np.isfinite(prog.sample_lls) != finite):
        gaps["ll"].top = math.inf
    return gaps
