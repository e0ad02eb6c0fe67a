"""Bayesian model selection across {null, subDLA, DLA(1..k)} models.

Pure-function rewrite of the reference's ``BayesModelSelect``
(reference: gpy_dla_detection/bayesian_model_selection.py:21-149).
Priors are data-driven from the prior catalog; the null prior absorbs
the remaining probability mass.  Works on numpy arrays.

The port's own copy of ``gpy_dla_detection_tpu/models/selection.py``
(numpy only), kept equal to it name for name and number for number so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def log_priors_k_dlas(num_dlas: float, num_quasars: float, max_k: int) -> np.ndarray:
    """log P(k DLAs | zQSO) for k = 1..max_k.

    ``P(at least k | zQSO) = (M/N)^k``;
    ``P(exactly k) = P(>=k) - P(>=k+1)`` except at ``k = max_k``.
    (reference: dla_gp.py:398-426)
    """
    ratio = num_dlas / num_quasars
    p_at_least = ratio ** np.arange(1, max_k + 1, dtype=np.float64)
    p = p_at_least.copy()
    p[:-1] -= p_at_least[1:]
    return np.log(p)


def log_priors_subdla(
    num_dlas: float, num_quasars: float, z_lls: float, z_dla: float, max_k: int = 1
) -> np.ndarray:
    """subDLA prior: the DLA prior rescaled by the partition-function
    ratio Z_lls / Z_dla (reference: subdla_gp.py:311-346)."""
    ratio = num_dlas / num_quasars
    p_at_least = (z_lls / z_dla) * ratio ** np.arange(1, max_k + 1, dtype=np.float64)
    p = p_at_least.copy()
    p[:-1] -= p_at_least[1:]
    return np.log(p)


def _logsumexp(x, axis=None):
    x = np.asarray(x, dtype=np.float64)
    m = np.nanmax(x, axis=axis, keepdims=True)
    out = m.squeeze(axis) if axis is not None else m.reshape(())
    with np.errstate(invalid="ignore"):
        s = np.nansum(np.exp(x - m), axis=axis)
    return out + np.log(s)


class ModelSelectionResult(NamedTuple):
    """Posterior over the model list [null, subDLA, DLA(1..k)]."""

    log_priors: np.ndarray  # (2 + max_k,)
    log_likelihoods: np.ndarray  # (2 + max_k,)
    log_posteriors: np.ndarray  # (2 + max_k,)
    model_posteriors: np.ndarray  # (2 + max_k,) normalized, linear scale
    p_dla: float
    p_no_dla: float


def model_selection(
    log_prior_subdla: np.ndarray,
    log_priors_dla: np.ndarray,
    log_evidence_null: float,
    log_evidences_subdla: np.ndarray,
    log_evidences_dla: np.ndarray,
) -> ModelSelectionResult:
    """Combine priors and evidences into normalized model posteriors.

    The null prior is ``1 - sum(other priors)``
    (reference: bayesian_model_selection.py:75-109).
    """
    log_priors_rest = np.concatenate(
        [np.atleast_1d(log_prior_subdla), np.atleast_1d(log_priors_dla)]
    ).astype(np.float64)
    log_prior_null = np.log(1.0 - np.exp(_logsumexp(log_priors_rest)))
    log_priors = np.concatenate([[log_prior_null], log_priors_rest])

    log_likelihoods = np.concatenate(
        [
            np.atleast_1d(np.float64(log_evidence_null)),
            np.atleast_1d(log_evidences_subdla).astype(np.float64),
            np.atleast_1d(log_evidences_dla).astype(np.float64),
        ]
    )
    log_posteriors = log_likelihoods + log_priors

    max_k = np.atleast_1d(log_evidences_dla).shape[0]
    model_posteriors = np.exp(log_posteriors - _logsumexp(log_posteriors))
    # the normalized posteriors can sum a hair past 1 in floating
    # point; clamp so p_dla is a probability by construction
    p_dla = float(np.clip(np.nansum(model_posteriors[-max_k:]), 0.0, 1.0))

    return ModelSelectionResult(
        log_priors=log_priors,
        log_likelihoods=log_likelihoods,
        log_posteriors=log_posteriors,
        model_posteriors=model_posteriors,
        p_dla=p_dla,
        p_no_dla=1.0 - p_dla,
    )
