"""The least time of the CIV doublet search's work on one H100.

The doublet stage (``ops/voigt.voigt_absorption_civ``: the unit optical
depth and K5) is counted by its bytes alone: the (S, P - 6) float32
absorption written once.  Whatever computes it (the plain Faddeeva and K5
today, a fused or windowed kernel later) does at least that, so its share
reads against the same work and stays under 100%.  K2 and K3 are
``harness/counts.py``'s, at the CIV head's N and with no extra profile
streams.
"""

from __future__ import annotations

from harness.counts import HBM_BYTES_PER_S, k2_least_s, k3_least_s


def civ_profile_bytes(S: int, P: int) -> float:
    """Bytes of one doublet stage: the (S, P - 6) float32 absorption."""
    return 4.0 * S * (P - 6)


def civ_profile_least_s(S: int, P: int) -> float:
    return civ_profile_bytes(S, P) / HBM_BYTES_PER_S


def civ_step_least_s(S: int, P: int, N: int, k: int) -> float:
    """Least seconds of one spectrum's step: the doublet stage, K2 over
    the S profiles at N pixels and K3."""
    return civ_profile_least_s(S, P) + k2_least_s(S, N, k, 0) + k3_least_s(S, k)
