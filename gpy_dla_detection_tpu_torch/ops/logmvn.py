"""Low-rank multivariate-normal log density (Woodbury identity).

Port of ``gpy_dla_detection_tpu/ops/logmvn.py``:

    log N(y; mu, M M^T + diag(d))

in O(n k^2) through the rank-k capacitance matrix ``I + M^T D^-1 M``,
masked (invalid pixels enter with ``1/d = 0``) and batched over the
absorption profiles of the QMC samples.

``batched_log_mvnpdf`` picks the implementation from its inputs and
``use_kernels`` (the reference's ``use_pallas``): float32 runs the
two-stage kernels K2 and K3 (``ops/logmvn_kernels.py``; on the CPU their
plain twins) at any GP basis width, and, on CPU tensors with
``use_kernels=False``, the plain composition below (the reference's XLA
path); float64 runs the plain composition, the conformance path, on the
CPU only.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch

from .kernel_config import ABS_I16_SCALE

LOG_2PI = 1.8378770664093453


def _masked_inputs(y, mu, d, mask):
    delta = torch.where(mask, y - mu, 0.0)
    d_safe = torch.where(mask, d, 1.0)
    d_inv = torch.where(mask, 1.0 / d_safe, 0.0)
    log_d = torch.where(mask, torch.log(d_safe), 0.0)
    return delta, d_inv, log_d


def log_mvnpdf_low_rank(y, mu, M, d, mask=None):
    """log N(y; mu, M M^T + diag(d)) over valid pixels, batched over any
    leading axes (the MCMC head passes one row per walker, as the
    reference ``vmap``s ``log_mvnpdf_low_rank``).

    The Cholesky factor is taken without an error check, so nothing is
    read back to the host; a capacitance that is not positive definite
    gives NaN, as in the reference.

    :param y, mu, d: (..., N), broadcast against each other.
    :param M: (..., N, k).
    :param mask: (..., N) bool, True = valid pixel; None = all valid.
    :return: (...,) log density.
    """
    if mask is None:
        mask = torch.ones(y.shape, dtype=torch.bool, device=y.device)
    delta, d_inv, log_d = _masked_inputs(y, mu, d, mask)
    k = M.shape[-1]
    D_inv_M = M * d_inv[..., None]
    B = torch.eye(k, dtype=y.dtype, device=y.device) + torch.einsum(
        "...ni,...nj->...ij", M, D_inv_M
    )
    L, info = torch.linalg.cholesky_ex(B)
    u = torch.einsum("...ni,...n->...i", M, d_inv * delta)
    t = torch.linalg.solve_triangular(L, u[..., None], upper=False)[..., 0]
    quad = torch.sum(delta * delta * d_inv, dim=-1) - torch.sum(t * t, dim=-1)
    log_det = torch.sum(log_d, dim=-1) + 2.0 * torch.sum(
        torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1
    )
    n = torch.sum(mask, dim=-1).to(y.dtype)
    return torch.where(info == 0, -0.5 * (quad + log_det + n * LOG_2PI), math.nan)


def log_mvnpdf_iid(y, mu, d, mask=None):
    """log N(y; mu, diag(d)) over valid pixels."""
    if mask is None:
        mask = torch.ones(y.shape, dtype=torch.bool, device=y.device)
    delta, d_inv, log_d = _masked_inputs(y, mu, d, mask)
    quad = torch.sum(delta * delta * d_inv, dim=-1)
    n = torch.sum(mask, dim=-1).to(y.dtype)
    return -0.5 * (quad + torch.sum(log_d, dim=-1) + n * LOG_2PI)


def pair_basis(M: torch.Tensor) -> torch.Tensor:
    """Flat outer-product basis ``P[n, i*k + j] = M[n, i] M[n, j]``."""
    N, k = M.shape
    return (M[:, :, None] * M[:, None, :]).reshape(N, k * k)


def likelihood_pair_basis(M: torch.Tensor) -> torch.Tensor:
    """The pair basis in the layout :func:`batched_log_mvnpdf` takes for
    ``M``'s dtype: the packed lower triangle (N, k(k+1)/2) for the float32
    kernels, the flat (N, k^2) basis for the float64 composition."""
    if M.dtype == torch.float32:
        from .logmvn_kernels import packed_pair_basis

        return packed_pair_basis(M)
    return pair_basis(M)


def batched_quad_logdet(B: torch.Tensor, u: torch.Tensor):
    """(u^T B^-1 u, log det B) for a batch of small SPD matrices: an
    unrolled Cholesky with the forward substitution fused in.

    :param B: (S, k, k) SPD.
    :param u: (S, k).
    :return: (quad (S,), logdet (S,)).
    """
    S, k, _ = B.shape
    A = B
    quad = torch.zeros((S,), dtype=B.dtype, device=B.device)
    logdet = torch.zeros((S,), dtype=B.dtype, device=B.device)
    row_idx = torch.arange(k, device=B.device)
    for j in range(k):
        dj = A[:, j, j]
        logdet = logdet + torch.log(dj)
        inv_sqrt = torch.rsqrt(dj)
        col = A[:, :, j] * inv_sqrt[:, None]
        col = torch.where(row_idx >= j, col, 0.0)
        tj = u[:, j] * inv_sqrt
        quad = quad + tj * tj
        u = u - tj[:, None] * col
        if j < k - 1:
            A = A - col[:, :, None] * col[:, None, :]
    return quad, logdet


def decode_profile_store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Stored profiles as ``dtype``: int16 codes times ``1 / ABS_I16_SCALE``
    (a product with the reciprocal, never a division), any float cast; the
    reference's ``_decode`` (``gpy_dla_detection_tpu/ops/logmvn.py``) and
    the plain version of K2's decode."""
    if x.dtype == torch.int16:
        return x.to(dtype) * (1.0 / ABS_I16_SCALE)
    return x.to(dtype)


def _batched_log_mvnpdf_plain(y, mu, M, omega2, v, mask, absorption, M_pair, extra):
    """The plain composition (the reference's XLA path), on profiles
    decoded to ``y``'s dtype."""
    k = M.shape[-1]
    absorption = decode_profile_store(absorption, y.dtype)
    for e in extra:
        absorption = absorption * decode_profile_store(e, y.dtype)
    a = torch.where(mask, absorption, 1.0)
    d = omega2 * a * a + v
    d_safe = torch.where(mask, d, 1.0)
    d_inv = torch.where(mask, 1.0 / d_safe, 0.0)
    delta = torch.where(mask, y - mu * a, 0.0)

    w = a * a * d_inv
    B = torch.eye(k, dtype=y.dtype, device=y.device) + torch.matmul(
        w, M_pair
    ).reshape(-1, k, k)
    r = a * delta * d_inv
    u = torch.matmul(r, M)
    corr, log_det_B = batched_quad_logdet(B, u)

    quad = torch.sum(delta * delta * d_inv, dim=-1) - corr
    log_det = (
        torch.sum(torch.where(mask, torch.log(d_safe), 0.0), dim=-1) + log_det_B
    )
    n = torch.sum(mask).to(y.dtype)
    return -0.5 * (quad + log_det + n * LOG_2PI)


def batched_log_mvnpdf(
    y, mu, M, omega2, v, mask, absorption, M_pair=None,
    extra: Sequence[torch.Tensor] = (),
    use_kernels: bool | None = None,
):
    """log N(y; mu a_s, (M a_s)(M a_s)^T + diag(omega2 a_s^2 + v)) for a
    batch of absorption profiles ``a_s = absorption[s] * prod(extra)[s]``.

    :param y, mu, omega2, v: (N,) spectrum-level arrays.
    :param M: (N, k).
    :param mask: (N,) bool.
    :param absorption: (S, N) absorption profiles, in ``y``'s float dtype
        or as int16 codes (``ops/kernel_config.py``), decoded on entry.
    :param M_pair: optional :func:`likelihood_pair_basis` of ``M``.
    :param extra: chained-absorber profile rows, each (S, N) and stored as
        ``absorption`` is, multiplied into the absorption (inside K2 on the
        float32 path, which also decodes them).
    :param use_kernels: float32 route: None or True takes K2 then K3 (the
        CUDA kernels at any k, or on the CPU their twins); False the plain
        composition, on CPU tensors only (on the card the likelihood runs
        the kernels, and False raises ``ValueError``).  Each float32
        composition adds one to ``launch_counts["logmvn_composition"]``.
        float64 is always the composition, and refuses True.
    :return: (S,) log densities.
    """
    if M_pair is None:
        M_pair = likelihood_pair_basis(M)
    if y.dtype == torch.float64:
        if y.device.type != "cpu" or use_kernels:
            raise TypeError(
                "the float64 likelihood is the CPU conformance path; the "
                "CUDA kernels take float32"
            )
        return _batched_log_mvnpdf_plain(
            y, mu, M, omega2, v, mask, absorption, M_pair, extra
        )
    from ._build import launch_counts
    from .logmvn_kernels import logmvn_cap, logmvn_chain

    if use_kernels is False:
        if y.device.type != "cpu":
            raise ValueError(
                "the plain composition is the CPU path; on the card the "
                "likelihood runs K2 and K3"
            )
        k = M.shape[-1]
        if k > 1 and M_pair.shape[-1] == k * (k + 1) // 2:
            # a packed basis reached the composition: rebuild the flat
            # layout, as the reference does
            M_pair = pair_basis(M)
        launch_counts["logmvn_composition"] += 1
        return _batched_log_mvnpdf_plain(
            y, mu, M, omega2, v, mask, absorption, M_pair, extra
        )
    rows = torch.stack([y, mu, omega2, v, mask.to(y.dtype)])
    B, u, misc = logmvn_cap(rows, M, M_pair, absorption, extra)
    return logmvn_chain(B, u, misc)
