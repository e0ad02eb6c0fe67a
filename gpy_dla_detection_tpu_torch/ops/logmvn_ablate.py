"""K7: the stage-by-stage ablation of the Woodbury likelihood (K2 + K3).

Counterpart of ``scripts/kernel_ablate.py``, the JAX package's
instrument for what the likelihood's time is made of, under its stage
names (``scripts/kernel_ablate_torch.py`` times them on the card):

* ``logmvn_ablate`` (``csrc/logmvn_ablate.cu``, counted as
  ``"logmvn_ablate"``): one kernel on K2's tile that stops after the
  elementwise assembly (``elementwise``, ``elementwise_nolog``), after the
  two products (``matmul``) or after the whole Cholesky chain (``full``,
  the fused one-kernel likelihood; ``chain_nodot``, its chain with a wrong
  trailing update on purpose).  Replaces ``make_kernel`` (``:27``).
* ``logmvn_flat_chain`` (the same source, counted as
  ``"logmvn_flat_chain"``): the chain alone on the flat (k^2-wide)
  capacitance, in the row layout (S, k^2) or the transposed (k^2, S) one,
  through strides.  Replaces ``kb`` of ``build_decoupled`` (``:235``) and
  ``kb_row``, ``kb_xt``, ``kb_xt2`` and ``kb_T`` of ``build_chain_only``.
* ``ka`` of ``build_decoupled`` (``:208``) is K2 itself with the flat
  basis (``ops/logmvn_kernels.logmvn_cap``); ``kb_xtp`` (``xtp``,
  ``xtp2c``) is K3 (``logmvn_chain``).

The TPU's precision variants (``matmul_default``, ``matmul_split``,
``full_split``, ``full_split2``, ``full_tri``, ``full_tri_split``,
``full_ilp2``; ``decoupled_tri``; the chain layouts) were Mosaic devices
for one function: on the card each is that function in float32, and the
name maps to it.  Every wrapper launches its kernel on float32 CUDA
tensors and runs its plain twin (``*_reference``) on float32 CPU tensors.
"""

from __future__ import annotations

import torch

from ._build import (
    check_cuda_f32,
    check_launch,
    launch_counts,
    load_library,
    ptr,
    stream_ptr,
    use_kernel,
)
from .logmvn import LOG_2PI
from .logmvn_kernels import assemble_reference, logmvn_cap, logmvn_chain

ELEMENTWISE, ELEMENTWISE_NOLOG, MATMUL, FULL, CHAIN_NODOT = range(5)

# the JAX script's make_kernel stages -> the function each computes; the
# first name of each function is its own, the others its TPU variants
STAGES = {
    "elementwise": ELEMENTWISE,
    "elementwise_nolog": ELEMENTWISE_NOLOG,
    "matmul": MATMUL,
    "matmul_default": MATMUL,
    "matmul_split": MATMUL,
    "full": FULL,
    "full_split": FULL,
    "full_split2": FULL,
    "full_tri": FULL,
    "full_tri_split": FULL,
    "full_ilp2": FULL,
    "chain_nodot": CHAIN_NODOT,
}
# build_chain_only's variants -> the capacitance layout each reads
CHAIN_LAYOUTS = {
    "row": "row", "xt": "row", "xt2": "row",
    "T_full": "transposed", "T_tri": "transposed",
    "xtp": "packed", "xtp2c": "packed",
}


def flat_chain_reference(
    B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor, nodot: bool = False
) -> torch.Tensor:
    """Plain twin of the flat chain, step for step as the JAX script's
    (``kb``, ``:268-291``): A = I + B on (S, k^2), row j of A scaled by
    1/sqrt(A[j, j]) and masked below the pivot is column j of the factor,
    then ``A -= rep * tile`` (``nodot``: ``A -= tile * tile``).

    :param B: (S, k^2) flat capacitance products, without the +I.
    :param u: (S, k).
    :param misc: (S, 2) = (quad0, logdet0 + n log 2 pi).
    :return: (S,) ``-1/2 (quad0 - quad + logdet0 + logdet)``.
    """
    S, k = u.shape
    A = B + torch.eye(k, dtype=B.dtype, device=B.device).reshape(1, k * k)
    lane = torch.arange(k, device=B.device)
    quad = torch.zeros((S,), dtype=B.dtype, device=B.device)
    logdet = torch.zeros_like(quad)
    for j in range(k):
        dj = A[:, j * k + j]
        logdet = logdet + torch.log(dj)
        inv_sqrt = torch.rsqrt(dj)[:, None]
        col = A[:, j * k:(j + 1) * k] * inv_sqrt * (lane >= j).to(B.dtype)
        tj = u[:, j:j + 1] * inv_sqrt
        quad = quad + tj[:, 0] * tj[:, 0]
        u = u - tj * col
        if j < k - 1:
            tile = col.repeat(1, k)  # tile[:, i k + a] = col[:, a]
            if nodot:
                A = A - tile * tile
            else:
                A = A - col.repeat_interleave(k, dim=1) * tile
    return -0.5 * (misc[:, 0] - quad + misc[:, 1] + logdet)


def logmvn_ablate_reference(
    stage: str,
    rows: torch.Tensor,
    M: torch.Tensor,
    Mp: torch.Tensor,
    absorption: torch.Tensor,
) -> torch.Tensor:
    """Plain twin of the stage kernel: what ``make_kernel(stage)``
    writes, per sample.

    :param stage: a name of :data:`STAGES`.
    :param rows: (5, N) rows y, mu, omega2, v, mask.
    :param M: (N, k).
    :param Mp: (N, k^2) flat pair basis (``ops/logmvn.pair_basis``).
    :param absorption: (S, N).
    :return: (S,).
    """
    code = STAGES[stage]
    d_inv, w, r, quad0, logdet0, n = assemble_reference(rows, absorption)
    if code == ELEMENTWISE:
        return quad0 + logdet0 + torch.sum(w + r, dim=1)
    if code == ELEMENTWISE_NOLOG:
        return quad0 + torch.sum(d_inv + w + r, dim=1)
    B = torch.matmul(w, Mp)
    u = torch.matmul(r, M)
    if code == MATMUL:
        return quad0 + logdet0 + torch.sum(B, dim=1) + torch.sum(u, dim=1)
    misc = torch.stack([quad0, logdet0 + n * LOG_2PI], dim=1)
    return flat_chain_reference(B, u, misc, nodot=code == CHAIN_NODOT)


def logmvn_flat_chain_reference(
    B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor, transposed: bool = False
) -> torch.Tensor:
    """Plain twin of :func:`logmvn_flat_chain`."""
    if transposed:
        B, u, misc = B.T, u.T, misc.T
    return flat_chain_reference(B, u, misc)


def logmvn_ablate(
    stage: str,
    rows: torch.Tensor,
    M: torch.Tensor,
    Mp: torch.Tensor,
    absorption: torch.Tensor,
) -> torch.Tensor:
    """One stage of the ablation: the stage kernel on CUDA, its twin on
    the CPU (float32).  Same contract as :func:`logmvn_ablate_reference`."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; choose from {sorted(STAGES)}")
    if not use_kernel(absorption):
        return logmvn_ablate_reference(stage, rows, M, Mp, absorption)
    device = absorption.device
    check_cuda_f32(device, rows=rows, M=M, Mp=Mp, absorption=absorption)
    S, N = absorption.shape
    k = M.shape[1]
    if rows.shape != (5, N) or M.shape != (N, k) or Mp.shape != (N, k * k):
        raise ValueError(
            f"shape mismatch: rows {tuple(rows.shape)}, M {tuple(M.shape)}, "
            f"Mp {tuple(Mp.shape)}, absorption {(S, N)}"
        )
    if S == 0 or N == 0:
        raise ValueError(f"empty problem: S={S}, N={N}")
    ll = torch.empty((S,), dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.logmvn_ablate_launch(
            STAGES[stage], ptr(rows), N, ptr(M), k, ptr(Mp), ptr(absorption), S,
            ptr(ll), stream_ptr(device),
        )
    check_launch("logmvn_ablate", err)
    launch_counts["logmvn_ablate"] += 1
    return ll


def logmvn_flat_chain(
    B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor, transposed: bool = False
) -> torch.Tensor:
    """The chain on the flat capacitance: the strided chain kernel on
    CUDA, its twin on the CPU (float32).

    :param B, u, misc: row layout (S, k^2), (S, k), (S, 2), or with
        ``transposed`` the (k^2, S), (k, S), (2, S) layout, read in place.
    :return: (S,) per-sample log-likelihoods.
    """
    if not use_kernel(B):
        return logmvn_flat_chain_reference(B, u, misc, transposed)
    device = B.device
    check_cuda_f32(device, B=B, u=u, misc=misc)
    sample_dim = 1 if transposed else 0
    S = u.shape[sample_dim]
    k = u.shape[1 - sample_dim]
    want = ((k * k, S), (k, S), (2, S)) if transposed else ((S, k * k), (S, k), (S, 2))
    if (tuple(B.shape), tuple(u.shape), tuple(misc.shape)) != want or S == 0:
        raise ValueError(
            f"shape mismatch: B {tuple(B.shape)}, u {tuple(u.shape)}, "
            f"misc {tuple(misc.shape)}, transposed={transposed}"
        )
    strides = [(t.stride(sample_dim), t.stride(1 - sample_dim)) for t in (B, u, misc)]
    ll = torch.empty((S,), dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.logmvn_flat_chain_launch(
            ptr(B), *strides[0], ptr(u), *strides[1], ptr(misc), *strides[2],
            S, k, ptr(ll), stream_ptr(device),
        )
    check_launch("logmvn_flat_chain", err)
    launch_counts["logmvn_flat_chain"] += 1
    return ll


def logmvn_decoupled(
    rows: torch.Tensor, M: torch.Tensor, Mp: torch.Tensor, absorption: torch.Tensor
) -> torch.Tensor:
    """``build_decoupled``: K2 with the flat basis (its ``ka``), then the
    flat chain in the row layout (its ``kb``).  (S,) log-likelihoods."""
    return logmvn_flat_chain(*logmvn_cap(rows, M, Mp, absorption))


def ablation_chain(
    variant: str, B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor
) -> torch.Tensor:
    """One chain-only variant of ``build_chain_only`` on inputs in its
    layout (:data:`CHAIN_LAYOUTS`): the flat chain for the row and
    transposed layouts, K3 for the packed one."""
    layout = CHAIN_LAYOUTS[variant]
    if layout == "packed":
        return logmvn_chain(B, u, misc)
    return logmvn_flat_chain(B, u, misc, transposed=layout == "transposed")
