"""K7: the stage-by-stage ablation of the Woodbury likelihood (K2 + K3).

Counterpart of ``scripts/kernel_ablate.py``, the JAX package's
instrument for what the likelihood's time is made of, under its stage
names (``scripts/kernel_ablate_torch.py`` times them on the card):

* ``logmvn_ablate`` (``csrc/logmvn_ablate.cu``, counted as
  ``"logmvn_ablate"``): K2's block (``csrc/logmvn_cap_block.cuh``) at K2's
  geometry for the packed basis (:func:`stage_geometry`), stopping after
  the elementwise assembly (``elementwise``, ``elementwise_nolog``), after
  the two products (``matmul``) or after K3's warp chain on them
  (``full``, the fused one-kernel likelihood; ``chain_nodot``, its chain
  with a wrong trailing update on purpose).  Replaces ``make_kernel``
  (``:27``).  The functions are those of the flat basis ``Mp`` the
  contract takes; the wrapper gathers its packed columns (the matrix is
  symmetric) into the packed basis K2 reads, one ``index_select`` a call
  by an index kept on the card.
  :func:`logmvn_ablate_packed` takes the packed basis itself: the stage
  kernel alone, which is what the timings time.
* ``logmvn_flat_chain`` (the same source, counted as
  ``"logmvn_flat_chain"``): K3's warp chain alone on the flat (k^2-wide)
  capacitance, in the row layout (S, k^2) or the transposed (k^2, S) one,
  through strides (:func:`~.logmvn_kernels.flat_chain_geometry`).
  Replaces ``kb`` of ``build_decoupled`` (``:235``) and ``kb_row``,
  ``kb_xt``, ``kb_xt2`` and ``kb_T`` of ``build_chain_only``.
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

import functools

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
from .logmvn_kernels import (
    CHAIN_MAX_K,
    CHAIN_ROW_BOUNDS,
    H100_SMS,
    CapGeometry,
    _sm_count,
    assemble_reference,
    cap_geometry,
    flat_chain_geometry,
    logmvn_cap,
    logmvn_chain,
    packed_flat_columns,
)

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

# full and chain_nodot run K3's warp chain, whose row bounds end at 64
STAGE_MAX_K = CHAIN_MAX_K


def stage_geometry(S: int, N: int, k: int, stage: int, sms: int = H100_SMS) -> CapGeometry:
    """The stage kernel's launch: K2's geometry for the packed basis,
    ``cap_geometry(S, N, k, k(k+1)/2)``, at every stage, so the stages
    differ in work and not in occupancy.  ``full`` and ``chain_nodot``
    also need their samples' triangles, u and misc (and the chain's row
    bound of padding) within the block's shared bytes.  Anything else
    raises ``ValueError``."""
    if not 1 <= k <= STAGE_MAX_K:
        raise ValueError(f"the stage kernel takes 1 <= k <= {STAGE_MAX_K}, got k={k}")
    kp = k * (k + 1) // 2
    g = cap_geometry(S, N, k, kp, 0, sms)
    if stage in (FULL, CHAIN_NODOT):
        rows = next(b for b in CHAIN_ROW_BOUNDS if k <= b)
        if 4 * (g.samples * (kp + k + 2) + rows) > g.shared_bytes:
            raise ValueError(f"K2's block cannot hold the chain's buffers at k={k}")
    return g


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


@functools.lru_cache(maxsize=None)
def _packed_index(k: int, device: torch.device) -> torch.Tensor:
    """:func:`~.logmvn_kernels.packed_flat_columns` on ``device``."""
    return torch.as_tensor(packed_flat_columns(k), device=device)


def logmvn_ablate(
    stage: str,
    rows: torch.Tensor,
    M: torch.Tensor,
    Mp: torch.Tensor,
    absorption: torch.Tensor,
) -> torch.Tensor:
    """One stage of the ablation: the stage kernel on CUDA, its twin on
    the CPU (float32).  Same contract as :func:`logmvn_ablate_reference`;
    on the card the k that :func:`stage_geometry` takes, the packed
    columns of ``Mp`` gathered first."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; choose from {sorted(STAGES)}")
    if not use_kernel(absorption):
        return logmvn_ablate_reference(stage, rows, M, Mp, absorption)
    k = M.shape[1]
    if Mp.shape != (M.shape[0], k * k):
        raise ValueError(f"shape mismatch: M {tuple(M.shape)}, Mp {tuple(Mp.shape)}")
    return logmvn_ablate_packed(stage, rows, M, Mp.index_select(1, _packed_index(k, Mp.device)),
                                absorption)


def logmvn_ablate_packed(
    stage: str,
    rows: torch.Tensor,
    M: torch.Tensor,
    Mp_packed: torch.Tensor,
    absorption: torch.Tensor,
) -> torch.Tensor:
    """:func:`logmvn_ablate` on the packed pair basis (N, k(k+1)/2)
    (``logmvn_kernels.packed_pair_basis``, the flat basis's columns
    :func:`~.logmvn_kernels.packed_flat_columns`): the stage kernel on
    CUDA, the twin on the flat basis the packed one holds on the CPU."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; choose from {sorted(STAGES)}")
    S, N = absorption.shape
    k = M.shape[1]
    if rows.shape != (5, N) or M.shape != (N, k) or Mp_packed.shape != (N, k * (k + 1) // 2):
        raise ValueError(
            f"shape mismatch: rows {tuple(rows.shape)}, M {tuple(M.shape)}, "
            f"Mp_packed {tuple(Mp_packed.shape)}, absorption {(S, N)}"
        )
    if not use_kernel(absorption):
        # flat column j k + a, and a k + j, hold packed column (j, a >= j)
        flat = torch.empty(k * k, dtype=torch.int64)
        for r, c in enumerate(packed_flat_columns(k)):
            flat[c] = flat[(c % k) * k + c // k] = r
        return logmvn_ablate_reference(stage, rows, M, Mp_packed[:, flat], absorption)
    device = absorption.device
    check_cuda_f32(device, rows=rows, M=M, Mp_packed=Mp_packed, absorption=absorption)
    if S == 0 or N == 0:
        raise ValueError(f"empty problem: S={S}, N={N}")
    code = STAGES[stage]
    g = stage_geometry(S, N, k, code, _sm_count(device))
    ll = torch.empty((S,), dtype=torch.float32, device=device)
    lib = load_library("ablate")
    with torch.cuda.device(device):
        err = lib.logmvn_ablate_launch(
            code, ptr(rows), N, ptr(M), k, ptr(Mp_packed), ptr(absorption), S,
            g.samples, g.pixels, g.threads, g.shared_bytes, g.grid,
            ptr(ll), stream_ptr(device),
        )
    check_launch("logmvn_ablate", err)
    launch_counts["logmvn_ablate"] += 1
    return ll


def logmvn_flat_chain(
    B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor, transposed: bool = False
) -> torch.Tensor:
    """The chain on the flat capacitance: the strided chain kernel on
    CUDA (1 <= k <= 64), its twin on the CPU (float32).

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
    g = flat_chain_geometry(S, k, _sm_count(device))
    ll = torch.empty((S,), dtype=torch.float32, device=device)
    lib = load_library("ablate")
    with torch.cuda.device(device):
        err = lib.logmvn_flat_chain_launch(
            ptr(B), *strides[0], ptr(u), *strides[1], ptr(misc), *strides[2],
            S, k, g.rows, g.warps, g.blocks_per_sm, g.chunk, g.shared_bytes, g.grid,
            ptr(ll), stream_ptr(device),
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
