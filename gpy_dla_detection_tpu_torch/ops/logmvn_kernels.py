"""K2 and K3: the two-stage batched Woodbury log-likelihood.

Stage A (K2, ``logmvn_cap``, ``csrc/logmvn_cap.cu``) assembles the noise
model per sample and forms the packed capacitance products; stage B (K3,
``logmvn_chain``, ``csrc/logmvn_chain.cu``) runs the k x k Cholesky with
the forward substitution and emits the per-sample log-likelihood.  Each
wrapper launches its kernel on float32 CUDA tensors and runs its plain
twin (``*_reference``) on float32 CPU tensors.  Both take a GP basis of
any width: K2 runs a basis wider than its block holds on its wide kernel
(``csrc/logmvn_cap_wide.cu``, the tensor cores in 3xTF32;
:func:`k2_geometry`), and K3 runs the k > 64 its warp chain's row bounds
end at on its wide chain, a warp a sample too (counted as
``logmvn_chain_wide``; :func:`k3_geometry`).  K2 also takes the
profiles as int16 codes (``ops/kernel_config.py``), which an
instantiation of its own decodes as it assembles (counted as
``logmvn_cap_i16``); its twin decodes with
``ops/logmvn.decode_profile_store``.

The zQSO exact scan's in-window inputs to K3 (``zqso_cap``,
``csrc/zqso_cap.cu``) come from the learned table and the padded spectrum
in one kernel that interpolates the GP basis in registers: the JAX package
forms that basis, (C, P, k), in plain XLA, so this kernel has no TPU
counterpart either.

K3's adjoint (``logmvn_chain_grad``, ``csrc/logmvn_chain_grad.cu``) is the
backward of :func:`chain_loglik`, the ``torch.autograd.Function`` that the
GP training differentiates (``models/training.py``): the JAX package
differentiates its unrolled chain by autodiff, so this kernel has no TPU
counterpart.

Replaces ``gpy_dla_detection_tpu/ops/logmvn_pallas.py``:
``_make_cap_kernel`` (K2) and ``_make_chain_kernel_tp2c`` (K3).
"""

from __future__ import annotations

import functools
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from ._build import (
    MAX_DYNAMIC_SHARED_BYTES,
    check_cuda_f32,
    check_launch,
    check_store_dtype,
    launch_counts,
    load_library,
    ptr,
    store_name,
    stream_ptr,
    use_kernel,
)
from .logmvn import LOG_2PI, batched_quad_logdet, decode_profile_store

MAX_EXTRA_STREAMS = 3  # streams K2 multiplies in; more are folded first

# K2's block (csrc/logmvn_cap.cu): a thread owns an 8-sample x 8-column
# register tile, a warp 2 sample groups x 16 column groups
CAP_TILE = 8
CAP_WARP_SAMPLES = 2 * CAP_TILE
CAP_WARP_COLUMNS = 16 * CAP_TILE
CAP_MAX_THREADS = 384  # 168 registers a thread
H100_SMS = 132


class CapGeometry(NamedTuple):
    """K2's launch: ``samples`` a block, ``pixels`` a chunk, ``threads``
    a block (whole warps), ``columns`` (both products, padded to whole
    warps), ``shared_bytes`` a block and ``grid`` blocks."""

    samples: int
    pixels: int
    threads: int
    columns: int
    shared_bytes: int
    grid: int


def _cap_shared_bytes(ts: int, tn: int, ncp: int, n_extra: int, elem: int = 4) -> int:
    """Double-buffered sample streams (rows of tn + 8 elements of ``elem``
    bytes: 4 float32, 2 int16 codes), M_pair | M chunk, and w | r tile
    (rows of ts + 4 floats)."""
    return elem * 2 * (1 + n_extra) * ts * (tn + 8) + 4 * (2 * tn * ncp + 4 * tn * (ts + 4))


def _cap_fits(ts: int, tn: int, k: int, kp: int, n_extra: int, elem: int) -> bool:
    """Whether K2's block of ``ts`` samples and ``tn``-pixel chunks holds a
    GP basis of k columns and a pair basis of kp: its threads and its
    shared memory."""
    groups = -(-kp // CAP_TILE) + -(-k // CAP_TILE)
    ncp = CAP_WARP_COLUMNS * -(-groups * CAP_TILE // CAP_WARP_COLUMNS)
    return (32 * (ncp // CAP_WARP_COLUMNS) * ts // CAP_WARP_SAMPLES <= CAP_MAX_THREADS
            and _cap_shared_bytes(ts, tn, ncp, n_extra, elem) <= MAX_DYNAMIC_SHARED_BYTES)


def _cap_chunk(N: int, k: int, kp: int, n_extra: int = 0, elem: int = 4) -> int | None:
    """K2's pixel chunk: 32 wide, 16 where N <= 16 or 32 does not fit in
    shared memory; None where the block cannot hold the basis at all."""
    return next((tn for tn in ((16,) if N <= 16 else (32, 16))
                 if _cap_fits(CAP_WARP_SAMPLES, tn, k, kp, n_extra, elem)), None)


def _padded_columns(k: int, kp: int) -> int:
    groups = -(-kp // CAP_TILE) + -(-k // CAP_TILE)
    return CAP_WARP_COLUMNS * -(-groups * CAP_TILE // CAP_WARP_COLUMNS)


def cap_geometry(S: int, N: int, k: int, kp: int, n_extra: int = 0,
                 sms: int = H100_SMS, elem: int = 4) -> CapGeometry:
    """K2's launch geometry for S samples, N pixels, a GP basis of k
    columns, a pair basis of kp and sample streams of ``elem`` bytes an
    element (4 float32, 2 int16 codes), where one block holds every
    column: the fewest waves over ``sms`` blocks at once, each wave as
    even as the block allows.  Pixel chunks are 32 wide, 16 where N <= 16
    or 32 does not fit in shared memory.  Raises ``ValueError`` where the
    block cannot hold the bases (:func:`wide_cap_geometry` can)."""
    ncp = _padded_columns(k, kp)
    warps_across = ncp // CAP_WARP_COLUMNS

    def threads_of(ts):
        return 32 * warps_across * ts // CAP_WARP_SAMPLES

    def fits(ts, tn):
        return _cap_fits(ts, tn, k, kp, n_extra, elem)

    tn = _cap_chunk(N, k, kp, n_extra, elem)
    if tn is None:
        raise ValueError(f"K2's block cannot hold k={k}, basis width {kp}")
    waves = 1
    while True:
        per_block = -(-S // (sms * waves))
        ts = CAP_WARP_SAMPLES * -(-per_block // CAP_WARP_SAMPLES)
        if fits(ts, tn):
            break
        waves += 1
    return CapGeometry(
        samples=ts, pixels=tn, threads=threads_of(ts), columns=ncp,
        shared_bytes=_cap_shared_bytes(ts, tn, ncp, n_extra, elem), grid=-(-S // ts),
    )


# K2's wide kernel (csrc/logmvn_cap_wide.cu): output tiles of 64 samples x
# 256 columns of B | u, 16 warps of 32 x 32 on the tensor cores, 16-pixel
# chunks through a ring of 3 stages; the pair basis padded to whole warps
WIDE_CAP_SAMPLES = 64
WIDE_CAP_COLUMNS = 256
WIDE_CAP_PIXELS = 16
WIDE_CAP_THREADS = 512
WIDE_CAP_WARP_COLUMNS = 32
WIDE_CAP_STAGES = 3


class WideCapGeometry(NamedTuple):
    """K2's wide launch: ``samples`` and ``columns`` a tile, ``pixels`` a
    chunk, ``pair_columns`` (the pair basis padded to whole warps: the M
    columns start there), ``tiles`` column tiles, ``threads`` and
    ``shared_bytes`` a block and ``grid`` blocks, one an output tile, the
    column tiles of a sample tile consecutive."""

    samples: int
    pixels: int
    columns: int
    pair_columns: int
    tiles: int
    threads: int
    shared_bytes: int
    grid: int


def _wide_cap_shared_bytes(n_extra: int, elem: int, samples: int, columns: int,
                           stages: int) -> int:
    """The basis ring (rows of ``columns`` + 8 floats), the assembled w | r
    tile split into hi and lo (two buffers, rows of ``samples`` + 8
    floats), the ring of the chunk's 5 spectrum rows, and the sample-stream
    ring (rows of 16 + 16 / elem elements), the rings ``stages`` deep."""
    floats = (stages * WIDE_CAP_PIXELS * (columns + 8)
              + 2 * 4 * WIDE_CAP_PIXELS * (samples + 8)
              + stages * 5 * WIDE_CAP_PIXELS)
    return 4 * floats + elem * stages * (1 + n_extra) * samples * (
        WIDE_CAP_PIXELS + 16 // elem)


def wide_cap_geometry(S: int, N: int, k: int, kp: int, n_extra: int = 0, elem: int = 4,
                      samples: int = WIDE_CAP_SAMPLES, columns: int = WIDE_CAP_COLUMNS,
                      stages: int = WIDE_CAP_STAGES) -> WideCapGeometry:
    """K2's wide launch for S samples, N pixels, a GP basis of k columns, a
    pair basis of kp (packed or flat) and sample streams of ``elem`` bytes
    an element: a block for every ``samples`` samples and ``columns``
    padded columns of B | u (the pair basis padded to a multiple of 32,
    then M).  The tile and ring are the ones the kernel is compiled for
    (others only for ``ops/cap_wide_sweep.py``'s builds)."""
    if S < 1 or N < 1 or k < 1:
        raise ValueError(f"empty problem: S={S}, N={N}, k={k}")
    kpp = WIDE_CAP_WARP_COLUMNS * -(-kp // WIDE_CAP_WARP_COLUMNS)
    tiles = -(-(kpp + k) // columns)
    return WideCapGeometry(
        samples=samples, pixels=WIDE_CAP_PIXELS, columns=tiles * columns,
        pair_columns=kpp, tiles=tiles, threads=WIDE_CAP_THREADS,
        shared_bytes=_wide_cap_shared_bytes(n_extra, elem, samples, columns, stages),
        grid=-(-S // samples) * tiles,
    )


def wide_cap_basis(M: torch.Tensor, M_pair: torch.Tensor, g: WideCapGeometry) -> torch.Tensor:
    """The basis as K2's wide kernel reads it: (N, ``g.columns``) rows of
    ``[M_pair | 0 | M | 0]``, the M columns from ``g.pair_columns`` on, so
    a tile's chunk is staged in 16-byte copies and each warp's columns take
    one operand."""
    N, k = M.shape
    P = M.new_zeros((N, g.columns))
    P[:, :M_pair.shape[1]] = M_pair
    P[:, g.pair_columns:g.pair_columns + k] = M
    return P


def k2_geometry(S: int, N: int, k: int, kp: int, n_extra: int = 0,
                sms: int = H100_SMS, elem: int = 4) -> CapGeometry | WideCapGeometry:
    """The geometry K2's wrapper launches: :func:`cap_geometry` where one
    block holds the bases (k <= 53 packed at N = 1,280), else the wide
    kernel's :func:`wide_cap_geometry`."""
    if _cap_chunk(N, k, kp, n_extra, elem) is not None:
        return cap_geometry(S, N, k, kp, n_extra, sms, elem)
    return wide_cap_geometry(S, N, k, kp, n_extra, elem)


# K3's block (csrc/logmvn_chain.cu, K3_GEOMETRY): a warp per sample; per
# row bound, the warps a block and the blocks an SM holds at once (the
# launch bound)
CHAIN_ROW_BOUNDS = (32, 64)
CHAIN_MAX_K = CHAIN_ROW_BOUNDS[-1]
CHAIN_WARPS = {32: 8, 64: 8}
CHAIN_BLOCKS_PER_SM = {32: 4, 64: 2}


class ChainGeometry(NamedTuple):
    """K3's launch: the row bound ``rows`` (KMAX) of the instantiation,
    ``warps`` a block, ``shared_bytes`` a block and ``grid`` blocks.  Warp
    w of the grid's T takes the samples ``w * S // T`` up to
    ``(w + 1) * S // T``."""

    rows: int
    warps: int
    shared_bytes: int
    grid: int


def _chain_grid(S: int, warps: int, per_sm: int, sms: int) -> int:
    """A block for every ``warps`` samples up to one an SM; beyond that the
    same number of blocks on every SM, at most ``per_sm``: one even wave."""
    blocks = -(-S // warps)
    return blocks if blocks <= sms else sms * min(-(-blocks // sms), per_sm)


def _chain_shared_bytes(k: int, rows: int, warps: int) -> int:
    """A warp's buffer: its triangle, up to 3 floats of alignment and
    ``rows`` of padding (the rows past k - 1 read into it), in whole
    float4s."""
    return 4 * warps * 4 * -(-(k * (k + 1) // 2 + 3 + rows) // 4)


def chain_geometry(S: int, k: int, sms: int = H100_SMS) -> ChainGeometry:
    """K3's launch geometry for S samples of a k x k capacitance on
    ``sms`` SMs: the smallest row bound that holds k, and
    :func:`_chain_grid`'s grid, so every warp takes an even share of the
    samples."""
    if not 1 <= k <= CHAIN_MAX_K:
        raise ValueError(f"K3 takes 1 <= k <= {CHAIN_MAX_K}, got k={k}")
    if S < 1:
        raise ValueError(f"K3 needs S >= 1, got S={S}")
    rows = next(b for b in CHAIN_ROW_BOUNDS if k <= b)
    warps = CHAIN_WARPS[rows]
    return ChainGeometry(rows=rows, warps=warps,
                         shared_bytes=_chain_shared_bytes(k, rows, warps),
                         grid=_chain_grid(S, warps, CHAIN_BLOCKS_PER_SM[rows], sms))


# K7's flat chain (csrc/logmvn_ablate.cu, whose launcher checks both): K3's
# warp chain, a block of warps staging a run of consecutive samples into
# shared memory; the warps a block, and per row bound the blocks an SM (the
# launch bound)
FLAT_CHAIN_WARPS = 8
FLAT_CHAIN_BLOCKS_PER_SM = {32: 4, 64: 2}
SM_SHARED_BYTES = 228 * 1024  # an SM's shared memory; 1 KB of it reserved a block


class FlatChainGeometry(NamedTuple):
    """The flat chain's launch: row bound ``rows``, ``warps`` a block,
    ``blocks_per_sm`` (the launch bound), ``chunk`` samples staged at once,
    ``shared_bytes`` a block and ``grid`` blocks.  Block b of the grid's G
    takes the samples ``b * S // G`` up to ``(b + 1) * S // G``, ``chunk``
    at a time."""

    rows: int
    warps: int
    blocks_per_sm: int
    chunk: int
    shared_bytes: int
    grid: int


def flat_chain_stride(k: int) -> int:
    """Floats of a staged sample: its packed triangle, u and misc, made odd
    (the sample-fastest stores of the transposed layout then fall in
    distinct banks)."""
    return (k * (k + 1) // 2 + k + 2) | 1


def flat_chain_geometry(S: int, k: int, sms: int = H100_SMS) -> FlatChainGeometry:
    """The flat chain's launch geometry for S samples of a k x k flat
    capacitance on ``sms`` SMs: K3's row bound and grid
    (:func:`_chain_grid`), and the largest chunk of a block's samples whose
    buffers (the table of the triangle's flat offsets, the chunk, the row
    bound of padding past the last sample) fit the block's share of an SM
    at the launch bound's blocks an SM."""
    if not 1 <= k <= CHAIN_MAX_K:
        raise ValueError(f"the flat chain takes 1 <= k <= {CHAIN_MAX_K}, got k={k}")
    if S < 1:
        raise ValueError(f"the flat chain needs S >= 1, got S={S}")
    rows = next(b for b in CHAIN_ROW_BOUNDS if k <= b)
    warps, per_sm = FLAT_CHAIN_WARPS, FLAT_CHAIN_BLOCKS_PER_SM[rows]
    grid = _chain_grid(S, warps, per_sm, sms)
    kp = k * (k + 1) // 2
    budget = min(MAX_DYNAMIC_SHARED_BYTES, SM_SHARED_BYTES // per_sm - 1024)
    chunk = min(-(-S // grid), (budget // 4 - kp - rows) // flat_chain_stride(k))
    shared = 16 * -(-(4 * (kp + chunk * flat_chain_stride(k) + rows)) // 16)
    return FlatChainGeometry(rows=rows, warps=warps, blocks_per_sm=per_sm, chunk=chunk,
                             shared_bytes=shared, grid=grid)


# K3's wide chain (csrc/logmvn_chain.cu), for k beyond the warp chain's row
# bounds: a warp a sample, up to WIDE_CHAIN_WARPS a block, each warp's
# buffer (the triangle, 3 floats of alignment, WIDE_CHAIN_PAD of padding, u)
# in shared memory; past a block's shared bytes, a block of
# WIDE_CHAIN_THREADS a sample with the triangle in a global workspace (at
# most WIDE_CHAIN_BLOCKS_PER_SM blocks an SM)
WIDE_CHAIN_WARPS = 8
WIDE_CHAIN_PAD = 32
WIDE_CHAIN_THREADS = 128
WIDE_CHAIN_BLOCKS_PER_SM = 16


class WideChainGeometry(NamedTuple):
    """The wide chain's launch: ``threads`` a block, ``shared_bytes`` a
    block (0 where the triangle lives in the workspace), ``workspace``
    floats a block in global memory (0 where it lives in shared memory)
    and ``grid`` blocks.  A warp takes a sample: warp w of the grid's T
    takes the samples ``w * S // T`` up to ``(w + 1) * S // T``; but in
    K3's workspace a block does: block b takes b, b + grid, ..."""

    threads: int
    shared_bytes: int
    workspace: int
    grid: int


def wide_chain_buffer_floats(k: int) -> int:
    """Floats of a wide warp's buffer: the packed triangle, 3 floats of
    alignment and WIDE_CHAIN_PAD of padding in whole float4s, then u in
    whole float4s."""
    return 4 * -(-(k * (k + 1) // 2 + 3 + WIDE_CHAIN_PAD) // 4) + 4 * -(-k // 4)


def wide_chain_geometry(S: int, k: int, sms: int = H100_SMS) -> WideChainGeometry:
    """The wide chain's launch geometry for S samples of a k x k
    capacitance (k > CHAIN_MAX_K) on ``sms`` SMs: a warp a sample where a
    warp's buffer fits a block's shared memory (k <= 339), as many warps a
    block (up to WIDE_CHAIN_WARPS) and blocks an SM as the shared bytes
    allow, and :func:`_chain_grid`'s grid; else the workspace's block a
    sample."""
    if k <= CHAIN_MAX_K:
        raise ValueError(f"the wide chain takes k > {CHAIN_MAX_K}, got k={k}")
    if S < 1:
        raise ValueError(f"K3 needs S >= 1, got S={S}")
    buf = 4 * wide_chain_buffer_floats(k)
    if buf > MAX_DYNAMIC_SHARED_BYTES:
        return WideChainGeometry(WIDE_CHAIN_THREADS, 0, k * (k + 1) // 2 + k,
                                 min(S, sms * WIDE_CHAIN_BLOCKS_PER_SM))
    return _warp_buffers_geometry(S, buf, sms)


def _warp_buffers_geometry(S: int, buf: int, sms: int) -> WideChainGeometry:
    """A warp a sample on a shared buffer of ``buf`` bytes a warp: as many
    warps a block (up to WIDE_CHAIN_WARPS) and blocks an SM as the shared
    bytes allow, and :func:`_chain_grid`'s grid."""
    warps = min(WIDE_CHAIN_WARPS, MAX_DYNAMIC_SHARED_BYTES // buf)
    per_sm = SM_SHARED_BYTES // (warps * buf + 1024)
    return WideChainGeometry(32 * warps, warps * buf, 0, _chain_grid(S, warps, per_sm, sms))


def k3_geometry(S: int, k: int, sms: int = H100_SMS) -> ChainGeometry | WideChainGeometry:
    """The geometry K3's wrapper launches: the warp chain's
    (:func:`chain_geometry`) for k <= CHAIN_MAX_K, else the wide chain's
    (:func:`wide_chain_geometry`)."""
    if k > CHAIN_MAX_K:
        return wide_chain_geometry(S, k, sms)
    return chain_geometry(S, k, sms)


# K3's adjoint (csrc/logmvn_chain_grad.cu, K3G_WARPS and K3G_ROWS_AND_BLOCKS):
# for k <= CHAIN_MAX_K a warp a sample, the symmetric sweep on the rows in
# registers, compiled for each row bound with its blocks an SM (the launch
# bound, which caps a thread's registers); past the row bounds a warp a
# sample on the packed triangle in the warp's own buffer, in shared memory
# (up to WIDE_CHAIN_WARPS a block) or, past a block's shared bytes, in a
# global workspace (CHAIN_GRAD_WORK_WARPS a block, at most
# CHAIN_GRAD_WORK_BLOCKS_PER_SM blocks an SM)
CHAIN_GRAD_ROW_BOUNDS = (24, 32, 64)
CHAIN_GRAD_WARPS = 8
CHAIN_GRAD_BLOCKS_PER_SM = {24: 4, 32: 2, 64: 1}
CHAIN_GRAD_WORK_WARPS = 4
CHAIN_GRAD_WORK_BLOCKS_PER_SM = 4


def _chain_grad_shared_bytes(k: int, rows: int, warps: int) -> int:
    """The warp kernel's buffer a warp: two column buffers (a slot a lane
    and row, then u_p), then the triangle and up to 3 floats of alignment,
    in whole float4s."""
    column = 32 * -(-rows // 32) + 4
    return 4 * warps * (2 * column + 4 * -(-(k * (k + 1) // 2 + 3) // 4))


def chain_grad_wide_floats(k: int) -> int:
    """Floats of a wide warp's buffer: F (a float4 a column and one for u),
    u in whole float4s, the triangle and 3 floats of alignment in whole
    float4s."""
    return 4 * (k + 1) + 4 * -(-k // 4) + 4 * -(-(k * (k + 1) // 2 + 3) // 4)


def chain_grad_geometry(S: int, k: int,
                        sms: int = H100_SMS) -> ChainGeometry | WideChainGeometry:
    """The geometry K3's adjoint launches for S samples of a k x k
    capacitance on ``sms`` SMs: for k <= CHAIN_MAX_K the smallest compiled
    row bound that holds k, its buffers and :func:`_chain_grid`'s grid at
    its launch bound; beyond, a warp a sample on its
    :func:`chain_grad_wide_floats` buffer, as many warps a block (up to
    WIDE_CHAIN_WARPS) and blocks an SM as shared memory holds, else
    CHAIN_GRAD_WORK_WARPS warps a block on a global workspace."""
    if S < 1 or k < 1:
        raise ValueError(f"K3's adjoint needs S >= 1 and k >= 1, got S={S}, k={k}")
    if k > CHAIN_MAX_K:
        floats = chain_grad_wide_floats(k)
        if 4 * floats > MAX_DYNAMIC_SHARED_BYTES:
            warps = CHAIN_GRAD_WORK_WARPS
            return WideChainGeometry(32 * warps, 0, warps * floats,
                                     _chain_grid(S, warps, CHAIN_GRAD_WORK_BLOCKS_PER_SM, sms))
        return _warp_buffers_geometry(S, 4 * floats, sms)
    rows = next(b for b in CHAIN_GRAD_ROW_BOUNDS if k <= b)
    return ChainGeometry(rows=rows, warps=CHAIN_GRAD_WARPS,
                         shared_bytes=_chain_grad_shared_bytes(k, rows, CHAIN_GRAD_WARPS),
                         grid=_chain_grid(S, CHAIN_GRAD_WARPS, CHAIN_GRAD_BLOCKS_PER_SM[rows],
                                          sms))


# the last k whose wide warp buffer fits a block's shared memory
CHAIN_GRAD_SHARED_MAX_K = max(k for k in range(CHAIN_MAX_K + 1, 400)
                              if 4 * chain_grad_wide_floats(k) <= MAX_DYNAMIC_SHARED_BYTES)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=16)
def _packed_maps(k: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Column-major lower-triangle packing: packed column r holds matrix
    entry (rows[r], cols[r]) with rows >= cols; column j's segment (rows
    j..k-1) starts at j*k - j*(j-1)/2."""
    cols, rows = [], []
    for j in range(k):
        for a in range(j, k):
            cols.append(j)
            rows.append(a)
    return tuple(cols), tuple(rows)


def packed_flat_columns(k: int) -> tuple[int, ...]:
    """The flat column ``j k + a`` of each packed column (j, a >= j): where
    a flat (k x k, row-major) capacitance or pair basis holds the packed
    triangle's entries: the columns K7's stage kernel gathers from the
    flat pair basis (``ops/logmvn_ablate.py``)."""
    cols, rows = _packed_maps(k)
    return tuple(j * k + a for j, a in zip(cols, rows))


@functools.lru_cache(maxsize=16)
def _pair_index(k: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_packed_maps` as index tensors on ``device``, uploaded once
    (an upload from pageable memory waits for the device's queue)."""
    cols, rows = _packed_maps(k)
    idx = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
    return idx(rows), idx(cols)


def packed_pair_basis(M: torch.Tensor) -> torch.Tensor:
    """Packed lower-triangle pair basis ``P[n, r] = M[n, a_r] M[n, j_r]``:
    (N, k(k+1)/2), formed once per spectrum and shared by its likelihood
    calls."""
    rows, cols = _pair_index(M.shape[-1], M.device)
    return M[:, rows] * M[:, cols]


def unpack_capacitance(B: torch.Tensor, k: int) -> torch.Tensor:
    """(S, k(k+1)/2) packed lower triangle -> (S, k, k) symmetric ``I + B``."""
    cols, rows = _packed_maps(k)
    flat = np.empty(k * k, np.int64)
    for r, (j, a) in enumerate(zip(cols, rows)):
        flat[j * k + a] = r
        flat[a * k + j] = r
    full = B[:, torch.as_tensor(flat, device=B.device)].reshape(-1, k, k)
    return full + torch.eye(k, dtype=B.dtype, device=B.device)


def assemble_reference(
    rows: torch.Tensor, absorption: torch.Tensor, extra: Sequence[torch.Tensor] = ()
):
    """K2's elementwise noise assembly, plain, with K2's masking.

    :param rows: (5, N) rows y, mu, omega2, v, mask (1.0 = valid pixel).
    :param absorption: (S, N), float or int16 codes (decoded to ``rows``'s
        dtype, as K2 decodes them).
    :param extra: chained streams, each (S, N), multiplied into ``a``.
    :return: d_inv, w = a^2 d_inv, r = a delta d_inv (each (S, N)), quad0
        = sum delta^2 d_inv and logdet0 = -sum log d_inv (each (S,)), and
        n, the count of valid pixels.
    """
    y, mu, omega2, v, mask = rows
    a_raw = decode_profile_store(absorption, rows.dtype)
    for e in extra:
        a_raw = a_raw * decode_profile_store(e, rows.dtype)
    valid = mask > 0
    a = torch.where(valid, a_raw, 1.0)
    d = omega2 * a * a + v
    d_inv = mask / torch.where(valid, d, 1.0)
    delta = torch.where(valid, y - mu * a, 0.0)
    w = a * a * d_inv
    r = a * delta * d_inv
    quad0 = torch.sum(delta * delta * d_inv, dim=1)
    logdet0 = -torch.sum(torch.log(d_inv + (~valid).to(d_inv.dtype)), dim=1)
    return d_inv, w, r, quad0, logdet0, torch.sum(mask)


def logmvn_cap_reference(
    rows: torch.Tensor,
    M: torch.Tensor,
    M_pair: torch.Tensor,
    absorption: torch.Tensor,
    extra: Sequence[torch.Tensor] = (),
):
    """Plain twin of K2: the elementwise noise assembly and the two
    products of the reference's composition
    (``gpy_dla_detection_tpu/ops/logmvn.py:201-221``), with K2's masking.

    :param rows: (5, N) rows y, mu, omega2, v, mask (1.0 = valid pixel).
    :param M: (N, k).
    :param M_pair: (N, k(k+1)/2) packed pair basis, or the flat (N, k^2)
        one of the ablation's decoupled split.
    :param absorption: (S, N), float32 or int16 codes.
    :param extra: chained streams, each (S, N) and stored as
        ``absorption``, multiplied into ``a``.
    :return: B (S, M_pair's width) without the +I, u (S, k), misc (S, 2)
        = (quad0, logdet0 + n log 2 pi).
    """
    _, w, r, quad0, logdet0, n = assemble_reference(rows, absorption, extra)
    B = torch.matmul(w, M_pair)
    u = torch.matmul(r, M)
    return B, u, torch.stack([quad0, logdet0 + n * LOG_2PI], dim=1)


def logmvn_chain_reference(B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor):
    """Plain twin of K3: ``batched_quad_logdet`` on the unpacked I + B.

    :return: (S,) per-sample log-likelihoods
        ``-1/2 (quad0 - quad + logdet0 + logdet)``.
    """
    quad, logdet = batched_quad_logdet(unpack_capacitance(B, u.shape[1]), u)
    return -0.5 * (misc[:, 0] - quad + misc[:, 1] + logdet)


def logmvn_cap(
    rows: torch.Tensor,
    M: torch.Tensor,
    M_pair: torch.Tensor,
    absorption: torch.Tensor,
    extra: Sequence[torch.Tensor] = (),
):
    """Stage A of the Woodbury likelihood: K2 on CUDA, its twin on the
    CPU (float32 ``rows``).  Same contract as :func:`logmvn_cap_reference`:
    the kernel takes a basis of any width (on the wide kernel where one
    block cannot hold it, :func:`k2_geometry`), the packed one on the
    catalog paths and the flat k^2 one in the ablation's decoupled split,
    and the profiles as float32 or, all alike, as int16 codes (launched as
    ``logmvn_cap_i16``)."""
    extra = tuple(extra)
    store = check_store_dtype(absorption.dtype)
    if any(e.dtype != absorption.dtype for e in extra):
        raise TypeError(
            f"absorption and the streams share one storage dtype; got "
            f"{absorption.dtype} and {[e.dtype for e in extra]}"
        )
    if not use_kernel(rows):
        return logmvn_cap_reference(rows, M, M_pair, absorption, extra)
    if len(extra) > MAX_EXTRA_STREAMS:
        # deeper chains than the catalog's 4 levels: fold the oldest rows,
        # decoded (codes are not encoded again: that would round twice),
        # and launch the float32 instantiation
        f32 = lambda x: decode_profile_store(x, torch.float32)
        head = extra[: len(extra) - MAX_EXTRA_STREAMS + 1]
        extra = (torch.prod(torch.stack([f32(e) for e in head]), dim=0),) + tuple(
            f32(e) for e in extra[len(head):])
        absorption, store = f32(absorption), torch.float32
    device = rows.device
    check_cuda_f32(device, rows=rows, M=M, M_pair=M_pair)
    for name, t in [("absorption", absorption)] + [(f"extra[{i}]", e) for i, e in enumerate(extra)]:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")
    S, N = absorption.shape
    k = M.shape[1]
    kp = M_pair.shape[1]
    if (
        rows.shape != (5, N)
        or M.shape != (N, k)
        or M_pair.shape[0] != N
        or kp not in (k * (k + 1) // 2, k * k)
        or any(e.shape != (S, N) for e in extra)
    ):
        raise ValueError(
            f"shape mismatch: rows {tuple(rows.shape)}, M {tuple(M.shape)}, "
            f"M_pair {tuple(M_pair.shape)}, absorption {(S, N)}, extra "
            f"{[tuple(e.shape) for e in extra]}"
        )
    if S == 0 or N == 0 or k == 0:
        raise ValueError(f"empty problem: S={S}, N={N}, k={k}")
    i16 = store == torch.int16
    g = k2_geometry(S, N, k, kp, len(extra), _sm_count(device), elem=2 if i16 else 4)
    B = torch.empty((S, kp), dtype=torch.float32, device=device)
    u = torch.empty((S, k), dtype=torch.float32, device=device)
    misc = torch.empty((S, 2), dtype=torch.float32, device=device)
    e = list(extra) + [None] * (MAX_EXTRA_STREAMS - len(extra))
    lib = load_library()
    streams = (ptr(absorption), ptr(e[0]), ptr(e[1]), ptr(e[2]), len(extra), int(i16), S)
    outs = (ptr(B), ptr(u), ptr(misc), stream_ptr(device))
    with torch.cuda.device(device):
        if isinstance(g, WideCapGeometry):
            P = wide_cap_basis(M, M_pair, g)
            err = lib.logmvn_cap_wide_launch(
                ptr(rows), N, ptr(P), k, kp, *streams, g.samples, g.pixels, g.pair_columns,
                g.tiles, g.threads, g.shared_bytes, g.grid, *outs)
        else:
            err = lib.logmvn_cap_launch(
                ptr(rows), N, ptr(M), k, ptr(M_pair), kp, *streams, g.samples, g.pixels,
                g.threads, g.shared_bytes, g.grid, *outs)
    name = store_name("logmvn_cap", store)
    check_launch(name, err)
    launch_counts[name] += 1
    return B, u, misc


def logmvn_chain(B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor):
    """Stage B of the Woodbury likelihood: K3 on CUDA, its twin on the
    CPU (float32).  Returns the (S,) per-sample log-likelihoods.  The warp
    chain takes 1 <= k <= ``CHAIN_MAX_K``, the wide chain (counted as
    ``logmvn_chain_wide``) any wider k."""
    if not use_kernel(B):
        return logmvn_chain_reference(B, u, misc)
    device = B.device
    check_cuda_f32(device, B=B, u=u, misc=misc)
    S, k = u.shape
    if B.shape != (S, k * (k + 1) // 2) or misc.shape != (S, 2) or S == 0:
        raise ValueError(
            f"shape mismatch: B {tuple(B.shape)}, u {tuple(u.shape)}, "
            f"misc {tuple(misc.shape)}"
        )
    g = k3_geometry(S, k, _sm_count(device))
    ll = torch.empty((S,), dtype=torch.float32, device=device)
    lib = load_library()
    if isinstance(g, WideChainGeometry):
        work = (torch.empty((g.grid, g.workspace), dtype=torch.float32, device=device)
                if g.workspace else None)
        with torch.cuda.device(device):
            err = lib.logmvn_chain_wide_launch(
                ptr(B), ptr(u), ptr(misc), S, k, g.threads, g.shared_bytes, g.grid,
                ptr(work), ptr(ll), stream_ptr(device))
        check_launch("logmvn_chain_wide", err)
        launch_counts["logmvn_chain_wide"] += 1
        return ll
    with torch.cuda.device(device):
        err = lib.logmvn_chain_launch(
            ptr(B), ptr(u), ptr(misc), S, k, g.rows, g.warps, g.shared_bytes, g.grid,
            ptr(ll), stream_ptr(device)
        )
    check_launch("logmvn_chain", err)
    launch_counts["logmvn_chain"] += 1
    return ll


# zqso_cap (csrc/zqso_cap.cu): the zQSO exact scan's in-window Woodbury
# inputs.  A block takes a run of redshifts (a lane each) over a tile of
# pixels in sub-tiles of ZQSO_CAP_SUB, staging a band of up to
# ZQSO_CAP_BAND_ROWS table rows; each warp holds a piece of the triangle's
# rows, at most ZQSO_CAP_PIECE_CAP accumulators a thread.  Compiled for GP
# bases up to each row bound, with its blocks an SM (the launch bound).
ZQSO_CAP_ROW_BOUNDS = (20, 32)
ZQSO_CAP_MAX_K = ZQSO_CAP_ROW_BOUNDS[-1]
ZQSO_CAP_SUB = 32
ZQSO_CAP_BAND_ROWS = 256
ZQSO_CAP_PIECE_CAP = 120
ZQSO_CAP_BLOCKS_PER_SM = {20: 3, 32: 2}
ZQSO_CAP_TILES = (1024, 512, 256, 128)  # pixels a tile, the widest first
# waves of blocks a tile should give: at 10,000 z a 256-pixel tile (8.7
# waves) took 1.39 ms against 1.41 for 1,024 (2.4), at 1,000 z 128 pixels
# 0.22 ms against 0.56 (ops/zqso_cap_sweep.py, PERF.md)
ZQSO_CAP_WAVES = 8


class ZqsoCapGeometry(NamedTuple):
    """zqso_cap's launch: the row bound ``rows`` (KMAX) of the
    instantiation, ``redshifts`` and ``threads`` a block, ``shared_bytes`` a
    block, ``tile_pixels`` a tile, ``tiles`` over the pixels, ``grid``
    blocks (redshift runs x tiles), the band's row ``stride`` in floats and
    the ``workspace`` of the tiles' partial sums, (tiles, kp + k + 3, C)."""

    rows: int
    redshifts: int
    threads: int
    shared_bytes: int
    tile_pixels: int
    tiles: int
    grid: int
    stride: int
    workspace: tuple[int, int, int]


def zqso_cap_pieces(rows: int) -> tuple[int, ...]:
    """The first row of each piece of the triangle's rows and the end: row
    a holds a + 1 entries of B and one of u, and a piece as many rows as
    keep it within ZQSO_CAP_PIECE_CAP accumulators (one row at least)."""
    lo, a = [0], 0
    while a < rows:
        held, b = 0, a
        while b < rows and (held + b + 2 <= ZQSO_CAP_PIECE_CAP or b == a):
            held, b = held + b + 2, b + 1
        lo.append(b)
        a = b
    return tuple(lo)


def zqso_cap_shared_bytes(redshifts: int, stride: int, sub: int = ZQSO_CAP_SUB) -> int:
    """A block's shared bytes: the pixel terms (16 bytes a redshift and
    pixel of a sub-tile), the band (rows of ``stride`` floats), two
    sub-tiles' pixels (wavelength, flux, noise, valid: 20 bytes) and the
    band's bounds."""
    return sub * redshifts * 16 + ZQSO_CAP_BAND_ROWS * stride * 4 + 2 * sub * 20 + 16


def zqso_cap_geometry(C: int, P: int, k: int, sms: int = H100_SMS, tile: int | None = None,
                      sub: int = ZQSO_CAP_SUB) -> ZqsoCapGeometry:
    """zqso_cap's launch for C redshifts, P pixels and a GP basis of k
    columns: the smallest row bound that holds k; a warp a piece (four
    warps of redshifts for one piece, two for two, else one); and the
    widest tile of ZQSO_CAP_TILES that still gives ZQSO_CAP_WAVES waves of
    blocks at the launch bound (the narrowest where none does), so blocks
    whose pixels fall outside the window leave no SM idle for long.
    ``tile`` and ``sub`` (pixels a sub-tile, compiled in) are for builds
    and tiles other than the shipped ones (``ops/zqso_cap_sweep.py``)."""
    if not 1 <= k <= ZQSO_CAP_MAX_K:
        raise ValueError(f"zqso_cap takes 1 <= k <= {ZQSO_CAP_MAX_K}, got k={k}")
    if C < 1 or P < 1:
        raise ValueError(f"empty problem: C={C}, P={P}")
    rows = next(b for b in ZQSO_CAP_ROW_BOUNDS if k <= b)
    pieces = len(zqso_cap_pieces(rows)) - 1
    zs = 32 * {1: 4, 2: 2}.get(pieces, 1)
    stride = rows if rows % 8 == 4 else rows + 4
    runs = -(-C // zs)
    if tile is None:
        target = ZQSO_CAP_WAVES * sms * ZQSO_CAP_BLOCKS_PER_SM[rows]
        tile = next((t for t in ZQSO_CAP_TILES if runs * -(-P // t) >= target),
                    ZQSO_CAP_TILES[-1])
        tile = min(tile, ZQSO_CAP_SUB * -(-P // ZQSO_CAP_SUB))
    tiles = -(-P // tile)
    return ZqsoCapGeometry(
        rows=rows, redshifts=zs, threads=zs * pieces,
        shared_bytes=zqso_cap_shared_bytes(zs, stride, sub),
        tile_pixels=tile, tiles=tiles, grid=runs * tiles, stride=stride,
        workspace=(tiles, k * (k + 1) // 2 + k + 3, C))


def zqso_cap_reference(z, median, min_obs, max_obs, wavelengths, flux, noise_variance, valid,
                       rest_wavelengths, mu, M, min_lambda: float, max_lambda: float):
    """Plain twin of zqso_cap: the exact scan's composition
    (``models/zqso``: ``interp_uniform``, then ``log_mvnpdf_low_rank``'s
    masked inputs and products) regrouped to stop at K3's inputs.

    :param z, min_obs, max_obs: (C,) float64: the redshifts and the
        observable cut's ends.
    :param median: (C,) the flux's normalization median at each z.
    :param wavelengths: (P,) float64; ``flux``, ``noise_variance`` (P,);
        ``valid`` (P,) bool.
    :param rest_wavelengths, mu: (R,) the learned grid (uniform) and mean;
        ``M`` (R, k).
    :return: B (C, k(k+1)/2) packed without the +I, u (C, k), misc (C, 2) =
        (sum delta^2 d_inv, sum log d + n log 2 pi), in ``flux``'s dtype.
    """
    from ..ops.interp import interp_uniform
    from .logmvn import _masked_inputs

    rest = wavelengths / (1.0 + z[:, None])
    mask = ((rest >= min_lambda) & (rest <= max_lambda)
            & (wavelengths > min_obs[:, None]) & (wavelengths < max_obs[:, None]) & valid)
    med = median[:, None]
    y = flux / med
    v = noise_variance / (med * med)
    x0 = rest_wavelengths[0]
    dx = rest_wavelengths[1] - rest_wavelengths[0]
    rest_q = rest.to(flux.dtype)
    Mz = interp_uniform(x0, dx, M, rest_q)
    delta, d_inv, log_d = _masked_inputs(y, interp_uniform(x0, dx, mu, rest_q), v, mask)
    rows, cols = _pair_index(M.shape[1], M.device)
    B = torch.einsum("cni,cnj->cij", Mz, Mz * d_inv[..., None])[:, rows, cols]
    u = torch.einsum("cni,cn->ci", Mz, d_inv * delta)
    n = torch.sum(mask, dim=-1).to(flux.dtype)
    misc = torch.stack([torch.sum(delta * delta * d_inv, dim=-1),
                        torch.sum(log_d, dim=-1) + n * LOG_2PI], dim=1)
    return B, u, misc


def zqso_cap(z, median, min_obs, max_obs, wavelengths, flux, noise_variance, valid,
             rest_wavelengths, mu, M, min_lambda: float, max_lambda: float):
    """The zQSO exact scan's in-window Woodbury inputs for a chunk of
    redshifts (:func:`zqso_cap_reference`'s contract): the kernel
    (``csrc/zqso_cap.cu``) on float32 CUDA tensors, the twin on float32 CPU
    tensors.  On the card a basis wider than ``ZQSO_CAP_MAX_K`` is refused
    (ValueError): ``models/zqso`` sends such a model to the composition.
    Nothing of the (C, P, k) basis reaches device memory;
    :func:`logmvn_chain` finishes the likelihood."""
    if not use_kernel(flux):
        return zqso_cap_reference(z, median, min_obs, max_obs, wavelengths, flux,
                                  noise_variance, valid, rest_wavelengths, mu, M,
                                  min_lambda, max_lambda)
    device = flux.device
    check_cuda_f32(device, median=median, flux=flux, noise_variance=noise_variance,
                   rest_wavelengths=rest_wavelengths, mu=mu, M=M)
    for name, t, dtype in (("z", z, torch.float64), ("min_obs", min_obs, torch.float64),
                           ("max_obs", max_obs, torch.float64),
                           ("wavelengths", wavelengths, torch.float64),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {device}")
    C, P, (R, k) = z.shape[0], wavelengths.shape[0], M.shape
    if (median.shape != (C,) or min_obs.shape != (C,) or max_obs.shape != (C,)
            or flux.shape != (P,) or noise_variance.shape != (P,) or valid.shape != (P,)
            or rest_wavelengths.shape != (R,) or mu.shape != (R,) or R < 2):
        raise ValueError(
            f"shape mismatch: z {tuple(z.shape)}, median {tuple(median.shape)}, min_obs "
            f"{tuple(min_obs.shape)}, max_obs {tuple(max_obs.shape)}, wavelengths {(P,)}, "
            f"flux {tuple(flux.shape)}, noise {tuple(noise_variance.shape)}, valid "
            f"{tuple(valid.shape)}, rest_wavelengths {tuple(rest_wavelengths.shape)}, mu "
            f"{tuple(mu.shape)}, M {(R, k)}")
    out = zqso_cap_launch(load_library(), zqso_cap_geometry(C, P, k, _sm_count(device)), z,
                          median, min_obs, max_obs, wavelengths, flux, noise_variance, valid,
                          rest_wavelengths, mu, M, min_lambda, max_lambda)
    launch_counts["zqso_cap"] += 1
    return out


def zqso_cap_launch(lib, g: ZqsoCapGeometry, z, median, min_obs, max_obs, wavelengths, flux,
                    noise_variance, valid, rest_wavelengths, mu, M, min_lambda: float,
                    max_lambda: float):
    """Launch ``lib``'s zqso_cap at the geometry ``g`` on inputs that
    :func:`zqso_cap` has checked (its workspace and outputs allocated
    here): B, u, misc.  Uncounted; ``ops/zqso_cap_sweep.py`` times other
    builds and tiles through it."""
    device = flux.device
    C, P, (R, k) = z.shape[0], wavelengths.shape[0], M.shape
    part = torch.empty(g.workspace, dtype=torch.float32, device=device)
    B = torch.empty((C, k * (k + 1) // 2), dtype=torch.float32, device=device)
    u = torch.empty((C, k), dtype=torch.float32, device=device)
    misc = torch.empty((C, 2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.zqso_cap_launch(
            ptr(z), ptr(median), ptr(min_obs), ptr(max_obs), C, ptr(wavelengths), ptr(flux),
            ptr(noise_variance), ptr(valid), P, ptr(rest_wavelengths), ptr(mu), ptr(M), R, k,
            float(min_lambda), float(max_lambda), g.rows, g.tile_pixels, g.tiles, g.threads,
            g.shared_bytes, ptr(part), ptr(B), ptr(u), ptr(misc), stream_ptr(device))
    check_launch("zqso_cap", err)
    return B, u, misc


def _cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of (S, k, k) SPD matrices by the unrolled
    right-looking chain of ``batched_quad_logdet``: a pivot that is not
    positive gives NaN, as K3."""
    k = A.shape[-1]
    row_idx = torch.arange(k, device=A.device)
    cols = []
    for j in range(k):
        col = torch.where(row_idx >= j, A[:, :, j] * torch.rsqrt(A[:, j, j])[:, None], 0.0)
        cols.append(col)
        if j < k - 1:
            A = A - col[:, :, None] * col[:, None, :]
    return torch.stack(cols, dim=2)


def logmvn_chain_grad_reference(B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor,
                                g: torch.Tensor):
    """Plain twin of K3's adjoint, in the inputs' dtype: with A = I + B,
    L its Cholesky factor, W = L^-1 and v = A^-1 u = W^T W u,

        dll/du = g v,   dll/dmisc = -g/2 (both columns),
        dll/dB(i, j) = -g/2 (v_i v_j + (W^T W)_ij), twice that for i != j
        (the packed entry stands for both halves).

    A sample whose factorization meets a pivot that is not positive gets
    NaN in dB and du, as K3 gives it a NaN likelihood.

    :return: dB (S, k(k+1)/2), du (S, k), dmisc (S, 2).
    """
    S, k = u.shape
    L = _cholesky_unrolled(unpack_capacitance(B, k))
    eye = torch.eye(k, dtype=B.dtype, device=B.device).expand(S, k, k)
    W = torch.linalg.solve_triangular(L, eye, upper=False)
    Wt = W.transpose(1, 2)
    v = (Wt @ (W @ u[:, :, None]))[:, :, 0]
    G = -0.5 * g[:, None, None] * (v[:, :, None] * v[:, None, :] + Wt @ W)
    cols, rows = _packed_maps(k)
    twice = torch.tensor([1.0 if a == j else 2.0 for j, a in zip(cols, rows)],
                         dtype=B.dtype, device=B.device)
    dB = G[:, list(rows), list(cols)] * twice
    bad = ~torch.isfinite(torch.diagonal(L, dim1=1, dim2=2)).all(dim=1)
    dB = torch.where(bad[:, None], torch.nan, dB)
    du = torch.where(bad[:, None], torch.nan, g[:, None] * v)
    return dB, du, (-0.5 * g)[:, None].expand(S, 2).contiguous()


def logmvn_chain_grad(B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor, g: torch.Tensor):
    """K3's adjoint (``csrc/logmvn_chain_grad.cu``) on CUDA, its twin on
    the CPU (float32): the gradient of ``g . logmvn_chain(B, u, misc)``
    with respect to B, u and misc (:func:`logmvn_chain_grad_reference`).
    The warp kernel takes 1 <= k <= ``CHAIN_MAX_K`` (counted as
    ``logmvn_chain_grad``), the wide kernel, a warp a sample too, any wider
    k (counted as ``logmvn_chain_grad_wide``)."""
    if not use_kernel(B):
        return logmvn_chain_grad_reference(B, u, misc, g)
    device = B.device
    check_cuda_f32(device, B=B, u=u, misc=misc, g=g)
    S, k = u.shape
    if (B.shape != (S, k * (k + 1) // 2) or misc.shape != (S, 2) or g.shape != (S,)
            or S == 0):
        raise ValueError(
            f"shape mismatch: B {tuple(B.shape)}, u {tuple(u.shape)}, "
            f"misc {tuple(misc.shape)}, g {tuple(g.shape)}"
        )
    geo = chain_grad_geometry(S, k, _sm_count(device))
    dB, du, dmisc = torch.empty_like(B), torch.empty_like(u), torch.empty_like(misc)
    lib = load_library()
    if isinstance(geo, WideChainGeometry):
        work = (torch.empty((geo.grid, geo.workspace), dtype=torch.float32, device=device)
                if geo.workspace else None)
        with torch.cuda.device(device):
            err = lib.logmvn_chain_grad_wide_launch(
                ptr(B), ptr(u), ptr(g), S, k, geo.threads, geo.shared_bytes, geo.grid,
                ptr(work), ptr(dB), ptr(du), ptr(dmisc), stream_ptr(device))
        name = "logmvn_chain_grad_wide"
    else:
        with torch.cuda.device(device):
            err = lib.logmvn_chain_grad_launch(
                ptr(B), ptr(u), ptr(g), S, k, geo.rows, geo.warps, geo.shared_bytes,
                geo.grid, ptr(dB), ptr(du), ptr(dmisc), stream_ptr(device))
        name = "logmvn_chain_grad"
    check_launch(name, err)
    launch_counts[name] += 1
    return dB, du, dmisc


class _ChainLoglik(torch.autograd.Function):
    """K3 forward, its adjoint backward; the twins on CPU tensors in their
    own dtype."""

    @staticmethod
    def forward(ctx, B, u, misc):
        ctx.save_for_backward(B, u, misc)
        if B.device.type == "cuda":
            return logmvn_chain(B, u, misc)
        return logmvn_chain_reference(B, u, misc)

    @staticmethod
    def backward(ctx, g):
        B, u, misc = ctx.saved_tensors
        g = g.contiguous()
        if B.device.type == "cuda":
            return logmvn_chain_grad(B, u, misc, g)
        return logmvn_chain_grad_reference(B, u, misc, g)


def chain_loglik(B: torch.Tensor, u: torch.Tensor, misc: torch.Tensor) -> torch.Tensor:
    """K3's per-sample log-likelihood ``-1/2 (misc0 - quad + misc1 +
    logdet)`` of I + B (packed), differentiable in B, u and misc.  On a
    CUDA tensor: K3 and its adjoint kernel, float32 only (anything else
    raises, as :func:`logmvn_chain` does); on a CPU tensor: their plain
    twins in the tensor's own dtype (float64 for the conformance tests)."""
    return _ChainLoglik.apply(B, u, misc)
