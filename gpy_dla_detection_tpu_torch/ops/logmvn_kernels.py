"""K2 and K3: the two-stage batched Woodbury log-likelihood.

Stage A (K2, ``logmvn_cap``, ``csrc/logmvn_cap.cu``) assembles the noise
model per sample and forms the packed capacitance products; stage B (K3,
``logmvn_chain``, ``csrc/logmvn_chain.cu``) runs the k x k Cholesky with
the forward substitution and emits the per-sample log-likelihood.  Each
wrapper launches its kernel on float32 CUDA tensors and runs its plain
twin (``*_reference``) on float32 CPU tensors.  Both take a GP basis of
any width: K2 cuts a basis wider than one block holds into column slices
(:func:`k2_geometry`), and K3 runs the k > 64 its warp chain's row bounds
end at on its wide chain (counted as ``logmvn_chain_wide``;
:func:`k3_geometry`).  K2 also takes the
profiles as int16 codes (``ops/kernel_config.py``), which an
instantiation of its own decodes as it assembles (counted as
``logmvn_cap_i16``); its twin decodes with
``ops/logmvn.decode_profile_store``.

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
    warps), ``shared_bytes`` a block and ``grid`` blocks of samples; each
    takes ``slice_columns`` of the padded columns, one of ``slices``
    column slices (the grid's y)."""

    samples: int
    pixels: int
    threads: int
    columns: int
    shared_bytes: int
    grid: int
    slice_columns: int
    slices: int


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
    block cannot hold the bases (:func:`sliced_cap_geometry` can)."""
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
        slice_columns=ncp, slices=1,
    )


def sliced_cap_geometry(S: int, N: int, k: int, kp: int, n_extra: int = 0,
                        elem: int = 4) -> CapGeometry:
    """K2's launch geometry for bases one block cannot hold: the padded
    columns cut into the fewest even slices of at most 12 warps across
    (the thread bound at one warp of sample groups), each slice's block
    the most samples (whole warps of sample groups, no more than S needs)
    whose threads and shared bytes fit, in 16-pixel chunks (the sliced
    instantiation's: a slice of 7 to 12 warps across holds no 32-pixel
    basis chunk)."""
    if S < 1 or N < 1 or k < 1:
        raise ValueError(f"empty problem: S={S}, N={N}, k={k}")
    ncp = _padded_columns(k, kp)
    warps = ncp // CAP_WARP_COLUMNS
    across = CAP_MAX_THREADS // 32
    slices = -(-warps // across)
    ncb = CAP_WARP_COLUMNS * -(-warps // slices)

    def fits(ts, tn):
        return (32 * (ncb // CAP_WARP_COLUMNS) * ts // CAP_WARP_SAMPLES <= CAP_MAX_THREADS
                and _cap_shared_bytes(ts, tn, ncb, n_extra, elem) <= MAX_DYNAMIC_SHARED_BYTES)

    tn = 16
    ts = CAP_WARP_SAMPLES
    while ts < S and fits(ts + CAP_WARP_SAMPLES, tn):
        ts += CAP_WARP_SAMPLES
    return CapGeometry(
        samples=ts, pixels=tn, threads=32 * (ncb // CAP_WARP_COLUMNS) * ts // CAP_WARP_SAMPLES,
        columns=ncp, shared_bytes=_cap_shared_bytes(ts, tn, ncb, n_extra, elem),
        grid=-(-S // ts), slice_columns=ncb, slices=-(-ncp // ncb),
    )


def k2_geometry(S: int, N: int, k: int, kp: int, n_extra: int = 0,
                sms: int = H100_SMS, elem: int = 4) -> CapGeometry:
    """The geometry K2's wrapper launches: :func:`cap_geometry` where one
    block holds the bases (k <= 53 packed at N = 1,280), else
    :func:`sliced_cap_geometry`."""
    if _cap_chunk(N, k, kp, n_extra, elem) is not None:
        return cap_geometry(S, N, k, kp, n_extra, sms, elem)
    return sliced_cap_geometry(S, N, k, kp, n_extra, elem)


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


# K3's wide chain (csrc/logmvn_chain.cu): a block of 128 threads a
# sample, for k beyond the warp chain's row bounds; at most 16 blocks an SM
WIDE_CHAIN_THREADS = 128
WIDE_CHAIN_BLOCKS_PER_SM = 16


class WideChainGeometry(NamedTuple):
    """The wide chain's launch: ``threads`` a block, ``shared_bytes`` a
    block (0 where the triangle lives in the workspace), ``workspace``
    floats a block in global memory (0 where it lives in shared memory)
    and ``grid`` blocks; block b takes the samples b, b + grid, ..."""

    threads: int
    shared_bytes: int
    workspace: int
    grid: int


def wide_chain_geometry(S: int, k: int, sms: int = H100_SMS) -> WideChainGeometry:
    """The wide chain's launch geometry for S samples of a k x k
    capacitance (k > CHAIN_MAX_K) on ``sms`` SMs: the triangle and u in
    shared memory where they fit a block, else in a global workspace; as
    many blocks an SM as the shared bytes allow (at most 16), and no more
    blocks than samples."""
    if k <= CHAIN_MAX_K:
        raise ValueError(f"the wide chain takes k > {CHAIN_MAX_K}, got k={k}")
    if S < 1:
        raise ValueError(f"K3 needs S >= 1, got S={S}")
    floats = k * (k + 1) // 2 + k
    shared = 16 * -(-4 * floats // 16)
    if shared <= MAX_DYNAMIC_SHARED_BYTES:
        per_sm = min(WIDE_CHAIN_BLOCKS_PER_SM, SM_SHARED_BYTES // (shared + 1024))
        return WideChainGeometry(WIDE_CHAIN_THREADS, shared, 0, min(S, sms * per_sm))
    return WideChainGeometry(WIDE_CHAIN_THREADS, 0, floats,
                             min(S, sms * WIDE_CHAIN_BLOCKS_PER_SM))


def k3_geometry(S: int, k: int, sms: int = H100_SMS) -> ChainGeometry | WideChainGeometry:
    """The geometry K3's wrapper launches: the warp chain's
    (:func:`chain_geometry`) for k <= CHAIN_MAX_K, else the wide chain's
    (:func:`wide_chain_geometry`)."""
    if k > CHAIN_MAX_K:
        return wide_chain_geometry(S, k, sms)
    return chain_geometry(S, k, sms)


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
    the kernel takes a basis of any width (in column slices where one
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
    with torch.cuda.device(device):
        err = lib.logmvn_cap_launch(
            ptr(rows), N, ptr(M), k, ptr(M_pair), kp, ptr(absorption),
            ptr(e[0]), ptr(e[1]), ptr(e[2]), len(extra), int(i16), S,
            g.samples, g.pixels, g.slice_columns, g.slices, g.threads, g.shared_bytes, g.grid,
            ptr(B), ptr(u), ptr(misc), stream_ptr(device),
        )
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
