"""K3's launch geometry (``chain_geometry``), which the wrapper passes to the
kernel: whole warps, the smallest row bound that holds k, every sample
covered by exactly one warp, shared memory within Hopper's 227 KB, one wave
with no thin tail at the main path's S = 10,000, and a ``ValueError`` beyond
the largest row bound.  The kernel itself is held against its twin on the
card (tests/test_torch_kernels_gpu.py)."""

import re
from pathlib import Path

import pytest

from gpy_dla_detection_tpu_torch.ops._build import CSRC, MAX_DYNAMIC_SHARED_BYTES
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    CHAIN_BLOCKS_PER_SM,
    CHAIN_GRAD_BLOCKS_PER_SM,
    CHAIN_GRAD_WARPS,
    CHAIN_MAX_K,
    CHAIN_ROW_BOUNDS,
    CHAIN_WARPS,
    H100_SMS,
    SM_SHARED_BYTES,
    WideChainGeometry,
    chain_geometry,
    chain_grad_geometry,
)

SS = (1, 2, 31, 32, 33, 1001, 10_000)


def warp_samples(g, S):
    """The samples of every warp of the grid, as the kernel splits them:
    warp w of T takes w S // T up to (w + 1) S // T."""
    total = g.grid * g.warps
    return [range(w * S // total, (w + 1) * S // total) for w in range(total)]


@pytest.mark.parametrize("k", range(1, CHAIN_MAX_K + 1))
def test_geometry_is_launchable_and_covers_every_sample_once(k):
    kp = k * (k + 1) // 2
    for S in SS:
        g = chain_geometry(S, k)
        assert g.rows == min(b for b in CHAIN_ROW_BOUNDS if b >= k)
        assert g.warps == CHAIN_WARPS[g.rows]
        assert 32 <= 32 * g.warps <= 1024  # whole warps
        # the warps' buffers: their triangles, the alignment shift and the
        # padding the rows past k - 1 read into, in whole float4s
        assert g.shared_bytes >= 4 * g.warps * (kp + 3 + g.rows)
        assert g.shared_bytes % (16 * g.warps) == 0
        assert g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES
        # the launch bound's blocks fit an SM's 228 KB, 1 KB reserved a block
        assert CHAIN_BLOCKS_PER_SM[g.rows] * (g.shared_bytes + 1024) <= 228 * 1024
        # one wave: at most one block an SM, or the same number on every SM
        assert 1 <= g.grid <= H100_SMS * CHAIN_BLOCKS_PER_SM[g.rows]
        assert g.grid <= H100_SMS or g.grid % H100_SMS == 0
        shares = warp_samples(g, S)
        assert [s for r in shares for s in r] == list(range(S))
        assert max(map(len, shares)) - min(map(len, shares)) <= 1
        # no block without work
        assert all(sum(map(len, shares[b * g.warps:(b + 1) * g.warps])) > 0
                   for b in range(g.grid))


@pytest.mark.parametrize("k", [1, 8, 16, 20, 21, 32, 33, 41, 64])
def test_main_path_fills_the_card_in_one_even_wave(k):
    """S = 10,000 on 132 SMs: every SM holds the same number of blocks,
    all at once, and each SM's samples are within one a block of its even
    share: no thin last wave."""
    g = chain_geometry(10_000, k)
    assert g.grid % H100_SMS == 0
    per_sm = g.grid // H100_SMS
    assert per_sm <= CHAIN_BLOCKS_PER_SM[g.rows]
    shares = warp_samples(g, 10_000)
    block_samples = [sum(map(len, shares[b * g.warps:(b + 1) * g.warps]))
                     for b in range(g.grid)]
    # blocks b, b + 132, ... share an SM
    sm_samples = [sum(block_samples[b::H100_SMS]) for b in range(H100_SMS)]
    mean = sum(sm_samples) / H100_SMS
    assert max(sm_samples) <= mean + per_sm and min(sm_samples) >= mean - per_sm


def test_main_path_geometry():
    """k = 20: row bound 32, 4 blocks of 8 warps an SM (528 blocks),
    7,936 shared bytes a block."""
    g = chain_geometry(10_000, 20)
    assert g == (32, 8, 7936, 528)
    assert chain_geometry(10_000, 20, sms=100).grid == 400


def test_geometry_matches_the_kernels_compiled_blocks():
    """The kernel's launch bounds (K3_GEOMETRY: warps and blocks an SM at
    row bounds 32 and 64) are the ones chain_geometry assumes."""
    src = (Path(CSRC) / "logmvn_chain.cu").read_text()
    compiled = re.search(r"#define K3_GEOMETRY (\d+), (\d+), (\d+), (\d+)", src).groups()
    assert tuple(map(int, compiled)) == (
        CHAIN_WARPS[32], CHAIN_BLOCKS_PER_SM[32], CHAIN_WARPS[64], CHAIN_BLOCKS_PER_SM[64])
    assert CHAIN_ROW_BOUNDS == (32, 64)


@pytest.mark.parametrize("k", [0, CHAIN_MAX_K + 1, 100])
def test_k_beyond_the_row_bounds_is_refused(k):
    with pytest.raises(ValueError):
        chain_geometry(10_000, k)


def test_no_samples_is_refused():
    with pytest.raises(ValueError):
        chain_geometry(0, 20)


@pytest.mark.parametrize("k", [1, 2, 20, 21, 32, 33, 63, 64])
def test_adjoint_geometry_is_launchable_and_covers_every_sample_once(k):
    """K3's adjoint (csrc/logmvn_chain_grad.cu) at k <= 64: K3's row bound
    and buffer a warp, its own warps and launch bound, every sample taken
    by exactly one warp."""
    kp = k * (k + 1) // 2
    for S in SS + (4096,):
        g = chain_grad_geometry(S, k)
        assert g.rows == min(b for b in CHAIN_ROW_BOUNDS if b >= k)
        assert g.warps == CHAIN_GRAD_WARPS[g.rows]
        assert g.shared_bytes >= 4 * g.warps * (kp + 3 + g.rows)
        assert CHAIN_GRAD_BLOCKS_PER_SM[g.rows] * (g.shared_bytes + 1024) <= 228 * 1024
        assert 1 <= g.grid <= H100_SMS * CHAIN_GRAD_BLOCKS_PER_SM[g.rows]
        shares = warp_samples(g, S)
        assert [s for r in shares for s in r] == list(range(S))


@pytest.mark.parametrize("k,home", [(65, "shared"), (100, "shared"), (334, "shared"),
                                    (335, "workspace"), (400, "workspace")])
def test_adjoint_wide_geometry(k, home):
    """Past k = 64 a block a sample: the triangle, t, v and a column for
    each of its 4 warps in shared memory up to k = 334, past that in a
    global workspace; at most 16 blocks an SM and no more than S."""
    floats = k * (k + 1) // 2 + 6 * k
    for S in (1, 33, 4096):
        g = chain_grad_geometry(S, k)
        assert isinstance(g, WideChainGeometry) and g.threads == 128
        assert 1 <= g.grid <= min(S, 16 * H100_SMS)
        if home == "shared":
            assert g.workspace == 0 and 4 * floats <= g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES
            assert g.grid <= H100_SMS * (SM_SHARED_BYTES // (g.shared_bytes + 1024))
        else:
            assert g.shared_bytes == 0 and g.workspace == floats


def test_adjoint_geometry_matches_the_kernels_compiled_blocks():
    src = (Path(CSRC) / "logmvn_chain_grad.cu").read_text()
    compiled = re.search(r"#define K3G_GEOMETRY (\d+), (\d+), (\d+), (\d+)", src).groups()
    assert tuple(map(int, compiled)) == (
        CHAIN_GRAD_WARPS[32], CHAIN_GRAD_BLOCKS_PER_SM[32], CHAIN_GRAD_WARPS[64],
        CHAIN_GRAD_BLOCKS_PER_SM[64])
    assert "kWideWarps = kWideThreads / 32" in src and "kWideThreads = 128" in src


@pytest.mark.parametrize("S,k", [(0, 20), (10, 0)])
def test_adjoint_refuses_an_empty_problem(S, k):
    with pytest.raises(ValueError):
        chain_grad_geometry(S, k)
