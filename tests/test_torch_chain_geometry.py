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
    CHAIN_GRAD_ROW_BOUNDS,
    CHAIN_GRAD_SHARED_MAX_K,
    CHAIN_GRAD_WARPS,
    CHAIN_GRAD_WORK_BLOCKS_PER_SM,
    CHAIN_GRAD_WORK_WARPS,
    CHAIN_MAX_K,
    CHAIN_ROW_BOUNDS,
    CHAIN_WARPS,
    H100_SMS,
    SM_SHARED_BYTES,
    WIDE_CHAIN_WARPS,
    WideChainGeometry,
    chain_geometry,
    chain_grad_geometry,
    chain_grad_wide_floats,
)

SS = (1, 2, 31, 32, 33, 1001, 10_000)


def warp_samples(g, S, warps=None):
    """The samples of every warp of the grid, as the kernel splits them:
    warp w of T takes w S // T up to (w + 1) S // T (``warps`` a block, by
    default the geometry's)."""
    total = g.grid * (warps or g.warps)
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


@pytest.mark.parametrize("k", [1, 2, 8, 9, 16, 17, 20, 21, 24, 25, 32, 33, 48, 49, 63, 64])
def test_adjoint_geometry_is_launchable_and_covers_every_sample_once(k):
    """K3's adjoint (csrc/logmvn_chain_grad.cu) at k <= 64: the smallest
    compiled row bound that holds k, its warps and launch bound, a warp's
    two column buffers, triangle and alignment in its shared bytes, every
    sample taken by exactly one warp."""
    kp = k * (k + 1) // 2
    for S in SS + (4064, 4096):
        g = chain_grad_geometry(S, k)
        assert g.rows == min(b for b in CHAIN_GRAD_ROW_BOUNDS if b >= k)
        assert g.warps == CHAIN_GRAD_WARPS
        column = 32 * -(-g.rows // 32) + 4
        assert g.shared_bytes >= 4 * g.warps * (2 * column + kp + 3)
        assert g.shared_bytes % (16 * g.warps) == 0
        assert CHAIN_GRAD_BLOCKS_PER_SM[g.rows] * (g.shared_bytes + 1024) <= SM_SHARED_BYTES
        assert 1 <= g.grid <= H100_SMS * CHAIN_GRAD_BLOCKS_PER_SM[g.rows]
        shares = warp_samples(g, S)
        assert [s for r in shares for s in r] == list(range(S))


@pytest.mark.parametrize("k,home", [(65, "shared"), (100, "shared"),
                                    (CHAIN_GRAD_SHARED_MAX_K, "shared"),
                                    (CHAIN_GRAD_SHARED_MAX_K + 1, "workspace"),
                                    (400, "workspace")])
def test_adjoint_wide_geometry(k, home):
    """Past k = 64 a warp a sample: its buffer (F, u, the triangle) in
    shared memory, up to 8 warps a block and as many blocks an SM as fit,
    while a warp's buffer fits a block's shared bytes (k <= 335); past that
    4 warps a block on a global workspace.  Every sample taken by exactly
    one warp."""
    floats = chain_grad_wide_floats(k)
    assert floats >= 4 * (k + 1) + k + k * (k + 1) // 2 + 3
    for S in (1, 33, 4096):
        g = chain_grad_geometry(S, k)
        assert isinstance(g, WideChainGeometry) and g.threads % 32 == 0
        warps = g.threads // 32
        if home == "shared":
            assert 1 <= warps <= WIDE_CHAIN_WARPS and g.workspace == 0
            assert g.shared_bytes == 4 * warps * floats <= MAX_DYNAMIC_SHARED_BYTES
            per_sm = SM_SHARED_BYTES // (g.shared_bytes + 1024)
            assert 1 <= g.grid <= H100_SMS * per_sm
        else:
            assert warps == CHAIN_GRAD_WORK_WARPS and g.shared_bytes == 0
            assert g.workspace == warps * floats
            assert 1 <= g.grid <= H100_SMS * CHAIN_GRAD_WORK_BLOCKS_PER_SM
        shares = warp_samples(g, S, warps)
        assert [s for r in shares for s in r] == list(range(S))
    assert 4 * chain_grad_wide_floats(CHAIN_GRAD_SHARED_MAX_K + 1) > MAX_DYNAMIC_SHARED_BYTES


def test_adjoint_geometry_matches_the_kernels_compiled_blocks():
    """The .cu's warps, row bounds and launch bounds, its launcher's cases,
    the wide kernel's warps and buffers equal the Python constants."""
    src = (Path(CSRC) / "logmvn_chain_grad.cu").read_text()
    assert int(re.search(r"#define K3G_WARPS (\d+)", src).group(1)) == CHAIN_GRAD_WARPS
    pairs = [int(x) for x in
             re.search(r"#define K3G_ROWS_AND_BLOCKS ([\d, ]+)", src).group(1).split(",")]
    assert dict(zip(pairs[::2], pairs[1::2])) == CHAIN_GRAD_BLOCKS_PER_SM
    assert tuple(pairs[::2]) == CHAIN_GRAD_ROW_BOUNDS and CHAIN_GRAD_ROW_BOUNDS[-1] == CHAIN_MAX_K
    cases = [int(x) for x in re.findall(r"case (\d+): return launch<\1>", src)]
    default = re.search(r"default: return launch<(\d+)>", src).group(1)
    assert cases + [int(default)] == list(CHAIN_GRAD_ROW_BOUNDS)
    assert f"constexpr int kWideWarps = {WIDE_CHAIN_WARPS};" in src
    assert f"constexpr int kWorkWarps = {CHAIN_GRAD_WORK_WARPS};" in src
    # the buffers' sizes, evaluated as the .cu writes them
    wide = re.search(r"inline int wide_floats\(int k\) \{\s*return ([^;]+);", src).group(1)
    column = re.search(r"constexpr int col_floats\(int kmax\) \{ return ([^;]+); \}", src).group(1)
    for k in (65, 66, 67, 100, 335, 400):
        assert eval(wide.replace("/", "//"), {"k": k}) == chain_grad_wide_floats(k)
    for rows in CHAIN_GRAD_ROW_BOUNDS:
        assert eval(column.replace("/", "//"), {"kmax": rows}) == 32 * -(-rows // 32) + 4


@pytest.mark.parametrize("S,k", [(0, 20), (10, 0)])
def test_adjoint_refuses_an_empty_problem(S, k):
    with pytest.raises(ValueError):
        chain_grad_geometry(S, k)
