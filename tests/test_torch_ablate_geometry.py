"""K7's launch geometries and column map, which the wrappers pass to the
kernels of ``csrc/logmvn_ablate.cu``: the stage kernel runs K2's block at
``cap_geometry(S, N, k, k(k+1)/2)`` on the packed columns of the flat pair
basis; the flat chain takes every sample once, in one even wave
at the main path's S = 10,000.  The constants compiled into the sources
are held equal to the Python ones, the libraries' names cover the headers
the sources include, and the ablation builds apart from the user paths'
kernels.  The kernels themselves are held against their twins on the card
(tests/test_torch_kernels_gpu.py)."""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.ops.logmvn_pallas import _packed_maps as jax_packed_maps
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops._build import CSRC, MAX_DYNAMIC_SHARED_BYTES
from gpy_dla_detection_tpu_torch.ops.logmvn import pair_basis
from gpy_dla_detection_tpu_torch.ops.logmvn_ablate import (
    CHAIN_NODOT,
    ELEMENTWISE,
    ELEMENTWISE_NOLOG,
    FULL,
    MATMUL,
    STAGE_MAX_K,
    STAGES,
    logmvn_ablate,
    logmvn_ablate_packed,
    stage_geometry,
)
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    CAP_MAX_THREADS,
    CAP_TILE,
    CAP_WARP_COLUMNS,
    CAP_WARP_SAMPLES,
    CHAIN_MAX_K,
    CHAIN_ROW_BOUNDS,
    FLAT_CHAIN_BLOCKS_PER_SM,
    FLAT_CHAIN_WARPS,
    H100_SMS,
    SM_SHARED_BYTES,
    cap_geometry,
    flat_chain_geometry,
    flat_chain_stride,
    packed_flat_columns,
    packed_pair_basis,
)

STAGE_CODES = (ELEMENTWISE, ELEMENTWISE_NOLOG, MATMUL, FULL, CHAIN_NODOT)
SS = (1, 2, 31, 79, 80, 81, 1001, 10_000, 10_240)
KS = (1, 2, 4, 5, 16, 17, 20, 21, 24, 31, 32, 33, 41, 53, 64)


def _kernel_packed_coord(c, k):
    """The kernel's walk (packed_coord, which weighs matmul's sum): column
    j and row a of packed column c."""
    off, j = 0, 0
    while c >= off + k - j:
        off += k - j
        j += 1
    return j, j + c - off


@pytest.mark.parametrize("k", KS)
def test_packed_columns_follow_the_reference_packing(k):
    """Packed column r of the stage kernel's basis is flat column j k + a
    of ``Mp`` for the reference's (cols[r], rows[r]), both by the map the
    wrapper gathers with and by the kernel's walk (matmul's weights)."""
    cols, rows = jax_packed_maps(k)
    want = tuple(j * k + a for j, a in zip(cols, rows))
    assert packed_flat_columns(k) == want
    assert [_kernel_packed_coord(c, k) for c in range(len(cols))] == list(zip(cols, rows))
    # every upper entry (j, a >= j) of the flat matrix once
    assert sorted(want) == [j * k + a for j in range(k) for a in range(j, k)]


@pytest.mark.parametrize("k", [1, 2, 5, 20, 33])
def test_flat_sum_is_the_weighted_packed_sum(k):
    """matmul's sum of the flat B = w Mp over its k^2 columns equals the
    packed product's diagonal plus twice its off-diagonal, in float64."""
    rng = np.random.default_rng(k)
    N, S = 64, 7
    M = rng.normal(size=(N, k))
    Mp = (M[:, :, None] * M[:, None, :]).reshape(N, k * k)
    w = rng.uniform(0.5, 2.0, (S, N))
    packed = w @ Mp[:, list(packed_flat_columns(k))]
    cols, rows = jax_packed_maps(k)
    weight = np.where(np.asarray(cols) == np.asarray(rows), 1.0, 2.0)
    np.testing.assert_allclose(packed @ weight, (w @ Mp).sum(1), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("k", range(1, STAGE_MAX_K + 2))
def test_stage_geometry_is_k2s_at_the_packed_width(k):
    """Every stage launches at K2's geometry for the packed basis, or
    refuses what the block cannot hold; full and chain_nodot also fit
    their chain's buffers in the block's shared bytes."""
    kp = k * (k + 1) // 2
    for N in (17, 1280, 1281, 1664):
        for S in (1, 79, 80, 81, 10_000):
            try:
                want = cap_geometry(S, N, k, kp)
            except ValueError:
                want = None
            for stage in STAGE_CODES:
                if want is None or k > STAGE_MAX_K:
                    with pytest.raises(ValueError):
                        stage_geometry(S, N, k, stage)
                    continue
                rows = min(b for b in CHAIN_ROW_BOUNDS if b >= k)
                fits = 4 * (want.samples * (kp + k + 2) + rows) <= want.shared_bytes
                if stage in (FULL, CHAIN_NODOT) and not fits:
                    with pytest.raises(ValueError):
                        stage_geometry(S, N, k, stage)
                    continue
                assert stage_geometry(S, N, k, stage) == want


def test_stage_kernel_takes_k_up_to_53_at_the_main_path():
    """Every stage takes k = 1 to 53 at the main path's N = 1,280 (at
    least the k <= 31 the ablation took before) and refuses 54 (K2's
    384-thread block)."""
    for stage in STAGE_CODES:
        for k in range(1, 54):
            stage_geometry(10_000, 1280, k, stage)
        with pytest.raises(ValueError):
            stage_geometry(10_000, 1280, 54, stage)


def test_stage_geometry_at_the_main_path():
    """k = 20, S = 10,000: K2's own launch, 80 samples a block, 125 blocks,
    with the 80 samples' triangles, u and misc (74,240 bytes) within its
    134,144 shared bytes."""
    g = stage_geometry(10_000, 1280, 20, FULL)
    assert (g.samples, g.pixels, g.threads, g.columns, g.shared_bytes, g.grid) == (
        80, 32, 320, 256, 134_144, 125)
    assert 4 * 80 * (210 + 20 + 2) == 74_240


def block_samples(g, S):
    """The samples of every block, as the kernel splits them: block b of G
    takes b S // G up to (b + 1) S // G."""
    return [range(b * S // g.grid, (b + 1) * S // g.grid) for b in range(g.grid)]


@pytest.mark.parametrize("k", range(1, CHAIN_MAX_K + 1))
def test_flat_chain_geometry_covers_every_sample_once(k):
    kp = k * (k + 1) // 2
    for S in SS:
        g = flat_chain_geometry(S, k)
        assert g.rows == min(b for b in CHAIN_ROW_BOUNDS if b >= k)
        assert g.warps == FLAT_CHAIN_WARPS
        assert g.blocks_per_sm == FLAT_CHAIN_BLOCKS_PER_SM[g.rows]
        assert 32 <= 32 * g.warps <= 1024
        # the offset table, a chunk's buffers and the padding past its last
        # sample, in whole float4s, within the block's share of an SM
        assert g.shared_bytes >= 4 * (kp + g.chunk * flat_chain_stride(k) + g.rows)
        assert g.shared_bytes % 16 == 0
        assert g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES
        assert FLAT_CHAIN_BLOCKS_PER_SM[g.rows] * (g.shared_bytes + 1024) <= SM_SHARED_BYTES
        assert g.chunk >= 1
        shares = block_samples(g, S)
        assert [s for r in shares for s in r] == list(range(S))
        assert max(map(len, shares)) - min(map(len, shares)) <= 1
        assert all(len(r) > 0 for r in shares)
        assert 1 <= g.grid <= H100_SMS * FLAT_CHAIN_BLOCKS_PER_SM[g.rows]
        # a chunk never exceeds what a block needs
        assert g.chunk <= max(map(len, shares))


@pytest.mark.parametrize("k", range(1, CHAIN_MAX_K + 1))
def test_flat_chain_fills_the_card_in_one_even_wave(k):
    """S = 10,000: the same number of blocks on every SM, all at once, the
    blocks' samples within one of each other."""
    g = flat_chain_geometry(10_000, k)
    assert g.grid % H100_SMS == 0
    assert g.grid // H100_SMS <= FLAT_CHAIN_BLOCKS_PER_SM[g.rows]
    lens = [len(r) for r in block_samples(g, 10_000)]
    assert max(lens) - min(lens) <= 1


def test_flat_chain_geometry_at_the_main_path():
    """k = 20: 528 blocks of 8 warps, 4 an SM, each its 18 or 19 samples in
    one chunk; k = 64: 264 blocks, 2 an SM, chunks of 12."""
    assert flat_chain_geometry(10_000, 20) == (32, 8, 4, 19, 18_688, 528)
    assert flat_chain_geometry(10_000, 64) == (64, 8, 2, 12, 111_632, 264)


@pytest.mark.parametrize("k", [0, CHAIN_MAX_K + 1])
def test_flat_chain_refuses_k_beyond_the_row_bounds(k):
    with pytest.raises(ValueError):
        flat_chain_geometry(10_000, k)


def test_flat_chain_refuses_no_samples():
    with pytest.raises(ValueError):
        flat_chain_geometry(0, 20)


def _constexpr(src, name):
    return int(re.search(rf"constexpr (?:int|float) {name} = ([0-9.]+)", src).group(1))


def test_compiled_constants_equal_pythons():
    """The block's tile, warp and thread bound (logmvn_cap_block.cuh), the
    stage codes and the stage kernel's largest k (logmvn_ablate.cu) are
    the ones the Python geometry assumes.  (The flat chain's warps and
    blocks an SM are launch arguments that its launcher checks.)"""
    block = (Path(CSRC) / "logmvn_cap_block.cuh").read_text()
    assert _constexpr(block, "kTile") == CAP_TILE
    assert _constexpr(block, "kWarpSG") * CAP_TILE == CAP_WARP_SAMPLES
    assert _constexpr(block, "kWarpCG") * CAP_TILE == CAP_WARP_COLUMNS
    assert _constexpr(block, "kMaxThreads") == CAP_MAX_THREADS
    ablate = (Path(CSRC) / "logmvn_ablate.cu").read_text()
    assert _constexpr(ablate, "kStageMaxK") == STAGE_MAX_K
    codes = dict(re.findall(r"  (k[A-Za-z]+) = (\d),", ablate))
    assert [int(codes[n]) for n in ("kElementwise", "kElementwiseNoLog", "kMatmul",
                                    "kFull", "kChainNoDot")] == list(STAGE_CODES)
    # the odd sample stride of the flat chain
    assert "const int stride = per | 1;" in ablate
    assert all(flat_chain_stride(k) % 2 == 1 for k in range(1, 65))


def test_library_name_covers_every_included_header(tmp_path, monkeypatch):
    """Every header a source includes is hashed into each library's name,
    so an edit to K2's block or K3's warp chain builds new libraries."""
    sources = [src for srcs in _build.LIBRARIES.values() for src in srcs]
    for name in sources + list(_build.headers()):
        for inc in re.findall(r'#include "([^"]+)"', (Path(CSRC) / name).read_text()):
            assert inc in _build.headers(), (name, inc)
    assert set(_build.headers()) >= {"logmvn_cap_block.cuh", "logmvn_chain_warp.cuh"}
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", copy)
    before = {lib: _build.library_path(lib).name for lib in _build.LIBRARIES}
    for header in ("logmvn_cap_block.cuh", "logmvn_chain_warp.cuh"):
        (copy / header).write_text((copy / header).read_text() + "\n// edited\n")
        after = {lib: _build.library_path(lib).name for lib in _build.LIBRARIES}
        assert all(after[lib] != before[lib] for lib in _build.LIBRARIES)
        before = after


def test_ablation_builds_apart_from_the_user_paths(tmp_path, monkeypatch):
    """The ablation source is the ablation library's alone: every other
    source is in the user paths' library once, and an edit to the
    ablation source leaves that library's name (and build) as it was."""
    assert _build.LIBRARIES["ablate"] == ("logmvn_ablate.cu",)
    main = _build.LIBRARIES["kernels"]
    assert "logmvn_ablate.cu" not in main and len(set(main)) == len(main)
    assert sorted(main + ("logmvn_ablate.cu",)) == sorted(p.name for p in Path(CSRC).glob("*.cu"))
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", copy)
    kernels, ablate = _build.library_path("kernels"), _build.library_path("ablate")
    assert kernels.name.startswith("libgpydla_kernels_")
    assert ablate.name.startswith("libgpydla_ablate_")
    (copy / "logmvn_ablate.cu").write_text((copy / "logmvn_ablate.cu").read_text() + "\n// x\n")
    assert _build.library_path("kernels") == kernels
    assert _build.library_path("ablate") != ablate


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_packed_entry_computes_the_flat_entrys_function(stage):
    """On the CPU, every stage on the packed basis equals the stage on the
    flat basis it holds (the twin on the flat basis rebuilt from the
    packed columns): the function the timings time is the contract's."""
    rng = np.random.default_rng(3)
    S, N, k = 6, 40, 5
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    M = f32(rng.normal(size=(N, k)) * 0.3)
    rows = f32(np.stack([1 + 0.1 * rng.normal(size=N), np.ones(N), rng.uniform(0.01, 0.05, N),
                         rng.uniform(0.02, 0.1, N), rng.uniform(size=N) > 0.1]))
    A = f32(np.exp(-rng.random((S, N))))
    want = logmvn_ablate(stage, rows, M, pair_basis(M), A)
    got = logmvn_ablate_packed(stage, rows, M, packed_pair_basis(M), A)
    assert torch.equal(got, want)


def test_packed_entry_refuses_the_flat_basis():
    M = torch.ones((8, 3))
    with pytest.raises(ValueError):
        logmvn_ablate_packed("matmul", torch.ones((5, 8)), M, pair_basis(M), torch.ones((2, 8)))
