"""K5's and K6's launch geometry (``tail_geometry``), which the wrappers
pass to the kernels, and the walk each warp makes (``tail_items``, the
``Cursor`` of ``csrc/absorption_stencil.cuh``): every output pixel of
every row computed exactly once, each from items that hold its 7 input
pixels and no pixel past the row; the warps' shares even, one even wave at
the catalog's S = 10,000 and a lone block's worth at 1 and 16 rows; a
``ValueError`` for what the kernels do not take.  The constants compiled
into the CUDA sources are held equal to the Python ones.  The kernels
themselves are held against their twins on the card
(tests/test_torch_kernels_gpu.py)."""

import re
from pathlib import Path

import pytest

from gpy_dla_detection_tpu_torch.ops._build import CSRC, headers
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import H100_SMS
from gpy_dla_detection_tpu_torch.ops.voigt import CHUNK, FAST_WINDOW
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    K56_BLOCKS_PER_SM,
    K56_CHUNK,
    K56_DEPTH,
    K56_PIXELS,
    K56_WARPS,
    tail_chunks,
    tail_geometry,
    tail_items,
)

HALO = 6
# rows: a lone row, the MCMC half-steps' 16 and 20, odd counts, the
# catalog's 10,000; P: one output pixel, one chunk and its halo, the CIV
# head's 774, the catalog's 1,286 (K6's P of 1,408 padded), the odd 1,287,
# the LLS search's 1,670
SS = (1, 2, 16, 20, 33, 1001, 10_000)
PS = (7, 8, 261, 262, 263, 774, 1286, 1287, 1670)


def warp_runs(g, S, P):
    """Per warp of the grid, its run of output chunks of the rows'
    sequence: warp w of T takes chunks w C // T up to (w + 1) C // T."""
    total = g.grid * g.warps
    C = S * tail_chunks(P)
    return [(w * C // total, (w + 1) * C // total) for w in range(total)]


def emitted(items, P):
    """The output chunks a warp's walk stores, as the kernel does: an item
    that does not open a row piece completes the previous chunk; and, for
    each, the input pixels its items hold (the full item's chunk, the next
    item's first 6 pixels or whole chunk), cut at the row's P."""
    out, first = [], True
    for i, (s, c, halo) in enumerate(items):
        if not first:
            ps, pc, _ = items[i - 1]
            assert (ps, pc) == (s, c - 1)  # the previous item is this row's previous chunk
            held = set(range(pc * K56_CHUNK, (pc + 1) * K56_CHUNK))
            held |= set(range(c * K56_CHUNK, c * K56_CHUNK + (HALO if halo else K56_CHUNK)))
            out.append((s, c - 1, {p for p in held if p < P}))
        first = halo
    return out


@pytest.mark.parametrize("P", PS)
def test_geometry_computes_every_row_and_output_pixel_once(P):
    n_out, nc = P - HALO, tail_chunks(P)
    assert (nc - 1) * K56_CHUNK < n_out <= nc * K56_CHUNK
    for S in SS:
        g = tail_geometry(S, P)
        assert g.warps == K56_WARPS
        # a ring of two chunks a warp, within 48 KB a block; the launch
        # bound's blocks within an SM's 228 KB
        assert g.shared_bytes == 4 * K56_WARPS * 2 * K56_CHUNK <= 48 * 1024
        assert K56_BLOCKS_PER_SM * (g.shared_bytes + 1024) <= 228 * 1024
        assert 1 <= g.grid <= H100_SMS * K56_BLOCKS_PER_SM
        assert g.grid <= H100_SMS or g.grid % H100_SMS == 0
        runs = warp_runs(g, S, P)
        assert [k for k0, k1 in runs for k in range(k0, k1)] == list(range(S * nc))
        lengths = [k1 - k0 for k0, k1 in runs]
        assert max(lengths) - min(lengths) <= 1
        seen = []
        for k0, k1 in runs:
            items = tail_items(k0, k1, P)
            # the kernel's count of its items: every output chunk's full
            # item and one halo item a row piece
            assert len(items) == ((k1 - k0) + ((k1 - 1) // nc - k0 // nc + 1) if k1 > k0 else 0)
            for s, c, pixels in emitted(items, P):
                first_q = c * K56_CHUNK
                last_q = min(n_out, first_q + K56_CHUNK) - 1
                # each output's 7 inputs are held, none past the row
                assert set(range(first_q, last_q + HALO + 1)) <= pixels
                assert max(pixels) <= P - 1
                seen.append((s, c))
        assert seen == [(s, c) for s in range(S) for c in range(nc)]


@pytest.mark.parametrize("P", [774, 1286, 1670])
def test_catalog_rows_fill_the_card_in_one_even_wave(P):
    """S = 10,000 on 132 SMs: every SM holds the same number of blocks, all
    at once; every warp has the same chunks to one, and every SM its even
    share to one a block."""
    g = tail_geometry(10_000, P)
    assert g.grid % H100_SMS == 0 and g.grid // H100_SMS == K56_BLOCKS_PER_SM
    shares = [k1 - k0 for k0, k1 in warp_runs(g, 10_000, P)]
    assert max(shares) - min(shares) == 1
    per_block = [sum(shares[b * g.warps:(b + 1) * g.warps]) for b in range(g.grid)]
    per_sm = [sum(per_block[b::H100_SMS]) for b in range(H100_SMS)]
    mean = 10_000 * tail_chunks(P) / H100_SMS
    assert max(per_sm) <= mean + K56_BLOCKS_PER_SM and min(per_sm) >= mean - K56_BLOCKS_PER_SM


@pytest.mark.parametrize("S, grid", [(1, 1), (16, 10), (20, 13)])
def test_few_rows_take_a_block_per_warps_chunks(S, grid):
    """A lone row and the MCMC half-steps' 16 and 20 rows of P = 1,286: a
    block for every 8 of their 5 chunks a row, a chunk a warp at most, so
    no warp walks more than a chunk and its halo."""
    g = tail_geometry(S, 1286)
    assert g.grid == grid
    assert max(k1 - k0 for k0, k1 in warp_runs(g, S, 1286)) == 1


def test_main_path_geometry():
    """P = 1,286: 5 chunks of 256 pixels a row; 4 blocks of 8 warps an SM
    (528 blocks, 11 or 12 chunks a warp), 16 KB of rings a block."""
    assert tail_chunks(1286) == 5 and tail_chunks(1670) == 7 and tail_chunks(774) == 3
    assert tail_chunks(7) == 1 and tail_chunks(262) == 1 and tail_chunks(263) == 2
    assert tail_geometry(10_000, 1286) == (8, 16384, 528)
    assert tail_geometry(10_000, 1286, sms=100).grid == 400


@pytest.mark.parametrize("S, P", [(0, 1286), (10, 6), (10, 0), (2**31 // 5 + 1, 1286)])
def test_what_the_kernels_do_not_take_is_refused(S, P):
    with pytest.raises(ValueError):
        tail_geometry(S, P)


def _compiled(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_geometry_matches_the_kernels_compiled_constants():
    stencil = (Path(CSRC) / "absorption_stencil.cuh").read_text()
    compiled = re.search(r"#define K56_GEOMETRY (\d+), (\d+), (\d+), (\d+)", stencil).groups()
    assert tuple(map(int, compiled)) == (K56_PIXELS, K56_DEPTH, K56_WARPS, K56_BLOCKS_PER_SM)
    assert K56_CHUNK == 32 * K56_PIXELS
    windowed = (Path(CSRC) / "absorption_windowed.cu").read_text()
    assert _compiled(windowed, "kWindowChunk") == CHUNK
    assert _compiled(windowed, "kWindow") == FAST_WINDOW
    # a lane's pixels lie wholly inside or outside a window
    assert CHUNK % K56_PIXELS == 0 and FAST_WINDOW % K56_PIXELS == 0
    # both kernels share the header, which the library's name hashes
    for src in ("absorption_tail.cu", "absorption_windowed.cu"):
        assert '#include "absorption_stencil.cuh"' in (Path(CSRC) / src).read_text()
    assert "absorption_stencil.cuh" in headers()
