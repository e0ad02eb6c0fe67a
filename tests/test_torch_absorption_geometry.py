"""K1's launch geometry (``k1_geometry``), which the wrapper passes to the
kernel: every chunk of every sample row taken by exactly one warp, the
warps' shares even, one even wave at the main path's S = 10,000,
the rings within the block's 48 KB, and a ``ValueError`` for what the
kernel does not take.  The constants compiled into
``csrc/absorption_all.cu`` (its geometry and its line table's layout) are
held equal to the Python ones.  The kernel itself is held against its twin
on the card (tests/test_torch_kernels_gpu.py)."""

import re
from pathlib import Path

import numpy as np
import pytest

from gpy_dla_detection_tpu_torch import constants as C
from gpy_dla_detection_tpu_torch.ops import voigt_kernels as V
from gpy_dla_detection_tpu_torch.ops._build import CSRC
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import H100_SMS
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    K1_BLOCKS_PER_SM,
    K1_CHUNK,
    K1_LINE_STRIDE,
    K1_MAX_FAMILIES,
    K1_MAX_LINES,
    K1_PIXELS,
    K1_TABLE_HEADER,
    K1_WARPS,
    k1_chunks,
    k1_geometry,
)

SS = (1, 2, 33, 1001, 10_000)
PS = (7, 8, 134, 135, 301, 1286, 1670)


def warp_chunks(g, S, P):
    """Per warp of the grid, its chunks of the rows' sequence, as the kernel
    splits them: warp w of T takes chunks w C // T up to (w + 1) C // T."""
    total = g.grid * g.warps
    C = S * k1_chunks(P)
    return [range(w * C // total, (w + 1) * C // total) for w in range(total)]


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("F", [1, 2, 3, K1_MAX_FAMILIES])
def test_geometry_covers_every_row_and_pixel_once(P, F):
    n_out = P - 6
    nc = k1_chunks(P)
    # chunks of 128 output pixels from 0, whose last one reaches the row's
    # last output pixel
    assert (nc - 1) * K1_CHUNK < n_out <= nc * K1_CHUNK
    for S in SS:
        g = k1_geometry(S, P, F)
        assert g.warps == K1_WARPS
        # two chunks of exp(-nhi tau) a family a warp, within 48 KB a block,
        # and the launch bound's blocks within an SM's 228 KB
        assert g.shared_bytes == 4 * F * K1_WARPS * 2 * K1_CHUNK <= 48 * 1024
        assert K1_BLOCKS_PER_SM * (g.shared_bytes + 1024) <= 228 * 1024
        assert 1 <= g.grid <= H100_SMS * K1_BLOCKS_PER_SM
        assert g.grid <= H100_SMS or g.grid % H100_SMS == 0
        # every row's every chunk once, the warps' shares within one chunk
        shares = warp_chunks(g, S, P)
        assert [k for r in shares for k in r] == list(range(S * nc))
        assert max(map(len, shares)) - min(map(len, shares)) <= 1
        # no block without work
        assert all(sum(map(len, shares[b * g.warps:(b + 1) * g.warps])) > 0
                   for b in range(g.grid))


@pytest.mark.parametrize("P", [1286, 1670])
def test_main_path_fills_the_card_in_one_even_wave(P):
    """S = 10,000 on 132 SMs: every SM holds the same number of blocks, all
    at once; every warp has the same chunks to one, and every SM its even
    share to one a block: no thin last wave."""
    g = k1_geometry(10_000, P, 2)
    assert g.grid % H100_SMS == 0 and g.grid // H100_SMS == K1_BLOCKS_PER_SM
    shares = [len(r) for r in warp_chunks(g, 10_000, P)]
    assert max(shares) - min(shares) == 1
    per_block = [sum(shares[b * g.warps:(b + 1) * g.warps]) for b in range(g.grid)]
    # blocks b, b + 132, ... share an SM
    per_sm = [sum(per_block[b::H100_SMS]) for b in range(H100_SMS)]
    mean = 10_000 * k1_chunks(P) / H100_SMS
    assert max(per_sm) <= mean + K1_BLOCKS_PER_SM and min(per_sm) >= mean - K1_BLOCKS_PER_SM


def test_main_path_geometry():
    """P = 1,286, F = 2: 10 chunks a row, 4 blocks of 8 warps an SM (528
    blocks, 23 or 24 chunks a warp), 16 KB of rings a block; a single row's
    10 chunks take two blocks."""
    assert k1_chunks(1286) == 10 and k1_chunks(1670) == 13 and k1_chunks(7) == 1
    assert k1_geometry(10_000, 1286, 2) == (8, 16384, 528)
    assert k1_geometry(10_000, 1286, 2, sms=100).grid == 400
    assert k1_geometry(1, 1286, 2) == (8, 16384, 2)


@pytest.mark.parametrize("S, P, F", [(0, 1286, 2), (10, 6, 2), (10, 1286, 0),
                                     (10, 1286, K1_MAX_FAMILIES + 1)])
def test_what_the_kernel_does_not_take_is_refused(S, P, F):
    with pytest.raises(ValueError):
        k1_geometry(S, P, F)


def test_lines_beyond_the_table_are_refused():
    with pytest.raises(ValueError):
        V._kernel_constants(K1_MAX_LINES + 1)
    with pytest.raises(ValueError):
        V._kernel_constants(0)


def _compiled(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_geometry_and_table_match_the_kernels_compiled_constants():
    src = (Path(CSRC) / "absorption_all.cu").read_text()
    compiled = re.search(r"#define K1_GEOMETRY (\d+), (\d+), (\d+)", src).groups()
    assert tuple(map(int, compiled)) == (K1_PIXELS, K1_WARPS, K1_BLOCKS_PER_SM)
    # the shipped kernel has every stage (the sweep's ablations clear one)
    assert re.search(r"#define K1_STAGES (\d+)", src).group(1) == "7"
    assert _compiled(src, "kMaxFamilies") == K1_MAX_FAMILIES
    assert _compiled(src, "kLinesAt") == K1_TABLE_HEADER
    assert _compiled(src, "kLineStride") == K1_LINE_STRIDE
    assert _compiled(src, "kMaxLines") == K1_MAX_LINES == len(C.LYMAN_WAVELENGTHS_A)
    assert _compiled(src, "kTapsAt") == V._TAB_TAPS
    assert _compiled(src, "kWeiAt") == V._TAB_WEI
    assert _compiled(src, "kDisk") == V._LINE_DISK
    assert _compiled(src, "kWing") == V._LINE_WING


def test_table_holds_the_twins_constants():
    """The table the kernel reads carries the twin's float32 constants, and
    the Weideman rational's per-line terms in the twin's rounding."""
    f = np.float32
    tab = V._kernel_table(K1_MAX_LINES)
    consts = V._kernel_constants(K1_MAX_LINES)
    assert tab.dtype == np.float32 and tab.size == K1_TABLE_HEADER + K1_MAX_LINES * K1_LINE_STRIDE
    assert tab[0] == f(consts["inv"]) and tab[1] == f(consts["c_cgs"])
    np.testing.assert_array_equal(tab[8:15], np.asarray(C.INSTRUMENT_PROFILE, f))
    L = f(V._WEIDEMAN_L32)
    assert tab[3] == f(2.0) * L
    for l, line in enumerate(consts["lines"]):
        rec = tab[K1_TABLE_HEADER + l * K1_LINE_STRIDE:][:K1_LINE_STRIDE]
        y = f(line["y"])
        assert tuple(rec[:4]) == (f(line["lam"]), f(line["amp"]), y, f(line["y2"]))
        assert rec[5] == L + y and rec[6] == (L + y) * (L + y)
        assert rec[7] == (L - y) * (L + y) and rec[8] == f(2.0) * (L + y)
        np.testing.assert_array_equal(rec[9:26], np.asarray(line["cd"], f))
        np.testing.assert_array_equal(rec[26:37], np.asarray(line["cw"], f))
