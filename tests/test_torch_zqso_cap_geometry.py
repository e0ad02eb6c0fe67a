"""zqso_cap's launch geometry and walk, on the CPU.

The kernel (``csrc/zqso_cap.cu``) cannot run here, so its plan is checked
and its walk replayed in numpy: ``zqso_cap_geometry`` (whole warps, shared
memory within Hopper's 227 KB, tiles that cover every pixel,
``ZQSO_CAP_WAVES`` waves of blocks at the main path's shapes), the pieces of the triangle (every row
once, at most ``ZQSO_CAP_PIECE_CAP`` accumulators a thread), the packed
index each thread stores to (K3's layout), the ``.cu``'s constants equal to
Python's, and the kernel's loops (redshift runs, pixel tiles, sub-tiles,
band windows of ``ZQSO_CAP_BAND_ROWS`` rows) replayed on the twin's float32
pixel terms: every pixel in a window taken once, its two table rows inside
the staged band, and the sums equal to the twin's.  The kernel itself is
held against its twin on the card (tests/test_torch_kernels_gpu.py).
"""

import re

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu_torch.data import synthetic as TSyn
from gpy_dla_detection_tpu_torch.models import zqso as TZ
from gpy_dla_detection_tpu_torch.ops._build import CSRC, MAX_DYNAMIC_SHARED_BYTES
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    H100_SMS,
    ZQSO_CAP_BAND_ROWS,
    ZQSO_CAP_BLOCKS_PER_SM,
    ZQSO_CAP_MAX_K,
    ZQSO_CAP_PIECE_CAP,
    ZQSO_CAP_ROW_BOUNDS,
    ZQSO_CAP_SUB,
    ZQSO_CAP_TILES,
    ZQSO_CAP_WAVES,
    _packed_maps,
    zqso_cap_geometry,
    zqso_cap_pieces,
    zqso_cap_reference,
)
from gpy_dla_detection_tpu_torch.params import ZParameters

SOURCE = (CSRC / "zqso_cap.cu").read_text()


def _cu_int(name: str) -> int:
    return int(re.search(rf"constexpr (?:int|float) {name} = ([0-9]+)", SOURCE).group(1))


def test_the_sources_constants_are_pythons():
    assert int(re.search(r"#define ZQSO_CAP_SUB (\d+)", SOURCE).group(1)) == ZQSO_CAP_SUB
    assert _cu_int("kBandRows") == ZQSO_CAP_BAND_ROWS
    assert _cu_int("kPieceCap") == ZQSO_CAP_PIECE_CAP
    blocks = re.search(r"#define ZQSO_CAP_BLOCKS (\d+), (\d+)", SOURCE).groups()
    assert (int(blocks[0]), int(blocks[1])) == (ZQSO_CAP_BLOCKS_PER_SM[20],
                                                ZQSO_CAP_BLOCKS_PER_SM[32])
    assert re.search(r"#define ZQSO_CAP_ABLATE 0\n", SOURCE)
    assert all(f"kmax == {b}) return launch<{b}>" in SOURCE for b in ZQSO_CAP_ROW_BOUNDS)
    assert "stride = KMAX % 8 == 4 ? KMAX : KMAX + 4;" in SOURCE


@pytest.mark.parametrize("rows", ZQSO_CAP_ROW_BOUNDS)
def test_pieces_cover_the_triangle_once_within_the_cap(rows):
    lo = zqso_cap_pieces(rows)
    assert lo[0] == 0 and lo[-1] == rows and all(a < b for a, b in zip(lo, lo[1:]))
    held = [sum(a + 2 for a in range(a0, a1)) for a0, a1 in zip(lo, lo[1:])]
    assert max(held) <= ZQSO_CAP_PIECE_CAP
    assert sum(held) == rows * (rows + 1) // 2 + rows
    if rows == 20:  # the main path: two warps' pieces of 119 and 111
        assert lo == (0, 14, 20) and held == [119, 111]


@pytest.mark.parametrize("k", range(1, ZQSO_CAP_MAX_K + 1))
def test_each_entry_stores_to_k3s_packed_index(k):
    cols, rows = _packed_maps(k)
    got = [j * k - j * (j - 1) // 2 + a - j for j, a in zip(cols, rows)]
    assert got == list(range(k * (k + 1) // 2))


@pytest.mark.parametrize("k", [1, 5, 20, 21, 32])
@pytest.mark.parametrize("C", [1, 37, 1_000, 4_000, 10_000])
@pytest.mark.parametrize("P", [1, 33, 1_286, 5_632])
def test_geometry_is_launchable_and_covers_the_pixels(k, C, P):
    g = zqso_cap_geometry(C, P, k)
    assert g.rows == next(b for b in ZQSO_CAP_ROW_BOUNDS if k <= b)
    pieces = len(zqso_cap_pieces(g.rows)) - 1
    assert g.threads == g.redshifts * pieces and g.threads % 32 == 0
    assert g.redshifts % 32 == 0 and g.threads <= 1024
    assert g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES
    assert ZQSO_CAP_BLOCKS_PER_SM[g.rows] * (g.shared_bytes + 1024) <= 228 * 1024
    assert g.tile_pixels % ZQSO_CAP_SUB == 0
    assert g.tiles == -(-P // g.tile_pixels) and (g.tiles - 1) * g.tile_pixels < P
    assert g.grid == -(-C // g.redshifts) * g.tiles
    # the widest tile that gives the waves of blocks at the launch bound,
    # else the narrowest
    target = ZQSO_CAP_WAVES * H100_SMS * ZQSO_CAP_BLOCKS_PER_SM[g.rows]
    runs = -(-C // g.redshifts)
    wider = [t for t in ZQSO_CAP_TILES if t > g.tile_pixels]
    assert all(runs * -(-P // t) < target for t in wider)
    if g.tile_pixels in ZQSO_CAP_TILES[:-1]:
        assert g.grid >= target
    if C == 10_000 and P == 5_632 and k <= 20:  # the main path
        assert g.tile_pixels == 256 and g.grid >= target
    # the band's row stride (the .cu's G::stride) and the tiles' partial sums
    assert g.stride % 8 == 4 and g.rows <= g.stride < g.rows + 8
    assert g.workspace == (g.tiles, k * (k + 1) // 2 + k + 3, C)


@pytest.mark.parametrize("tile, sub", [(64, 64), (1024, 16), (128, ZQSO_CAP_SUB)])
def test_geometry_takes_a_tile_and_sub_tile_as_given(tile, sub):
    g = zqso_cap_geometry(1_000, 5_632, 20, tile=tile, sub=sub)
    shipped = zqso_cap_geometry(1_000, 5_632, 20)
    assert g.tile_pixels == tile and g.tiles == -(-5_632 // tile)
    assert g.grid == -(-1_000 // g.redshifts) * g.tiles
    assert g.workspace == (g.tiles, 233, 1_000)
    assert g.shared_bytes - shipped.shared_bytes == (sub - ZQSO_CAP_SUB) * (g.redshifts * 16 + 40)


def test_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="1 <= k <= 32"):
        zqso_cap_geometry(10, 100, ZQSO_CAP_MAX_K + 1)
    with pytest.raises(ValueError, match="1 <= k"):
        zqso_cap_geometry(10, 100, 0)
    with pytest.raises(ValueError, match="empty"):
        zqso_cap_geometry(0, 100, 20)


def _terms(z, med, lo_obs, hi_obs, wl, flux, noise, valid, rw, mu, params):
    """The kernel's pixel terms in float32, as its first phase forms them:
    (row, f, d_inv, d_inv delta) with row -1 outside the window."""
    f32 = np.float32
    rest = wl[None, :] / (1.0 + z[:, None])
    ind = ((rest >= params.min_lambda) & (rest <= params.max_lambda)
           & (wl[None, :] > lo_obs[:, None]) & (wl[None, :] < hi_obs[:, None]) & valid[None, :])
    x0, dx = rw[0], f32(rw[1] - rw[0])
    t = (rest.astype(f32) - x0) / dx
    idx = np.clip(np.floor(t).astype(np.int64), 0, rw.shape[0] - 2)
    f = np.clip(t - idx.astype(f32), f32(0), f32(1))
    mu_i = mu[idx] * (f32(1) - f) + mu[idx + 1] * f
    with np.errstate(divide="ignore", invalid="ignore"):
        y = flux[None, :] / med[:, None]
        v = noise[None, :] / (med * med)[:, None]
        dinv = f32(1) / v
        delta = y - mu_i
        wd = dinv * delta
    return np.where(ind, idx, -1), f, dinv, wd, ind


def replay(z, med, lo_obs, hi_obs, wl, flux, noise, valid, rw, mu, M, params):
    """The kernel's walk over its blocks, tiles, sub-tiles and band windows
    in numpy (float64 sums of the float32 terms and products): B, u, how
    many times each (z, pixel) was taken, and the window mask."""
    C, P, (R, k) = z.shape[0], wl.shape[0], M.shape
    g = zqso_cap_geometry(C, P, k)
    row, f, dinv, wd, ind = _terms(z, med, lo_obs, hi_obs, wl, flux, noise, valid, rw, mu, params)
    kp = k * (k + 1) // 2
    cols, rows_ = _packed_maps(k)
    part = np.zeros((g.tiles, kp + k, C))
    taken = np.zeros((C, P), np.int64)
    f32 = np.float32
    for z0 in range(0, C, g.redshifts):
        zs = slice(z0, min(C, z0 + g.redshifts))
        for tile in range(g.tiles):
            p_end = min(P, (tile + 1) * g.tile_pixels)
            for sub in range(tile * g.tile_pixels, p_end, ZQSO_CAP_SUB):
                ps = slice(sub, min(p_end, sub + ZQSO_CAP_SUB))
                r = row[zs, ps]
                if not (r >= 0).any():
                    continue
                first, last = r[r >= 0].min(), r[r >= 0].max()
                for w0 in range(first, last + 1, ZQSO_CAP_BAND_ROWS - 1):
                    staged = min(ZQSO_CAP_BAND_ROWS, R - w0)
                    rel = r - w0
                    take = (rel >= 0) & (rel < ZQSO_CAP_BAND_ROWS - 1)
                    assert (rel[take] + 1 < staged).all()  # both rows in the band
                    taken[zs, ps] += take
                    zi, pi = np.nonzero(take)
                    zi, pi = zi + zs.start, pi + ps.start
                    ri, fi = row[zi, pi], f[zi, pi]
                    m = M[ri] * (f32(1) - fi)[:, None] + M[ri + 1] * fi[:, None]
                    dm = m * dinv[zi, pi][:, None]
                    prod = m[:, list(rows_)].astype(np.float64) * dm[:, list(cols)]
                    np.add.at(part[tile, :kp].T, zi, prod)
                    np.add.at(part[tile, kp:].T, zi, m.astype(np.float64) * wd[zi, pi][:, None])
    return part.sum(0)[:kp].T, part.sum(0)[kp:].T, taken, ind


def _linear_spectrum(P_real=5_600, P=5_632, shuffle=False, seed=4):
    """DESI's linear 0.8 A grid from 3,600 A with a noisy flat continuum,
    padded; with ``shuffle`` the pixels in a random order (the band then
    spans the table)."""
    rng = np.random.default_rng(seed)
    wl = 3600.0 + 0.8 * np.arange(P_real)
    flux = 1.0 + 0.1 * rng.normal(size=P_real)
    noise = rng.uniform(0.005, 0.02, P_real)
    mask = rng.uniform(size=P_real) < 0.05
    if shuffle:
        order = rng.permutation(P_real)
        wl, flux, noise, mask = wl[order], flux[order], noise[order], mask[order]
    return TZ.prepare_z_spectrum(wl, flux, noise, mask, P)


@pytest.mark.parametrize("case", ["fine_grid", "coarse_grid", "unsorted", "k21_ragged"])
def test_replayed_walk_takes_every_pixel_once_and_sums_the_twins_inputs(case):
    """The walk at the main path's grid step (4.02e-4 in z: one band
    window a sub-tile), at a coarse grid (0.02: several windows), on
    unsorted wavelengths (windows across the table) and at k = 21 on a
    ragged chunk (five pieces, 32 redshifts a block)."""
    k = 21 if case == "k21_ragged" else 20
    C = {"fine_grid": 150, "coarse_grid": 70, "unsorted": 40, "k21_ragged": 45}[case]
    step = {"fine_grid": 4.02e-4, "coarse_grid": 0.02, "unsorted": 0.05, "k21_ragged": 0.01}[case]
    learned = TSyn.synthetic_z_learned_model(0, k).to("cpu", torch.float32)
    spec = TZ.device_spectrum(_linear_spectrum(shuffle=case == "unsorted"), "cpu",
                              torch.float32)
    params = ZParameters(k=k)
    z = torch.as_tensor(2.2 + step * np.arange(C))
    wl = spec.wavelengths
    hi = torch.minimum(params.max_lambda * (1.0 + z), torch.max(torch.where(spec.valid, wl,
                                                                            -np.inf)))
    lo = torch.maximum(params.min_lambda * (1.0 + z), torch.min(torch.where(spec.valid, wl,
                                                                            np.inf)))
    med = TZ._normalization_median(TZ._sorted_flux_view(spec), z[:, None], lo[:, None],
                                   hi[:, None], params)
    args = (z, med, lo, hi, wl, spec.flux, spec.noise_variance, spec.valid,
            learned.rest_wavelengths, learned.mu, learned.M)
    B, u, misc = zqso_cap_reference(*args, params.min_lambda, params.max_lambda)
    rB, ru, taken, ind = replay(*[a.numpy() for a in args], params)
    np.testing.assert_array_equal(taken, ind.astype(np.int64))
    assert ind.sum() > 0.5 * C * 5_000 if case == "fine_grid" else ind.any()
    for got, want in ((rB, B.numpy()), (ru, u.numpy())):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2e-6 * scale, np.abs(got - want).max() / scale
