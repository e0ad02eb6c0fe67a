"""K2's launch geometry (``cap_geometry``), which the wrapper passes to the
kernel and the kernel's launcher checks: whole warps within the block's
limits, shared memory within Hopper's 227 KB, tiles that cover every
sample and column, and one wave at the main path's S = 10,000.  The
kernel itself is held against its twin on the card
(tests/test_torch_kernels_gpu.py)."""

import pytest

from gpy_dla_detection_tpu_torch.ops._build import MAX_DYNAMIC_SHARED_BYTES
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    CAP_MAX_THREADS,
    CAP_WARP_COLUMNS,
    CAP_WARP_SAMPLES,
    H100_SMS,
    cap_geometry,
)

NS = (1, 31, 768, 1280, 1664)
SS = (1, 79, 80, 81, 10_000, 10_001)


@pytest.mark.parametrize("basis", ["packed", "flat"])
@pytest.mark.parametrize("k", range(1, 25))
def test_geometry_is_launchable_and_covers_the_problem(k, basis):
    kp = k * (k + 1) // 2 if basis == "packed" else k * k
    for N in NS:
        for S in SS:
            for n_extra in (0, 3):
                g = cap_geometry(S, N, k, kp, n_extra)
                assert g.threads % 32 == 0 and 32 <= g.threads <= min(1024, CAP_MAX_THREADS)
                assert g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES
                assert g.samples % CAP_WARP_SAMPLES == 0
                assert g.pixels in (16, 32)
                assert g.columns % CAP_WARP_COLUMNS == 0
                assert g.columns >= kp + k
                assert g.samples * g.grid >= S > g.samples * (g.grid - 1)
                # the block's warps of 2 x 16 register tiles
                warps = (g.samples // CAP_WARP_SAMPLES) * (g.columns // CAP_WARP_COLUMNS)
                assert g.threads == 32 * warps


@pytest.mark.parametrize("N", [768, 1280, 1664])
@pytest.mark.parametrize("n_extra", [0, 3])
def test_main_path_fills_the_card_in_one_wave(N, n_extra):
    """k = 20 packed at S = 10,000: 80 samples a block, 125 blocks on the
    132 SMs, no tail; 10 warps (320 threads), 134,144 / 210,944 shared
    bytes."""
    g = cap_geometry(10_000, N, 20, 210, n_extra)
    assert g.grid <= H100_SMS
    assert g.grid >= 0.9 * H100_SMS
    assert (g.samples, g.pixels, g.threads, g.columns) == (80, 32, 320, 256)
    assert g.shared_bytes == (210_944 if n_extra else 134_144)


@pytest.mark.parametrize("N", [768, 1280, 1664])
@pytest.mark.parametrize("n_extra", [0, 1, 2, 3])
def test_int16_storage_keeps_the_main_path_geometry(N, n_extra):
    """Sample streams staged as int16 codes: the same block and one wave,
    in half the streams' shared bytes (80 samples x 40 codes x 2 buffers a
    stream)."""
    g32 = cap_geometry(10_000, N, 20, 210, n_extra)
    g16 = cap_geometry(10_000, N, 20, 210, n_extra, elem=2)
    assert g16._replace(shared_bytes=0) == g32._replace(shared_bytes=0)
    assert g32.shared_bytes - g16.shared_bytes == 2 * 2 * (1 + n_extra) * 80 * 40


@pytest.mark.parametrize("S", [20_000, 30_000])
def test_more_samples_take_the_fewest_waves(S):
    """Beyond one wave of the largest block (80 samples with three
    streams), the waves are as few as that block allows."""
    g = cap_geometry(S, 1280, 20, 210, 3)
    assert g.samples <= 80
    assert -(-g.grid // H100_SMS) == -(-S // (80 * H100_SMS))


def test_a_basis_beyond_the_block_is_refused():
    with pytest.raises(ValueError):
        cap_geometry(10_000, 1280, 64, 64 * 64, 3)
