"""The frozen work counts give the bounds of the port's kernel table
(PERF.md section 6) at the main path's shapes: S = 10,000, N = 1,280
(P = 1,286 padded), k = 20."""

import numpy as np
import pytest

from harness import counts

S, N, P, K = 10_000, 1_280, 1_286, 20


def test_k1_bound_is_its_bytes():
    wl = 3600.0 * 10 ** (1e-4 * np.arange(P)) * 1.2
    z = np.linspace(2.4, 3.4, S)
    n_bytes, ops = counts.k1_work(wl, z, 2, 3)
    assert counts.k1_ms_fp32(n_bytes, ops) == pytest.approx(0.0306, abs=5e-5)
    assert n_bytes / counts.HBM_BYTES_PER_S > ops / counts.FP32_OPS_PER_S


def test_k3_bound():
    n_bytes, ops = counts.k3_work(S, K)
    assert 1e3 * counts.least_s(n_bytes, ops) == pytest.approx(0.0028, abs=5e-5)


def test_k2_bounds():
    assert counts.k2_ms_fp32(S, N, K, 0) == pytest.approx(0.0902, abs=5e-5)
    # 3xTF32 on the tensor cores: 3 x 2 S N (k(k+1)/2 + k) over 495 TFLOP/s
    assert counts.k2_tf32_bound(S, N, K, 0) == pytest.approx(0.0357, abs=5e-5)
    # the roofline's least time: the products at 3xTF32, bytes as they grow
    assert 1e3 * counts.k2_least_s(S, N, K, 0) == pytest.approx(counts.k2_tf32_bound(S, N, K, 0))
    assert 1e3 * counts.k2_least_s(S, N, K, 3) == pytest.approx(0.0643, abs=5e-5)


def test_k1_counts_follow_the_redshifts():
    """K1's far field is counted from the spectrum's own samples."""
    wl = 3600.0 * 10 ** (1e-4 * np.arange(P)) * 1.2
    near = counts.k1_work(wl, np.full(100, 3.0), 2, 3)[1]
    far = counts.k1_work(wl, np.full(100, 9.0), 2, 3)[1]
    assert far < near


def test_zqso_exact_scan_is_bound_by_its_passes():
    """The exact scan's least time at the zQSO cell's shapes (Z = 10,000,
    P = 5,632, k = 20, ~4,000 window pixels a redshift) is the per-z
    passes' bytes, not the capacitance products."""
    Z, P, k = 10_000, 5_632, 20
    least = counts.zqso_exact_least_s(Z, P, k, 4_000.0 * Z)
    passes = Z * P * 17 / counts.HBM_BYTES_PER_S
    assert least == pytest.approx(passes + counts.k3_work(Z, k)[0] / counts.HBM_BYTES_PER_S)
    assert 2.0 * 4_000 * Z * (k * (k + 1) // 2 + k) / counts.TF32X3_OPS_PER_S < least
