"""The work of each kernel, and the least time the card needs for it.

Frozen copies of ``chip_smoke.py``'s ``k1_work``, ``k2_work``,
``k2_tf32_bound`` and ``k3_work``: operations and bytes computed from the
shapes and the inputs the work needs, whatever implements it.  The peaks are
NVIDIA's published figures for one H100 SXM (dense, no sparsity), which
assume its full 700 W: each run prints the card's power limit beside them.
"""

from __future__ import annotations

import math

import numpy as np

from reference import physics as C

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# 3xTF32: three TF32 products give a float32-accurate one
TF32X3_OPS_PER_S = TF32_OPS_PER_S / 3
PEAKS_LINE = ("peaks: HBM 3.35 TB/s, float32 67 TFLOP/s, TF32 495 TFLOP/s (3xTF32 165), "
              "NVIDIA H100 SXM published, at 700 W")

# K1's window: the polynomial disk inside |x|^2 <= WINDOW_U0, the far field
# (Lorentzian) beyond |z| = CF_FAR_RADIUS
WINDOW_U0 = 9.0
CF_FAR_RADIUS = 256.0
FAR_FIELD_LINES = 16


def k1_work(wl, z, n_fam: int, num_lines: int, lls_break=False, poly=True, elem=4):
    """Bytes and float32 operations of one K1 call (one spectrum, ``n_fam``
    column-density families sharing the redshifts ``z``): per sample, pixel
    and line 6 for the line's x and |z|^2, 4 in the far field, 38 on the
    polynomial disk or 30 on its wing (without ``poly``: 180 in the Weideman
    disk, 48 on the continued fraction); per family an exp and a product per
    pixel and 7 FMAs an output pixel; the Lyman-limit break 5 a pixel.

    :param wl: (P,) padded wavelengths; ``z`` (S,) redshifts (numpy or torch,
        any float type: the counts are taken in float64).
    """
    wl = np.asarray(wl, np.float64) if not hasattr(wl, "double") else wl.double()
    z = np.asarray(z, np.float64) if not hasattr(z, "double") else z.double()
    S, P = z.shape[0], wl.shape[0]
    inv = 1.0 / (math.sqrt(2.0) * C.THERMAL_SIGMA_CGS)
    ops = 5.0 * S * P if lls_break else 0.0
    one_plus_z = (1.0 + z)[:, None]
    for l in range(num_lines):
        lam_c = float(C.LYMAN_WAVELENGTHS_A[l]) * one_plus_z
        u = ((wl[None, :] - lam_c) * (C.SPEED_OF_LIGHT_CGS / lam_c) * inv) ** 2
        y2 = (float(C.LYMAN_GAMMA_V[l]) * inv) ** 2
        far = (u + y2) > CF_FAR_RADIUS**2
        n_far = float(far.sum())
        if poly:
            n_disk = float((~far & (u <= WINDOW_U0)).sum())
            window = 38 * n_disk + 30 * (S * P - n_far - n_disk)
        else:
            n_inner = float(((u + y2) <= 49.0).sum())
            window = 180 * n_inner + 48 * (S * P - n_far - n_inner)
        ops += 6 * S * P + (4 * n_far if l < FAR_FIELD_LINES else 0) + window
    ops += n_fam * (2 * S * P + 14 * S * (P - 6))
    if elem == 2:
        ops += 2.0 * n_fam * S * (P - 6)
    n_bytes = 4 * (P + S + n_fam * S) + elem * n_fam * S * (P - 6)
    return float(n_bytes), float(ops)


def k2_work(S, N, k, n_extra, elem=4):
    """(bytes, products, other float32 operations) of one K2 call: the two
    capacitance products 2 S N (k(k+1)/2 + k), ~12 + n_extra elementwise
    operations a sample and pixel; reads the profile and its chained rows,
    the rows, M and its packed pairs, writes B, u and misc."""
    kp = k * (k + 1) // 2
    products = 2.0 * S * N * (kp + k)
    other = S * N * (12 + n_extra) + (2.0 * S * N * (1 + n_extra) if elem == 2 else 0.0)
    n_bytes = 4.0 * (5 * N + N * k + N * kp + S * (kp + k + 2)) + elem * S * N * (1 + n_extra)
    return n_bytes, products, other


def k3_work(S, k):
    """(bytes, operations) of one K3 call: per sample the Cholesky (~k^3/3),
    the substitution and the logs (~2 k^2); reads B, u, misc, writes ll."""
    kp = k * (k + 1) // 2
    return 4.0 * S * (kp + k + 2 + 1), S * (k**3 / 3.0 + 2.0 * k * k)


def least_s(n_bytes, fp32_ops=0.0, tensor_products=0.0) -> float:
    """Least seconds: the larger of the bytes over the HBM rate, the float32
    operations over the float32 peak and the products over the 3xTF32 rate
    of the tensor cores (units that may run at once, so the largest)."""
    return max(n_bytes / HBM_BYTES_PER_S, fp32_ops / FP32_OPS_PER_S,
               tensor_products / TF32X3_OPS_PER_S)


def k1_ms_fp32(n_bytes, ops) -> float:
    """The float32 bound of ``chip_smoke.bound``, in ms."""
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def k2_ms_fp32(S, N, k, n_extra, elem=4) -> float:
    """K2's bound with every operation on the float32 peak, in ms."""
    n_bytes, products, other = k2_work(S, N, k, n_extra, elem)
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, (products + other) / FP32_OPS_PER_S)


def k2_tf32_bound(S, N, k, n_extra, elem=4) -> float:
    """``chip_smoke.k2_tf32_bound``: K2 on the tensor cores in 3xTF32, in ms."""
    n_bytes, products, _ = k2_work(S, N, k, n_extra, elem)
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, 3 * products / TF32_OPS_PER_S)


def k2_least_s(S, N, k, n_extra, elem=4) -> float:
    """K2's least seconds for the rooflines: products at 3xTF32, the rest at
    float32, bytes at the HBM rate."""
    n_bytes, products, other = k2_work(S, N, k, n_extra, elem)
    return least_s(n_bytes, other, products)


def k3_least_s(S, k) -> float:
    n_bytes, ops = k3_work(S, k)
    return least_s(n_bytes, ops)


def zqso_scan_least_s(Z, P, k, nfft, oversample, stream_count) -> float:
    """Least seconds of one correlation scan at float32: the correlation
    (the weights' rFFT, the product of every stream row's spectrum with its
    weight's, the inverse FFTs, 5 n log2 n operations a real FFT of n
    points, 6 a complex product) read and written once, then K3 over the Z
    capacitances; the per-z median and iid passes read the flux, noise,
    wavelength and mask of every pixel at every z."""
    F = nfft // 2 + 1
    rows = stream_count * oversample
    fft_ops = 5.0 * nfft * math.log2(nfft) * (5 + rows) + 6.0 * rows * F
    fft_bytes = 8.0 * rows * F + 4.0 * rows * nfft + 4.0 * 5 * P
    pass_bytes = Z * P * (4 + 4 + 8 + 1)
    k3_bytes, k3_ops = k3_work(Z, k)
    return least_s(fft_bytes + pass_bytes + k3_bytes, fft_ops + k3_ops)


def zqso_exact_least_s(Z, P, k, pixels_in_window) -> float:
    """Least seconds of one exact scan at float32: the capacitance products
    over the pixels inside each redshift's model window (``pixels_in_window``
    summed over the Z redshifts; 2 (k(k+1)/2 + k) operations a pixel, at
    3xTF32 as K2's), K3 over the Z capacitances, and the per-z median and
    iid passes, which read the flux, noise, wavelength and mask of every
    pixel at every z."""
    kp = k * (k + 1) // 2
    products = 2.0 * pixels_in_window * (kp + k)
    k3_bytes, k3_ops = k3_work(Z, k)
    return least_s(Z * P * (4 + 4 + 8 + 1) + k3_bytes, k3_ops, products)
