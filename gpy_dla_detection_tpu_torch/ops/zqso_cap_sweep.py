"""Time zqso_cap (the zQSO exact scan's in-window inputs) at other builds
and tiles, and show what bounds it.

The kernel's block is compiled in (``csrc/zqso_cap.cu``): the pixels a
sub-tile (``ZQSO_CAP_SUB``), the blocks an SM of its launch bounds
(``ZQSO_CAP_BLOCKS``, which cap a thread's registers) and an ablation stage
(``ZQSO_CAP_ABLATE``: 1 leaves the accumulation out, so the pixel terms,
the band's staging, the barriers and the stores remain).  This script

1. rebuilds ``csrc/zqso_cap.cu`` alone at each of ``BUILDS`` (one ``nvcc``
   each, all at once) and prints each build's registers and spill bytes
   per instantiation from ptxas;
2. times each build through its C launcher on :func:`problem` (DESI's
   linear grid, k = 20) at C = 1,000, 5,000 and 10,000, in three interleaved
   rounds: ms a call (both kernels) by CUDA events over 20 calls after a
   warm-up, and each build's B against the twin's;
3. times the shipped build at each C with each pixel tile of ``TILES``
   (the geometry picks one of ``ZQSO_CAP_TILES`` by the blocks it gives).

Then the card's nvidia-smi name and power limit.  Run from the repository
root:

    python3 -m gpy_dla_detection_tpu_torch.ops.zqso_cap_sweep
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import _build
from .logmvn_kernels import (
    ZQSO_CAP_BLOCKS_PER_SM,
    ZQSO_CAP_SUB,
    _pair_index,
    zqso_cap_geometry,
    zqso_cap_launch,
    zqso_cap_reference,
)
from .timing import events_ms

SIZES = (1_000, 5_000, 10_000)
ROUNDS = 3
TILES = (1024, 512, 256, 128, 64)
SHIPPED = {"ZQSO_CAP_SUB": ZQSO_CAP_SUB,
           "ZQSO_CAP_BLOCKS": f"{ZQSO_CAP_BLOCKS_PER_SM[20]}, {ZQSO_CAP_BLOCKS_PER_SM[32]}",
           "ZQSO_CAP_ABLATE": 0}
BUILDS = (
    SHIPPED,
    {**SHIPPED, "ZQSO_CAP_BLOCKS": "2, 2"},
    {**SHIPPED, "ZQSO_CAP_ABLATE": 1},
    {**SHIPPED, "ZQSO_CAP_SUB": 64, "ZQSO_CAP_BLOCKS": "2, 2"},
    {**SHIPPED, "ZQSO_CAP_SUB": 16},
)


def problem(device, C: int, k: int = 20, special: str | None = None, step: float = 4.02e-4,
            z0: float = 2.14):
    """zqso_cap's arguments at the main path's shapes: DESI's linear 0.8 A
    grid of 5,600 pixels from 3,600 A (padded to 5,632) with a noisy flat
    continuum, a synthetic model of width k, C consecutive redshifts of the
    grid's step from z0, and the scan's own observable cut and
    normalization median (``models/zqso``).  ``special``: "window" puts the
    last z at 20 (no pixel in its window; median 1), "median" makes the
    4th z's median +inf (an empty normalization window)."""
    from ..data.synthetic import synthetic_z_learned_model
    from ..models import zqso
    from ..params import ZParameters

    rng = np.random.default_rng(5)
    learned = synthetic_z_learned_model(0, k).to(device, torch.float32)
    wl = 3600.0 + 0.8 * np.arange(5_600)
    spec = zqso.device_spectrum(zqso.prepare_z_spectrum(
        wl, 1.0 + 0.1 * rng.normal(size=wl.shape), rng.uniform(0.005, 0.02, wl.shape),
        rng.uniform(size=wl.shape) < 0.05), device, torch.float32)
    params = ZParameters(k=k)
    z = torch.as_tensor(z0 + step * np.arange(C), device=device)
    if special == "window":
        z[-1] = 20.0
    w = spec.wavelengths
    hi = torch.minimum(params.max_lambda * (1.0 + z),
                       torch.max(torch.where(spec.valid, w, -np.inf)))
    lo = torch.maximum(params.min_lambda * (1.0 + z),
                       torch.min(torch.where(spec.valid, w, np.inf)))
    med = zqso._normalization_median(zqso._sorted_flux_view(spec), z[:, None], lo[:, None],
                                     hi[:, None], params)
    if special == "window":
        med[-1] = 1.0
    if special == "median":
        med[3] = np.inf
    return (z, med, lo, hi, w, spec.flux, spec.noise_variance, spec.valid,
            learned.rest_wavelengths, learned.mu, learned.M, params.min_lambda,
            params.max_lambda)


def float64_sum(z, med, lo, hi, wl, flux, noise, valid, rest_wl, mu, M, min_lambda, max_lambda,
                chunk: int = 1_000):
    """B as the twin forms its float32 terms m_a (m_b d_inv), summed in
    float64 (a product of two float32 is exact there): the sum that
    zqso_cap and the twin each round in their own order.  Arguments as
    :func:`problem` gives them."""
    from .interp import interp_uniform
    from .logmvn import _masked_inputs

    rows, cols = _pair_index(M.shape[1], M.device)
    x0, dx = rest_wl[0], rest_wl[1] - rest_wl[0]
    out = []
    for i in range(0, z.shape[0], chunk):
        rest = wl / (1.0 + z[i:i + chunk, None])
        ind = ((rest >= min_lambda) & (rest <= max_lambda) & (wl > lo[i:i + chunk, None])
               & (wl < hi[i:i + chunk, None]) & valid)
        m = med[i:i + chunk, None]
        Mz = interp_uniform(x0, dx, M, rest.to(torch.float32))
        d_inv = _masked_inputs(flux / m, flux / m, noise / (m * m), ind)[1]
        out.append(torch.einsum("cni,cnj->cij", Mz.double(),
                                (Mz * d_inv[..., None]).double())[:, rows, cols])
    return torch.cat(out)


def launcher(lib, args, sub: int = ZQSO_CAP_SUB, tile: int | None = None):
    """A call of ``lib``'s zqso_cap on ``args`` (:func:`problem`) at
    ``sub`` pixels a sub-tile (as the build was compiled) and the
    geometry's tile (or ``tile``); it returns B, u, misc."""
    z, wl, M = args[0], args[4], args[10]
    g = zqso_cap_geometry(z.shape[0], wl.shape[0], M.shape[1], tile=tile, sub=sub)
    return lambda: zqso_cap_launch(lib, g, *args)


def main() -> None:
    device = torch.device("cuda", 0)
    built = _build.build_variants("zqso_cap_sweep", ("zqso_cap.cu",), BUILDS,
                                  ("zqso_cap_launch",))
    for macros, (_, _, log, seconds) in zip(BUILDS, built):
        usage = _build.ptxas_usage(log, r"zqso_cap_(kernel|sum_kernel)\w*?(ILi(\d+)E)?")
        print(f"build {macros}: nvcc {seconds:.1f} s; registers, spill bytes "
              + ", ".join(f"{g[0]}{g[2] or ''}: {r}" for g, r in usage.items()))
    problems = {C: problem(device, C) for C in SIZES}
    want = {C: zqso_cap_reference(*a)[0] for C, a in problems.items()}
    times = {(i, C): [] for i in range(len(BUILDS)) for C in SIZES}
    for _ in range(ROUNDS):
        for i, (macros, (lib, *_)) in enumerate(zip(BUILDS, built)):
            for C, args in problems.items():
                call = launcher(lib, args, sub=int(macros["ZQSO_CAP_SUB"]))
                times[i, C].append(events_ms(call, reps=20))
                if macros["ZQSO_CAP_ABLATE"] == 0 and len(times[i, C]) == 1:
                    B = call()[0]
                    fin = torch.isfinite(want[C])
                    rel = float((B - want[C])[fin].abs().max() / want[C][fin].abs().max())
                    print(f"  build {i} C={C}: B vs twin {rel:.2e}")
    for i, macros in enumerate(BUILDS):
        print(f"build {i} {macros}: " + ", ".join(
            f"C={C} {np.median(times[i, C]):.4f} ms ({', '.join(f'{t:.4f}' for t in times[i, C])})"
            for C in SIZES))
    lib = built[0][0]
    for C, args in problems.items():
        print(f"shipped build, C={C}, tile picked "
              f"{zqso_cap_geometry(C, 5_632, 20).tile_pixels}: " + ", ".join(
                  f"tile {t}: {events_ms(launcher(lib, args, tile=t), reps=20):.4f} ms"
                  for t in TILES))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
