"""Time K5 and K6 (the absorption-tail kernels) at other launch geometries.

Both kernels are the streaming tail of ``csrc/absorption_stencil.cuh``,
whose geometry (``K56_GEOMETRY``: pixels a lane, items in flight a warp,
warps a block, blocks an SM) is compiled in; the grid is a launch argument
(``voigt_kernels.tail_geometry``'s rule at the build's warps and blocks an
SM).  This script

1. rebuilds ``csrc/absorption_tail.cu`` and ``csrc/absorption_windowed.cu``
   at each geometry of :data:`BUILDS` (one ``nvcc`` each, all at once) and
   prints each build's registers and spill bytes per instantiation;
2. checks every build's K5 and K6 against their twins once per case
   (float32 within 1e-6, int16 codes within 1);
3. times each build through its C launchers, in three interleaved
   rounds: device ms a launch by CUDA events over 50 launches after a
   warm-up at 10,000 rows (a launch's host time, ~0.01 ms, is below the
   kernel's), and by the profiler over 50 launches at 16 rows
   (``ops/timing.device_ms``; "not measured" where it loses records in
   every window), on: K5 at 10,000 rows of P = 1,286 (the catalog), 1,670 (the
   LLS search) and 774 (the CIV head), and at the MCMC half-step's 16 rows;
   K6 at 10,000 and 16 rows of P = 1,286 on the 1,408-pixel padded grid
   with L = 3; each in float32 and int16 storage.  The unit optical depth
   is the placed windowed one of seeded redshifts on a log-uniform grid.

Then the card's nvidia-smi name and power limit.  Run from the repository
root:

    python3 -m gpy_dla_detection_tpu_torch.ops.tail_sweep
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import _build
from .absorption_sweep import events_ms
from .logmvn_kernels import H100_SMS, _chain_grid
from .timing import device_ms
from .voigt import place_windows, windowed_tau_parts
from .voigt_kernels import (
    K56_BLOCKS_PER_SM,
    K56_DEPTH,
    K56_PIXELS,
    K56_WARPS,
    _device_taps,
    absorption_tail_reference,
    absorption_windowed_reference,
    tail_chunks,
)

ROUNDS = 3
TOL = 1e-6  # TOL_K5 = TOL_K6, absolute
MAX_DCODE = 1
SHIPPED = (K56_PIXELS, K56_DEPTH, K56_WARPS, K56_BLOCKS_PER_SM)
# (name, K56_GEOMETRY)
BUILDS = (
    ("shipped", SHIPPED),
    ("4 px, 1 in flight, 8x8", (4, 1, 8, 8)),
    ("4 px, 2 in flight, 8x5", (4, 2, 8, 5)),
    ("4 px, 2 in flight, 4x10", (4, 2, 4, 10)),
    ("4 px, 3 in flight, 8x4", (4, 3, 8, 4)),
    ("8 px, 1 in flight, 8x6", (8, 1, 8, 6)),
    ("8 px, 2 in flight, 4x8", (8, 2, 4, 8)),
    ("8 px, 2 in flight, 16x2", (8, 2, 16, 2)),
    ("8 px, 3 in flight, 8x3", (8, 3, 8, 3)),
)
SOURCES = ("absorption_tail.cu", "absorption_windowed.cu")


def build_variants():
    """One library per build: [(name, geometry, CDLL, ptxas output)]."""
    built = _build.build_variants(
        "k56_sweep", SOURCES, [{"K56_GEOMETRY": ", ".join(map(str, geo))} for _, geo in BUILDS],
        ("absorption_tail_launch", "absorption_windowed_launch"))
    return [(name, geo, lib, log) for (name, geo), (lib, _, log, _) in zip(BUILDS, built)]


def ptxas_usage(log: str) -> dict:
    """Instantiation (source, store) -> (registers, spill store bytes)."""
    return {(src, "float32" if st == "f" else "int16"): u for (src, st), u in
            _build.ptxas_usage(log, r"tail_kernelI.*?(Tail|Windowed)SourceE?([fs])").items()}


def inputs(device, S: int, P: int, seed: int = 3):
    """The placed windowed unit optical depth (K5's input, S x P), its
    parts (K6's input) and column densities, from seeded redshifts on a
    log-uniform grid of P pixels."""
    rng = np.random.default_rng(seed)
    wl = torch.as_tensor((1215.67 * 2.9 * 10 ** (1e-4 * np.arange(P))).astype(np.float32),
                         device=device)
    z = torch.as_tensor(rng.uniform(1.9, 3.3, S).astype(np.float32), device=device)
    nhi = torch.as_tensor((10 ** rng.uniform(20, 23, S)).astype(np.float32), device=device)
    parts = windowed_tau_parts(wl, z, 3)
    return place_windows(parts).contiguous(), parts, nhi


def launchers(lib, geo, device, unit, parts, nhi, store):
    """K5's and K6's launches of ``lib`` (built at ``geo``) on these inputs,
    with the grid at the build's warps and blocks an SM, and their outputs."""
    pix, _, warps, per_sm = geo
    chunk = 32 * pix
    smem = 4 * warps * 2 * chunk
    taps = _device_taps(device)
    dtype = torch.int16 if store else torch.float32
    S, P = unit.shape
    grid = _chain_grid(S * -(-(P - 6) // chunk), warps, per_sm, H100_SMS)
    out5 = torch.empty((S, P - 6), dtype=dtype, device=device)
    out6 = torch.empty((S, P - 6), dtype=dtype, device=device)
    p = _build.ptr
    st = _build.stream_ptr(device)
    a5 = (p(unit), p(nhi), S, P, p(taps), store, warps, smem, grid, p(out5), st)
    a6 = (p(parts.far), p(parts.corr), p(parts.c0), p(nhi), S, parts.far.shape[1], P,
          parts.c0.shape[1], p(taps), store, warps, smem, grid, p(out6), st)

    def k5():
        _build.check_launch("absorption_tail", lib.absorption_tail_launch(*a5))

    def k6():
        _build.check_launch("absorption_windowed", lib.absorption_windowed_launch(*a6))

    return (k5, out5), (k6, out6)


def time_ms(fn, few_rows: bool) -> float | None:
    """A launch's device ms: CUDA events for the catalog's rows, the
    profiler for few rows (whose kernel is shorter than a launch's host
    time); None where the profiler lost records in every window."""
    if not few_rows:
        return events_ms(fn)
    try:
        return device_ms(fn)[0]
    except RuntimeError:
        return None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tail_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    if torch.cuda.get_device_properties(device).multi_processor_count != H100_SMS:
        raise SystemExit(f"tail_sweep: the grids assume {H100_SMS} SMs")
    built = build_variants()
    for name, geo, _, log in built:
        print(f"[build] {name} {geo}: registers / spill bytes "
              + ", ".join(f"{src} {st}: {r}/{sp}"
                          for (src, st), (r, sp) in sorted(ptxas_usage(log).items())))
    # (kernel, rows, P): K6 only at the catalog's P
    cases = [("K5", 10_000, 1286), ("K5", 16, 1286), ("K5", 10_000, 1670),
             ("K5", 10_000, 774), ("K6", 10_000, 1286), ("K6", 16, 1286)]
    data = {(S, P): inputs(device, S, P) for _, S, P in cases}
    runs, failed = {}, []
    for kname, S, P in cases:
        unit, parts, nhi = data[(S, P)]
        for store in (0, 1):
            dtype = torch.int16 if store else None
            want = (absorption_tail_reference(unit, nhi, dtype) if kname == "K5"
                    else absorption_windowed_reference(parts, nhi, dtype))
            for bname, geo, lib, _ in built:
                (k5, o5), (k6, o6) = launchers(lib, geo, device, unit, parts, nhi, store)
                run, out = (k5, o5) if kname == "K5" else (k6, o6)
                run()
                torch.cuda.synchronize()
                if store:
                    e = int((out.int() - want.int()).abs().max())
                    ok = e <= MAX_DCODE
                else:
                    e = float((out - want).abs().max())
                    ok = e <= TOL
                label = f"{kname} {S}x{P} {'int16' if store else 'float32'}"
                if not ok:
                    failed.append(f"{bname} {label}: {e}")
                runs[(label, bname)] = (run, e)
    times = {key: [] for key in runs}
    for _ in range(ROUNDS):
        for key, (run, _) in runs.items():
            times[key].append(time_ms(run, key[0].split()[1].startswith("16x")))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for (label, bname), ts in times.items():
        timer = "profiler" if label.split()[1].startswith("16x") else "CUDA events"
        print(f"[time] {label} {bname}: "
              + " / ".join("not measured" if t is None else f"{t:.4f}" for t in ts)
              + f" ms ({timer}, 50 launches; vs twin {runs[(label, bname)][1]:.3g})")
    print(f"[chunks] a row of P = 774 / 1,286 / 1,670 at the shipped geometry: "
          f"{tail_chunks(774)} / {tail_chunks(1286)} / {tail_chunks(1670)}")
    print(card)
    if failed:
        raise SystemExit(f"tail_sweep: beyond the tolerance against the twin: {failed}")


if __name__ == "__main__":
    main()
