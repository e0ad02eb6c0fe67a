"""Time K1 (the fused absorption kernel) by stage, at other blocks and
grids, and show what bounds it.

K1's block (``K1_GEOMETRY``: pixels a thread, warps a block, blocks an SM)
and its stages (``K1_STAGES``: the far field, the windows, the stores) are
compiled into ``csrc/absorption_all.cu``; the grid is a launch argument.
This script

1. rebuilds ``csrc/absorption_all.cu`` alone as the shipped kernel, with
   stages left out (the windows; the far field and the windows; the
   stores; the tau and the stores) and at other blocks (one ``nvcc`` each,
   all at once), and
   prints each build's registers and spill bytes per instantiation;
2. times each build through its C launcher on the main path's inputs
   (S = 10,000 samples of one synthetic spectrum's model at
   ``Parameters()``: P = 1,286, F = 2, and the stage builds also with the
   DLA family alone; with the Lyman-limit break the LLS
   search's P = 1,670, F = 1) for the polynomial and the Weideman window, in
   three interleaved rounds: device ms a launch by CUDA events over 50
   launches after a warm-up; each build's output is checked once against
   the twin (the stage ablations are not);
3. times the shipped build with grids of 1 to 4 blocks an SM (8 to 32
   warps an SM, each warp taking an even share of the chunks);
4. counts the shipped build's SASS instructions by opcode per
   instantiation, and with ``--sass FILE`` writes the shipped build's SASS
   of K1 there.

Then the card's nvidia-smi name and power limit.  Run from the repository
root:

    python3 -m gpy_dla_detection_tpu_torch.ops.absorption_sweep [--sass FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess

import numpy as np
import torch

from . import _build
from .logmvn_kernels import H100_SMS, _chain_grid
from .timing import events_ms
from .voigt_kernels import (
    K1_BLOCKS_PER_SM,
    K1_CHUNK,
    K1_PIXELS,
    K1_WARPS,
    _kernel_table,
    absorption_all_reference,
    k1_chunks,
)

ROUNDS = 3
TOL = {True: 2e-6, False: 5e-4}  # K1's card tolerances, polynomial and Weideman
SHIPPED = (K1_PIXELS, K1_WARPS, K1_BLOCKS_PER_SM)
# (name, K1_GEOMETRY, K1_STAGES)
BUILDS = (
    ("shipped", SHIPPED, 7),
    ("no windows", SHIPPED, 5),
    ("no tau", SHIPPED, 4),
    ("no stores", SHIPPED, 3),
    ("no tau, no stores", SHIPPED, 0),
    ("8 warps x 3", (4, 8, 3), 7),
    ("16 warps x 3", (4, 16, 3), 7),
    ("4 warps x 8", (4, 4, 8), 7),
)
BLOCKS_PER_SM = (1, 2, 3, 4)
OPCODES = ("FFMA", "FMUL", "FADD", "MUFU", "FSETP", "LDS", "STS", "STG", "LDG", "VOTE",
           "BRA", "CALL")


def build_variants():
    """One library per build: [(name, geometry, CDLL, its path, ptxas output)]."""
    built = _build.build_variants(
        "k1_sweep", ("absorption_all.cu",),
        [{"K1_GEOMETRY": ", ".join(map(str, geo)), "K1_STAGES": stages}
         for _, geo, stages in BUILDS],
        ("absorption_all_launch", "absorption_all_upload"))
    return [(name, geo, lib, so, log)
            for (name, geo, _), (lib, so, log, _) in zip(BUILDS, built)]


def ptxas_usage(log: str) -> dict:
    """Instantiation (lines, poly) -> (registers, spill store bytes)."""
    return {(int(lines), bool(int(poly))): u for (lines, poly), u in
            _build.ptxas_usage(log, r"absorption_all_kernelILi(\d+)ELb(\d)E").items()}


def k1_sass(so) -> list[str]:
    """The SASS of each K1 instantiation in library ``so``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    return [body for body in text.split("Function : ")[1:]
            if re.match(r"\S*absorption_all_kernel", body)]


def sass_census(so) -> dict:
    """Instantiation (lines, poly) -> (instructions, opcode counts)."""
    return {(int(lines), bool(int(poly))): c for (lines, poly), c in
            _build.sass_census(so, r"absorption_all_kernelILi(\d+)ELb(\d)E", OPCODES).items()}


def main_path_inputs(device):
    """The main path's K1 inputs: one synthetic spectrum's padded grid and
    the DLA samples' redshifts and both families' column densities at
    ``Parameters()``; the LLS search's grid and samples likewise."""
    from ..data.samples import generate_dla_samples, generate_subdla_samples
    from ..data.spectrum import to_torch
    from ..data.synthetic import synthetic_learned_model, synthetic_spectrum
    from ..models.learned import LearnedModel, build_spectrum_model
    from ..models.lls import generate_lya_samples
    from ..params import Parameters

    put = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    cases = {}
    for name, params, z_qso in (
            ("P=1286 F=2", Parameters(), 3.0),
            ("P=1670 F=1, break", Parameters(num_dla_samples=10000, min_lambda=850.0,
                                              num_pixels_padded=1664), 3.1)):
        arrays = synthetic_learned_model(params)
        learned = LearnedModel.from_numpy(arrays, device, torch.float32)
        spec = synthetic_spectrum(params, arrays, z_qso, seed=1)
        model = build_spectrum_model(learned, to_torch(spec, device, torch.float32), params)
        if name.endswith("break"):
            samples = generate_lya_samples(params.num_dla_samples)
            offsets, nhis = samples.offset_samples, (samples.nhi_samples,)
        else:
            dla = generate_dla_samples(params)
            offsets = dla.offset_samples
            nhis = (dla.nhi_samples, generate_subdla_samples(params).nhi_samples)
        z = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * put(offsets)
        cases[name] = (model.padded_wavelengths.contiguous(), z.contiguous(),
                       torch.stack([put(n) for n in nhis]).contiguous(), name.endswith("break"))
    return cases


def launcher(lib, geo, case, poly, device, per_sm=None):
    """A launch of ``lib``'s K1 built at ``geo`` on ``case``, with the
    grid of ``k1_geometry``'s rule at the build's blocks an SM, or at
    ``per_sm`` blocks an SM."""
    wl, z, nhi, lls_break = case
    F, S, P = nhi.shape[0], z.shape[0], wl.shape[0]
    out = torch.empty((F, S, P - 6), device=device)
    warps = geo[1]
    grid = _chain_grid(S * k1_chunks(P), warps, per_sm or geo[2], H100_SMS)
    smem = 4 * F * warps * 2 * K1_CHUNK

    # the arguments once, so a launch costs the host little next to the kernel
    args = (_build.ptr(wl), P, _build.ptr(z), S, _build.ptr(nhi), F, 3, 3, int(lls_break),
            int(poly), 0, warps, smem, grid, _build.ptr(out), _build.stream_ptr(device))

    def run():
        _build.check_launch("absorption_all", lib.absorption_all_launch(*args))

    return run, out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", help="write the shipped build's SASS of K1 here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("absorption_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    if torch.cuda.get_device_properties(device).multi_processor_count != H100_SMS:
        raise SystemExit(f"absorption_sweep: the grids assume {H100_SMS} SMs")
    built = build_variants()
    table = _kernel_table(3)
    for _, _, lib, _, _ in built:
        err = lib.absorption_all_upload(ctypes.c_void_p(table.ctypes.data), table.size,
                                        _build.stream_ptr(device))
        _build.check_launch("absorption_all (table upload)", err)
    for name, geo, _, _, log in built:
        usage = ptxas_usage(log)
        print(f"[build] {name} {geo}: registers / spill bytes "
              + ", ".join(f"{'poly' if p else 'weideman'} L={l if l else 'any'}: {r}/{sp}"
                          for (l, p), (r, sp) in sorted(usage.items())))

    cases = main_path_inputs(device)
    runs, failed = {}, []
    for cname, case in cases.items():
        wl, z, nhi, lls_break = case
        for poly in (True, False):
            want = absorption_all_reference(wl, z, tuple(nhi), 3, lls_break, poly)
            for bname, geo, lib, _, _ in built:
                run, out = launcher(lib, geo, case, poly, device)
                if not bname.startswith("no "):  # the stage ablations compute less
                    run()
                    torch.cuda.synchronize()
                    e = max(float((a - b).abs().max()) for a, b in zip(out, want))
                    print(f"[parity] {bname} {cname} {'poly' if poly else 'weideman'}: "
                          f"max|d| vs twin {e:.3e} (tol {TOL[poly]})")
                    if e > TOL[poly]:
                        failed.append(f"{bname} {cname} poly={poly}")
                runs[(cname, poly, bname)] = run
            if cname == "P=1286 F=2":
                lib, geo = built[0][2], built[0][1]
                for per_sm in BLOCKS_PER_SM:
                    run, _ = launcher(lib, geo, case, poly, device, per_sm)
                    runs[(cname, poly, f"shipped, {per_sm} blocks an SM")] = run
                # one family: what the second family's exp, stencil and
                # stores cost
                for bname, geo, lib, _, _ in built[:5]:  # shipped and the stages
                    run, _ = launcher(lib, geo, (wl, z, nhi[:1], lls_break), poly, device)
                    runs[(cname, poly, f"{bname}, F=1")] = run
    times = {key: [] for key in runs}
    for _ in range(ROUNDS):
        for key, run in runs.items():
            times[key].append(events_ms(run))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for (cname, poly, bname), ts in times.items():
        print(f"[time] {cname} {'poly' if poly else 'weideman'} {bname}: "
              + " / ".join(f"{t:.4f}" for t in ts) + " ms (CUDA events, 50 launches)")
    if args.sass:
        with open(args.sass, "w") as fh:
            fh.write("".join(f"Function : {body}" for body in k1_sass(built[0][3])))
    for (l, p), (n, ops) in sorted(sass_census(built[0][3]).items()):
        print(f"[sass] shipped {'poly' if p else 'weideman'} L={l if l else 'any'}: {n} "
              "instructions, " + ", ".join(f"{o} {c}" for o, c in ops.items()))
    print(card)
    if failed:
        raise SystemExit(f"absorption_sweep: beyond the tolerance against the twin: {failed}")


if __name__ == "__main__":
    main()
