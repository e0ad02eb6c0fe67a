"""Time K3's adjoint warp kernel (``csrc/logmvn_chain_grad.cu``, k <= 64)
at other launch bounds, and show what bounds it.

The kernel's block is compiled in: the warps a block (``K3G_WARPS``) and
the blocks an SM of each row bound's launch bound, which caps a thread's
registers (``K3G_ROWS_AND_BLOCKS``).  This script

1. rebuilds ``csrc/logmvn_chain_grad.cu`` alone at several such settings
   (the shipped one first, timed alone, then one ``nvcc`` each, all at
   once) and prints each build's registers and spill bytes per row bound
   from ptxas;
2. times each build's warp kernel through its C launcher on the GP
   training's own inputs (``woodbury_inputs`` of
   ``synthetic_training_problem``: a training chunk's S = 4,064 spectra,
   R = 1,217, 31 forest lines, seed k) at k = 8, 16, 20 (the training's),
   24, 32, 33, 48 and 64, in three interleaved rounds: device ms a launch,
   the profiler's kernel time over 50 launches after a warm-up; each
   build's outputs are held once to the float32 twin within 1e-5 of each
   output's largest magnitude;
3. times the shipped build at k = 20 with exactly r = 1..3 samples a warp
   at 1 block of 8 warps an SM up to its launch bound's most: whether a
   round of samples costs the same at more warps an SM (the warps wait on
   latency) or grows in proportion (on issue);
4. counts the shipped build's SASS instructions by opcode in each
   instantiation.

Then the card's nvidia-smi name and power limit.  Run from the repository
root:

    python3 -m gpy_dla_detection_tpu_torch.ops.chain_grad_sweep
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import _build
from .logmvn_kernels import (
    CHAIN_GRAD_BLOCKS_PER_SM,
    CHAIN_GRAD_WARPS,
    H100_SMS,
    _chain_grad_shared_bytes,
    _chain_grid,
    logmvn_chain_grad_reference,
)
from .timing import device_ms

S = 4064
KS = (8, 16, 20, 24, 32, 33, 48, 64)
ROUNDS = 3
REL = 1e-5
SHIPPED_TABLE = tuple(CHAIN_GRAD_BLOCKS_PER_SM.items())
# (name, warps a block, ((row bound, blocks an SM), ...))
BUILDS = (
    ("shipped", CHAIN_GRAD_WARPS, SHIPPED_TABLE),
    ("more blocks an SM", 8, ((24, 5), (32, 3), (64, 1))),
    ("fewer blocks an SM", 8, ((24, 3), (32, 1), (64, 1))),
    ("4 warps a block", 4, tuple((r, 2 * b) for r, b in SHIPPED_TABLE)),
)
OPCODES = ("FFMA", "FMUL", "FSEL", "LDS", "STS", "LDG", "STG", "MUFU", "WARPSYNC", "BAR", "SHFL")


def build_variants():
    """One library per build: [(build, CDLL, its path, ptxas output)], and
    the seconds the shipped build's nvcc took alone."""
    built = _build.build_variants(
        "chain_grad_sweep", ("logmvn_chain_grad.cu",),
        [{"K3G_WARPS": warps, "K3G_ROWS_AND_BLOCKS": ", ".join(f"{r}, {b}" for r, b in table)}
         for _, warps, table in BUILDS],
        ("logmvn_chain_grad_launch",), first_alone=True)
    return [(b, lib, so, log) for b, (lib, so, log, _) in zip(BUILDS, built)], built[0][3]


def ptxas_usage(log: str) -> dict:
    """Row bound -> (registers, spill store bytes) of each warp-kernel
    instantiation."""
    return {int(m): u for (m,), u in
            _build.ptxas_usage(log, r"logmvn_chain_grad_kernelILi(\d+)E").items()}


def training_inputs(k: int, S_: int, device):
    """The training's capacitances (B, u, misc) and an incoming gradient g."""
    from ..data.synthetic import synthetic_training_problem
    from ..models import training as TT

    fields, arrays = synthetic_training_problem(S_, 1217, k, seed=k)
    p = TT.TrainingParams.from_numpy(fields, device)
    with torch.no_grad():
        B, u, misc = TT.woodbury_inputs(p, *(torch.as_tensor(x, device=device) for x in arrays),
                                        31)
    g = torch.as_tensor(np.random.default_rng(k).normal(size=S_).astype(np.float32),
                        device=device)
    return B, u, misc, g


def launcher(lib, inputs, k, warps, table, device, per_sm=None):
    """A launch of the build's warp kernel at the smallest row bound of
    ``table`` that holds k: (run, outputs, grid)."""
    B, u, misc, g = inputs
    S_ = u.shape[0]
    rows, blocks = next((r, b) for r, b in table if r >= k)
    outs = (torch.empty_like(B), torch.empty_like(u), torch.empty_like(misc))
    smem = _chain_grad_shared_bytes(k, rows, warps)
    grid = _chain_grid(S_, warps, per_sm or blocks, H100_SMS)

    def run():
        err = lib.logmvn_chain_grad_launch(
            _build.ptr(B), _build.ptr(u), _build.ptr(g), S_, k, rows, warps, smem, grid,
            *(_build.ptr(x) for x in outs), _build.stream_ptr(device))
        _build.check_launch("logmvn_chain_grad", err)

    return run, outs, grid


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chain_grad_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    if torch.cuda.get_device_properties(device).multi_processor_count != H100_SMS:
        raise SystemExit(f"chain_grad_sweep: the grids assume {H100_SMS} SMs")
    built, alone = build_variants()
    print(f"nvcc of the shipped build alone: {alone:.1f} s", flush=True)
    for (name, warps, table), _, _, log in built:
        print(f"build '{name}': {warps} warps a block, blocks an SM "
              + ", ".join(f"{r}: {b}" for r, b in table) + " | "
              + ", ".join(f"{m}: {r} registers, {s} spill bytes"
                          for m, (r, s) in ptxas_usage(log).items()), flush=True)
    inputs = {k: training_inputs(k, S, device) for k in KS}
    twins = {k: logmvn_chain_grad_reference(*inputs[k]) for k in KS}
    times, grids = {}, {}
    for rnd in range(ROUNDS):
        for b, lib, _, _ in built:
            for k in KS:
                run, outs, grid = launcher(lib, inputs[k], k, b[1], b[2], device)
                times.setdefault((b[0], k), []).append(device_ms(run)[0])
                if rnd == 0:
                    rel = [float((x - y).abs().max() / y.abs().max())
                           for x, y in zip(outs, twins[k])]
                    if not max(rel) <= REL:
                        raise SystemExit(f"{b[0]} k={k}: |d| / max {rel} > {REL}")
                    grids[b[0], k] = grid
    for b, _, _, _ in built:
        for k in KS:
            print(f"S={S} k={k:2d} build '{b[0]}' grid {grids[b[0], k]}: device ms "
                  + " / ".join(f"{t:.4f}" for t in times[(b[0], k)]), flush=True)

    lib = built[0][1]
    warps = CHAIN_GRAD_WARPS
    per_sm_max = CHAIN_GRAD_BLOCKS_PER_SM[24]
    rounds_in = training_inputs(20, 3 * H100_SMS * per_sm_max * warps, device)
    for per_sm in range(1, per_sm_max + 1):
        line = []
        for r in (1, 2, 3):
            S_ = r * H100_SMS * per_sm * warps
            sub = tuple(x[:S_].contiguous() for x in rounds_in)
            run, _, _ = launcher(lib, sub, 20, warps, SHIPPED_TABLE, device, per_sm)
            line.append(f"{r}: {device_ms(run)[0]:.4f}")
        print(f"k=20, {per_sm * warps} warps an SM, samples a warp -> device ms: "
              + ", ".join(line), flush=True)

    census = _build.sass_census(built[0][2], r"logmvn_chain_grad_kernelILi(\d+)E", OPCODES)
    for (kmax,), (total, ops) in sorted(census.items(), key=lambda x: int(x[0][0])):
        print(f"SASS KMAX={kmax}: {total} instructions, "
              + ", ".join(f"{o} {n}" for o, n in ops.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
