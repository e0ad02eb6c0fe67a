"""Time K3 (the factorization-chain kernel) at other launch geometries,
and show what bounds it.

K3's block is compiled in: the warps a block and the blocks an SM of its
launch bound (which caps a thread's registers), at row bounds 32 and 64
(``K3_GEOMETRY`` in ``csrc/logmvn_chain.cu``).  This script

1. rebuilds ``csrc/logmvn_chain.cu`` alone at several such geometries (one
   ``nvcc`` each, all at once) and prints each build's registers and spill
   bytes per row bound from ptxas;
2. times each build through its C launcher at S = 10,000 and k = 8, 16,
   20 (the main path), 21, 32, 33, 41, on the capacitance of a random GP
   basis from a seed, in three interleaved rounds: device ms a launch, the
   profiler's kernel time over 50 launches after a warm-up; each build's
   |dll| against the twin, relative to max |ll|, is checked once;
3. times the shipped build at k = 20 with exactly r = 1..4 samples a warp,
   at 1 to 4 blocks of 8 warps an SM: how the time a round of samples
   takes grows with the warps an SM says whether a warp's chain waits on
   latency (the round costs the same) or on issue (in proportion);
4. counts the shipped build's SASS instructions by opcode in each
   instantiation's converged path (up to the first target of a ``BRA.DIV``:
   the code after it is the divergent fallback of ``__shfl_sync``).

Then the card's nvidia-smi name and power limit.  Run from the repository
root:

    python3 -m gpy_dla_detection_tpu_torch.ops.chain_geometry_sweep
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import _build
from .logmvn_kernels import (
    CHAIN_BLOCKS_PER_SM,
    CHAIN_WARPS,
    H100_SMS,
    _chain_grid,
    _chain_shared_bytes,
    logmvn_cap_reference,
    logmvn_chain_reference,
    packed_pair_basis,
)

S, N = 10_000, 1280
KS = (8, 16, 20, 21, 32, 33, 41)
ROUNDS = 3
SHIPPED = (CHAIN_WARPS[32], CHAIN_BLOCKS_PER_SM[32], CHAIN_WARPS[64], CHAIN_BLOCKS_PER_SM[64])
# (warps, blocks an SM) at row bound 32, then at 64
GEOMETRIES = (SHIPPED, (8, 3, 4, 4), (16, 2, 16, 1), (4, 6, 4, 3), (32, 1, 8, 1))
OPCODES = ("SHFL", "FFMA", "FMUL", "FADD", "MUFU", "LDS", "LDG", "STS", "BRA")


def device_ms(fn, reps: int = 50) -> float:
    """The profiler's kernel time a call over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU) / 1e3 / reps


def build_variants():
    """One library per geometry: [(geometry, CDLL, its path, ptxas output)]."""
    built = _build.build_variants(
        "chain_sweep", ("logmvn_chain.cu",),
        [{"K3_GEOMETRY": ", ".join(map(str, geo))} for geo in GEOMETRIES],
        ("logmvn_chain_launch",))
    return [(geo, lib, so, log) for geo, (lib, so, log, _) in zip(GEOMETRIES, built)]


def ptxas_usage(log: str) -> dict:
    """Row bound -> (registers, spill store bytes) of each instantiation."""
    return {int(m): u for (m,), u in
            _build.ptxas_usage(log, r"logmvn_chain_kernelILi(\d+)E").items()}


def sass_census(so) -> dict:
    """Row bound -> opcode counts of the converged path of its kernel."""
    return {int(m): c for (m,), c in
            _build.sass_census(so, r"logmvn_chain_kernelILi(\d+)E", OPCODES,
                               converged=True).items()}


def capacitance(k: int, S_: int, device, rng):
    put = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    M = put(rng.normal(size=(N, k)) / np.sqrt(k) * 0.1)
    rows = put(np.stack([1 + 0.1 * rng.normal(size=N), np.ones(N), rng.uniform(0.01, 0.05, N),
                         rng.uniform(0.02, 0.1, N), rng.uniform(size=N) > 0.1]))
    A = put(np.exp(-rng.random((S_, N))))
    return logmvn_cap_reference(rows, M, packed_pair_basis(M), A)


def launcher(lib, cap, S_, k, rows, warps, per_sm, device):
    B, u, misc = cap
    ll = torch.empty((S_,), device=device)
    smem = _chain_shared_bytes(k, rows, warps)
    grid = _chain_grid(S_, warps, per_sm, H100_SMS)

    def run():
        err = lib.logmvn_chain_launch(_build.ptr(B), _build.ptr(u), _build.ptr(misc), S_, k,
                                      rows, warps, smem, grid, _build.ptr(ll),
                                      _build.stream_ptr(device))
        _build.check_launch("logmvn_chain", err)

    return run, ll, grid


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chain_geometry_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    if torch.cuda.get_device_properties(device).multi_processor_count != H100_SMS:
        raise SystemExit(f"chain_geometry_sweep: the grids assume {H100_SMS} SMs")
    built = build_variants()
    for geo, _, _, log in built:
        usage = ptxas_usage(log)
        print(f"build warps x blocks/SM {geo[0]}x{geo[1]} at KMAX 32, {geo[2]}x{geo[3]} at 64 | "
              + ", ".join(f"KMAX {m}: {r} registers, {s} spill bytes"
                          for m, (r, s) in sorted(usage.items())), flush=True)
    rng = np.random.default_rng(11)
    caps = {k: capacitance(k, S, device, rng) for k in KS}
    twins = {k: logmvn_chain_reference(*caps[k]) for k in KS}
    times, grids = {}, {}
    for rnd in range(ROUNDS):
        for geo, lib, _, _ in built:
            for k in KS:
                rows = 32 if k <= 32 else 64
                warps, per_sm = (geo[0], geo[1]) if rows == 32 else (geo[2], geo[3])
                run, ll, grid = launcher(lib, caps[k], S, k, rows, warps, per_sm, device)
                times.setdefault((geo, k), []).append(device_ms(run))
                if rnd == 0:
                    dll = float((ll - twins[k]).abs().max() / twins[k].abs().max())
                    if not dll <= 1e-6:
                        raise SystemExit(f"{geo} k={k}: |dll| {dll:.2e} of max|ll| > 1e-6")
                    grids[geo, k] = grid
    for geo, _, _, _ in built:
        mark = "  <- shipped" if geo == SHIPPED else ""
        for k in KS:
            rows = 32 if k <= 32 else 64
            warps, per_sm = (geo[0], geo[1]) if rows == 32 else (geo[2], geo[3])
            print(f"S={S} k={k:2d} KMAX={rows} {warps:2d} warps x {per_sm} blocks/SM, grid "
                  f"{grids[geo, k]}: device ms "
                  + " / ".join(f"{t:.4f}" for t in times[(geo, k)]) + mark, flush=True)

    lib = next(lib for geo, lib, _, _ in built if geo == SHIPPED)
    warps = SHIPPED[0]
    rounds_cap = capacitance(20, 4 * H100_SMS * 4 * warps, device, rng)
    for per_sm in (1, 2, 3, 4):
        line = []
        for r in (1, 2, 3, 4):
            S_ = r * H100_SMS * per_sm * warps
            cap = tuple(x[:S_].contiguous() for x in rounds_cap)
            run, _, _ = launcher(lib, cap, S_, 20, 32, warps, per_sm, device)
            line.append(f"{r}: {device_ms(run):.4f}")
        print(f"k=20, {per_sm * warps} warps an SM, samples a warp -> device ms: "
              + ", ".join(line), flush=True)

    so = next(so for geo, _, so, _ in built if geo == SHIPPED)
    for kmax, (total, ops) in sorted(sass_census(so).items()):
        print(f"SASS KMAX={kmax} converged path: {total} instructions, "
              + ", ".join(f"{o} {n}" for o, n in ops.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
