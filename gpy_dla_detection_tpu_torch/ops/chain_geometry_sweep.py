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

import ctypes
import re
import shutil
import subprocess
from collections import Counter

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
    nvcc = _build._nvcc()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for geo in GEOMETRIES:
        # nvcc splits a -D value at its commas, so the macro comes from a
        # source of its own that includes the kernel's
        stem = _build.BUILD_DIR / f"chain_sweep_{'_'.join(map(str, geo))}"
        src, so = stem.with_suffix(".cu"), stem.with_suffix(".so")
        src.write_text(f"#define K3_GEOMETRY {', '.join(map(str, geo))}\n"
                       f"#include \"{_build.CSRC / 'logmvn_chain.cu'}\"\n")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)]
        jobs.append((geo, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    built = []
    for geo, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {geo}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.logmvn_chain_launch.argtypes = _build._SIGNATURES["logmvn_chain_launch"]
        lib.logmvn_chain_launch.restype = ctypes.c_int
        built.append((geo, lib, so, out))
    return built


def ptxas_usage(log: str) -> dict:
    """Row bound -> (registers, spill store bytes) of each instantiation."""
    usage = {}
    for block in log.split("Compiling entry function")[1:]:
        kmax = re.search(r"logmvn_chain_kernelILi(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if kmax and regs:
            usage[int(kmax.group(1))] = (int(regs.group(1)), int(spill.group(1)) if spill else 0)
    return usage


def sass_census(so) -> dict:
    """Row bound -> opcode counts of the converged path of its kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    census = {}
    for body in text.split("Function : ")[1:]:
        kmax = re.match(r"\S*logmvn_chain_kernelILi(\d+)E", body)
        if not kmax:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        div = [int(t, 16) for t in re.findall(r"BRA\.DIV \w+, (0x[0-9a-f]+)", body)]
        end = min(div) if div else None
        ops = Counter(op.split(".")[0] for a, op in ins if end is None or int(a, 16) < end)
        census[int(kmax.group(1))] = (sum(ops.values()), {o: ops[o] for o in OPCODES})
    return census


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
