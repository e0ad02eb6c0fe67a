"""Time K7's stage kernel, stage by stage, beside K2 at every launch geometry.

The stage kernel runs K2's block (``csrc/logmvn_cap_block.cuh``) and picks
its epilogue by stage, so the stages' device times split K2's: staging
and assembly (``elementwise``), the FMA loop (``matmul`` - ``elementwise``)
and the stores (K2 - ``matmul``).  This script launches the stage kernel
and K2 through their C launchers at every block geometry (TS samples a
block, TN pixels a chunk) that K2's block takes, at the main path's S =
10,000, N = 1,280, k = 20 (packed basis, built once: no gather in the
timed calls), float32, no extra stream, on random inputs from a seed.
Each line gives the device ms (CUDA events over 50 launches after a
warm-up) of ``elementwise``, ``elementwise_nolog``, ``matmul``, ``full``
and K2, the split, the blocks, threads and shared bytes, the blocks an SM
can hold by shared memory and registers, and the largest |d| / max|value|
of the stages against their twins; the geometry ``cap_geometry`` picks is
marked.  Then the card's nvidia-smi name and power limit.

Run from the repository root:

    python3 -m gpy_dla_detection_tpu_torch.ops.ablate_sweep
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import _build
from .cap_geometry_sweep import REGISTERS, SM_SHARED, device_ms, problem
from .logmvn import pair_basis
from .logmvn_ablate import STAGES, logmvn_ablate_reference
from .logmvn_kernels import (
    CAP_MAX_THREADS,
    CAP_WARP_COLUMNS,
    CAP_WARP_SAMPLES,
    CHAIN_ROW_BOUNDS,
    _cap_shared_bytes,
    cap_geometry,
)

S, N, K = 10_000, 1280, 20
TIMED = ("elementwise", "elementwise_nolog", "matmul", "full")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    lib, ablate_lib = _build.load_library(), _build.load_library("ablate")
    rows, M, Mp, A, _ = problem(N, 0, device, np.random.default_rng(7))
    kp = Mp.shape[1]
    Mp_flat = pair_basis(M)
    twins = {st: logmvn_ablate_reference(st, rows, M, Mp_flat, A) for st in TIMED}
    picked = cap_geometry(S, N, K, kp)
    ncp = picked.columns
    rows_bound = next(b for b in CHAIN_ROW_BOUNDS if K <= b)
    ll = torch.empty((S,), device=device)
    B = torch.empty((S, kp), device=device)
    u = torch.empty((S, K), device=device)
    misc = torch.empty((S, 2), device=device)
    P = _build.ptr
    for ts in range(CAP_WARP_SAMPLES, 129, CAP_WARP_SAMPLES):
        for tn in (16, 32):
            threads = 32 * (ts // CAP_WARP_SAMPLES) * (ncp // CAP_WARP_COLUMNS)
            smem = _cap_shared_bytes(ts, tn, ncp, 0)
            if threads > CAP_MAX_THREADS or smem > _build.MAX_DYNAMIC_SHARED_BYTES:
                continue
            if 4 * (ts * (kp + K + 2) + rows_bound) > smem:
                continue  # full's chain buffers do not fit
            grid = -(-S // ts)

            def stage(st):
                def run():
                    err = ablate_lib.logmvn_ablate_launch(
                        STAGES[st], P(rows), N, P(M), K, P(Mp), P(A), S, ts, tn, threads,
                        smem, grid, P(ll), _build.stream_ptr(device))
                    _build.check_launch("logmvn_ablate", err)
                return run

            def k2():
                err = lib.logmvn_cap_launch(
                    P(rows), N, P(M), K, P(Mp), kp, P(A), P(None), P(None), P(None), 0, 0, S,
                    ts, tn, threads, smem, grid, P(B), P(u), P(misc),
                    _build.stream_ptr(device))
                _build.check_launch("logmvn_cap", err)

            ms, err = {}, 0.0
            for st in TIMED:
                ms[st] = device_ms(stage(st))
                want = twins[st]
                err = max(err, float((ll - want).abs().max() / want.abs().max()))
            ms["K2"] = device_ms(k2)
            per_sm = min(SM_SHARED // (smem + 1024), 65536 // (threads * REGISTERS))
            mark = "  <- cap_geometry" if (ts, tn) == (picked.samples, picked.pixels) else ""
            el, mm = ms["elementwise"], ms["matmul"]
            print(f"TS={ts:3d} TN={tn} threads={threads} shared={smem} blocks={grid} "
                  f"blocks/SM<={per_sm}: "
                  + ", ".join(f"{n} {v:.4f}" for n, v in ms.items())
                  + f" ms | split of K2: staging+assembly {el:.4f}, FMA loop {mm - el:.4f}, "
                  f"stores {ms['K2'] - mm:.4f} | stages vs twins {err:.1e}{mark}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
