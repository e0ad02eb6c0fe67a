"""Time K2 (the capacitance-product kernel) at other launch geometries.

K2's wrapper takes its block from ``cap_geometry`` (samples a block TS,
pixels a chunk TN).  This script launches the same kernel through its C
launcher at every (TS, TN) that fits the block's limits, at the main
path's S = 10,000 and k = 20 (packed basis), at N = 1,280 and 1,664, with
0 and 3 extra streams, with the profiles stored as float32 and as int16
codes (``--store f32``, ``--store i16`` or both, the default), on random
inputs from a seed.  Each line gives the
device ms (CUDA events over 50 launches after a warm-up), the blocks,
threads and shared bytes, the blocks an SM can hold by shared memory and
registers, and the kernel's |dll| against its twin relative to max |ll|;
the geometry ``cap_geometry`` picks is marked.  Then the card's nvidia-smi
name and power limit.

Run from the repository root:

    python3 -m gpy_dla_detection_tpu_torch.ops.cap_geometry_sweep [--store f32|i16]
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from . import _build
from .logmvn_kernels import (
    CAP_MAX_THREADS,
    CAP_WARP_COLUMNS,
    CAP_WARP_SAMPLES,
    _cap_shared_bytes,
    cap_geometry,
    logmvn_cap_reference,
    logmvn_chain_reference,
    packed_pair_basis,
)
from .voigt import encode_profile_store

S, K = 10_000, 20
REGISTERS = 168  # a thread, under the kernel's 384-thread launch bound
SM_SHARED = 228 * 1024  # bytes an SM shares among its blocks (1 KB each reserved)


def device_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def problem(N: int, n_extra: int, device, rng):
    put = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    M = put(rng.normal(size=(N, K)) / np.sqrt(K) * 0.1)
    rows = put(np.stack([1 + 0.1 * rng.normal(size=N), np.ones(N), rng.uniform(0.01, 0.05, N),
                         rng.uniform(0.02, 0.1, N), rng.uniform(size=N) > 0.1]))
    A = put(np.exp(-rng.random((S, N))))
    extra = [put(np.exp(-0.3 * rng.random((S, N)))) for _ in range(n_extra)]
    return rows, M, packed_pair_basis(M), A, extra


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--store", choices=("f32", "i16"), action="append",
                        help="profile storage to sweep (repeatable; default both)")
    stores = parser.parse_args().store or ["f32", "i16"]
    if not torch.cuda.is_available():
        raise SystemExit("cap_geometry_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    lib = _build.load_library()
    rng = np.random.default_rng(7)
    cases = [(store, N, n_extra) for store in stores for N in (1280, 1664) for n_extra in (0, 3)]
    for store, N, n_extra in cases:
        rows, M, Mp, A, extra = problem(N, n_extra, device, rng)
        elem = 4
        if store == "i16":
            A, extra = encode_profile_store(A, torch.int16), [
                encode_profile_store(e, torch.int16) for e in extra]
            elem = 2
        kp = Mp.shape[1]
        ll_twin = logmvn_chain_reference(*logmvn_cap_reference(rows, M, Mp, A, extra))
        scale = float(ll_twin.abs().max())
        picked = cap_geometry(S, N, K, kp, n_extra, elem=elem)
        ncp = picked.columns
        streams = [_build.ptr(e) for e in extra] + [_build.ptr(None)] * (3 - n_extra)
        for ts in range(CAP_WARP_SAMPLES, 129, CAP_WARP_SAMPLES):
            for tn in (16, 32):
                threads = 32 * (ts // CAP_WARP_SAMPLES) * (ncp // CAP_WARP_COLUMNS)
                smem = _cap_shared_bytes(ts, tn, ncp, n_extra, elem)
                if threads > CAP_MAX_THREADS or smem > _build.MAX_DYNAMIC_SHARED_BYTES:
                    continue
                grid = -(-S // ts)
                B = torch.empty((S, kp), device=device)
                u = torch.empty((S, K), device=device)
                misc = torch.empty((S, 2), device=device)

                def run():
                    err = lib.logmvn_cap_launch(
                        _build.ptr(rows), N, _build.ptr(M), K, _build.ptr(Mp), kp,
                        _build.ptr(A), *streams, n_extra, int(elem == 2), S, ts, tn, threads,
                        smem, grid, _build.ptr(B), _build.ptr(u), _build.ptr(misc),
                        _build.stream_ptr(device))
                    _build.check_launch("logmvn_cap", err)

                ms = device_ms(run)
                dll = float((logmvn_chain_reference(B, u, misc) - ll_twin).abs().max()) / scale
                per_sm = min(SM_SHARED // (smem + 1024), 65536 // (threads * REGISTERS))
                mark = "  <- cap_geometry" if (ts, tn) == (picked.samples, picked.pixels) else ""
                print(f"{store} N={N} streams={n_extra} TS={ts:3d} TN={tn} threads={threads} "
                      f"shared={smem} blocks={grid} blocks/SM<={per_sm}: {ms:.4f} ms, "
                      f"|dll|/max|ll| {dll:.1e}{mark}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
