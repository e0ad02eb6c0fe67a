"""Where K2's wide kernel and K3's wide chain spend their time.

K2's wide kernel (``csrc/logmvn_cap_wide.cu``) walks the pixels in chunks
through four stages: the stream copies (A, the extra streams and the
chunk's spectrum rows), the basis copies, the assembly of w and r, and the
3xTF32 products.  This script

1. rebuilds ``csrc/logmvn_cap_wide.cu`` alone in three forms
   (``VARIANTS``: as shipped, 64 samples x 256 columns a tile and a ring of
   3 stages; the same with a ring of 5, whose copies have four iterations
   to land instead of two; and 128 x 128, which assembles each chunk's w
   and r for twice as many column tiles and reads the streams twice as
   often but the basis half as often), the shipped one also with each
   stage left out (``CAP_WIDE_ABLATE`` 1-4), one ``nvcc`` a build, all at
   once, and prints each build's registers and spill bytes from ptxas;
2. times each build through its C launcher on the construction of
   ``tests/test_torch_kernels_gpu.py`` (seed k, S = 10,000, N = 1,280,
   float32) at k = 54 and 65 with 3 chained streams and at k = 54 with
   none: device ms a launch, the profiler's kernel time over 50 launches
   after a warm-up (a build with a stage left out computes garbage; each
   whole build's |dll| against the twin, relative to max |ll|, is
   checked);
3. counts each tile's SASS instructions by opcode in the float32,
   16-byte-copy instantiation;
4. times K3's wide chain (the shipped library, through ``logmvn_chain``)
   at k = 65, 80, 100 and 130 on the twin's products of the same
   construction, S = 10,000: how its time grows with k says whether the
   left-looking dot products (~k^3 / 6 a sample) or the per-column steps
   (~k) set it; and counts its SASS instructions by opcode.

Then the card's nvidia-smi name and power limit.  Run from the repository
root:

    python3 -m gpy_dla_detection_tpu_torch.ops.cap_wide_sweep
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from . import _build
from .logmvn_kernels import (
    logmvn_cap_reference,
    logmvn_chain,
    logmvn_chain_reference,
    packed_pair_basis,
    wide_cap_basis,
    wide_cap_geometry,
)
from .timing import device_ms

S, N = 10_000, 1280
ABLATIONS = {0: "shipped", 1: "no stream copies", 2: "no basis copies", 3: "no assembly",
             4: "no products"}
CASES = ((54, 3), (65, 3), (54, 0))  # (k, extra streams)
# (samples, padded columns) a tile, the ring's stages; shipped first
VARIANTS = ((64, 256, 3), (64, 256, 5), (128, 128, 3))
CHAIN_KS = (65, 80, 100, 130)
OPCODES = ("HMMA", "LDS", "STS", "LDGSTS", "LDG", "STG", "BAR", "FFMA", "FADD", "FMUL", "MUFU",
           "SHFL", "DADD", "BRA")


def build_variants():
    """One library per tile and ablation: [(tile, ablation, CDLL, its path,
    ptxas output)]."""
    variants = [(tile, ab) for tile in VARIANTS
                for ab in (ABLATIONS if tile == VARIANTS[0] else (0,))]
    built = _build.build_variants(
        "cap_wide_sweep", ("logmvn_cap_wide.cu",),
        [{"CAP_WIDE_ABLATE": ab, "CAP_WIDE_BM": tile[0], "CAP_WIDE_BN": tile[1],
          "CAP_WIDE_STAGES": tile[2]} for tile, ab in variants],
        ("logmvn_cap_wide_launch",))
    return [(tile, ab, lib, so, log) for (tile, ab), (lib, so, log, _) in zip(variants, built)]


def ptxas_usage(log: str) -> dict:
    """(copy bytes, storage) -> (registers, spill store bytes)."""
    return {(vb, {"f": "f32", "s": "i16"}[st]): u for (vb, st), u in
            _build.ptxas_usage(log, r"logmvn_cap_wide_kernelILi(\d+)E(\w)").items()}


def sass_census(so, pattern: str) -> tuple[int, dict]:
    """Opcode counts of the first function of ``so`` whose name matches."""
    census = _build.sass_census(so, pattern, OPCODES)
    if not census:
        raise RuntimeError(f"no function matching {pattern} in {so}")
    return next(iter(census.values()))


def problem(k: int, n_extra: int, device):
    """tests/test_torch_kernels_gpu.py's construction at S x N, seed k."""
    rng = np.random.default_rng(k)
    put = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    M = put(rng.normal(size=(N, k)) / np.sqrt(k) * 0.1)
    rows = put(np.stack([1 + 0.1 * rng.normal(size=N), np.ones(N), rng.uniform(0.01, 0.05, N),
                         rng.uniform(0.02, 0.1, N), rng.uniform(size=N) > 0.1]))
    A = put(np.exp(-rng.random((S, N))))
    extra = [put(np.exp(-0.3 * rng.random((S, N)))) for _ in range(n_extra)]
    return rows, M, packed_pair_basis(M), A, extra


def launcher(lib, tile, rows, M, Mp, A, extra, device):
    k, kp, n_extra = M.shape[1], Mp.shape[1], len(extra)
    g = wide_cap_geometry(S, N, k, kp, n_extra, 4, *tile)
    P = wide_cap_basis(M, Mp, g)
    out = (torch.empty((S, kp), device=device), torch.empty((S, k), device=device),
           torch.empty((S, 2), device=device))
    streams = [_build.ptr(e) for e in extra] + [_build.ptr(None)] * (3 - n_extra)

    def run():
        err = lib.logmvn_cap_wide_launch(
            _build.ptr(rows), N, _build.ptr(P), k, kp, _build.ptr(A), *streams,
            n_extra, 0, S, g.samples, g.pixels, g.pair_columns, g.tiles, g.threads,
            g.shared_bytes, g.grid, *[_build.ptr(x) for x in out], _build.stream_ptr(device))
        _build.check_launch("logmvn_cap_wide", err)

    return run, out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cap_wide_sweep: needs a CUDA device")
    device = torch.device("cuda", 0)
    built = build_variants()
    for tile, ab, _, _, log in built:
        print(f"build {tile[0]}x{tile[1]}, {tile[2]} stages, {ab} ({ABLATIONS[ab]}): " + ", ".join(
            f"{vb}-byte {st}: {r} registers, {sp} spill bytes"
            for (vb, st), (r, sp) in sorted(ptxas_usage(log).items())), flush=True)
    for k, n_extra in CASES:
        rows, M, Mp, A, extra = problem(k, n_extra, device)
        ll_twin = logmvn_chain_reference(*logmvn_cap_reference(rows, M, Mp, A, extra))
        for tile in VARIANTS:
            line = []
            for t_, ab, lib, _, _ in built:
                if t_ != tile:
                    continue
                run, out = launcher(lib, tile, rows, M, Mp, A, extra, device)
                ms = device_ms(run, kernels=1)[0]
                if ab == 0:
                    run()
                    dll = float((logmvn_chain_reference(*out) - ll_twin).abs().max()
                                / ll_twin.abs().max())
                    if not dll <= 1e-6:
                        raise SystemExit(f"k={k} tile {tile}: |dll| {dll:.2e} > 1e-6")
                    line.append(f"{ABLATIONS[ab]} {ms:.4f} (|dll| / max|ll| {dll:.1e})")
                else:
                    line.append(f"{ABLATIONS[ab]} {ms:.4f}")
            print(f"K2 wide {tile[0]}x{tile[1]}, {tile[2]} stages, S={S} N={N} k={k} "
                  f"streams={n_extra}, device ms (profiler, 50 launches): " + ", ".join(line),
                  flush=True)
    for tile in VARIANTS:
        so = next(so for t_, ab, _, so, _ in built if t_ == tile and ab == 0)
        total, ops = sass_census(so, r"logmvn_cap_wide_kernelILi16EfE")
        print(f"K2 wide {tile[0]}x{tile[1]}, {tile[2]} stages, SASS (16-byte copies, float32): "
              f"{total} instructions, " + ", ".join(f"{o} {n}" for o, n in ops.items()),
              flush=True)

    line = []
    for k in CHAIN_KS:
        rows, M, Mp, A, _ = problem(k, 0, device)
        cap = logmvn_cap_reference(rows, M, Mp, A)
        ms = device_ms(lambda: logmvn_chain(*cap), kernels=1)[0]
        line.append(f"k={k} {ms:.4f} ms ({ms / (k ** 3 / 6 * S) * 1e9:.2f} ns a "
                    f"k^3/6-FMA x 1e3 samples)")
    print(f"K3 wide chain S={S}, device ms (profiler, 50 launches): " + ", ".join(line),
          flush=True)
    lib_path = _build.library_path("kernels")
    total, ops = sass_census(lib_path, r"logmvn_chain_wide_warp_kernel")
    print(f"K3 wide chain SASS: {total} instructions, "
          + ", ".join(f"{o} {n}" for o, n in ops.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
