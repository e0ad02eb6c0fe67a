#!/usr/bin/env python3
"""Measure the card's memory rate and float32 FMA rate.

The kernel bounds in PERF.md divide bytes by the HBM rate and float32
operations by the float32 peak.  This script measures both on the card
it runs on, beside the published H100 SXM figures (3.35 TB/s, 67 TFLOP/s
float32 outside the tensor cores):

* device-memory rate: ``copy_`` of a 2 GiB float32 buffer (2 bytes moved
  per byte copied) and ``sum`` over it (read only), CUDA events over 20
  calls after a warm-up;
* float32 FMA rate: a small CUDA kernel (built here with nvcc into the
  port's gitignored build directory) in which every thread runs 8
  independent FMA chains, 132 x 16 blocks of 256 threads;
* for reference, a float32 matrix product (8192^3, TF32 off).

Prints one line per figure and the card's nvidia-smi name and power
limit.  Run from the repository root:  python3 scripts/card_peaks.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gpy_dla_detection_tpu_torch.ops import _build  # noqa: E402

FMA_SRC = r"""
#include <cuda_runtime.h>
__global__ void fma_loop(float* out, int iters, float a, float b) {
  float x0 = threadIdx.x, x1 = x0 + 1, x2 = x0 + 2, x3 = x0 + 3;
  float x4 = x0 + 4, x5 = x0 + 5, x6 = x0 + 6, x7 = x0 + 7;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x0 = fmaf(x0, a, b); x1 = fmaf(x1, a, b); x2 = fmaf(x2, a, b);
      x3 = fmaf(x3, a, b); x4 = fmaf(x4, a, b); x5 = fmaf(x5, a, b);
      x6 = fmaf(x6, a, b); x7 = fmaf(x7, a, b);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = x0 + x1 + x2 + x3 + x4 + x5 + x6 + x7;
}
extern "C" int fma_launch(float* out, int blocks, int threads, int iters, void* stream) {
  fma_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters, 0.999999f, 1e-7f);
  return (int)cudaGetLastError();
}
"""
FMAS_PER_ITER = 8 * 16


def events_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_fma() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "peaks"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fma_loop.cu"
    src.write_text(FMA_SRC)
    so = out_dir / "libfma_loop.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-1], "-shared", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.fma_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
    lib.fma_launch.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("card_peaks: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    n = 1 << 29  # 2 GiB of float32
    src = torch.rand(n, device=dev)
    dst = torch.empty_like(src)
    copy_ms = events_ms(lambda: dst.copy_(src))
    sum_ms = events_ms(lambda: src.sum())
    nbytes = 4 * n
    # elapsed times are in ms: bytes / ms / 1e6 = GB/s
    print(f"hbm copy {2 * nbytes / copy_ms / 1e6:.1f} GB/s (read+write), "
          f"sum {nbytes / sum_ms / 1e6:.1f} GB/s (read) | published 3350 GB/s")
    del src, dst

    lib = build_fma()
    blocks, threads, iters = 132 * 16, 256, 4096
    out = torch.empty(blocks * threads, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def fma():
        err = lib.fma_launch(ctypes.c_void_p(out.data_ptr()), blocks, threads, iters, stream)
        if err:
            raise RuntimeError(f"fma_loop: CUDA error {err}")

    fma_ms = events_ms(fma, reps=5)
    flops = 2.0 * blocks * threads * iters * FMAS_PER_ITER
    print(f"fp32 fma {flops / fma_ms / 1e6:.1f} GFLOP/s | published 67000 GFLOP/s")

    a = torch.rand((8192, 8192), device=dev)
    mm_ms = events_ms(lambda: a @ a, reps=5)
    print(f"fp32 matmul (TF32 off) {2 * 8192**3 / mm_ms / 1e6:.1f} GFLOP/s")
    print(card)


if __name__ == "__main__":
    main()
