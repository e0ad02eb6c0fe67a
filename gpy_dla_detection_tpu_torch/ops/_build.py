"""Build, load and count the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  On first use they
are compiled by ``nvcc`` for ``sm_90a`` (Hopper) into shared libraries in
``csrc/build/`` (:data:`LIBRARIES`: the kernels of the user paths, and the
likelihood-ablation instrument apart), each named by a hash of its
sources, the headers they include and the flags, and loaded with
``ctypes``.  Nothing is built at import time, and nothing falls back: a
missing ``nvcc`` or a failed build raises.

Which implementation runs is decided by the tensor alone
(:func:`use_kernel`): float32 on a CUDA device launches the kernel,
float32 on the CPU takes the kernel's plain PyTorch twin, anything else
raises.  Every wrapper adds one to ``launch_counts[name]`` where it
launches its kernel and nowhere else; an instantiation that stores or
reads int16 profile codes counts under its own name (:func:`store_name`).
One count is of a stage and not of a kernel: ``"civ_profile"``, a CIV
doublet profile evaluated on the card (``ops/voigt.voigt_absorption_civ``,
whose unit optical depth counts as ``"civ_tau"`` and whose K5 launch as
``"absorption_tail"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# library -> its sources.  The ablation instrument (on no user path) has
# its own library: its instantiations of K2's block take a minute of nvcc
# that the user paths' library does not wait for.
LIBRARIES = {
    "kernels": ("absorption_all.cu", "absorption_tail.cu", "absorption_windowed.cu",
                "logmvn_cap.cu", "logmvn_cap_wide.cu", "logmvn_chain.cu",
                "logmvn_chain_grad.cu", "zqso_cap.cu", "civ_tau.cu"),
    "ablate": ("logmvn_ablate.cu",),
}
BUILD_DIR = CSRC / "build"
# each source compiles to an object on its own (all at once), then one link
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_DYNAMIC_SHARED_BYTES = 232448

# kernel name (or "civ_profile") -> launches since the last reset
launch_counts: Counter = Counter()

_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# library -> launcher -> argument types
_SIGNATURES = {"kernels": {
    # wl, P, z, S, nhi, F, num_lines, far_lines, lls_break, poly, store
    # (0 float32, 1 int16), then the geometry (warps a block, shared bytes,
    # grid), out, stream
    "absorption_all_launch": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P, _P],
    # the line table: host floats, their count, stream
    "absorption_all_upload": [_P, _I, _P],
    # unit_tau, nhi, S, P, taps, store, then the geometry (warps a block,
    # shared bytes, grid), out, stream
    "absorption_tail_launch": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P],
    # far, corr, c0, nhi, S, P_pad, P, L, taps, store, then the geometry,
    # out, stream
    "absorption_windowed_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                                   _P, _P],
    # rows, N, M, k, Mp, kp, A, e0, e1, e2, n_extra, store (of A and the
    # streams: 0 float32, 1 int16), S, then the geometry (samples a block,
    # pixels a chunk, threads, shared bytes, grid), B, u, misc, stream
    "logmvn_cap_launch": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # K2's wide kernel: rows, N, the padded basis P, k, kp, then as
    # logmvn_cap_launch from A on, with its geometry (samples a tile, pixels
    # a chunk, padded pair columns, column tiles, threads, shared bytes, grid)
    "logmvn_cap_wide_launch": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # B, u, misc, S, k, then the geometry (row bound, warps a block, shared
    # bytes, grid), ll, stream
    "logmvn_chain_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # B, u, misc, S, k, then the geometry (threads, shared bytes, grid),
    # the workspace (or null: a warp a sample), ll, stream
    "logmvn_chain_wide_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # K3's adjoint: B, u, g, S, k, then the geometry (row bound, warps a
    # block, shared bytes, grid), dB, du, dmisc, stream
    "logmvn_chain_grad_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # B, u, g, S, k, then the geometry (threads, shared bytes, grid), the
    # workspace (or null), dB, du, dmisc, stream
    "logmvn_chain_grad_wide_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # the zQSO exact scan's in-window inputs: z, med, min_obs, max_obs, C,
    # wl, flux, noise, valid, P, rest_wl, mu, M, R, k, min_lambda,
    # max_lambda, then the geometry (row bound, pixels a tile, tiles,
    # threads, shared bytes), the workspace, B, u, misc, stream
    "zqso_cap_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _D, _D,
                        _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # the CIV doublet's unit optical depth: wl, P, z, sigma, S, num_lines,
    # the host constants and their count, then the geometry (warps a block,
    # grid), out, stream
    "civ_tau_launch": [_P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P],
}, "ablate": {
    # stage, rows, N, M, k, Mp, A, S, then K2's geometry (samples a block,
    # pixels a chunk, threads, shared bytes, grid), ll, stream
    "logmvn_ablate_launch": [_I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P, _P],
    # B, its sample and entry strides, u, its strides, misc, its strides,
    # S, k, then the geometry (row bound, warps a block, blocks an SM,
    # samples a chunk, shared bytes, grid), ll, stream
    "logmvn_flat_chain_launch": [_P, _L, _L, _P, _L, _L, _P, _L, _L, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _P, _P],
}}


def reset_launch_counts() -> None:
    launch_counts.clear()


def use_kernel(x: torch.Tensor) -> bool:
    """True when ``x`` selects the CUDA kernel, False for the CPU twin.

    The kernels are float32-only; every other dtype raises, so a float64
    tensor cannot reach a float32 kernel or its twin by accident."""
    if x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32 tensors, got {x.dtype}")
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise TypeError(f"no kernel for device {x.device}")


def check_store_dtype(dtype: torch.dtype | None) -> torch.dtype:
    """The profile storage a kernel takes: float32 (``None`` too) or int16
    codes (``ops/kernel_config.py``); anything else raises."""
    if dtype is None or dtype == torch.float32:
        return torch.float32
    if dtype == torch.int16:
        return torch.int16
    raise TypeError(f"the kernels store profiles as float32 or int16, not {dtype}")


def store_name(name: str, dtype: torch.dtype) -> str:
    """The launch count of a kernel's instantiation for profile storage
    ``dtype``: ``name`` for float32, ``name + "_i16"`` for int16 codes."""
    return name + "_i16" if dtype == torch.int16 else name


def check_cuda_f32(device: torch.device, **tensors: torch.Tensor) -> None:
    """Validate kernel operands: float32, contiguous, on ``device``."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def headers() -> tuple[str, ...]:
    """The headers beside the sources (K2's block, K3's warp chain, K5's and
    K6's tail), which every library's name hashes with its sources."""
    return tuple(sorted(p.name for p in CSRC.glob("*.cuh")))


def library_path(name: str = "kernels") -> Path:
    h = hashlib.sha256()
    for src in LIBRARIES[name] + headers():
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libgpydla_{name}_{h.hexdigest()[:16]}.so"


def build(*names: str) -> list[Path]:
    """Compile the named libraries (default: every one) unless they exist;
    returns their paths.  One ``nvcc`` per source of every library to
    build runs at the same time, then one link a library.  The compilers'
    output (``-Xptxas=-v``: registers and shared memory per kernel) is kept
    beside each library as ``.log``."""
    names = names or tuple(LIBRARIES)
    paths = [library_path(n) for n in names]
    todo = [(n, so) for n, so in zip(names, paths) if not so.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = [(n, src, work / n / f"{Path(src).stem}.o") for n, _ in todo for src in LIBRARIES[n]]
        procs = []
        for n, src, obj in jobs:
            obj.parent.mkdir(exist_ok=True)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = {n: [] for n, _ in todo}
        failed = []
        for (n, src, _), proc in zip(jobs, procs):
            out, _ = proc.communicate()
            logs[n].append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        for n, so in todo:
            if failed:
                break
            tmp = work / n / so.name
            objs = [str(obj) for m, _, obj in jobs if m == n]
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            logs[n].append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link {n}")
        for n, so in todo:
            so.with_suffix(".log").write_text("".join(logs[n]))
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               + "".join(x for n, _ in todo for x in logs[n]))
        for n, so in todo:
            os.replace(work / n / so.name, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


def load_library(name: str = "kernels") -> ctypes.CDLL:
    """The kernel library ``name`` (:data:`LIBRARIES`), built on first use."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)[0]))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def build_variants(tag: str, sources, variants, launchers=(), first_alone: bool = False):
    """Rebuild ``sources`` (under ``csrc/``) once for each of ``variants``,
    a dict of macros each, defined ahead of the sources, into a shared
    library of its own in ``csrc/build/``: one ``nvcc`` a variant, all at
    once (the first alone before the others when ``first_alone``).  The
    ``launchers`` of each library get their argument types.  Returns
    [(CDLL, its path, ptxas output, nvcc seconds)] in the variants' order;
    a failed build raises."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, macros in enumerate(variants):
        # nvcc splits a -D value at its commas, so the macros come from a
        # source of its own that includes the kernels'
        stem = BUILD_DIR / f"{tag}_{i}"
        src, so = stem.with_suffix(".cu"), stem.with_suffix(".so")
        src.write_text("".join(f"#define {m} {v}\n" for m, v in macros.items())
                       + "".join(f"#include \"{CSRC / name}\"\n" for name in sources))
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((macros, so, proc, time.perf_counter()))
        if i == 0 and first_alone:
            proc.wait()
    built = []
    for macros, so, proc, t0 in jobs:
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {macros}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn in launchers:
            getattr(lib, fn).argtypes = _SIGNATURES["kernels"][fn]
            getattr(lib, fn).restype = ctypes.c_int
        built.append((lib, so, out, seconds))
    return built


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers and spill store bytes a thread, from ptxas's ``-v`` output
    ``log``, of each kernel whose mangled name matches the regular
    expression ``kernel``: {the match's groups: (registers, spill bytes)}."""
    usage = {}
    for block in log.split("Compiling entry function")[1:]:
        inst = re.search(kernel, block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if inst and regs:
            usage[inst.groups()] = (int(regs.group(1)), int(spill.group(1)) if spill else 0)
    return usage


def sass_census(so, kernel: str, opcodes, converged: bool = False) -> dict:
    """Instructions by opcode in the SASS (``cuobjdump``) of each kernel of
    library ``so`` whose mangled name matches ``kernel``: {the match's
    groups: (instructions, {opcode: count})} for ``opcodes``.  With
    ``converged``, only the code ahead of the first divergent branch's
    target."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    census = {}
    for body in text.split("Function : ")[1:]:
        inst = re.match(r"\S*" + kernel, body)
        if not inst:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        div = [int(t, 16) for t in re.findall(r"BRA\.DIV \w+, (0x[0-9a-f]+)", body)]
        end = min(div) if converged and div else None
        ops = Counter(op.split(".")[0] for a, op in ins if end is None or int(a, 16) < end)
        census[inst.groups()] = (sum(ops.values()), {o: ops[o] for o in opcodes})
    return census
