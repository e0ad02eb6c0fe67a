"""What the CLIs share: the device argument and the reference's kernel flags.

The JAX package selects its kernel configurations with ``GPY_DLA_*``
environment variables, read when its modules are imported
(``gpy_dla_detection_tpu/ops/kernel_config.py``).  The port's library
takes arguments instead and reads no environment.  Its CLIs read the
reference's PRODUCTION flags here, once, and pass them on:

=============================  ==========================================
``GPY_DLA_FAST_VOIGT=0``       ``voigt_impl="exact"``
``GPY_DLA_FUSED_ABS=0``        ``voigt_impl="windowed_unfused"``
``GPY_DLA_FUSED_POLY=0``       ``voigt_impl="windowed_weideman"``
``GPY_DLA_WINDOW_TIER=0``      ``window_tier=False``
``GPY_DLA_ABS_DTYPE=i16|i16p`` ``abs_dtype=torch.int16`` (float32 runs)
``GPY_DLA_RESAMPLER``          ``resampler``
``GPY_DLA_USE_PALLAS=0``       ``use_kernels=False`` (the CPU only)
=============================  ==========================================

They combine as in the reference: ``GPY_DLA_FAST_VOIGT=0`` takes the
exact profiles whatever the other two Voigt flags say, and
``GPY_DLA_FUSED_POLY`` acts only inside the fused kernel, so
``GPY_DLA_FUSED_ABS=0`` overrides it.  A flag counts as on only when it is
``1``.  ``GPY_DLA_ABS_DTYPE`` applies to float32 runs (float64 is the
conformance path, as in the reference), and unset it keeps float32
storage, the port's default: the reference's TPU default ``i16p`` gained
nothing end to end on the card.
"""

from __future__ import annotations

import argparse
import os
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from .models.evidence import RESAMPLERS
from .ops.kernel_config import profile_store_dtype


class KernelOptions(NamedTuple):
    """The configuration arguments of the library's entry points."""

    voigt_impl: str = "windowed"
    abs_dtype: torch.dtype | None = None
    window_tier: bool = True
    use_kernels: bool | None = None
    resampler: str = "multinomial"


def kernel_options(dtype: torch.dtype, environ: Mapping[str, str] | None = None) -> KernelOptions:
    """The reference's PRODUCTION flags in ``environ`` (default: the
    process's environment) as the port's arguments for a run in
    ``dtype``; bad values raise ``ValueError`` with the reference's
    messages."""
    env = os.environ if environ is None else environ
    on = lambda name: env.get(name, "1") == "1"
    if not on("GPY_DLA_FAST_VOIGT"):
        voigt_impl = "exact"
    elif not on("GPY_DLA_FUSED_ABS"):
        voigt_impl = "windowed_unfused"
    elif not on("GPY_DLA_FUSED_POLY"):
        voigt_impl = "windowed_weideman"
    else:
        voigt_impl = "windowed"
    store = env.get("GPY_DLA_ABS_DTYPE", "f32")
    if store not in ("f32", "i16", "i16p"):
        raise ValueError(
            f"GPY_DLA_ABS_DTYPE must be 'f32', 'i16' or 'i16p', got {store!r}"
        )
    abs_dtype = profile_store_dtype(store) if dtype == torch.float32 else dtype
    resampler = env.get("GPY_DLA_RESAMPLER", "multinomial")
    if resampler not in RESAMPLERS:
        raise ValueError(
            f"GPY_DLA_RESAMPLER must be 'multinomial' or 'systematic', "
            f"got {resampler!r}"
        )
    return KernelOptions(
        voigt_impl=voigt_impl,
        abs_dtype=None if abs_dtype == dtype else abs_dtype,
        window_tier=on("GPY_DLA_WINDOW_TIER"),
        use_kernels=None if on("GPY_DLA_USE_PALLAS") else False,
        resampler=resampler,
    )


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the run computes: the CUDA card (default; the kernels, "
        "float32) or the CPU (the kernels' plain twins, or float64)",
    )


def resolve_device(
    parser: argparse.ArgumentParser, device: str, dtype: torch.dtype, options: KernelOptions
) -> torch.device:
    """The run's device, or a ``parser.error``: ``cuda`` needs a card, and
    runs neither float64 (which takes no kernel) nor the plain likelihood
    composition (``GPY_DLA_USE_PALLAS=0``).  Nothing falls back to the
    CPU."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        parser.error(
            "--device cuda: no CUDA device (torch.cuda.is_available() is False); "
            "pass --device cpu to run on the CPU"
        )
    if dtype == torch.float64:
        parser.error("float64 runs on the CPU only (--device cpu): on the card it takes no kernel")
    if options.use_kernels is False:
        parser.error("GPY_DLA_USE_PALLAS=0 (the plain likelihood composition) runs on the "
                     "CPU only (--device cpu)")
    return torch.device("cuda", torch.cuda.current_device())


def device_and_dtype(
    parser: argparse.ArgumentParser, device: str
) -> tuple[torch.device, torch.dtype]:
    """The device of an example or an accuracy gate (or a
    ``parser.error``, as :func:`resolve_device`) and its dtype: float32 on
    the card, where the kernels run, float64 on the CPU, the JAX package's
    conformance dtype."""
    placed = resolve_device(parser, device, torch.float32, KernelOptions())
    return placed, torch.float32 if placed.type == "cuda" else torch.float64


def require_matplotlib(parser: argparse.ArgumentParser, what: str, remedy: str) -> None:
    """``parser.error`` where matplotlib does not import: a run that would
    draw stops at its argument parsing, before any work, and never skips
    its drawing silently."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        parser.error(
            f"{what} draws with matplotlib, which does not import here ({e}); "
            f"install it or {remedy}"
        )


def device_count(device: torch.device) -> int:
    """Devices of the run, for the metrics sidecar: the visible cards on
    CUDA, 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


class SearchRun(NamedTuple):
    """What the LLS or CIV CLI's ``run`` computed: its catalog's datasets,
    in the reference's names, and where they go."""

    arrays: dict[str, np.ndarray]
    qso_list: list[str]
    output: str


def write_search_catalog(out: SearchRun) -> None:
    """Write a search's catalog to HDF5 as the reference's CLIs do: its
    datasets, then ``qso_list`` as strings."""
    import h5py

    with h5py.File(out.output, "w") as f:
        for name, arr in out.arrays.items():
            f.create_dataset(name, data=arr)
        f.create_dataset("qso_list", data=np.asarray(out.qso_list, h5py.string_dtype()))
    print(f"wrote {out.output}")
