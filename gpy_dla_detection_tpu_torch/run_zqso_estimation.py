"""CLI: quasar redshift estimation over a list of spectra.

The port's twin of ``gpy_dla_detection_tpu/run_zqso_estimation.py``, with
its arguments and ``--device`` (reference: tests/test_zestimation.py:22-77,
zqso_gp.py:214-250).  FITS reads prefetch on a worker thread and stream
into ``models.zqso.inference_z_qso_many``, which scans each spectrum's
redshift grid on the device while earlier scans' results are copied back.

On the CUDA card (the default) it computes in float32, the correlation
scan's k x k solves on K3; with ``--device cpu`` in float64.  :func:`run`
computes the MAP redshifts and :func:`main` writes them with h5py.

Usage:
    python -m gpy_dla_detection_tpu_torch.run_zqso_estimation \\
        --qso_list spec-*.fits [--learned-file learned_zqso_....mat] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from .cli_config import KernelOptions, add_device_argument, resolve_device
from .data.fits import spec_reader
from .data.loaders import load_z_learned_model
from .data.synthetic import synthetic_z_learned_model
from .models.zqso import inference_z_qso_many, prepare_z_spectrum
from .params import ZParameters
from .utils.prefetch import prefetch_map


class ZqsoRun(NamedTuple):
    """What :func:`run` computed: the MAP redshifts (NaN where a scan
    found no finite evidence), the spectra in order, the wall seconds of
    the scans and where the catalog goes."""

    z_map: np.ndarray
    qso_list: list[str]
    seconds: float
    output: str


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--qso_list", nargs="+", required=True)
    parser.add_argument(
        "--release",
        choices=["dr12q", "dr14q"],
        default="dr12q",
        help="data release the spectra come from (selects the reader; "
        "reference: read_spec.py:22,74)",
    )
    parser.add_argument("--learned-file", default=None)
    parser.add_argument("--output", default="zqso_estimates.h5")
    parser.add_argument("--z-min", type=float, default=2.14)
    parser.add_argument("--z-max", type=float, default=6.16)
    parser.add_argument("--num-samples", type=int, default=10000)
    add_device_argument(parser)
    return parser


def run(argv=None) -> ZqsoRun:
    """Parse ``argv`` and estimate every spectrum's redshift."""
    parser = build_parser()
    args = parser.parse_args(argv)
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    device = resolve_device(parser, args.device, dtype, KernelOptions())

    read_spec = spec_reader(args.release)
    params = ZParameters(num_zqso_samples=args.num_samples)
    if args.learned_file:
        arrays = load_z_learned_model(args.learned_file)
    else:
        print("[warn] no --learned-file given; using a synthetic zQSO model")
        arrays = synthetic_z_learned_model()
    # the learned model goes to the device once, for every scan
    learned = arrays.to(device, dtype)

    def load(fname):
        wl, flux, nv, pm = read_spec(fname)
        return prepare_z_spectrum(wl, flux, nv, pm, params.num_pixels_padded)

    t0 = time.time()
    # FITS reads prefetch on a worker thread and stream straight into
    # the scan pipeline (reads, device compute and host readback all
    # overlap — models/zqso.py inference_z_qso_many)
    results, _ = inference_z_qso_many(
        learned, prefetch_map(load, args.qso_list), params, args.z_min, args.z_max,
    )
    seconds = time.time() - t0
    z_maps = np.asarray([z for z, _ in results])
    for i, (fname, z_map) in enumerate(zip(args.qso_list, z_maps)):
        print(f"[{i + 1}/{len(args.qso_list)}] {fname}: z_map = {z_map:.4f}")
    print(f"{len(z_maps) / seconds:.2f} spectra/sec")
    return ZqsoRun(z_maps, list(args.qso_list), seconds, args.output)


def main(argv=None):
    """Estimate the redshifts and write ``z_map`` and ``qso_list`` to
    ``--output`` (HDF5)."""
    out = run(argv)
    import h5py

    with h5py.File(out.output, "w") as f:
        f.create_dataset("z_map", data=out.z_map)
        f.create_dataset("qso_list", data=np.asarray(out.qso_list, h5py.string_dtype()))
    print(f"wrote {out.output}")


if __name__ == "__main__":
    main()
