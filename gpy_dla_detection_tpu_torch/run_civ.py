"""CLI: CIV doublet detection.

The port's twin of ``gpy_dla_detection_tpu/run_civ.py``, with its
arguments and ``--device``: the QMC evidence of each spectrum
(``models.civ.civ_inference_many``) and optionally MCMC parameter
refinement (``models.absorber_mcmc.run_civ_mcmc``).

On the CUDA card (the default) it computes in float32 through the
kernels; with ``--device cpu`` in float64, the conformance path.
``GPY_DLA_USE_PALLAS=0`` takes the plain likelihood composition (the CPU
only; ``cli_config.py``).  :func:`run` computes the catalog's arrays and
:func:`main` writes them with h5py.

Usage:
    python -m gpy_dla_detection_tpu_torch.run_civ \\
        --qso_list spec-*.fits --z_qso_list 2.1 ... \\
        --learned-file learned_model-C13_full.mat [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .cli_config import (
    SearchRun,
    add_device_argument,
    kernel_options,
    resolve_device,
    write_search_catalog,
)
from .data.fits import spec_reader
from .data.loaders import load_learned_model
from .data.spectrum import preprocess
from .data.synthetic import synthetic_learned_model
from .models.absorber_mcmc import run_civ_mcmc
from .models.civ import civ_inference_many, civ_spectrum_model, generate_civ_samples
from .models.learned import LearnedModel
from .params import CIVParameters
from .utils.prefetch import prefetch_map


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
    parser.add_argument("--z_qso_list", nargs="+", type=float, required=True)
    parser.add_argument("--learned-file", default=None)
    parser.add_argument("--output", default="processed_civ.h5")
    parser.add_argument("--num-samples", type=int, default=10000)
    parser.add_argument("--mcmc-steps", type=int, default=0)
    add_device_argument(parser)
    return parser


def run(argv=None) -> SearchRun:
    """Parse ``argv`` and run the CIV search up to its catalog arrays."""
    parser = build_parser()
    args = parser.parse_args(argv)
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    try:
        options = kernel_options(dtype)
    except ValueError as e:
        parser.error(str(e))
    device = resolve_device(parser, args.device, dtype, options)

    read_spec = spec_reader(args.release)
    params = CIVParameters(num_civ_samples=args.num_samples)

    if args.learned_file:
        arrays = load_learned_model(args.learned_file)
    else:
        print("[warn] no --learned-file given; using a synthetic CIV-window model")
        arrays = synthetic_learned_model(params)
    learned = LearnedModel.from_numpy(arrays, device, dtype)
    samples = generate_civ_samples(params)

    def load(pair):
        fname, z_qso = pair
        wl, flux, nv, pm = read_spec(fname)
        return preprocess(wl, flux, nv, pm, z_qso, params)

    # FITS reads prefetch on a worker thread and stream straight into the
    # evidence pipeline (models/civ.py); spectra are retained only when
    # the MCMC refinement pass needs them afterwards
    pairs = list(zip(args.qso_list, args.z_qso_list))
    specs = []  # filled only under --mcmc-steps

    def spec_stream():
        for spec in prefetch_map(load, pairs):
            if args.mcmc_steps:
                specs.append(spec)
            yield spec

    results = civ_inference_many(
        learned, spec_stream(), samples, params, use_kernels=options.use_kernels
    )
    p_civs = [r[0] for r in results]
    evidences = [(r[1], r[2]) for r in results]
    for fname, p_civ in zip(args.qso_list, p_civs):
        print(f"{fname}: P(CIV|D) = {p_civ:.4f}")

    if args.mcmc_steps:
        for fname, spec in zip(args.qso_list, specs):
            model = civ_spectrum_model(learned, spec, params)
            generator = torch.Generator(device=device).manual_seed(0)
            chain, lps, acc = run_civ_mcmc(model, params, generator, nsamples=args.mcmc_steps)
            tail = chain[-args.mcmc_steps // 4 :].reshape(-1, 3).cpu().numpy()
            print(
                f"  {fname} MCMC: z = {np.median(tail[:, 0]):.4f}, "
                f"logN = {np.median(tail[:, 1]):.3f}, "
                f"sigma = {np.median(tail[:, 2]):.3g}"
            )

    return SearchRun(
        {"p_civs": np.asarray(p_civs), "log_evidences": np.asarray(evidences)},
        list(args.qso_list),
        args.output,
    )


def main(argv=None):
    """Run the CIV search and write its catalog to ``--output`` (HDF5)."""
    write_search_catalog(run(argv))


if __name__ == "__main__":
    main()
