"""CLI: strong-Lya-absorber (LLS) search.

The port's twin of ``gpy_dla_detection_tpu/run_find_lls.py``, with its
arguments and ``--device``: null-vs-k-absorber model selection using the
Lyman-limit-break profile and the BOSS mean-flux parameters.  FITS reads
prefetch on a worker thread and stream into ``models.lls``'s batched
search, which one seeded generator drives.

On the CUDA card (the default) it computes in float32 through the
kernels; with ``--device cpu`` in float64, the conformance path.  The
reference's ``GPY_DLA_*`` kernel flags select the configuration
(``cli_config.py``).  :func:`run` computes the catalog's arrays and
:func:`main` writes them with h5py.

Usage:
    python -m gpy_dla_detection_tpu_torch.run_find_lls \\
        --qso_list spec-*.fits --z_qso_list 3.1 ... \\
        [--learned-file learned.mat] [--max-lya 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .cli_config import (
    SearchRun,
    add_device_argument,
    kernel_options,
    resolve_device,
    write_search_catalog,
)
from .data.catalog import PriorCatalog
from .data.fits import spec_reader
from .data.loaders import load_learned_model
from .data.spectrum import preprocess
from .data.synthetic import synthetic_learned_model
from .models.learned import LearnedModel
from .models.lls import (
    generate_lya_samples,
    lls_inference_many,
    lls_model_posteriors,
    with_boss_meanflux,
)
from .params import Parameters
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
    parser.add_argument("--output", default="processed_lls.h5")
    parser.add_argument("--max-lya", type=int, default=4)
    parser.add_argument("--num-samples", type=int, default=10000)
    parser.add_argument("--min-log-nhi", type=float, default=17.2)
    parser.add_argument("--max-log-nhi", type=float, default=23.0)
    parser.add_argument("--min-lambda", type=float, default=850.0)
    parser.add_argument(
        "--boss-meanflux",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="apply the BOSS DR12 mean-flux lift to the learned model "
        "(default on; --no-boss-meanflux disables it)",
    )
    parser.add_argument(
        "--prior",
        choices=["garnett", "uniform"],
        default="garnett",
        help="logNHI sample prior: data-driven Garnett fit (reference "
        "default) or flat",
    )
    parser.add_argument("--catalog-file", default=None, help="catalog.mat for "
                        "data-driven model priors")
    parser.add_argument("--los-catalog", default=None)
    parser.add_argument("--dla-catalog", default=None)
    parser.add_argument("--seed", type=int, default=0)
    add_device_argument(parser)
    return parser


def run(argv=None) -> SearchRun:
    """Parse ``argv`` and run the LLS search up to its catalog arrays."""
    parser = build_parser()
    args = parser.parse_args(argv)
    dtype = torch.float32 if args.device == "cuda" else torch.float64
    try:
        options = kernel_options(dtype)
    except ValueError as e:
        parser.error(str(e))
    device = resolve_device(parser, args.device, dtype, options)

    read_spec = spec_reader(args.release)
    # a bluer model window so Lyman-limit breaks are inside it
    params = Parameters(
        num_dla_samples=args.num_samples,
        min_lambda=args.min_lambda,
        num_pixels_padded=1664 if args.min_lambda < 900 else 1280,
    )

    if args.learned_file:
        arrays = load_learned_model(args.learned_file)
    else:
        print("[warn] no --learned-file; using a synthetic learned model")
        arrays = synthetic_learned_model(params)
    learned = LearnedModel.from_numpy(arrays, device, dtype)
    if args.boss_meanflux:
        learned = with_boss_meanflux(learned)

    samples = generate_lya_samples(
        args.num_samples, args.min_log_nhi, args.max_log_nhi, prior=args.prior
    )

    prior_catalog = None
    if args.catalog_file:
        prior_catalog = PriorCatalog.from_mat(
            params, args.catalog_file, args.los_catalog, args.dla_catalog
        )

    def load(pair):
        fname, z_qso = pair
        wl, flux, nv, pm = read_spec(fname)
        return preprocess(wl, flux, nv, pm, z_qso, params)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    rows = []
    t0 = time.time()
    # FITS reads prefetch on a worker thread and stream straight into the
    # batched search (models/lls.py); the search windows are captured as
    # spectra stream past
    z_windows = []

    def spec_stream():
        for spec in prefetch_map(load, list(zip(args.qso_list, args.z_qso_list))):
            z_windows.append((float(spec.min_z_dla), float(spec.max_z_dla)))
            yield spec

    outs = lls_inference_many(
        learned, spec_stream(), samples, generator, args.max_lya, params,
        voigt_impl=options.voigt_impl, abs_dtype=options.abs_dtype,
        window_tier=options.window_tier, use_kernels=options.use_kernels,
        resampler=options.resampler,
    )
    for i, ((fname, z_qso), (min_z, max_z), (null_ev, result)) in enumerate(
        zip(zip(args.qso_list, args.z_qso_list), z_windows, outs)
    ):
        if prior_catalog is not None:
            m, n = prior_catalog.less_ind(z_qso)
            post = lls_model_posteriors(null_ev, result.log_evidences, m, n)
        else:
            post = lls_model_posteriors(null_ev, result.log_evidences)
        rows.append(
            dict(
                null_ev=null_ev,
                lls_evs=result.log_evidences,
                posteriors=post,
                map_z=result.map_z_dlas,
                map_lognhi=result.map_log_nhis,
                min_z=min_z,
                max_z=max_z,
            )
        )
        p_lls = 1.0 - post[0]
        print(
            f"[{i + 1}/{len(args.qso_list)}] {fname}: P(LLS|D)={p_lls:.4f} "
            f"MAP z={rows[-1]['map_z'][0, 0]:.4f} "
            f"logNHI={rows[-1]['map_lognhi'][0, 0]:.3f} "
            f"({(i + 1) / (time.time() - t0):.2f} spectra/s)"
        )

    arrays = {
        "min_z_lyas": np.array([r["min_z"] for r in rows]),
        "max_z_lyas": np.array([r["max_z"] for r in rows]),
        "log_likelihoods_no_lya": np.array([r["null_ev"] for r in rows]),
        "log_likelihoods_lya": np.stack([r["lls_evs"] for r in rows]),
        "model_posteriors": np.stack([r["posteriors"] for r in rows]),
        "MAP_z_lyas": np.stack([r["map_z"] for r in rows]),
        "MAP_log_nhis": np.stack([r["map_lognhi"] for r in rows]),
        "z_qsos": np.asarray(args.z_qso_list),
    }
    return SearchRun(arrays, list(args.qso_list), args.output)


def main(argv=None):
    """Run the LLS search and write its catalog to ``--output`` (HDF5)."""
    write_search_catalog(run(argv))


if __name__ == "__main__":
    main()
