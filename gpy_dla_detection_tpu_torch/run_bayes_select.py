"""CLI: batched Bayesian DLA detection over a list of spectra.

The port's twin of ``gpy_dla_detection_tpu/run_bayes_select.py``, with its
arguments (less ``--plot-figures``: the plots are not ported) and
``--device``: loads (or synthesizes) the learned model, prior catalog and
QMC samples, reads and preprocesses the spectra on a worker thread, keeps
``--inflight`` dispatched batches queued on the device while one finalize
thread reads them back, checkpoints each batch to a part file, logs a
``.metrics.jsonl`` sidecar, and writes the processed HDF5 catalog.

It runs on the CUDA card unless ``--device cpu`` is given; ``--dtype
float64`` runs on the CPU only.  The reference's ``GPY_DLA_*`` kernel flags
select the configuration (``cli_config.py``).  :func:`run` computes the
catalog arrays and :func:`main` writes them with h5py, which a machine
without h5py never imports.

Usage:
    python -m gpy_dla_detection_tpu_torch.run_bayes_select \\
        --qso_list spec-*.fits --z_qso_list 2.6 3.1 ... \\
        [--max_dlas 4] [--learned-file learned.mat ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import os
import pickle
import time
from typing import NamedTuple

import numpy as np
import torch

from .catalog_io import results_to_arrays, write_catalog
from .cli_config import add_device_argument, device_count, kernel_options, resolve_device
from .data import loaders
from .data.catalog import PriorCatalog
from .data.fits import spec_reader
from .data.samples import fit_log_nhi_prior, generate_dla_samples, generate_subdla_samples
from .data.spectrum import preprocess
from .data.synthetic import synthetic_learned_model, synthetic_prior_catalog
from .models.pipeline import SpectrumResult
from .parallel.batch import device_put_inputs, dispatch_batch, finalize_batch
from .params import Parameters
from .utils.metrics import RunLogger
from .utils.prefetch import prefetch_map


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--qso_list", nargs="+", required=True)
    parser.add_argument("--z_qso_list", nargs="+", type=float, required=True)
    parser.add_argument("--max_dlas", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--output", default="processed_qsos_multi_meanflux.h5")
    parser.add_argument("--learned-file", default=None, help=".mat learned model")
    parser.add_argument("--catalog-file", default=None, help="catalog.mat")
    parser.add_argument("--los-catalog", default=None)
    parser.add_argument("--dla-catalog", default=None)
    parser.add_argument("--dla-samples-file", default=None)
    parser.add_argument("--subdla-samples-file", default=None)
    parser.add_argument(
        "--fit-nhi-prior",
        action="store_true",
        help="re-derive the logNHI sample prior from the --dla-catalog's "
        "own DLAs (KDE -> quadratic log-pdf fit) instead of the published "
        "Garnett coefficients (reference: generate_dla_samples.m:21-54)",
    )
    parser.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32",
        help="float32 (the kernels on the card, their twins on the CPU) or "
        "float64 (the CPU's conformance path)",
    )
    parser.add_argument(
        "--release",
        choices=["dr12q", "dr14q"],
        default="dr12q",
        help="data release the spectra come from (selects the reader; "
        "reference: read_spec.py:22,74)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--num-samples",
        type=int,
        default=None,
        help="override the QMC sample count (default: Parameters default)",
    )
    parser.add_argument(
        "--checkpoint",
        action="store_true",
        help="persist every batch's results to a part file and resume "
        "from existing parts on rerun",
    )
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=None,
        help=argparse.SUPPRESS,  # legacy alias: any N>0 behaves as --checkpoint
    )
    parser.add_argument(
        "--no-sample-lls",
        action="store_true",
        help="catalog-lite: omit the per-sample log-likelihood arrays "
        "and resampling indices from the readback and the catalog "
        "(evidences/MAPs/posteriors are unaffected).  Use for surveys "
        "that don't feed the CDDF analysis",
    )
    parser.add_argument(
        "--inflight",
        type=int,
        default=3,
        help="dispatched batches kept in flight on the device while the "
        "finalize thread drains readbacks (>=1; deeper costs device memory)",
    )
    add_device_argument(parser)
    return parser


class CatalogRun(NamedTuple):
    """What :func:`run` computed: the catalog arrays
    (``catalog_io.results_to_arrays``) and what the catalog records beside
    them."""

    arrays: dict[str, np.ndarray]
    results: list[SpectrumResult]
    qso_list: list[str]
    z_qso_list: list[float]
    all_exceptions: list[int]
    params: Parameters
    max_dlas: int
    output: str


def batch_generator(seed: int, start: int, device) -> torch.Generator:
    """The importance resampling's generator for the batch that starts at
    catalog index ``start``: a function of ``(seed, start)`` alone, so a
    resumed run draws what the uninterrupted one drew."""
    state = np.random.SeedSequence([seed, start]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def run(argv=None) -> CatalogRun:
    """Parse ``argv`` and run the catalog up to its arrays."""
    parser = build_parser()
    args = parser.parse_args(argv)
    dtype = torch.float32 if args.dtype == "float32" else torch.float64
    try:
        options = kernel_options(dtype)
    except ValueError as e:
        parser.error(str(e))
    device = resolve_device(parser, args.device, dtype, options)
    if args.fit_nhi_prior:
        if not args.dla_catalog:
            parser.error("--fit-nhi-prior requires --dla-catalog")
        if args.dla_samples_file or args.subdla_samples_file:
            # the fitted prior only shapes samples we generate ourselves
            parser.error(
                "--fit-nhi-prior conflicts with --dla-samples-file/"
                "--subdla-samples-file: samples loaded from a file keep "
                "the prior they were drawn from"
            )

    read_spec = spec_reader(args.release)
    params = (
        Parameters(num_dla_samples=args.num_samples)
        if args.num_samples
        else Parameters()
    )

    if args.learned_file:
        learned = loaders.load_learned_model(args.learned_file)
    else:
        print("[warn] no --learned-file given; using a synthetic learned model")
        learned = synthetic_learned_model(params)

    if args.catalog_file:
        prior = PriorCatalog.from_mat(
            params, args.catalog_file, args.los_catalog, args.dla_catalog
        )
    else:
        print("[warn] no --catalog-file given; using a synthetic prior catalog")
        prior = synthetic_prior_catalog(params)

    nhi_fit = None
    if args.fit_nhi_prior:
        nhi_fit = fit_log_nhi_prior(np.loadtxt(args.dla_catalog)[:, 2], params)
        print(
            f"[info] fitted logNHI prior from {args.dla_catalog}: "
            f"exp({-nhi_fit.A:.4f} x^2 + {nhi_fit.B:.3f} x + {nhi_fit.C:.2f}), "
            f"peak {nhi_fit.peak:.3f}"
        )

    dla_samples = (
        loaders.load_dla_samples(args.dla_samples_file, params)
        if args.dla_samples_file
        else generate_dla_samples(params, fit=nhi_fit)
    )
    subdla_samples = (
        loaders.load_subdla_samples(args.subdla_samples_file, params)
        if args.subdla_samples_file
        else generate_subdla_samples(params, fit=nhi_fit)
    )

    metrics = RunLogger(
        args.output + ".metrics.jsonl",
        run_config=dict(
            num_spectra=len(args.qso_list),
            max_dlas=args.max_dlas,
            batch_size=args.batch_size,
            num_samples=params.num_dla_samples,
            dtype=args.dtype,
            devices=device_count(device),
        ),
    )

    # the batch-invariant inputs go to the device once, with the decision
    # that the two sample sets share their offsets
    inputs = device_put_inputs(
        learned, dla_samples, subdla_samples, device, dtype
    )

    checkpoint = args.checkpoint or bool(args.checkpoint_every)

    # batches stream through a host-side prefetcher: batch i+1 is read
    # and preprocessed on a worker thread while the device computes
    # batch i, and only the in-flight batches are resident
    total = len(args.qso_list)
    starts = list(range(0, total, args.batch_size))

    def part_path(start):
        return f"{args.output}.part{start:08d}.pkl"

    def part_meta(start):
        """Identity of the batch a part file covers: parts are keyed by
        start offset only, so resuming with a different --batch-size or
        a reordered --qso_list must be detected, not silently misread
        as completed work."""
        return {
            "batch_size": args.batch_size,
            "files": list(args.qso_list[start : start + args.batch_size]),
        }

    def write_part(start, kept, errors, batch_results):
        with open(part_path(start), "wb") as f:
            pickle.dump((part_meta(start), kept, errors, batch_results), f)

    def read_part(start):
        with open(part_path(start), "rb") as f:
            meta, kept, errors, batch_results = pickle.load(f)
        if meta != part_meta(start):
            raise SystemExit(
                f"{part_path(start)} was written by a run with a "
                "different --batch-size or --qso_list; delete the "
                "part files or rerun with the original settings"
            )
        return kept, errors, batch_results

    def load_batch(start):
        """Read + preprocess one batch on the worker thread, with
        per-spectrum failure capture (the reference records
        all_exceptions per QSO,
        multi_dlas/process_qsos_multiple_dlas_meanflux.m:222-233)."""
        if checkpoint and os.path.exists(part_path(start)):
            return start, None, [], []  # results come from the part file
        specs, kept, errors = [], [], []
        for idx in range(start, min(start + args.batch_size, total)):
            filename, z_qso = args.qso_list[idx], args.z_qso_list[idx]
            try:
                wavelengths, flux, noise_variance, pixel_mask = read_spec(filename)
                specs.append(
                    preprocess(
                        wavelengths, flux, noise_variance, pixel_mask,
                        z_qso, params,
                    )
                )
                kept.append(idx)
            except Exception as e:
                errors.append((idx, filename, f"{type(e).__name__}: {e}"))
        return start, specs, kept, errors

    results = []
    kept_all, all_exceptions = [], []
    t0 = time.time()
    done = computed = 0
    # device pipeline: up to --inflight dispatched batches stay queued on
    # the device while a dedicated finalize thread drains them (it waits
    # on each batch's readback event, then runs the model selection and
    # writes the part file)
    window = max(1, args.inflight)
    inflight = collections.deque()  # (start, n, future, t)
    fin_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def finalize_job(start, specs, kept, errors, out):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        batch_results = finalize_batch(
            out, specs, subdla_samples, prior, args.max_dlas
        )
        if checkpoint:
            write_part(start, kept, errors, batch_results)
        return batch_results

    def drain_one():
        nonlocal done, computed
        start, n, future, t_batch = inflight.popleft()
        t_wait = time.time()
        batch_results = future.result()
        results.extend(batch_results)
        done += len(batch_results)
        computed += len(batch_results)
        rate = computed / (time.time() - t0)
        print(f"[{done}/{total}] {rate:.2f} spectra/sec")
        metrics.batch(
            index=start // args.batch_size,
            size=n,
            done=done,
            total=total,
            # main-thread wait on the finalize thread (~0 when fully
            # overlapped); span covers dispatch->drain including the
            # overlapped device compute of the newer in-flight batches
            seconds=time.time() - t_wait,
            span_seconds=round(time.time() - t_batch, 3),
        )

    def drain_all():
        while inflight:
            drain_one()

    try:
        for start, specs, kept, errors in prefetch_map(load_batch, starts):
            # step-granular checkpoint/resume: every batch's results persist
            # to a part file together with its kept indices and failures;
            # reruns skip completed batches and reproduce the original
            # run's output (each batch draws from its own generator)
            if checkpoint and os.path.exists(part_path(start)):
                drain_all()  # keep results in batch order
                batch_kept, batch_errors, batch_results = read_part(start)
                all_exceptions.extend(idx for idx, _, _ in batch_errors)
                results.extend(batch_results)
                kept_all.extend(batch_kept)
                done += len(batch_results)
                continue

            for idx, filename, msg in errors:
                print(f"[skip] {filename}: {msg}")
                metrics.failure(filename, msg)
                all_exceptions.append(idx)
            kept_all.extend(kept)
            if not specs:
                if checkpoint:
                    write_part(start, kept, errors, [])
                continue
            t_batch = time.time()
            out = dispatch_batch(
                inputs, specs, params,
                batch_generator(args.seed, start, device), args.max_dlas,
                voigt_impl=options.voigt_impl,
                abs_dtype=options.abs_dtype,
                window_tier=options.window_tier,
                use_kernels=options.use_kernels,
                resampler=options.resampler,
                with_sample_lls=not args.no_sample_lls,
            )
            inflight.append((
                start,
                len(specs),
                fin_pool.submit(finalize_job, start, specs, kept, errors, out),
                t_batch,
            ))
            while len(inflight) >= window:
                drain_one()

        drain_all()
    finally:
        fin_pool.shutdown()

    qso_list = [args.qso_list[i] for i in kept_all]
    z_qso_list = [args.z_qso_list[i] for i in kept_all]

    for r, name in zip(results, qso_list):
        print(
            f"{name}: p_dla={r.p_dla:.4f} "
            f"MAP z={r.map_z_dlas[0, 0]:.4f} logNHI={r.map_log_nhis[0, 0]:.3f}"
        )
    metrics.finish(
        spectra_processed=len(results),
        spectra_failed=len(all_exceptions),
        spectra_per_sec=round(len(results) / max(time.time() - t0, 1e-9), 3),
        output=args.output,
    )
    return CatalogRun(
        arrays=results_to_arrays(results, params, args.max_dlas),
        results=results,
        qso_list=qso_list,
        z_qso_list=z_qso_list,
        all_exceptions=all_exceptions,
        params=params,
        max_dlas=args.max_dlas,
        output=args.output,
    )


def main(argv=None):
    """Run the catalog and write it to ``--output`` (HDF5, the reference's
    dataset names; ``all_exceptions`` when a spectrum failed)."""
    out = run(argv)
    write_catalog(
        out.output, out.results, out.params, out.max_dlas, out.z_qso_list, out.qso_list
    )
    if out.all_exceptions:
        import h5py

        with h5py.File(out.output, "a") as f:
            f.create_dataset("all_exceptions", data=np.asarray(out.all_exceptions))
    print(f"wrote {out.output}")


if __name__ == "__main__":
    main()
