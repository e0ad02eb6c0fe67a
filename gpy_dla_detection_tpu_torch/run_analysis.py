"""CLI driver: population analysis of a processed DLA catalog.

One command replaces the reference's make_plots.py __main__ block
(reference: CDDF_analysis/make_plots.py:271-310): load the processed
catalog, render the full paper-figure set (CDDF / dN/dX / Omega_DLA
with all the split and systematic checks) into an output directory, and
emit the LaTeX tables from the written data files.

The port's twin of ``gpy_dla_detection_tpu/run_analysis.py``, with its
arguments and outputs.  It touches no device: it reads the files (h5py)
and computes on the host (numpy, scipy, matplotlib), as the reference
does.

Usage:
    python -m gpy_dla_detection_tpu_torch.run_analysis \
        --processed processed_qsos.h5 --samples dla_samples.mat \
        [--snrs snrs.mat] [--out figures/] [--max-k 1] \
        [--tables tables.tex] [--quick]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--processed", required=True, help="processed HDF5 catalog")
    parser.add_argument("--samples", required=True, help="QMC sample file (.mat/.h5)")
    parser.add_argument("--snrs", default=None, help="per-spectrum SNR file")
    parser.add_argument("--out", default="analysis_figures")
    parser.add_argument("--tables", default=None, help="write LaTeX tables here")
    parser.add_argument("--max-k", type=int, default=1,
                        help="DLAs per sightline included in the statistics")
    parser.add_argument("--occams-razor", type=float, default=1.0)
    parser.add_argument("--snr-thresh", type=float, default=-2.0)
    parser.add_argument("--bins-per-z", type=int, default=6)
    parser.add_argument(
        "--quick", action="store_true",
        help="headline figures only (skip the split/systematic checks)",
    )
    parser.add_argument(
        "--compare", default=None,
        help="second processed catalog to overlay (reference: "
        "make_plots.py:246-269 do_compare_plots)",
    )
    parser.add_argument("--compare-label", default="compare")
    args = parser.parse_args(argv)

    from .analysis import paper_plots as pp
    from .analysis.cddf import ProcessedCatalog

    cat = ProcessedCatalog.from_file(
        args.processed,
        sample_file=args.samples,
        snrs_file=args.snrs,
        max_k=args.max_k,
        occams_razor=args.occams_razor,
        snr_thresh=args.snr_thresh,
    )
    cat.bins_per_z = args.bins_per_z

    if args.quick:
        pp.do_data_plots(cat, args.out)
    else:
        pp.make_all_plots(cat, args.out)
    print(f"wrote figures + data tables to {args.out}/")

    if args.compare:
        other = ProcessedCatalog.from_file(
            args.compare,
            sample_file=args.samples,
            snrs_file=args.snrs,
            max_k=args.max_k,
            occams_razor=args.occams_razor,
            snr_thresh=args.snr_thresh,
        )
        other.bins_per_z = args.bins_per_z
        pp.do_compare_plots(cat, other, args.out, label=args.compare_label)
        print(f"wrote comparison overlays vs {args.compare}")

    if args.tables:
        from .analysis.tables import all_tables

        with open(args.tables, "w") as f:
            f.write(all_tables(args.out))
        print(f"wrote LaTeX tables to {args.tables}")


if __name__ == "__main__":
    main()
