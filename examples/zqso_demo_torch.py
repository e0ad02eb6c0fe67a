"""Quasar redshift estimation demo on synthetic spectra, on the PyTorch port.

The port's twin of ``examples/zqso_demo.py`` (itself the script twin of
the reference's "Quasar Redshift Estimations.ipynb" notebook): build a
wide-window zQSO GP, generate spectra at known redshifts, scan the
candidate redshifts with the correlation scan (its solves on K3 on the
card; the reference notebook loops 10,000 serial set_data calls,
reference: zqso_gp.py:214-250), and save the per-spectrum posterior-scan
figure.

On the card (``--device cuda``, the default) the scans run in float32;
``--device cpu`` runs them in float64.  ``--no-plots`` skips the drawing
(the card's machine has no matplotlib); without it, a missing matplotlib
stops the run before any work.

Run:  python3 examples/zqso_demo_torch.py [outdir] [--device cuda|cpu] [--no-plots]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from gpy_dla_detection_tpu_torch.cli_config import (  # noqa: E402
    device_and_dtype,
    require_matplotlib,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outdir", nargs="?",
                        default=os.path.join(tempfile.gettempdir(), "zqso_demo"))
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--no-plots", action="store_true",
                        help="compute everything, draw nothing (no matplotlib needed)")
    parser.add_argument("--num-samples", type=int, default=2000,
                        help="candidate redshifts of the scan")
    args = parser.parse_args(argv)
    device, dtype = device_and_dtype(parser, args.device)
    if not args.no_plots:
        require_matplotlib(parser, "the demo's figure", "pass --no-plots")

    from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_z_observation
    from gpy_dla_detection_tpu_torch.models.zqso import (
        inference_z_qso,
        prepare_z_spectrum,
    )
    from gpy_dla_detection_tpu_torch.params import ZParameters

    os.makedirs(args.outdir, exist_ok=True)
    params = ZParameters(num_zqso_samples=args.num_samples)

    z_trues = [2.5, 3.1, 4.0]
    scans = []
    for z_true in z_trues:
        learned, (wl, flux, nv, pm) = synthetic_z_observation(z_true, seed=1)
        spec = prepare_z_spectrum(wl, flux, nv, pm, params.num_pixels_padded)
        z_map, lls, z_grid = inference_z_qso(learned.to(device, dtype), spec, params)
        print(f"z_true = {z_true:.3f} -> z_map = {z_map:.3f}")
        assert abs(z_map - z_true) < 0.5, (z_map, z_true)
        scans.append((z_true, z_map, lls, z_grid))

    if not args.no_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(len(z_trues), 1, figsize=(10, 3 * len(z_trues)))
        for ax, (z_true, z_map, lls, z_grid) in zip(np.atleast_1d(axes), scans):
            finite = np.isfinite(lls)
            ax.plot(z_grid[finite], lls[finite], lw=0.6)
            ax.axvline(z_true, color="C2", ls="--", label=f"truth {z_true}")
            ax.axvline(z_map, color="C3", ls=":", label=f"MAP {z_map:.3f}")
            ax.set_xlabel("z_qso")
            ax.set_ylabel("log evidence")
            ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(args.outdir, "zqso_scan.png"), dpi=100)
        plt.close(fig)
        print(f"wrote {args.outdir}/zqso_scan.png")
    return [z_map for _, z_map, _, _ in scans]


if __name__ == "__main__":
    main()
