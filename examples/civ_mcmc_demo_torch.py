"""CIV doublet detection + MCMC demo on a synthetic spectrum, on the PyTorch port.

The port's twin of ``examples/civ_mcmc_demo.py`` (itself the script twin
of the reference's "GP CIV using MCMC.ipynb" notebook): build a
CIV-window GP, inject a CIV doublet, run the QMC evidence (which the
reference notebook could not -- reference: civ_gp.py:248-250 left it as
TODO; one K5, K2 and K3 launch on the card) and the affine-invariant
ensemble MCMC (one K5 launch a half-step), then save the corner plot.

On the card (``--device cuda``, the default) the model runs in float32;
``--device cpu`` runs it in float64.  ``--no-plots`` skips the drawing
(the card's machine has no matplotlib); without it, a missing matplotlib
stops the run before any work.

Run:  python3 examples/civ_mcmc_demo_torch.py [outdir] [--device cuda|cpu] [--no-plots]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from gpy_dla_detection_tpu_torch.cli_config import (  # noqa: E402
    device_and_dtype,
    require_matplotlib,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outdir", nargs="?",
                        default=os.path.join(tempfile.gettempdir(), "civ_demo"))
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--no-plots", action="store_true",
                        help="compute everything, draw nothing (no matplotlib needed)")
    parser.add_argument("--num-samples", type=int, default=2000,
                        help="QMC samples of the evidence")
    parser.add_argument("--mcmc-steps", type=int, default=2000,
                        help="ensemble steps; the last quarter is the tail")
    args = parser.parse_args(argv)
    device, dtype = device_and_dtype(parser, args.device)
    if not args.no_plots:
        require_matplotlib(parser, "the demo's figure", "pass --no-plots")

    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        civ_doublet_transmission,
        synthetic_learned_model,
        synthetic_observation,
    )
    from gpy_dla_detection_tpu_torch.models.absorber_mcmc import run_civ_mcmc
    from gpy_dla_detection_tpu_torch.models.civ import (
        civ_model_posterior,
        civ_null_log_evidence,
        civ_qmc_log_evidence,
        civ_spectrum_model,
        generate_civ_samples,
    )
    from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
    from gpy_dla_detection_tpu_torch.models.mcmc import autocorrelation_time
    from gpy_dla_detection_tpu_torch.params import CIVParameters

    os.makedirs(args.outdir, exist_ok=True)
    params = CIVParameters(num_civ_samples=args.num_samples)
    z_qso = 2.1
    z_civ_true, log_nciv_true, sigma_true = 1.85, 14.5, 2.4e6

    arrays = synthetic_learned_model(params)
    wl, flux, nv, pm = synthetic_observation(params, arrays, z_qso, seed=0)
    # the unbroadened doublet, exact Faddeeva
    flux = flux * civ_doublet_transmission(wl, z_civ_true, log_nciv_true, sigma_true)

    spec = preprocess(wl, flux, nv, pm, z_qso, params)
    # the CIV covariance carries no absorption-noise term
    # (reference: civ_gp.py:158-183)
    model = civ_spectrum_model(LearnedModel.from_numpy(arrays, device, dtype), spec, params)

    samples = generate_civ_samples(params)
    null_ev = float(civ_null_log_evidence(model))
    civ_ev, _ = civ_qmc_log_evidence(model, samples, params)
    p_civ = civ_model_posterior(null_ev, float(civ_ev))
    print(f"P(CIV | D) = {p_civ:.4f}   (truth: doublet at z={z_civ_true})")

    steps = args.mcmc_steps
    chain, log_probs, acc = run_civ_mcmc(
        model, params, torch.Generator(device=device).manual_seed(0), nsamples=steps
    )
    chain = chain.cpu().numpy()
    tail = chain[-(steps // 4):].reshape(-1, 3)
    print(
        f"MCMC medians: z = {np.median(tail[:, 0]):.4f} "
        f"(true {z_civ_true}), logN = {np.median(tail[:, 1]):.3f} "
        f"(true {log_nciv_true}), sigma = {np.median(tail[:, 2]):.3g} "
        f"(true {sigma_true:.3g}); acceptance = {float(acc):.2f}"
    )
    tau = autocorrelation_time(chain[:, 0, 0])
    print(f"autocorrelation time (z chain, walker 0): {tau:.1f} steps")

    if not args.no_plots:
        from gpy_dla_detection_tpu_torch.plotting import plot_corner

        fig = plot_corner(
            chain.reshape(-1, 3),
            labels=["z_civ", "log N_CIV", "sigma"],
            burn_in=(steps // 4) * chain.shape[1],
        )
        fig.savefig(os.path.join(args.outdir, "civ_corner.png"), dpi=100)
        print(f"wrote {args.outdir}/civ_corner.png")
    return {"p_civ": p_civ, "chain": chain, "acceptance": float(acc)}


if __name__ == "__main__":
    main()
