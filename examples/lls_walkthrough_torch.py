"""Worked walkthrough of the strong-Lya-absorber (LLS) finder, on the PyTorch port.

The port's twin of ``examples/lls_walkthrough.py`` (itself the script
twin of the reference's notebook-style ``examples/gp_find_lls.py``,
reference: examples/gp_find_lls.py:52-1125) on synthetic data:

1. the data-driven logNHI prior on [17.2, 23] -- Garnett's quadratic fit
   with the flat low-column extension -- plotted against its QMC samples
   and checked to integrate to 1 (the reference computes the same
   normalization constant with ``scipy.integrate.quad``,
   gp_find_lls.py:325-351);
2. a synthetic quasar with an injected logNHI = 19.6 absorber INCLUDING
   its Lyman-limit break (the regime the search exists for,
   reference: voigt_lls.py:254-284);
3. the BOSS mean-flux lift (tau_0 = 0.00554, beta = 3.182,
   reference: gp_find_lls.py:404-417);
4. null-vs-k-absorber evidences from the shared QMC engine with the
   LLS-break profile (K1 with the break, K2 and K3 on the card), combined
   with the catalog-driven model priors into P(k | D) (reference:
   gp_find_lls.py:757-767);
5. the MAP (z, logNHI) read off the per-sample likelihood surface, the
   fitted model over the data (the MAP absorber's profile on the model's
   padded grid, K5 on the card), and the sample-likelihood scatter -- the
   three figures the reference walkthrough builds.

On the card (``--device cuda``, the default) the model runs in float32;
``--device cpu`` runs it in float64.  ``--no-plots`` computes every
figure's data and draws nothing (the card's machine has no matplotlib);
without it, a missing matplotlib stops the run before any work.

Run:  python3 examples/lls_walkthrough_torch.py [outdir] [--device cuda|cpu] [--no-plots]
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
                        default=os.path.join(tempfile.gettempdir(), "lls_walkthrough"))
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--no-plots", action="store_true",
                        help="compute every figure's data, draw nothing (no matplotlib needed)")
    parser.add_argument("--num-samples", type=int, default=5000,
                        help="QMC samples of (z, logNHI)")
    args = parser.parse_args(argv)
    device, dtype = device_and_dtype(parser, args.device)
    if not args.no_plots:
        require_matplotlib(parser, "the walkthrough's figures", "pass --no-plots")

    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess, to_torch
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
        synthetic_prior_catalog,
    )
    from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, build_spectrum_model
    from gpy_dla_detection_tpu_torch.models.lls import (
        BOSS_BETA,
        BOSS_TAU_0,
        generate_lya_samples,
        lls_log_evidences,
        lls_model_posteriors,
        lya_log_nhi_pdf,
        with_boss_meanflux,
    )
    from gpy_dla_detection_tpu_torch.ops.voigt import voigt_absorption_lls
    from gpy_dla_detection_tpu_torch.params import Parameters

    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)

    # The search window reaches blueward of the quasar's Lyman limit so
    # the break itself is in-model (same choice as run_find_lls.py).
    params = Parameters(
        num_dla_samples=args.num_samples, min_lambda=850.0, num_pixels_padded=1664
    )

    # ------------------------------------------------------------------
    # 1. the logNHI prior and its QMC samples
    # ------------------------------------------------------------------
    samples = generate_lya_samples(params.num_dla_samples)
    grid = np.linspace(17.2, 23.0, 600)
    pdf = lya_log_nhi_pdf(grid)
    norm = np.trapezoid(pdf, grid)
    print(f"logNHI prior normalization over [17.2, 23]: {norm:.6f}")
    assert abs(norm - 1.0) < 1e-3, norm

    # ------------------------------------------------------------------
    # 2. a synthetic quasar with an injected LLS (break included)
    # ------------------------------------------------------------------
    z_qso, z_lls, log_nhi_true = 3.5, 3.15, 19.6
    arrays = synthetic_learned_model(params)
    learned = with_boss_meanflux(LearnedModel.from_numpy(arrays, device, dtype))
    # the observation is drawn from the same model, BOSS mean flux included
    wl, flux, nv, pm = synthetic_observation(
        params,
        arrays._replace(prev_tau_0=np.float64(BOSS_TAU_0), prev_beta=np.float64(BOSS_BETA)),
        z_qso,
        seed=7,
        dlas=[(z_lls, log_nhi_true)],
        with_lls_break=True,
    )
    spec = preprocess(wl, flux, nv, pm, z_qso, params)

    # ------------------------------------------------------------------
    # 3. + 4. evidences and model posteriors
    # ------------------------------------------------------------------
    max_lya = 4
    null_ev, result = lls_log_evidences(
        learned, spec, samples, torch.Generator(device=device).manual_seed(0), max_lya, params
    )
    null_ev = float(null_ev)
    evs = result.log_evidences.cpu().numpy().astype(np.float64)
    print(f"log evidence (null)        = {null_ev:.2f}")
    for k in range(max_lya):
        print(f"log evidence ({k + 1} absorber) = {evs[k]:.2f}")

    prior = synthetic_prior_catalog(params)
    m, n = prior.less_ind(z_qso)
    post = lls_model_posteriors(null_ev, evs, m, n)
    p_lls = 1.0 - post[0]
    print(f"model posteriors = {np.array2string(post, precision=4)}")
    print(f"P(at least one strong absorber | D) = {p_lls:.4f}")
    assert p_lls > 0.99, "injected 19.6 absorber must be detected"

    # ------------------------------------------------------------------
    # 5. MAP parameters, fitted model, likelihood surface
    # ------------------------------------------------------------------
    map_z = float(result.map_z_dlas[0, 0])
    map_lognhi = float(result.map_log_nhis[0, 0])
    print(
        f"truth: z = {z_lls:.4f}, logNHI = {log_nhi_true:.2f}   "
        f"MAP: z = {map_z:.4f}, logNHI = {map_lognhi:.2f}"
    )
    assert abs(map_z - z_lls) < 0.02, (map_z, z_lls)
    assert abs(map_lognhi - log_nhi_true) < 0.5, (map_lognhi, log_nhi_true)

    # the fitted model's curves on the model's device: the MAP absorber's
    # profile on the padded grid, so that each pixel lines up with mu
    model = build_spectrum_model(learned, to_torch(spec, device, dtype), params)
    n_pix = int(model.mask.sum())
    wl_m = np.asarray(spec.wavelengths)[:n_pix]
    flux_m = np.asarray(spec.flux)[:n_pix]
    mu_m = model.mu.cpu().numpy()[:n_pix]
    absorption = voigt_absorption_lls(
        model.padded_wavelengths,
        torch.tensor([10.0**map_lognhi], dtype=dtype, device=device),
        torch.tensor([map_z], dtype=dtype, device=device),
        params.num_lines,
    )[0].cpu().numpy()[:n_pix]

    min_z, max_z = float(spec.min_z_dla), float(spec.max_z_dla)
    z_samp = min_z + (max_z - min_z) * samples.offset_samples
    sll = result.sample_log_likelihoods[:, 0].cpu().numpy()
    fin = np.isfinite(sll)

    if not args.no_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        ax.hist(
            samples.log_nhi_samples,
            bins=60,
            density=True,
            alpha=0.4,
            label=f"{params.num_dla_samples} Halton samples",
        )
        ax.plot(grid, pdf, "C3", label="Garnett fit, flat below 20.03")
        ax.axvline(20.03, color="gray", ls=":", lw=0.8)
        ax.set_xlabel(r"$\log_{10} N_{\rm HI}$")
        ax.set_ylabel("prior density")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, "lls_prior.png"), dpi=100)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(11, 4))
        ax.plot(wl_m, flux_m, lw=0.4, color="gray", label="observed")
        ax.plot(wl_m, mu_m, "C0", lw=1.0, label="GP continuum (null)")
        ax.plot(wl_m, mu_m * absorption, "C3", lw=1.0, label="GP + MAP LLS")
        ax.axvline(1215.67 * (1 + map_z), color="C3", ls=":", lw=0.8)
        ax.set_xlabel("observed wavelength [A]")
        ax.set_ylabel("normalized flux")
        ax.set_title(
            f"P(LLS|D) = {p_lls:.3f}, MAP z = {map_z:.3f}, "
            f"logNHI = {map_lognhi:.2f} (truth {z_lls}, {log_nhi_true})"
        )
        ax.legend(loc="lower right")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, "lls_fit.png"), dpi=100)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(8, 5))
        sc = ax.scatter(
            z_samp[fin],
            samples.log_nhi_samples[fin],
            c=sll[fin],
            s=3,
            vmin=np.nanpercentile(sll[fin], 60),
            cmap="viridis",
        )
        ax.plot(z_lls, log_nhi_true, "r*", ms=14, label="truth")
        ax.plot(map_z, map_lognhi, "wx", ms=10, mew=2, label="MAP")
        fig.colorbar(sc, label="sample log likelihood")
        ax.set_xlabel("z absorber")
        ax.set_ylabel(r"$\log_{10} N_{\rm HI}$")
        ax.legend(loc="upper left")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, "lls_samples.png"), dpi=100)
        plt.close(fig)

        print(f"wrote {outdir}/lls_prior.png, lls_fit.png, lls_samples.png")
    return {"norm": norm, "p_lls": p_lls, "map_z": map_z, "map_log_nhi": map_lognhi,
            "fit": mu_m * absorption}


if __name__ == "__main__":
    main()
