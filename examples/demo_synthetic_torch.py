"""End-to-end demo on synthetic data (no downloads, no .mat files), on the PyTorch port.

The port's twin of ``examples/demo_synthetic.py``: train a GP on
synthetic spectra (K3 forward and its adjoint on the card), detect
injected DLAs with Bayesian model selection (K1, K2 and K3), refine
parameters with MCMC (K5 a half-step), and produce the plots (the
MAP-absorbed mean through K5).

On the card (``--device cuda``, the default) everything runs in float32;
``--device cpu`` runs it in float64.  ``--no-plots`` computes every
figure's data and draws nothing (the card's machine has no matplotlib);
without it, a missing matplotlib stops the run before any work.

    python3 examples/demo_synthetic_torch.py [--out-dir demo_out] [--device cuda|cpu] [--no-plots]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from gpy_dla_detection_tpu_torch.cli_config import (  # noqa: E402
    device_and_dtype,
    require_matplotlib,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default="demo_out")
    parser.add_argument("--num-spectra", type=int, default=8)
    parser.add_argument("--num-samples", type=int, default=2000)
    parser.add_argument("--train-iters", type=int, default=50,
                        help="L-BFGS iterations of the training")
    parser.add_argument("--mcmc-steps", type=int, default=800,
                        help="ensemble steps; the first quarter is burn-in")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--no-plots", action="store_true",
                        help="compute every figure's data, draw nothing (no matplotlib needed)")
    args = parser.parse_args(argv)
    device, dtype = device_and_dtype(parser, args.device)
    if not args.no_plots:
        require_matplotlib(parser, "the demo's figures", "pass --no-plots")
    os.makedirs(args.out_dir, exist_ok=True)

    from gpy_dla_detection_tpu_torch import plotting
    from gpy_dla_detection_tpu_torch.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess, to_torch
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
        synthetic_prior_catalog,
    )
    from gpy_dla_detection_tpu_torch.models import training as T
    from gpy_dla_detection_tpu_torch.models.absorber_mcmc import run_dla_mcmc
    from gpy_dla_detection_tpu_torch.models.learned import build_spectrum_model
    from gpy_dla_detection_tpu_torch.parallel.batch import process_batch
    from gpy_dla_detection_tpu_torch.params import Parameters

    params = Parameters(num_dla_samples=args.num_samples)
    truth = synthetic_learned_model(params)
    prior = synthetic_prior_catalog(params)
    generator = lambda seed: torch.Generator(device=device).manual_seed(seed)

    # ----- 1. train a GP on clean synthetic spectra --------------------
    print("== training the null GP ==")
    wl_l, fx_l, nv_l, pm_l, zs = [], [], [], [], []
    rng = np.random.default_rng(0)
    for i in range(16):
        z = float(rng.uniform(2.5, 3.6))
        wl, fx, nv, pm = synthetic_observation(params, truth, z, seed=500 + i, noise_level=0.05)
        rest = wl / (1 + z)
        norm = np.nanmedian(fx[(rest >= 1310) & (rest <= 1325)])
        wl_l.append(wl); fx_l.append(fx / norm); nv_l.append(nv / norm**2)
        pm_l.append(pm); zs.append(z)
    train = T.prepare_training_set(params, wl_l, fx_l, nv_l, pm_l, zs)
    t0 = time.time()
    learned, losses = T.train_model(params, train, num_iterations=args.train_iters,
                                    device=device, dtype=dtype)
    print(f"   trained in {time.time() - t0:.1f}s; loss {losses[0]:.1f} -> {losses[-1]:.1f}")

    # ----- 2. detect injected DLAs ------------------------------------
    print("== Bayesian model selection ==")
    injected = []
    spectra = []
    for i in range(args.num_spectra):
        z_qso = 2.8 + 0.1 * i
        dla = [(z_qso - 0.35, 20.6 + 0.1 * i)] if i % 2 else None
        injected.append(dla)
        wl, fx, nv, pm = synthetic_observation(params, truth, z_qso, seed=i, dlas=dla)
        spectra.append(preprocess(wl, fx, nv, pm, z_qso, params))

    dla_s = generate_dla_samples(params)
    sub_s = generate_subdla_samples(params)
    t0 = time.time()
    results = process_batch(
        learned, spectra, dla_s, sub_s, prior, params, generator(0), 4
    )
    dt = time.time() - t0
    print(f"   {len(spectra)} spectra in {dt:.1f}s ({len(spectra) / dt:.2f}/s)")
    for i, r in enumerate(results):
        truth_str = f"injected z={injected[i][0][0]:.2f}" if injected[i] else "clean"
        print(
            f"   [{i}] {truth_str:>22}: p_dla={r.p_dla:.3f} "
            f"MAP z={r.map_z_dlas[0, 0]:.3f} logNHI={r.map_log_nhis[0, 0]:.2f}"
        )

    # ----- 3. MCMC refinement on one detection ------------------------
    print("== MCMC refinement ==")
    i_det = 1
    model = build_spectrum_model(learned, to_torch(spectra[i_det], device, dtype), params)
    steps = args.mcmc_steps
    chain, lps, acc = run_dla_mcmc(
        model, params, generator(7), k_dlas=1, nwalkers=32, nsamples=steps
    )
    chain = chain.cpu().numpy()
    tail = chain[-(3 * steps // 8):].reshape(-1, 2)
    print(
        f"   posterior z = {np.median(tail[:, 0]):.4f} +- {tail[:, 0].std():.4f}, "
        f"logNHI = {np.median(tail[:, 1]):.3f} +- {tail[:, 1].std():.3f} "
        f"(accept {float(acc):.2f})"
    )

    # ----- 4. plots ----------------------------------------------------
    r = results[i_det]
    spec = spectra[i_det]
    sample_z_dlas = np.asarray(spec.min_z_dla) + (
        np.asarray(spec.max_z_dla) - np.asarray(spec.min_z_dla)) * dla_s.offset_samples
    # the MAP-absorbed mean the model plot draws, on the model's device
    fit = plotting.absorbed_mean(model, params, r.map_z_dlas[0, :1], r.map_log_nhis[0, :1])
    if not args.no_plots:
        fig = plotting.plot_dla_model(
            model,
            params,
            sample_z_dlas=sample_z_dlas,
            log_nhi_samples=dla_s.log_nhi_samples,
            sample_log_likelihoods=r.sample_log_likelihoods_dla,
            map_z_dlas=r.map_z_dlas,
            map_log_nhis=r.map_log_nhis,
            nth_dla=1,
            title=f"p_dla = {r.p_dla:.3f}",
        )
        fig.savefig(os.path.join(args.out_dir, "dla_model.png"), dpi=90)
        fig2 = plotting.plot_corner(chain, labels=["z_dla", "logNHI"], burn_in=steps // 4)
        fig2.savefig(os.path.join(args.out_dir, "corner.png"), dpi=90)
        print(f"   wrote plots to {args.out_dir}/")
    return {"losses": losses, "results": results, "injected": injected, "chain": chain,
            "fit": plotting.to_host(fit)}


if __name__ == "__main__":
    main()
