"""MCMC-head throughput of the port: reference-scale ensemble runs on the card.

The port's twin of ``scripts/mcmc_throughput.py``.  The reference's
``DLAGP.run_mcmc`` is emcee with a serial Python posterior: every step
evaluates nwalkers Voigt + Woodbury likelihoods one at a time
(reference: dla_gp.py:227-309, civ_gp.py:77-156).  The port advances the
whole ensemble a half-step at a time on the card (``models/mcmc.py``:
one K5 launch and one batched Woodbury a half-step).

A DLA chain of 32 walkers x 5,000 steps and a CIV chain of 40 x 5,000,
``MCMC_REPS`` times each (default 4), each run on a different spectrum
with its own ``torch.Generator``; s/chain is the mean over the runs,
after a short warm-up chain that loads the kernels.  ``MCMC_STEPS``
(default 5,000) shortens the chains for a quick check.  float32 on the
card; ``--device cpu`` runs K5's twin.  Imports no JAX and nothing of
the JAX package.

    MCMC_REPS=4 python3 scripts/mcmc_throughput_torch.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpy_dla_detection_tpu_torch.cli_config import KernelOptions, resolve_device  # noqa: E402
from gpy_dla_detection_tpu_torch.data.spectrum import preprocess, to_torch  # noqa: E402
from gpy_dla_detection_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.models.absorber_mcmc import (  # noqa: E402
    run_civ_mcmc,
    run_dla_mcmc,
)
from gpy_dla_detection_tpu_torch.models.learned import (  # noqa: E402
    LearnedModel,
    build_spectrum_model,
)
from gpy_dla_detection_tpu_torch.params import CIVParameters, Parameters  # noqa: E402
from gpy_dla_detection_tpu_torch.utils.timing import card_line  # noqa: E402

REPS = int(os.environ.get("MCMC_REPS", "4"))
STEPS = int(os.environ.get("MCMC_STEPS", "5000"))
WARM_STEPS = 10


def build_models(params, n, device, z0=3.05, dla=(2.82, 21.0)):
    arrays = synthetic_learned_model(params)
    learned = LearnedModel.from_numpy(arrays, device, torch.float32)
    models = []
    for i in range(n):
        wl, fx, nv, pm = synthetic_observation(
            params, arrays, z0, seed=20 + i, dlas=[dla], noise_level=0.05
        )
        spec = preprocess(wl, fx, nv, pm, z0, params)
        models.append(build_spectrum_model(learned, to_torch(spec, device, torch.float32),
                                           params))
    return models


def time_chain(label, run, models, seed0, nwalkers, nsamples, device):
    """Print the chain's line: s/chain, posterior evaluations a second and
    the last run's acceptance; return the evaluations a second."""
    gen = lambda i: torch.Generator(device=device).manual_seed(seed0 + i)
    run(models[0], gen(0), WARM_STEPS)[1].cpu()
    t0 = time.time()
    outs = [run(m, gen(i), nsamples) for i, m in enumerate(models)]
    for _, lps, _ in outs:
        lps.cpu()
    dt = (time.time() - t0) / len(models)
    total = nwalkers * nsamples
    print(
        f"{label:<10} {dt:6.2f} s/chain ({nwalkers} walkers x {nsamples} "
        f"steps; {total / dt:,.0f} posterior evals/sec; "
        f"acceptance {float(outs[-1][2]):.2f})",
        flush=True,
    )
    return total / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; K5) or the CPU (its twin)")
    args = ap.parse_args(argv)
    device = resolve_device(ap, args.device, torch.float32, KernelOptions())
    print(f"device {card_line(device)} reps={REPS} steps={STEPS}", flush=True)

    params = Parameters()
    nw = 32
    dla_rate = time_chain(
        "dla 1x",
        lambda m, g, ns: run_dla_mcmc(m, params, g, k_dlas=1, nwalkers=nw, nsamples=ns),
        build_models(params, REPS, device), 0, nw, STEPS, device)

    cparams = CIVParameters()
    cw = 40
    civ_rate = time_chain(
        "civ",
        lambda m, g, ns: run_civ_mcmc(m, cparams, g, k_civ=1, nwalkers=cw, nsamples=ns),
        build_models(cparams, REPS, device, z0=2.2, dla=(2.1, 20.5)), 100, cw, STEPS, device)
    return {"dla": dla_rate, "civ": civ_rate}


if __name__ == "__main__":
    main()
