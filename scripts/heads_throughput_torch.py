"""Throughput of the port's zQSO / CIV / LLS heads (amortized wall clock).

The port's twin of ``scripts/heads_throughput.py``: each head processes
different synthetic spectra through its pipelined many-path (the LLS and
CIV heads' ``max_in_flight`` window, the zQSO head's window of scans);
ms/spectrum = total wall time / count, after a warm-up pass on other
spectra (which also loads the kernels), the card synchronised before the
clock starts and before it stops.  float32 on the card; ``--device cpu``
runs the kernels' twins.  Imports no JAX and nothing of the JAX package.

    python3 scripts/heads_throughput_torch.py [--count 64] [--head all|lls|civ|zqso]
        [--device cuda|cpu] [--num-samples N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpy_dla_detection_tpu_torch.cli_config import KernelOptions, resolve_device  # noqa: E402
from gpy_dla_detection_tpu_torch.utils.timing import card_line  # noqa: E402


def time_head(label, run, warm, device):
    """Print the head's line: ms a spectrum and spectra a second of
    ``run`` (which returns its spectrum count) after ``warm``."""
    warm()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.time()
    n = run()
    sync()
    dt = time.time() - t0
    print(
        f"{label:<6} {1e3 * dt / n:8.1f} ms/spectrum  "
        f"{n / dt:6.1f} spectra/sec  ({n} spectra)",
        flush=True,
    )
    return n / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--count", type=int, default=64)
    ap.add_argument(
        "--head", default="all", choices=["all", "lls", "civ", "zqso"]
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; the kernels) or the CPU (their twins)")
    ap.add_argument("--num-samples", type=int,
                    help="QMC samples of the LLS and CIV heads and candidate redshifts "
                    "of the zQSO head (default: each head's parameters, 10,000)")
    args = ap.parse_args(argv)
    samples_of = lambda field: {} if args.num_samples is None else {field: args.num_samples}
    device = resolve_device(ap, args.device, torch.float32, KernelOptions())
    print(f"device {card_line(device)}", flush=True)

    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
        synthetic_z_learned_model,
    )
    from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
    from gpy_dla_detection_tpu_torch.params import CIVParameters, Parameters

    rates = {}
    if args.head in ("all", "lls"):
        from gpy_dla_detection_tpu_torch.models.lls import (
            generate_lya_samples,
            lls_inference_many,
        )

        params = Parameters(min_lambda=911.75, **samples_of("num_dla_samples"))
        arrays = synthetic_learned_model(params)
        learned = LearnedModel.from_numpy(arrays, device, torch.float32)
        samples = generate_lya_samples(params.num_dla_samples)

        def lls_specs(n, seed0=0):
            for i in range(n):
                z = 2.9 + 0.3 * (i % 5) / 5.0
                wl, fx, nv, pm = synthetic_observation(
                    params, arrays, z, seed=seed0 + i
                )
                yield preprocess(wl, fx, nv, pm, z, params)

        gen = lambda: torch.Generator(device=device).manual_seed(0)
        rates["lls"] = time_head(
            "lls",
            lambda: len(
                lls_inference_many(
                    learned, lls_specs(args.count, 1000), samples, gen(), 2,
                    params,
                )
            ),
            lambda: lls_inference_many(
                learned, lls_specs(8), samples, gen(), 2, params
            ),
            device,
        )

    if args.head in ("all", "civ"):
        from gpy_dla_detection_tpu_torch.models.civ import (
            civ_inference_many,
            generate_civ_samples,
        )

        cparams = CIVParameters(**samples_of("num_civ_samples"))
        carrays = synthetic_learned_model(cparams)
        clearned = LearnedModel.from_numpy(carrays, device, torch.float32)
        csamples = generate_civ_samples(cparams)

        def civ_specs(n, seed0=0):
            for i in range(n):
                z = 2.1 + 0.2 * (i % 5) / 5.0
                wl, fx, nv, pm = synthetic_observation(
                    cparams, carrays, z, seed=seed0 + i
                )
                yield preprocess(wl, fx, nv, pm, z, cparams)

        rates["civ"] = time_head(
            "civ",
            lambda: len(
                civ_inference_many(
                    clearned, civ_specs(args.count, 1000), csamples, cparams
                )
            ),
            lambda: civ_inference_many(
                clearned, civ_specs(16), csamples, cparams
            ),
            device,
        )

    if args.head in ("all", "zqso"):
        from gpy_dla_detection_tpu_torch.models.zqso import (
            inference_z_qso_many,
            prepare_z_spectrum,
        )
        from gpy_dla_detection_tpu_torch.params import ZParameters

        zlearned = synthetic_z_learned_model().to(device, torch.float32)
        zparams = ZParameters(**samples_of("num_zqso_samples"))

        def z_specs(n, seed0=0):
            rng = np.random.default_rng(seed0)
            for i in range(n):
                P = 4000
                wl = 3810.0 * 10 ** (1e-4 * np.arange(P))
                fx = 1.0 + 0.05 * rng.standard_normal(P)
                nv = np.full(P, 0.01)
                pm = np.zeros(P, bool)
                yield prepare_z_spectrum(wl, fx, nv, pm)

        rates["zqso"] = time_head(
            "zqso",
            lambda: len(
                inference_z_qso_many(
                    zlearned, z_specs(args.count, 1000), zparams
                )[0]
            ),
            lambda: inference_z_qso_many(zlearned, z_specs(4), zparams),
            device,
        )
    return rates


if __name__ == "__main__":
    main()
