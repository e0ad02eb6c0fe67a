"""Training throughput on one CUDA card: ms per L-BFGS iteration.

The port's twin of ``scripts/train_throughput.py``.  The reference trains
with MATLAB minFunc L-BFGS over a serial per-spectrum objective loop
(reference: learn_qso_model_meanflux.m:161-162, objective_lyseries.m:42).
This measures ``models/training.fit_lbfgs_stepwise`` per iteration with
(a) the batched objective, ``total_objective``: two (Q, R) products, K3
forward and K3's adjoint backward, and (b) the per-spectrum
``spectrum_loss`` batched with ``torch.func.vmap``, whose factorizations
are the library's batched Cholesky and triangular solve; on the
training's synthetic problem (``data/synthetic.synthetic_training_problem``)
at the reference's R = 1,217, k = 20, 31 forest lines, float32.  Each
objective fits once as a warm-up, then once timed.

    TRAIN_Q=4096 TRAIN_ITERS=20 python3 scripts/train_throughput_torch.py [--device cuda]

``--device cpu`` runs the kernels' plain twins (the tests); ``cuda``, the
default, raises without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_training_problem  # noqa: E402
from gpy_dla_detection_tpu_torch.models.training import (  # noqa: E402
    TrainingParams,
    fit_lbfgs_stepwise,
    spectrum_loss,
    training_device,
)
from gpy_dla_detection_tpu_torch.params import Parameters  # noqa: E402

Q = int(os.environ.get("TRAIN_Q", "4096"))
ITERS = int(os.environ.get("TRAIN_ITERS", "20"))


def time_fit(p0, args, params, iters, device, objective=None):
    """ms an iteration of a timed fit after a warm-up one, and its values."""
    fit_lbfgs_stepwise(p0, *args, params, iters, objective=objective)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _, values = fit_lbfgs_stepwise(p0, *args, params, iters, objective=objective)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    assert np.isfinite(values).all(), values
    return dt / iters * 1e3, values


def vmapped_objective(p, flux, lya_1pz, nv, mask, zqso, params):
    """The per-spectrum loss over the batch by ``torch.func.vmap``, without
    the priors (as the JAX script's)."""
    losses = torch.func.vmap(
        lambda y, z1, v, m, zq: spectrum_loss(y, z1, v, m, zq, p, params.num_forest_lines)
    )(flux, lya_1pz, nv, mask, zqso)
    return torch.sum(losses)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the kernels' twins)")
    args = ap.parse_args(argv)
    device = training_device(args.device, torch.float32)
    params = Parameters()
    R = int(round((params.max_lambda - params.min_lambda) / params.dlambda)) + 1
    fields, arrays = synthetic_training_problem(Q, R, params.k, seed=0)
    p0 = TrainingParams.from_numpy(fields, device)
    data = tuple(torch.as_tensor(x, device=device) for x in arrays)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Q={Q} R={R} k={params.k} iters={ITERS} device={name}")

    ms_b, v_b = time_fit(p0, data, params, ITERS, device)
    print(f"batched objective:  {ms_b:8.1f} ms/iteration "
          f"({Q / (ms_b / 1e3):,.0f} spectrum-losses/sec)")
    ms_v, v_v = time_fit(p0, data, params, ITERS, device, objective=vmapped_objective)
    print(f"vmapped objective:  {ms_v:8.1f} ms/iteration")
    print(f"speedup: {ms_v / ms_b:.1f}x; final losses "
          f"batched={v_b[-1]:.3f} vmapped={v_v[-1]:.3f}")
    return {"Q": Q, "iters": ITERS, "device": name,
            "batched": {"ms_per_iteration": ms_b, "values": v_b},
            "vmapped": {"ms_per_iteration": ms_v, "values": v_v}}


if __name__ == "__main__":
    main()
