"""Reference-scale GP training on one CUDA card: the port of
``scripts/train_fullscale.py``.

The reference trains its null GP with MATLAB minFunc L-BFGS, 2,000
iterations over the DR12Q training set (reference:
multi_dlas/learn_qso_model_meanflux.m:161-184).  This script runs the
whole thing with ``gpy_dla_detection_tpu_torch``: Q = 65,024 synthetic
spectra drawn from a generating GP, the rest-grid preparation and PCA
initialization on the host, the 2,000-iteration L-BFGS fit on the card,
and records a JSON artifact (default ``TRAIN_torch.json``):

* wall time per stage (generate / prepare / fit / gate), ms an
  iteration and L-BFGS evaluations an iteration, the fit's peak device
  memory and K3's and its adjoint's launches an evaluation;
* the loss trajectory (downsampled), asserted finite;
* the recovered model's quality against the generating model: mu RMSE,
  the principal angles between the learned and generating low-rank
  subspaces, omega RMSE, the recovered tau_0 and beta;
* a detection gate: the full Bayes model selection (K1, K2, K3) with the
  trained model on held-out spectra, half with injected DLAs.

Memory: each evaluation runs the (Q, R) objective in ``--chunks`` chunks
under ``torch.utils.checkpoint`` (non-reentrant), so the backward holds
one chunk's intermediates: each chunk's forward runs twice (K3 twice) and
its backward once (K3's adjoint once).

Precision: the fit runs in float32 on a SHIFTED objective.  At Q = 65k
the total is ~4e7, whose float32 ulp (~4) swallows the line search's
decrements; the strong-Wolfe test is invariant under adding a constant,
so each per-spectrum loss has a constant near the current mean
subtracted before the sum (the value then stays ~1e4-1e6), and the true
loss, ``value + Q * shift``, is restored on the host in float64.  A
second stage re-shifts at the first stage's optimum and restarts L-BFGS
(a fresh optimizer, so no stale line-search state sees the changed
constant).

    python3 scripts/train_fullscale_torch.py [--num-spectra 65024] [--iters 2000]
        [--chunks 16] [--gate-n 100] [--single-stage] [--output TRAIN_torch.json]
        [--cache PATH.npz] [--device cuda]

``--device cpu`` runs the same float32 program on the CPU through the
kernels' plain twins (the tests); ``--device cuda``, the default, raises
without a card.  ``--cache`` keeps the prepared training set (in
``TrainingSet``'s field names, the JAX script's layout) between runs:
generation and preparation take minutes at Q = 65k.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpy_dla_detection_tpu_torch.data.samples import (  # noqa: E402
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu_torch.data.spectrum import preprocess, to_torch  # noqa: E402
from gpy_dla_detection_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_learned_model,
    synthetic_observation,
    synthetic_prior_catalog,
)
from gpy_dla_detection_tpu_torch.models import training as T  # noqa: E402
from gpy_dla_detection_tpu_torch.models.evidence import null_log_evidence  # noqa: E402
from gpy_dla_detection_tpu_torch.models.learned import (  # noqa: E402
    LearnedModel,
    build_spectrum_model,
)
from gpy_dla_detection_tpu_torch.ops import _build  # noqa: E402
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch  # noqa: E402
from gpy_dla_detection_tpu_torch.params import Parameters  # noqa: E402

TAG = "[train_fullscale_torch]"


def generate_observations(params, learned, Q, seed0=1000, z_range=(2.3, 4.4)):
    """Q DLA-free sightlines from the generating model, with its
    absorption noise (the reference trains on the DLA-free prior subset,
    model_priors.py:85-92).

    :return: the lists (wavelengths, flux, noise_variance, pixel_mask) and
        the redshifts.
    """
    rng = np.random.default_rng(7)
    zs = rng.uniform(*z_range, size=Q)
    wl_l, fx_l, nv_l, pm_l = [], [], [], []
    for i in range(Q):
        wl, fx, nv, pm = synthetic_observation(
            params, learned, float(zs[i]), seed=seed0 + i, with_omega_noise=True
        )
        wl_l.append(wl)
        fx_l.append(fx)
        nv_l.append(nv)
        pm_l.append(pm)
    return wl_l, fx_l, nv_l, pm_l, zs


def chunked_objective_factory(n_chunks: int, shift_per_spectrum: float = 0.0):
    """``total_objective`` with the Q axis in ``n_chunks`` checkpointed
    chunks and each per-spectrum loss shifted by ``shift_per_spectrum``;
    the true loss is ``value + Q * shift_per_spectrum``.  The sum runs in
    the parameters' dtype (float32 on the card, as the JAX script's scan
    carry; float64 on the CPU for the conformance tests)."""
    shift = float(shift_per_spectrum)

    def objective(p, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz, params):
        Q = flux_centered.shape[0]
        if Q % n_chunks:
            raise ValueError(f"{Q} spectra do not split into {n_chunks} chunks")
        Qc = Q // n_chunks
        total = torch.zeros((), dtype=p.M.dtype, device=p.M.device)
        for c in range(n_chunks):
            s = slice(c * Qc, (c + 1) * Qc)
            losses = checkpoint(
                T.batched_spectrum_losses, p, flux_centered[s], lya_1pz[s],
                noise_variance[s], mask[s], zqso_1pz[s], params.num_forest_lines,
                use_reentrant=False, preserve_rng_state=False,
            )
            # the shift comes off each spectrum before the sum: a chunk's
            # sum is then O(|deviation| sqrt(Qc)), not O(|mean loss| Qc),
            # and float32 keeps the precision the line search needs
            total = total + torch.sum(losses - shift)
        return total + T.kim_priors(p)

    return objective


def mean_spectrum_loss(objective_args, params, n_chunks: int) -> float:
    """Mean per-spectrum loss at the current parameters: one forward pass
    a chunk, each chunk's losses summed in float64 and the sums accumulated
    on the host (picks the shift; Q times it, plus the priors, is then the
    true loss to float64 rounding of the float32 losses)."""
    p, flux_centered, lya_1pz, noise_variance, mask, zqso_1pz = objective_args
    Q = flux_centered.shape[0]
    Qc = Q // n_chunks
    total = 0.0
    with torch.no_grad():
        for c in range(n_chunks):
            s = slice(c * Qc, (c + 1) * Qc)
            total += float(torch.sum(T.batched_spectrum_losses(
                p, flux_centered[s], lya_1pz[s], noise_variance[s], mask[s], zqso_1pz[s],
                params.num_forest_lines), dtype=torch.float64))
    return total / Q


def stage_split(iters: int, single_stage: bool = False) -> tuple[int, int]:
    """Iterations of stage A (at the starting point's shift) and of stage
    B (re-shifted at stage A's optimum, a fresh optimizer)."""
    stage_a = iters if single_stage else min(iters, max(100, iters // 5))
    return stage_a, iters - stage_a


class Stage(NamedTuple):
    """One stage of :func:`fit_two_stage`."""

    shift: float  # per spectrum, from mean_spectrum_loss at the stage's start
    start_loss: float  # Q * shift + the priors: the true loss at the stage's start
    values: np.ndarray  # the true loss at the start of each iteration, float64
    evaluations: int  # objective evaluations (the line search's included)


def fit_two_stage(p0, fit_args, params, stage_a: int, stage_b: int, chunks: int):
    """The shifted float32 schedule: stage A fits ``stage_a`` iterations
    at the shift of ``p0``; stage B, when ``stage_b`` > 0, re-shifts at
    stage A's optimum and runs ``stage_b`` iterations on a fresh L-BFGS.

    :return: ``(p_final, values, stages)``: the fitted parameters, the true
        loss at the start of every iteration (float64, both stages), and
        each stage's :class:`Stage`.
    """
    Q = fit_args[0].shape[0]
    p, stages = p0, []
    for tag, iters in (("A", stage_a), ("B", stage_b)):
        if iters <= 0:
            continue
        shift = mean_spectrum_loss((p, *fit_args), params, chunks)
        with torch.no_grad():
            start_loss = Q * shift + float(T.kim_priors(p))
        moved = f" (stage A moved the mean loss by {shift - stages[0].shift:.3f})" if stages else ""
        print(f"{TAG} shift {tag} = {shift:.3f} / spectrum{moved}", flush=True)
        shifted = chunked_objective_factory(chunks, shift)
        evaluations = 0

        def objective(*args):
            nonlocal evaluations
            evaluations += 1
            return shifted(*args)

        t_start = time.time()

        def progress(i, v, tag=tag, t_start=t_start):
            print(f"{TAG} stage {tag} iter {i + 1}: shifted loss {v:.3f} "
                  f"({(time.time() - t_start) / (i + 1) * 1e3:.0f} ms/iter)", flush=True)
            return False

        p, values = T.fit_lbfgs_stepwise(p, *fit_args, params, iters, objective=objective,
                                         callback=progress, callback_every=100)
        stages.append(Stage(shift, start_loss, np.float64(values) + Q * shift, evaluations))
    return p, np.concatenate([s.values for s in stages]), stages


def subspace_principal_angles(A, B):
    """Principal angles (degrees) between span(A) and span(B)."""
    qa, _ = np.linalg.qr(np.asarray(A, np.float64))
    qb, _ = np.linalg.qr(np.asarray(B, np.float64))
    s = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return np.degrees(np.arccos(np.clip(s, -1.0, 1.0)))


def detection_gate(params, learned_trained, learned_true, n=100, seed0=90000):
    """Full Bayes model selection with the TRAINED model (a float32
    ``LearnedModel`` on its device) on held-out spectra from the generating
    model ``learned_true`` (``LearnedArrays``), half carrying injected DLAs
    (logNHI 20.8-21.6).

    :return: the JAX script's gate numbers, plus the per-spectrum null
        evidences of the clean spectra under both models.
    """
    device = learned_trained.M.device
    true_model = LearnedModel.from_numpy(learned_true, device, torch.float32)
    rng = np.random.default_rng(99)
    dla_samples = generate_dla_samples(params)
    sub_samples = generate_subdla_samples(params)
    prior = synthetic_prior_catalog(params)

    spectra, truths, null_trained, null_true = [], [], [], []
    for i in range(n):
        z = float(rng.uniform(2.6, 3.8))
        if i % 2:
            z_dla = float(rng.uniform(z - 0.7, z - 0.1))
            log_nhi = float(rng.uniform(20.8, 21.6))
            dlas = [(z_dla, log_nhi)]
        else:
            dlas = None
        wl, fx, nv, pm = synthetic_observation(params, learned_true, z, seed=seed0 + i,
                                               dlas=dlas)
        spec = preprocess(wl, fx, nv, pm, z, params)
        spectra.append(spec)
        truths.append(dlas)
        if dlas is None:
            # null-evidence agreement, trained vs generating model
            spec_t = to_torch(spec, device, torch.float32)
            null_trained.append(float(null_log_evidence(
                build_spectrum_model(learned_trained, spec_t, params))))
            null_true.append(float(null_log_evidence(
                build_spectrum_model(true_model, spec_t, params))))

    results = process_batch(
        learned_trained, spectra, dla_samples, sub_samples, prior, params,
        torch.Generator(device=device).manual_seed(0), max_dlas=4,
    )

    det, fp, z_errs = [], [], []
    for r, truth in zip(results, truths):
        if truth is not None:
            det.append(r.p_dla > 0.9)
            k_map = int(np.argmax(r.selection.model_posteriors)) - 2
            if k_map >= 0:
                z_map = float(np.asarray(r.map_z_dlas)[k_map, 0])
                z_errs.append(abs(z_map - truth[0][0]))
        else:
            fp.append(r.p_dla > 0.5)
    null_deltas = np.subtract(null_trained, null_true)
    return {
        "n_injected": len(det),
        "detection_rate_p0.9": float(np.mean(det)),
        "false_positive_rate_p0.5": float(np.mean(fp)),
        "map_z_abs_err_median": float(np.median(z_errs)) if z_errs else None,
        "map_z_abs_err_max": float(np.max(z_errs)) if z_errs else None,
        "null_evidence_delta_trained_minus_true_mean": float(np.mean(null_deltas)),
        "null_evidence_delta_trained_minus_true_max_abs": float(np.max(np.abs(null_deltas))),
        "null_log_evidence_trained": null_trained,
        "null_log_evidence_true": null_true,
    }


def training_set(params, learned_true, Q, cache=None):
    """The prepared training set: loaded from the ``cache`` npz when it
    exists, else generated, prepared and, with ``cache``, saved there.

    :return: ``(train, t_generate, t_prepare)`` (seconds; 0 when loaded).
    """
    if cache and os.path.exists(cache):
        with np.load(cache) as f:
            train = T.TrainingSet(**{k: f[k] for k in T.TrainingSet._fields})
        if train.flux.shape[0] != Q:
            raise ValueError(f"the cache {cache} holds {train.flux.shape[0]} spectra, not {Q}")
        print(f"{TAG} loaded cached training set from {cache}", flush=True)
        return train, 0.0, 0.0
    t0 = time.time()
    wl_l, fx_l, nv_l, pm_l, zs = generate_observations(params, learned_true, Q)
    t_gen = time.time() - t0
    print(f"{TAG} generated {Q} spectra in {t_gen:.0f}s", flush=True)
    t0 = time.time()
    train = T.prepare_training_set(params, wl_l, fx_l, nv_l, pm_l, zs)
    t_prep = time.time() - t0
    print(f"{TAG} prepared rest-grid set (R={train.rest_wavelengths.shape[0]}) in "
          f"{t_prep:.0f}s", flush=True)
    if cache:
        np.savez(cache, **train._asdict())
        print(f"{TAG} cached training set to {cache}", flush=True)
    return train, t_gen, t_prep


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"], capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-spectra", type=int, default=65024,
                    help="training-set size (multiple of --chunks)")
    ap.add_argument("--iters", type=int, default=2000,
                    help="L-BFGS iterations (the minFunc setting)")
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--gate-n", type=int, default=100)
    ap.add_argument("--single-stage", action="store_true",
                    help="one shift stage: late decrements resolve at ulp(|total decrease|)")
    ap.add_argument("--output", default="TRAIN_torch.json")
    ap.add_argument("--cache", default=None,
                    help="npz path for the prepared training set (generation and "
                    "preparation take minutes at Q=65k)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the kernels' twins)")
    args = ap.parse_args(argv)

    device = T.training_device(args.device, torch.float32)
    params = Parameters()
    learned_true = synthetic_learned_model(params)
    label = device_label(device)
    print(f"{TAG} device={label} Q={args.num_spectra} iters={args.iters}", flush=True)
    if device.type == "cuda":
        # a fresh checkout compiles the kernels on first use: not in the fit's time
        t0 = time.time()
        _build.load_library()
        print(f"{TAG} kernels ready in {time.time() - t0:.0f}s", flush=True)

    train, t_gen, t_prep = training_set(params, learned_true, args.num_spectra, args.cache)

    t0 = time.time()
    mu, p0 = T.initialize(params, train, device, torch.float32)
    print(f"{TAG} PCA/mean init in {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    put = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    fit_args = (
        put(np.where(train.mask, train.flux - mu, 0.0)),
        put(train.lya_1pz),
        put(train.noise_variance),
        put(train.mask, torch.bool),
        put(train.zqso_1pz),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    print(f"{TAG} device transfer in {time.time() - t0:.0f}s", flush=True)

    stage_a, stage_b = stage_split(args.iters, args.single_stage)
    _build.reset_launch_counts()
    t0 = time.time()
    p_final, values, stages = fit_two_stage(p0, fit_args, params, stage_a, stage_b,
                                            args.chunks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_fit = time.time() - t0
    launches = dict(_build.launch_counts)
    peak_mib = ((torch.cuda.max_memory_allocated(device) - held) / 2**20
                if device.type == "cuda" else None)
    if not np.isfinite(values).all():
        raise RuntimeError("loss trajectory has non-finite entries")
    evaluations = sum(s.evaluations for s in stages)
    print(f"{TAG} {args.iters} L-BFGS iterations in {t_fit:.0f}s "
          f"({t_fit / args.iters * 1e3:.1f} ms/iter, {evaluations / args.iters:.2f} "
          f"evaluations/iter); loss {values[0]:.6g} -> {values[-1]:.6g}", flush=True)

    M, log_omega, log_c_0, log_tau_0, log_beta = p_final.numpy()
    learned_trained = LearnedModel.from_numpy(
        (train.rest_wavelengths, mu, M, log_omega, log_c_0, log_tau_0, log_beta,
         np.float64(params.prev_tau_0), np.float64(params.prev_beta)),
        device, torch.float32,
    )

    # ---- recovered-model quality vs the generating model ----
    grid = train.rest_wavelengths
    mu_true = np.interp(grid, learned_true.rest_wavelengths, learned_true.mu)
    M_true = np.stack(
        [np.interp(grid, learned_true.rest_wavelengths, learned_true.M[:, j])
         for j in range(learned_true.M.shape[1])], axis=1)
    angles = subspace_principal_angles(M, M_true)
    omega_true = np.interp(
        grid, learned_true.rest_wavelengths, np.exp(learned_true.log_omega))
    quality = {
        "mu_rmse_vs_generating": float(np.sqrt(np.mean((mu - mu_true) ** 2))),
        "mu_rms": float(np.sqrt(np.mean(mu_true**2))),
        "M_subspace_principal_angles_deg_quartiles": [
            float(np.percentile(angles, q)) for q in (25, 50, 75, 100)
        ],
        "omega_rmse_vs_generating": float(
            np.sqrt(np.mean((np.exp(log_omega) - omega_true) ** 2))
        ),
        "recovered_tau_0": float(np.exp(log_tau_0)),
        "recovered_beta": float(np.exp(log_beta)),
    }
    print(f"{TAG} quality: {quality}", flush=True)

    if args.gate_n > 0:
        t0 = time.time()
        gate = detection_gate(params, learned_trained, learned_true, n=args.gate_n)
        t_gate = time.time() - t0
        print(f"{TAG} detection gate in {t_gate:.0f}s: "
              f"{ {k: v for k, v in gate.items() if not isinstance(v, list)} }", flush=True)
    else:
        gate, t_gate = None, 0.0

    ds = max(1, args.iters // 100)
    mean_passes = len(stages) * args.chunks  # K3 launches of the shift passes
    artifact = {
        "device": label,
        "num_spectra": args.num_spectra,
        "rest_grid_pixels": int(train.rest_wavelengths.shape[0]),
        "rank_k": int(params.k),
        "num_iterations": args.iters,
        "chunks": args.chunks,
        "dtype": "float32 (shifted objective; two-stage reshift)",
        "shift_schedule": {
            "stage_a_iters": int(stage_a),
            "stage_b_iters": int(stage_b),
            "shift_a_per_spectrum": round(stages[0].shift, 6),
            "shift_b_per_spectrum": round(stages[1].shift, 6) if stage_b > 0 else None,
        },
        "wall_s": {
            "generate": round(t_gen, 1),
            "prepare": round(t_prep, 1),
            "fit": round(t_fit, 1),
            "detection_gate": round(t_gate, 1),
        },
        "ms_per_iteration": round(t_fit / args.iters * 1e3, 2),
        "evaluations_per_iteration": evaluations / args.iters,
        "peak_memory_mib_above_data": peak_mib,
        "launches_per_evaluation": {
            "logmvn_chain": (launches.get("logmvn_chain", 0) - mean_passes) / evaluations
            if device.type == "cuda" else None,
            "logmvn_chain_grad": launches.get("logmvn_chain_grad", 0) / evaluations
            if device.type == "cuda" else None,
        },
        "loss_first": float(values[0]),
        "loss_last": float(values[-1]),
        "loss_trajectory_downsampled": {
            "stride": ds,
            "values": [float(v) for v in values[::ds]],
        },
        "model_quality_vs_generating": quality,
        "detection_gate_with_trained_model": gate,
        "reference": "learn_qso_model_meanflux.m:161-184 (minFunc L-BFGS, "
                     "2000 iterations); gate tolerances from "
                     "tests/test_selection.py:437-452",
    }
    with open(args.output, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"{TAG} wrote {args.output}", flush=True)
    return artifact


if __name__ == "__main__":
    main()
