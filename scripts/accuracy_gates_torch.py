"""Full-scale synthetic accuracy gates of the port's three variant heads.

The port's twin of ``scripts/accuracy_gates.py``: measured detection and
estimation accuracy over hundreds of synthetic spectra, the analogue of
the reference's published-catalog acceptance gates that need real SDSS
data (reference: tests/test_zestimation.py:68-70 requires P(|dz|<0.5) >
0.98 over 100 spectra; tests/test_selection.py:428-452 pins p_dla).  The
same seeds, spectra, injections, sample counts, detection rules, JSON
keys, completeness bins and pass/fail rule; the LLS search's resampling
draws come from a ``torch.Generator`` seeded 0 (the JAX script's
``PRNGKey(0)``), so only its second level differs.

Each gate's per-spectrum outputs come from a helper (``zqso_outputs``,
``lls_outputs``, ``civ_outputs``) that the tests call on a few spectra;
the gate composes the JSON from them.  On the card the heads run in
float32 (the kernels), on the CPU in float64.  Imports no JAX and
nothing of the JAX package.

    python3 scripts/accuracy_gates_torch.py [--n-zqso 300] [--n-lls 200] [--n-civ 200]
        [--num-samples 10000] [--device cuda|cpu] [--out ACCURACY_torch.json]

Exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gpy_dla_detection_tpu_torch.cli_config import device_and_dtype  # noqa: E402
from gpy_dla_detection_tpu_torch.utils.timing import card_line  # noqa: E402

LLS_BINS = [(17.8, 18.5), (18.5, 19.0), (19.0, 19.5), (19.5, 20.0), (20.0, 21.5)]
CIV_BINS = [(13.3, 13.6), (13.6, 13.9), (13.9, 14.2), (14.2, 14.5)]


def zqso_observations(n):
    """(z_true, the synthetic zQSO GP as numpy, an iterator of the n
    observations (wl, flux, noise_variance, pixel_mask)) of the zQSO
    gate: one learned model, each observation its own noise seed."""
    from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_z_observation

    rng = np.random.default_rng(42)
    z_true = rng.uniform(2.2, 5.2, size=n)
    learned, _ = synthetic_z_observation(3.0, seed=0)
    obs = (synthetic_z_observation(float(z), seed=0, obs_seed=10_000 + i)[1]
           for i, z in enumerate(z_true))
    return z_true, learned, obs


def zqso_outputs(n, device, dtype, num_zqso_samples=10000):
    """{"z_true", "z_map", "seconds"} of the zQSO gate's n spectra, the
    full grid scanned by ``inference_z_qso_many``."""
    from gpy_dla_detection_tpu_torch.models.zqso import inference_z_qso_many, prepare_z_spectrum
    from gpy_dla_detection_tpu_torch.params import ZParameters

    params = ZParameters(num_zqso_samples=num_zqso_samples)
    z_true, learned, obs = zqso_observations(n)
    specs = (prepare_z_spectrum(*o, params.num_pixels_padded) for o in obs)
    t0 = time.time()
    results, _ = inference_z_qso_many(learned.to(device, dtype), specs, params)
    dt = time.time() - t0
    return {"z_true": z_true, "z_map": np.array([r[0] for r in results]), "seconds": dt}


def zqso_gate(n, device, dtype, num_zqso_samples=10000):
    """P(|z_map - z_true| < 0.5) over n spectra from one synthetic zQSO
    GP, scanning the full production grid."""
    out = zqso_outputs(n, device, dtype, num_zqso_samples)
    dz = np.abs(out["z_map"] - out["z_true"])
    return {
        "n": n,
        "num_zqso_samples": num_zqso_samples,
        "P(|dz|<0.5)": float(np.mean(dz < 0.5)),
        "P(|dz|<0.05)": float(np.mean(dz < 0.05)),
        "median_|dz|": float(np.median(dz)),
        "worst_|dz|": float(dz.max()),
        "seconds": round(out["seconds"], 1),
        "reference_gate": "P(|dz|<0.5) > 0.98 (tests/test_zestimation.py:68-70)",
    }


def lls_observations(n, params):
    """(injected, log_nhis, the learned arrays, an iterator of (z_qso,
    observation)) of the LLS gate: every odd spectrum carries one strong
    Lya absorber, with its Lyman-limit break, 0.15-0.5 below z_qso."""
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_learned_model,
        synthetic_observation,
    )

    learned = synthetic_learned_model(params)
    rng = np.random.default_rng(7)
    z_qsos = rng.uniform(2.6, 3.6, size=n)
    injected = np.arange(n) % 2 == 1
    log_nhis = rng.uniform(17.8, 21.5, size=n)

    def observations():
        for i in range(n):
            z = float(z_qsos[i])
            dlas = None
            if injected[i]:
                # keep the absorber inside the searched window
                dlas = [(z - float(rng.uniform(0.15, 0.5)), float(log_nhis[i]))]
            yield z, synthetic_observation(params, learned, z, seed=100 + i, dlas=dlas,
                                           with_lls_break=True)

    return injected, log_nhis, learned, observations()


def lls_outputs(n, device, dtype, num_samples=10000, max_lya=2):
    """{"injected", "log_nhis", "null", "log_evidences" (n, max_lya),
    "p_lls", "seconds"} of the LLS gate's n spectra through
    ``lls_inference_many`` with the flat p = 0.5 prior."""
    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
    from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
    from gpy_dla_detection_tpu_torch.models.lls import (
        generate_lya_samples,
        lls_inference_many,
        lls_model_posteriors,
    )
    from gpy_dla_detection_tpu_torch.params import Parameters

    params = Parameters()
    injected, log_nhis, arrays, obs = lls_observations(n, params)
    learned = LearnedModel.from_numpy(arrays, device, dtype)
    samples = generate_lya_samples(num_samples=num_samples)
    specs = (preprocess(*o, z, params) for z, o in obs)
    t0 = time.time()
    out = lls_inference_many(learned, specs, samples,
                             torch.Generator(device=device).manual_seed(0), max_lya, params)
    dt = time.time() - t0
    null = np.array([null_ev for null_ev, _ in out])
    evs = np.stack([res.log_evidences for _, res in out]).astype(np.float64)
    p_lls = np.array([1.0 - lls_model_posteriors(a, b)[0] for a, b in zip(null, evs)])
    return {"injected": injected, "log_nhis": log_nhis, "null": null, "log_evidences": evs,
            "p_lls": p_lls, "seconds": dt}


def completeness(detected, injected, values, bins):
    """Detection rate of the injected spectra in each bin of ``values``."""
    curve = {}
    for lo, hi in bins:
        m = injected & (values >= lo) & (values < hi)
        curve[f"[{lo},{hi})"] = float(np.mean(detected[m])) if m.any() else None
    return curve


def lls_gate(n, device, dtype, num_samples=10000, max_lya=2):
    """LLS detection accuracy: half the spectra carry one injected
    strong Lya absorber with logNHI uniform in [17.8, 21.5] (the
    reference finder's 17.2-23 search range, gp_find_lls.py), half are
    clean; detect at P(LLS|D) > 0.5 with the flat p=0.5 prior."""
    out = lls_outputs(n, device, dtype, num_samples, max_lya)
    injected, log_nhis = out["injected"], out["log_nhis"]
    detected = out["p_lls"] > 0.5
    strong = injected & (log_nhis >= 19.5)
    return {
        "n": n,
        "num_samples": num_samples,
        "injected_lognhi_range": [17.8, 21.5],
        "recall_overall": float(np.mean(detected[injected])),
        "recall_lognhi>=19.5": float(np.mean(detected[strong])),
        "completeness_curve": completeness(detected, injected, log_nhis, LLS_BINS),
        "false_positive_rate": float(np.mean(detected[~injected])),
        "accuracy": float(np.mean(detected == injected)),
        "seconds": round(out["seconds"], 1),
    }


def civ_observations(n, params):
    """(injected, log_ns, the learned arrays, an iterator of (z_qso,
    observation)) of the CIV gate: every odd z ~ 2 spectrum carries one
    doublet 0.05-0.2 below z_qso, its broadening in the sampler's range."""
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        civ_doublet_transmission,
        synthetic_learned_model,
        synthetic_observation,
    )

    learned = synthetic_learned_model(params)
    rng = np.random.default_rng(11)
    z_qsos = rng.uniform(2.0, 2.3, size=n)
    injected = np.arange(n) % 2 == 1
    log_ns = rng.uniform(13.3, 14.5, size=n)

    def observations():
        for i in range(n):
            z = float(z_qsos[i])
            wl, fx, nv, pm = synthetic_observation(params, learned, z, seed=200 + i)
            if injected[i]:
                z_civ = z - float(rng.uniform(0.05, 0.2))
                sig = float(rng.uniform(1.5e6, 4e6))
                fx = fx * civ_doublet_transmission(wl, z_civ, float(log_ns[i]), sig)
            yield z, (wl, fx, nv, pm)

    return injected, log_ns, learned, observations()


def civ_outputs(n, device, dtype, num_civ_samples=10000):
    """{"injected", "log_ns", "p_civ", "null", "civ", "seconds"} of the
    CIV gate's n spectra through ``civ_inference_many``."""
    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
    from gpy_dla_detection_tpu_torch.models.civ import civ_inference_many, generate_civ_samples
    from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
    from gpy_dla_detection_tpu_torch.params import CIVParameters

    params = CIVParameters(num_civ_samples=num_civ_samples)
    injected, log_ns, arrays, obs = civ_observations(n, params)
    learned = LearnedModel.from_numpy(arrays, device, dtype)
    specs = (preprocess(*o, z, params) for z, o in obs)
    t0 = time.time()
    out = civ_inference_many(learned, specs, generate_civ_samples(params), params)
    dt = time.time() - t0
    p_civ, null, civ = (np.array(x) for x in zip(*out))
    return {"injected": injected, "log_ns": log_ns, "p_civ": p_civ, "null": null, "civ": civ,
            "seconds": dt}


def civ_gate(n, device, dtype, num_civ_samples=10000):
    """CIV doublet detection accuracy: half the z~2 spectra carry one
    injected doublet (logN uniform in [13.3, 14.5], sigma in the
    sampler's range), half are clean; detect at P(CIV|D) > 0.5."""
    out = civ_outputs(n, device, dtype, num_civ_samples)
    injected, log_ns = out["injected"], out["log_ns"]
    detected = out["p_civ"] > 0.5
    strong = injected & (log_ns >= 14.2)
    return {
        "n": n,
        "num_civ_samples": num_civ_samples,
        "injected_logn_range": [13.3, 14.5],
        "recall_overall": float(np.mean(detected[injected])),
        "recall_logn>=14.2": float(np.mean(detected[strong])),
        "completeness_curve": completeness(detected, injected, log_ns, CIV_BINS),
        "false_positive_rate": float(np.mean(detected[~injected])),
        "accuracy": float(np.mean(detected == injected)),
        "seconds": round(out["seconds"], 1),
    }


def gates_pass(report) -> bool:
    """The JAX script's pass/fail rule (scripts/accuracy_gates.py:244-250)."""
    return (
        report["zqso"]["P(|dz|<0.5)"] >= 0.98
        and report["lls"]["recall_lognhi>=19.5"] >= 0.95
        and report["lls"]["false_positive_rate"] <= 0.02
        and report["civ"]["recall_logn>=14.2"] >= 0.95
        and report["civ"]["false_positive_rate"] <= 0.02
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-zqso", type=int, default=300)
    ap.add_argument("--n-lls", type=int, default=200)
    ap.add_argument("--n-civ", type=int, default=200)
    ap.add_argument("--num-samples", type=int, default=10000,
                    help="QMC samples (zQSO: candidate redshifts) of every gate; "
                    "10,000 as the JAX script")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; float32, the kernels) or the CPU (float64)")
    ap.add_argument("--out", default=os.path.join(REPO, "ACCURACY_torch.json"))
    args = ap.parse_args(argv)
    device, dtype = device_and_dtype(ap, args.device)

    report = {"card": card_line(device)}
    report["zqso"] = zqso_gate(args.n_zqso, device, dtype, args.num_samples)
    print("zqso:", json.dumps(report["zqso"]), flush=True)
    report["lls"] = lls_gate(args.n_lls, device, dtype, args.num_samples)
    print("lls:", json.dumps(report["lls"]), flush=True)
    report["civ"] = civ_gate(args.n_civ, device, dtype, args.num_samples)
    print("civ:", json.dumps(report["civ"]), flush=True)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    ok = gates_pass(report)
    print("GATES:", "PASS" if ok else "FAIL", f"({report['card']})")
    return report, ok


if __name__ == "__main__":
    sys.exit(0 if main()[1] else 1)
