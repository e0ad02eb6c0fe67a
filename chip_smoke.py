#!/usr/bin/env python3
"""Drive the PyTorch port's DLA catalog path once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result:
  1. environment (torch, CUDA, nvcc, the card and its power limit, TF32 off)
  2. build of the CUDA kernels from gpy_dla_detection_tpu_torch/csrc
  3. each kernel against its plain PyTorch twin at main-path shapes
     (S = 10,000 samples, N = 1,280 pixels, k = 20, two families,
     0 and 3 chained streams)
  4. the slice end to end at Parameters(): process_batch on 16 synthetic
     spectra (odd ones carry a DLA at z_qso - 0.3, logNHI 21.2), with the
     kernels' launch counts over that run and the detections checked
  5. full-width parity with the JAX package's float64 run on the same
     inputs and resampling indices (tests/data/torch_golden_fullscale.npz)
  6. timings: each kernel vs its twin, and the slice's spectra/s
Then a JSON line of the kernels, the card line, and the result line.

It imports nothing of JAX: ``jax`` is blocked before the port is imported.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.modules["jax"] = None  # the card's machine has no JAX; fail loudly if reached

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_fullscale.npz"
NUM_SPECTRA = 16
MAX_DLAS = 4

TOL_K1 = 2e-6  # absolute, kernel vs twin (measured 2.4e-7)
REL_K23 = 1e-6  # |dll| <= REL_K23 * max|ll|, kernel vs twin (measured 3.7e-7)
REL_GOLDEN_EVIDENCE = 1e-4  # of the largest |log evidence|, float32 vs float64 JAX
ABS_GOLDEN_P_DLA = 1e-3

KERNELS = {
    "absorption_all": (
        "gpy_dla_detection_tpu_torch/csrc/absorption_all.cu",
        "gpy_dla_detection_tpu/ops/voigt_pallas.py:239",
    ),
    "logmvn_cap": (
        "gpy_dla_detection_tpu_torch/csrc/logmvn_cap.cu",
        "gpy_dla_detection_tpu/ops/logmvn_pallas.py:238",
    ),
    "logmvn_chain": (
        "gpy_dla_detection_tpu_torch/csrc/logmvn_chain.cu",
        "gpy_dla_detection_tpu/ops/logmvn_pallas.py:497",
    ),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def timed_median(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` with the device synchronised before
    and after each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")

    from gpy_dla_detection_tpu.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu.params import Parameters
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_learned_model,
        synthetic_prior_catalog,
        synthetic_spectrum,
    )
    from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
    from gpy_dla_detection_tpu_torch.models.learned import (
        LearnedModel,
        build_spectrum_model,
    )
    from gpy_dla_detection_tpu_torch.ops import _build
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
        logmvn_cap,
        logmvn_cap_reference,
        logmvn_chain,
        logmvn_chain_reference,
        packed_pair_basis,
    )
    from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
        absorption_all,
        absorption_all_reference,
    )
    from gpy_dla_detection_tpu_torch.parallel.batch import process_batch

    device = torch.device("cuda", 0)

    # 1. environment
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} | {nvcc} | "
          f"card {card} | devices {torch.cuda.device_count()} | matmul.allow_tf32 {tf32}")
    check(not tf32, "torch.backends.cuda.matmul.allow_tf32 must be False")

    # 2. kernel build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s, nvcc {' '.join(_build.NVCC_FLAGS)} "
          f"-> {lib_path.relative_to(ROOT)}")

    # inputs of the main path, at full width
    params = Parameters()
    arrays = synthetic_learned_model(params)
    learned = LearnedModel.from_numpy(arrays, device, torch.float32)
    prior = synthetic_prior_catalog(params)
    dla_samples = generate_dla_samples(params)
    sub_samples = generate_subdla_samples(params)
    z_qsos = np.linspace(2.6, 3.4, NUM_SPECTRA)
    truths = [(z - 0.3, 21.2) if i % 2 else None for i, z in enumerate(z_qsos)]
    spectra = [
        synthetic_spectrum(params, arrays, z, seed=i, dlas=None if t is None else [t])
        for i, (z, t) in enumerate(zip(z_qsos, truths))
    ]

    # 3. kernels vs twins at main-path shapes
    model = build_spectrum_model(learned, to_torch(spectra[1], device, torch.float32), params)
    put = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    z_s = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * put(dla_samples.offset_samples)
    nhis = (put(dla_samples.nhi_samples), put(sub_samples.nhi_samples))
    wl = model.padded_wavelengths
    k1_out = absorption_all(wl, z_s, nhis)
    k1_ref = absorption_all_reference(wl, z_s, nhis)
    err = {"absorption_all": max(float((a - b).abs().max()) for a, b in zip(k1_out, k1_ref))}
    check(err["absorption_all"] <= TOL_K1, f"K1 vs twin {err['absorption_all']:.3e} > {TOL_K1}")

    A = k1_out[0]
    S = A.shape[0]
    gen = torch.Generator(device=device).manual_seed(0)
    extras3 = [A[torch.randint(0, S, (S,), generator=gen, device=device)] for _ in range(3)]
    rows = torch.stack([model.y, model.mu, model.omega2, model.v, model.mask.float()])
    Mp = packed_pair_basis(model.M)
    k2_err, k3_err, k2_rel = [], [], []
    for extra in ([], extras3):
        cap = logmvn_cap(rows, model.M, Mp, A, extra)
        cap_ref = logmvn_cap_reference(rows, model.M, Mp, A, extra)
        ll_ref = logmvn_chain_reference(*cap_ref)
        scale = float(ll_ref.abs().max())
        k2 = float((logmvn_chain_reference(*cap) - ll_ref).abs().max())
        k3 = float((logmvn_chain(*cap) - logmvn_chain_reference(*cap)).abs().max())
        check(k2 <= REL_K23 * scale, f"K2 ({len(extra)} streams) |dll| {k2:.3e} > {REL_K23} x {scale:.4g}")
        check(k3 <= REL_K23 * scale, f"K3 ({len(extra)} streams) |dll| {k3:.3e} > {REL_K23} x {scale:.4g}")
        k2_err.append(k2)
        k3_err.append(k3)
        k2_rel.append(max(
            float((a - b).abs().max() / b.abs().max()) for a, b in zip(cap, cap_ref)
        ))
    err["logmvn_cap"] = max(k2_err)
    err["logmvn_chain"] = max(k3_err)
    torch.cuda.synchronize()
    print(f"[3 parity] S={S} N={A.shape[1]} k={model.M.shape[1]} F=2 | K1 max|d| "
          f"{err['absorption_all']:.3e} (tol {TOL_K1}) | K2 max|dll| 0/3 streams "
          f"{k2_err[0]:.3e}/{k2_err[1]:.3e}, outputs max rel {max(k2_rel):.3e} | K3 max|dll| "
          f"{k3_err[0]:.3e}/{k3_err[1]:.3e} (tol {REL_K23} x max|ll| {scale:.4g})")

    # 4. the slice end to end through the batch entry point
    def run_slice(base_inds=None, batch=spectra):
        return process_batch(
            learned, batch, dla_samples, sub_samples, prior, params,
            torch.Generator(device=device).manual_seed(1), MAX_DLAS,
            base_inds_override=base_inds,
        )

    _build.reset_launch_counts()
    results = run_slice()
    launches = dict(_build.launch_counts)
    need = {"absorption_all": NUM_SPECTRA, "logmvn_cap": 5 * NUM_SPECTRA,
            "logmvn_chain": 5 * NUM_SPECTRA}
    for name, n in need.items():
        check(launches.get(name, 0) >= n, f"{name} launched {launches.get(name, 0)} < {n} times")
    detections = []
    for res, truth in zip(results, truths):
        finite = (np.isfinite(res.log_evidence_null) and np.isfinite(res.log_evidence_subdla)
                  and np.isfinite(res.log_evidences_dla).all())
        check(finite, "non-finite evidence")
        if truth is None:
            check(res.p_dla < 0.1, f"clean spectrum p_dla {res.p_dla:.4f} >= 0.1")
        else:
            dz = abs(float(res.map_z_dlas[0][0]) - truth[0])
            check(res.p_dla > 0.9, f"injected DLA missed: p_dla {res.p_dla:.4f}")
            check(dz < 0.01, f"injected DLA MAP z off by {dz:.4f}")
            detections.append(dz)
    p_clean = max(r.p_dla for r, t in zip(results, truths) if t is None)
    p_inj = min(r.p_dla for r, t in zip(results, truths) if t is not None)
    print(f"[4 slice] {NUM_SPECTRA} spectra at S={params.num_dla_samples} N="
          f"{params.num_pixels_padded} k={params.k} max_dlas={MAX_DLAS} | launches {launches} | "
          f"clean max p_dla {p_clean:.3e} | injected min p_dla {p_inj:.6f}, "
          f"max |MAP z - truth| {max(detections):.2e}")

    # 5. full-width golden parity with the JAX float64 run
    g = np.load(GOLDEN)
    golden_spectra = [
        synthetic_spectrum(
            params, arrays, float(z), seed=int(seed),
            dlas=[(float(dz), float(dn))] if inj else None,
        )
        for z, seed, inj, dz, dn in zip(g["z_qso"], g["obs_seed"], g["injected"],
                                        g["dla_z"], g["dla_log_nhi"])
    ]
    gres = run_slice(g["base_inds"].astype(np.int64), golden_spectra)
    worst_rel, worst_dp = 0.0, 0.0
    for i, res in enumerate(gres):
        got = np.concatenate([[res.log_evidence_null, res.log_evidence_subdla],
                              res.log_evidences_dla]).astype(np.float64)
        want = np.concatenate([[g["log_evidence_null"][i], g["log_evidence_subdla"][i]],
                               g["log_evidences_dla"][i]])
        # relative to the spectrum's evidence scale (a log evidence may cross 0)
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        dp = abs(res.p_dla - float(g["p_dla"][i]))
        worst_rel, worst_dp = max(worst_rel, rel), max(worst_dp, dp)
        check(rel <= REL_GOLDEN_EVIDENCE, f"golden {i}: log evidence rel {rel:.3e}")
        check(dp <= ABS_GOLDEN_P_DLA, f"golden {i}: |dp_dla| {dp:.3e}")
        check(np.argmax(res.selection.model_posteriors) == np.argmax(g["model_posteriors"][i]),
              f"golden {i}: argmax model differs")
    print(f"[5 golden] {len(gres)} spectra vs JAX float64 at full width, same indices | "
          f"log evidence max rel {worst_rel:.3e} (tol {REL_GOLDEN_EVIDENCE}) | "
          f"max |dp_dla| {worst_dp:.3e} (tol {ABS_GOLDEN_P_DLA}) | argmax models equal")

    # 6. timings on the card
    ms = {
        "absorption_all": (timed_median(lambda: absorption_all(wl, z_s, nhis)),
                           timed_median(lambda: absorption_all_reference(wl, z_s, nhis))),
    }
    cap0 = logmvn_cap(rows, model.M, Mp, A)
    for name, extra in (("logmvn_cap", []), ("logmvn_cap_3", extras3)):
        ms[name] = (timed_median(lambda: logmvn_cap(rows, model.M, Mp, A, extra)),
                    timed_median(lambda: logmvn_cap_reference(rows, model.M, Mp, A, extra)))
    ms["logmvn_chain"] = (timed_median(lambda: logmvn_chain(*cap0)),
                          timed_median(lambda: logmvn_chain_reference(*cap0)))
    slice_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_slice()
        slice_s.append(time.perf_counter() - t0)
    rate = NUM_SPECTRA / statistics.median(slice_s)
    timing = " | ".join(f"{n} {k:.3f} ms vs twin {p:.3f} ms" for n, (k, p) in ms.items())
    print(f"[6 timing] {card} | median of 10 synchronised calls: {timing} | slice "
          f"{rate:.2f} spectra/s (median of 3 runs of {NUM_SPECTRA}, after warm-up)")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
