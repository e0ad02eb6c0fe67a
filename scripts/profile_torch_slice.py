"""Where the PyTorch port's catalog paths spend their device time.

Runs one path on one CUDA card: one warm-up run, then one run under
``torch.profiler`` (after one timed without it).  Prints the device time
per kernel name (top 15), the device busy time against both wall times,
and the card's name and power limit; with ``--trace PATH`` also writes
the Chrome trace there.  Imports no JAX and nothing of the JAX package.

Paths (``--path``): ``windowed`` (default), ``exact``,
``windowed_unfused`` and ``windowed_weideman`` run ``process_batch`` in
that Voigt configuration on
the 16 synthetic spectra of ``chip_smoke.py`` at ``Parameters()``;
``lls`` runs ``lls_inference_many`` on the 8 LLS spectra of
``chip_smoke.py`` at the LLS search's width; ``zqso`` runs
``inference_z_qso_many`` (the correlation scan) on the 8 spectra of
``chip_smoke.py`` phase 18 at ``ZParameters()`` (10,000 candidate
redshifts, k = 20, P = 5,632) and also sums the device time by part: K3,
the cuFFT rFFTs and irFFT, the gathers, the median passes (sort, scan),
the reductions, the copies and the other elementwise kernels, and the
device records a spectrum.  With ``--chunk-sizes C1,C2,...`` the
``zqso`` path first runs the scans at each chunk size: the correlation
scan (``zqso_corr.CORR_CHUNK`` candidates a median and iid pass) on
``NUM_ZQSO_RATE`` spectra, spectra/s as the median of 3 passes after a
warm-up, and the exact scan (``zqso.EXACT_CHUNK``) on one spectrum, ms
as the median of 3 after a warm-up; each with its peak device memory
above what was held before it.  ``train`` runs ``fit_lbfgs_stepwise`` for
``TRAIN_ITERS`` iterations on the training's synthetic problem of
``chip_smoke.py`` phase 19 (Q = 4,096 spectra, R = 1,217, k = 20, 31
forest lines, float32) and sums the device time by part: K3 (forward),
its adjoint (backward), the GEMMs, the reductions, the gathers and
scatters, the copies and the other elementwise kernels.  ``--num-spectra``
sets Q; ``--chunks C`` fits one iteration of the reference-scale
training's objective instead (``scripts/train_fullscale_torch.py``: C
checkpointed chunks, shifted by the mean loss at the start), so
``--num-spectra 65024 --chunks 16`` profiles one iteration of that run.
Every path
prints the device busy time twice: the union of the device records'
intervals (each moment once) and the sum of their times, user
annotations left out of both.  ``--abs-dtype`` stores the absorption
profiles as float32 (``f32``, the default) or as int16 codes (``i16``,
or ``i16p``, which the port stores alike); the zQSO head stores none.

    python3 scripts/profile_torch_slice.py [--path PATH] [--abs-dtype f32|i16|i16p] [--trace FILE]
        [--chunk-sizes C1,C2,...] [--num-spectra Q --chunks C]
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gpy_dla_detection_tpu_torch.data.samples import (  # noqa: E402
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel  # noqa: E402
from gpy_dla_detection_tpu_torch.models.lls import (  # noqa: E402
    generate_lya_samples,
    lls_inference_many,
    with_boss_meanflux,
)
from gpy_dla_detection_tpu_torch.ops.kernel_config import profile_store_dtype  # noqa: E402
from gpy_dla_detection_tpu_torch.ops.timing import (  # noqa: E402
    SENTINEL_KERNEL,
    union_busy_ms,
    prime_profiler,
)
from gpy_dla_detection_tpu_torch.params import Parameters  # noqa: E402
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch  # noqa: E402

NUM_SPECTRA = 16
NUM_LLS = 8
NUM_ZQSO = 8
NUM_ZQSO_RATE = 128  # 4x inference_z_qso_many's window of 32 scans in flight
ZQSO_Z_SEED = 3  # z_true of chip_smoke.py phase 18's library path
PATHS = ("windowed", "exact", "windowed_unfused", "windowed_weideman", "lls", "zqso", "train")
TRAIN_Q = 4096
TRAIN_ITERS = 3  # iterations profiled unchunked; one with --chunks
# the training's device time by part: (label, test on the kernel's name)
TRAIN_PARTS = (
    ("K3's adjoint logmvn_chain_grad", lambda n: "logmvn_chain_grad" in n),
    ("K3 logmvn_chain", lambda n: "logmvn_chain" in n),
    ("GEMMs", lambda n: any(w in n.lower() for w in ("gemm", "cutlass", "xmma"))),
    ("reductions", lambda n: "reduce" in n.lower()),
    ("gathers and scatters", lambda n: any(w in n.lower() for w in ("index", "scatter",
                                                                      "gather"))),
    ("copies", lambda n: "memcpy" in n.lower() or "copy" in n.lower()),
    ("other elementwise", lambda n: "elementwise" in n.lower()),
)
# the zQSO scan's device time by part: (label, test on the kernel's name)
ZQSO_PARTS = (
    ("K3 logmvn_chain", lambda n: "logmvn_chain" in n),
    ("cuFFT (rFFT, irFFT)", lambda n: "fft" in n.lower()),
    ("gathers (index_select, indexing)", lambda n: "index" in n.lower()),
    ("median passes (sort, scan)", lambda n: any(w in n.lower() for w in ("sort", "scan"))),
    ("reductions", lambda n: "reduce" in n.lower()),
    ("copies", lambda n: "memcpy" in n.lower() or "copy" in n.lower()),
    ("other elementwise", lambda n: "elementwise" in n.lower()),
)


def zqso_chunk_sweep(card, learned, spectra, params, sizes) -> None:
    """Both zQSO scans at each chunk size in ``sizes``: the correlation
    scan's spectra/s over ``spectra``, the exact scan's ms on the first
    one, each with its peak device memory above what was held."""
    from gpy_dla_detection_tpu_torch.models import zqso, zqso_corr

    def measure(fn, reps=3):
        fn()  # warm-up
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), (torch.cuda.max_memory_allocated() - held) / 2**20

    corr_chunk, exact_chunk = zqso_corr.CORR_CHUNK, zqso.EXACT_CHUNK
    rows = []
    try:
        for size in sizes:
            zqso_corr.CORR_CHUNK = zqso.EXACT_CHUNK = size
            corr_s, corr_mib = measure(
                lambda: zqso.inference_z_qso_many(learned, spectra, params))
            try:
                exact_s, exact_mib = measure(lambda: zqso.inference_z_qso(
                    learned, spectra[0], params, method="exact"))
                exact = f"exact {1e3 * exact_s:.1f} ms a spectrum, peak {exact_mib:.1f} MiB"
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                exact = "exact out of device memory"
            rows.append(f"chunk {size}: corr {len(spectra) / corr_s:.2f} spectra/s, peak "
                        f"{corr_mib:.1f} MiB; {exact}")
    finally:
        zqso_corr.CORR_CHUNK, zqso.EXACT_CHUNK = corr_chunk, exact_chunk
    print(f"card {card} | zQSO chunk sizes at Z={params.num_zqso_samples}, k={params.k}, "
          f"P={params.num_pixels_padded}, float32; corr on {len(spectra)} spectra (median of 3 "
          f"passes after a warm-up), exact on one (median of 3) | " + " | ".join(rows))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=PATHS, default="windowed")
    parser.add_argument("--abs-dtype", choices=("f32", "i16", "i16p"), default="f32")
    parser.add_argument("--trace", type=Path, help="write the Chrome trace here")
    parser.add_argument("--chunk-sizes", type=lambda v: [int(c) for c in v.split(",")],
                        help="zqso: time both scans at each of these chunk sizes first")
    parser.add_argument("--num-spectra", type=int, default=TRAIN_Q,
                        help="train: Q, the spectra of the synthetic problem")
    parser.add_argument("--chunks", type=int,
                        help="train: one iteration of the chunked, shifted objective of "
                        "scripts/train_fullscale_torch.py in this many chunks")
    args = parser.parse_args()
    store = profile_store_dtype(args.abs_dtype)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.path == "zqso":
        from gpy_dla_detection_tpu_torch.data.synthetic import (
            synthetic_z_learned_model,
            synthetic_z_observation,
        )
        from gpy_dla_detection_tpu_torch.models.zqso import (
            inference_z_qso_many,
            prepare_z_spectrum,
        )
        from gpy_dla_detection_tpu_torch.params import ZParameters

        params = ZParameters()
        learned = synthetic_z_learned_model(0, params.k).to(device, torch.float32)
        z_true = np.random.default_rng(ZQSO_Z_SEED).uniform(2.4, 4.6, NUM_ZQSO_RATE)
        spectra = [
            prepare_z_spectrum(*synthetic_z_observation(float(z), seed=0, k=params.k,
                                                        obs_seed=50 + i)[1])
            for i, z in enumerate(z_true)
        ]
        if args.chunk_sizes:
            zqso_chunk_sweep(card, learned, spectra, params, args.chunk_sizes)
        spectra = spectra[:NUM_ZQSO]

        def run():
            return inference_z_qso_many(learned, spectra, params)
    elif args.path == "train":
        from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_training_problem
        from gpy_dla_detection_tpu_torch.models.training import (
            TrainingParams,
            fit_lbfgs_stepwise,
        )

        params = Parameters()
        R = int(round((params.max_lambda - params.min_lambda) / params.dlambda)) + 1
        fields, arrays = synthetic_training_problem(args.num_spectra, R, params.k, seed=0)
        p0 = TrainingParams.from_numpy(fields, device)
        data = tuple(torch.as_tensor(x, device=device) for x in arrays)
        spectra = arrays[0]
        del arrays
        train_iters, objective = TRAIN_ITERS, None
        if args.chunks:
            spec = importlib.util.spec_from_file_location(
                "train_fullscale_torch", ROOT / "scripts" / "train_fullscale_torch.py")
            fullscale = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(fullscale)
            shift = fullscale.mean_spectrum_loss((p0, *data), params, args.chunks)
            train_iters = 1
            objective = fullscale.chunked_objective_factory(args.chunks, shift)

        def run():
            return fit_lbfgs_stepwise(p0, *data, params, train_iters, objective=objective)
    elif args.path == "lls":
        params = Parameters(num_dla_samples=10000, min_lambda=850.0, num_pixels_padded=1664)
        arrays = synthetic_learned_model(params)
        learned = with_boss_meanflux(LearnedModel.from_numpy(arrays, device, torch.float32))
        samples = generate_lya_samples(params.num_dla_samples)
        z_qsos = [3.0 + 0.2 * (i % 2) + 0.05 * (i // 2) for i in range(NUM_LLS)]
        spectra = [
            synthetic_spectrum(params, arrays, z, seed=100 + i, with_lls_break=True,
                               dlas=[(z - 0.2, 18.5)] if i % 2 else None)
            for i, z in enumerate(z_qsos)
        ]

        def run():
            return lls_inference_many(learned, spectra, samples,
                                      torch.Generator(device=device).manual_seed(3), 4, params,
                                      abs_dtype=store)
    else:
        params = Parameters()
        arrays = synthetic_learned_model(params)
        learned = LearnedModel.from_numpy(arrays, device, torch.float32)
        prior = synthetic_prior_catalog(params)
        dla, sub = generate_dla_samples(params), generate_subdla_samples(params)
        z_qsos = np.linspace(2.6, 3.4, NUM_SPECTRA)
        spectra = [
            synthetic_spectrum(params, arrays, z, seed=i,
                               dlas=[(z - 0.3, 21.2)] if i % 2 else None)
            for i, z in enumerate(z_qsos)
        ]

        def run():
            return process_batch(learned, spectra, dla, sub, prior, params,
                                 torch.Generator(device=device).manual_seed(1),
                                 voigt_impl=args.path, abs_dtype=store)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_profiler()  # else the profiler can miss the run's first kernels
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side entries only: the aten:: CPU ops that launch kernels also
    # report their kernels' time and would count it twice, and a user
    # annotation (Optimizer.step#LBFGS.step) is a device-side range over
    # the kernels of a whole step
    events = [
        e for e in prof.key_averages()
        if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0
        and not e.is_user_annotation and SENTINEL_KERNEL not in e.key
    ]
    sum_ms = sum(e.self_device_time_total for e in events) / 1e3
    union_ms = union_busy_ms(prof)
    if args.path == "zqso":
        width = f"Z={params.num_zqso_samples}, P={params.num_pixels_padded}, k={params.k}"
    elif args.path == "train":
        width = (f"R={R}, k={params.k}, {params.num_forest_lines} forest lines, {train_iters} "
                 f"L-BFGS iterations, "
                 + (f"{args.chunks} chunks (shifted)" if args.chunks else "unchunked"))
    else:
        width = f"S={params.num_dla_samples}, N={params.num_pixels_padded}, k={params.k}"
    print(f"card {card} | path {args.path}, storage {args.abs_dtype} | {len(spectra)} spectra, {width} | wall {plain_ms:.2f} ms "
          f"unprofiled, {wall_ms:.2f} ms profiled | device busy {union_ms:.2f} ms (the union "
          f"of the records' intervals; {100 * union_ms / plain_ms:.1f}% of the unprofiled "
          f"wall, {100 * union_ms / wall_ms:.1f}% of the profiled); the records' times sum "
          f"to {sum_ms:.2f} ms")
    print(f"{'device ms':>10} {'calls':>6} {'share':>6}  name")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        ms = e.self_device_time_total / 1e3
        print(f"{ms:10.3f} {e.count:6d} {100 * ms / sum_ms:5.1f}%  {e.key[:90]}")
    part_tests = {"zqso": ZQSO_PARTS, "train": TRAIN_PARTS}.get(args.path)
    if part_tests:
        parts = dict.fromkeys([label for label, _ in part_tests] + ["other"], 0.0)
        for e in events:
            label = next((lb for lb, test in part_tests if test(e.key)), "other")
            parts[label] += e.self_device_time_total / 1e3
        print(f"{args.path} device ms by part: " + ", ".join(
            f"{label} {ms:.3f} ({100 * ms / sum_ms:.1f}%)" for label, ms in parts.items())
            + f" | idle {100 * (1 - union_ms / wall_ms):.1f}% of the profiled wall | "
            f"{sum(e.count for e in events) / len(spectra):.1f} device records a spectrum")
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))


if __name__ == "__main__":
    main()
