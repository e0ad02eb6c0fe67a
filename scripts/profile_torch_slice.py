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
``chip_smoke.py`` at the LLS search's width.  ``--abs-dtype`` stores the
absorption profiles as float32 (``f32``, the default) or as int16 codes
(``i16``, or ``i16p``, which the port stores alike).

    python3 scripts/profile_torch_slice.py [--path PATH] [--abs-dtype f32|i16|i16p] [--trace FILE]
"""

from __future__ import annotations

import argparse
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
from gpy_dla_detection_tpu_torch.params import Parameters  # noqa: E402
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch  # noqa: E402

NUM_SPECTRA = 16
NUM_LLS = 8
PATHS = ("windowed", "exact", "windowed_unfused", "windowed_weideman", "lls")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=PATHS, default="windowed")
    parser.add_argument("--abs-dtype", choices=("f32", "i16", "i16p"), default="f32")
    parser.add_argument("--trace", type=Path, help="write the Chrome trace here")
    args = parser.parse_args()
    store = profile_store_dtype(args.abs_dtype)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.path == "lls":
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
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side entries only: the aten:: CPU ops that launch kernels also
    # report their kernels' time and would count it twice
    events = [
        e for e in prof.key_averages()
        if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"card {card} | path {args.path}, storage {args.abs_dtype} | {len(spectra)} spectra, S={params.num_dla_samples}, "
          f"N={params.num_pixels_padded}, k={params.k} | wall {plain_ms:.2f} ms "
          f"unprofiled, {wall_ms:.2f} ms profiled | device kernel time "
          f"{busy_ms:.2f} ms ({100 * busy_ms / plain_ms:.1f}% of the unprofiled "
          f"wall, {100 * busy_ms / wall_ms:.1f}% of the profiled)")
    print(f"{'device ms':>10} {'calls':>6} {'share':>6}  name")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        ms = e.self_device_time_total / 1e3
        print(f"{ms:10.3f} {e.count:6d} {100 * ms / busy_ms:5.1f}%  {e.key[:90]}")
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))


if __name__ == "__main__":
    main()
