"""Where the PyTorch port's catalog slice spends its device time.

Runs ``process_batch`` on the 16 synthetic spectra of ``chip_smoke.py``
at ``Parameters()`` on one CUDA card: one warm-up run, then one run under
``torch.profiler`` (after one timed without it).  Prints the device time
per kernel name (top 15), the device busy time against both wall times,
and the card's name and power limit; with ``--trace PATH`` also writes
the Chrome trace there.  Imports no JAX and nothing of the JAX package.

    python3 scripts/profile_torch_slice.py [--trace PATH]
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
from gpy_dla_detection_tpu_torch.params import Parameters  # noqa: E402
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch  # noqa: E402

NUM_SPECTRA = 16


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", type=Path, help="write the Chrome trace here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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
                             torch.Generator(device=device).manual_seed(1))

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
    print(f"card {card} | {NUM_SPECTRA} spectra, S={params.num_dla_samples}, "
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
