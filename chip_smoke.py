#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result:
  1. environment (torch, CUDA, nvcc, the card and its power limit, TF32 off)
  2. build of the CUDA kernels from gpy_dla_detection_tpu_torch/csrc
  3. each kernel against its plain PyTorch twin at main-path shapes
     (S = 10,000 samples, N = 1,280 pixels, k = 20, two families, 0 and 3
     chained streams; K5 at 10,000 x 1,286 and at the MCMC half-steps'
     16 and 20 x 1,286; K3 also at the odd k = 21 of the rank-1 chain
     variant; K6 at 10,000 x 1,408 for both families; K1 with the
     Lyman-limit break at the LLS search's P = 1,670, and K2 and K3 at its
     N = 1,664; K2 also on a narrow basis, k = 5; K3 also on both sides of
     its row bound 32 and of a half warp, k = 1, 2, 8, 16, 17, 31, 32, 33,
     41, on full-rank bases); K1 with the Weideman window (poly=False) at
     the same two widths, also against the float64 exact profile; and both
     K1 branches at 1, 8 and 31 lines, F = 1 and 3, P = 7 and 301)
  4. the default catalog path at Parameters(): process_batch on 16
     synthetic spectra (odd ones carry a DLA at z_qso - 0.3, logNHI 21.2),
     with the kernels' launch counts over that run and the detections
  5. full-width parity with the JAX package's float64 run on the same
     inputs and resampling indices (tests/data/torch_golden_fullscale.npz)
  6. the exact-Voigt catalog configuration (voigt_impl="exact": exact
     unit optical depth + K5 per family) on 4 of those spectra, with its
     launch counts and detections, and its golden parity as in phase 5
  7. the unfused windowed configuration (voigt_impl="windowed_unfused":
     windowed unit optical depth parts + K6 per family) likewise; then its
     golden parity once more without the two-tier window (window_tier=False,
     the reference's GPY_DLA_WINDOW_TIER=0)
  8. the LLS search at the width of run_find_lls.py (S = 10,000, 850 A
     window, N = 1,664, max_lya = 4, BOSS mean flux) on 8 synthetic
     spectra through lls_inference_many (odd ones carry an LLS of logNHI
     18.5 at z_qso - 0.2, its break inside the window), with launch counts
     and detections, and its golden parity with the JAX float64 run
     (tests/data/torch_golden_lls.npz); then the same search once more in
     the unfused windowed configuration (voigt_impl="windowed_unfused":
     the placed windowed unit tau plus the break, K5; no K1 or K6) with its
     launch counts, detections and golden parity
  9. the absorber MCMC head: a DLA chain (32 walkers x 5,000 steps) on an
     injected spectrum at full width, checked against the truth, and a
     CIV chain (40 walkers x 1,000 steps); posterior evaluations per second
 10. timings: each kernel vs its twin and its bound (K1 also by its device
     time over 50 launches, CUDA events and the profiler, at P = 1,286, with
     the break at P = 1,670 and with the Weideman window; K5 by its device
     time over 50 launches at 10,000 and 16 rows; K2 also beside its
     library yardstick, the two float32 matmuls on the twin's w and r,
     with its achieved TFLOP/s and share of the bound; K3 also by its device
     time over 50 launches, and beside its library yardstick, the batched
     cholesky_ex of the unpacked I + B and solve_triangular), and the spectra/s of
     the default slice, the exact and unfused configurations, the LLS
     search and the CIV head
 11. the likelihood ablation (K7) through scripts/kernel_ablate_torch.py at
     its full width (S = 10,000, N = 1,280, k = 20): every stage of the
     stage kernel, K2 with the flat basis and the flat chain (decoupled),
     every chain variant (the flat chain in the row and the transposed
     layout, K3 on the packed one), each launch counted and held against
     its twin; the float64 accuracy of full, decoupled and K2 + K3; the
     stage kernel's and the flat chain's times vs twins and bounds, with
     the SGEMM yardstick beside the matmul stage and the cholesky_ex +
     solve_triangular yardstick beside the flat chain; device ms of every
     stage beside K2's and K3's on the same inputs, full against K2 + K3
     run apart, and the split of the shipped K2 (staging and assembly, FMA
     loop, stores) that the stage differences give
 12. the CIV QMC head at CIVParameters() (S = 10,000, N = 768) on 8
     synthetic spectra through civ_inference_many (odd ones carry a CIV
     doublet), with launch counts, detections and golden parity with the
     JAX float64 run (tests/data/torch_golden_civ.npz)
 13. the Weideman-window configuration (voigt_impl="windowed_weideman": K1
     with the Weideman rational and continued fraction in the windows, the
     reference's GPY_DLA_FUSED_POLY=0) on 4 spectra of the default catalog,
     with its launch counts, detections and golden parity as in phase 5;
     then the LLS search in it, with launch counts, detections and golden
     parity as in phase 8
 14. compact profile storage (abs_dtype=torch.int16: int16 codes round(a *
     32767), the reference's GPY_DLA_ABS_DTYPE=i16 and i16p): the int16
     instantiations of K1 (both windows, with and without the break), K5 (at
     10,000 and 16 rows), K6 and K2 (0 and 3 streams, N = 1,280 and 1,664)
     against their twins by codes (max |dcode| <= 1; K2 |dll| <= 1e-6 |ll|,
     and against K2 fed the codes decoded to float32); the default catalog
     in int16 on 4 spectra and its golden parity with the JAX float64 int16
     run (tests/data/torch_golden_i16.npz), the exact, unfused and Weideman
     configurations and the LLS search in int16 on 4 spectra each, with
     launch counts that show only the int16 instantiations, detections and
     golden parity; then each int16 kernel's times beside the float32 one's
     (interleaved), the chained-row gather, the default slice's device time
     and peak memory per 16 spectra, and its spectra/s, in each storage
 15. K5 and K6, the streaming absorption tail (csrc/absorption_stencil.cuh),
     at every shape the paths give them: 1, 16, 20 and 10,000 rows; K5 at
     P = 774 (the CIV head's row), 1,286 and 1,670; K6 on the main path's
     parts (10,000 x 1,408 padded, P = 1,286, L = 3), with 8 lines
     (overlapping windows) and with redshifts at the grid's red end
     (windows clipped at the row's P); each in float32 (within 1e-6 of the
     twin) and int16 (codes within 1); then a 1 GiB device copy's rate, and
     K5's and K6's device ms (profiler, 50 calls) at 10,000 and 16 rows in
     both storages and at P = 1,670 and 774, each beside its bound and the
     share of that copy rate (K6's bound by the bytes its function needs:
     far's first P pixels and the window pixels below P; the earlier
     padded count beside it)
 16. wide GP bases (k = 54, one column past one K2 block at N = 1,280,
     and 65, one past K3's row bounds; S = 10,000, 3 chained streams, on
     the seeded construction tests/test_torch_kernels_gpu.py holds the
     budget on): the likelihood runs K2 in column slices and K3 (its wide
     chain at k = 65), counted; each kernel against its twin (|dll| <=
     1e-6 max|ll|); the likelihood against the CPU float64 value of the
     first 2,000 samples within the reference's float32 budget (median
     |dll| 7.4e-4, max 3.8e-3); device ms beside the bounds, the wide
     chain's row of the kernels line; K2's library yardstick at both
     widths (the two float32 SGEMMs, TF32 off).  No phase runs the
     likelihood's plain composition (checked in every counted run)
 17. the CLIs through the entry points a user calls: 32
     synthetic spectra written as speclite FITS files (odd ones with a DLA
     at z_qso - 0.3, logNHI 21.2) through run_bayes_select.run at
     Parameters(), float32, --batch-size 8 --inflight 3 --checkpoint, with
     its launch counts (K1 32, K2 and K3 160, no composition), detections
     and peak memory; its arrays against process_batch on the same spectra
     read back through the port's read_spec and preprocess with the same
     per-batch generators, bit for bit; dispatch_batch under CUDA's sync
     debug mode (no synchronising call); a rerun after deleting one part
     file, bit for bit; --no-sample-lls, the evidences, MAPs and
     posteriors bit for bit and the three per-sample datasets absent;
     GPY_DLA_RESAMPLER=systematic, its detections and its evidences within
     the resampler tests' tolerance of the multinomial run (10x the spread
     of another seed's, or 0.5); a profiled run for the device's share of
     the wall; then run_find_lls.run and run_civ.run on 8 FITS spectra each
     with launch counts and detections; the catalog CLI's steady-state
     spectra/s from its .metrics.jsonl (the first batch skipped)
 18. the zQSO head at ZParameters() (Z = 10,000 candidate redshifts, k = 20,
     P = 5,632): the JAX package's float64 scans of 4 spectra
     (tests/data/torch_golden_zqso.npz) replayed from their seeds through
     inference_z_qso_many, the correlation scan on all 4 and the exact scan
     on the first (the same z_map and NaN pattern, every finite |dll| within
     1e-4 of the largest finite |ll|, within 1% of the peak's margin near
     the peak), one K3 launch a spectrum (the correlation scan's solves) and
     none for the exact scan, no composition; K3 on the zQSO's own inputs
     against its twin, its device ms beside the catalog's and its bound;
     the library path on 8 spectra (one K3 launch each, every |z_map -
     z_true| < 0.5, the count within 0.05), its dispatch under CUDA's sync
     debug mode set to error; spectra/s on 128 spectra, 4x the window of 32
     scans in flight (median of 3 passes after a warm-up), the device's
     busy share and peak memory of a profiled pass over them;
     run_zqso_estimation.run on 8 FITS spectra at k = 20, --device cuda,
     bit for bit the library path's z_map on the files read back
 19. GP training (models/training.py) at the reference's width (R = 1,217
     rest pixels, k = 20, 31 forest lines): K3's adjoint (the backward of
     chain_loglik) against its twin at Q = 4,096 and k = 1, 20, 21, 64, 65
     on scripts/train_throughput.py's synthetic problem (each output within
     1e-5 of its largest magnitude); the JAX float64 objective of 64
     spectra (tests/data/torch_golden_train.npz) replayed from their seeds
     through prepare_training_set and initialize, the card's float32
     per-spectrum losses within 1e-5 of max|loss| and each of the five
     gradient blocks within 1e-3 of its max|g|; fit_lbfgs_stepwise on the
     synthetic problem at Q = 4,096 (a warm-up, then 20 iterations: ms an
     iteration, median of 3 runs; evaluations an iteration; K3 and its
     adjoint once an evaluation and nothing else; the loss falls), peak
     memory and the busy share of one profiled iteration (the union of the
     device records' intervals over the wall); one evaluation
     at k = 65 (the wide pair); the adjoint's device ms (50 launches)
     beside K3's forward on the same inputs, its bound and the library
     yardstick (cholesky_ex + cholesky_inverse of the unpacked I + B)
 20. the reference-scale training run (scripts/train_fullscale_torch.py)
     at the same width: (a) on phase 19's synthetic problem at Q = 65,024,
     one evaluation of the chunked, shifted objective in 16 chunks (Qc =
     4,064; the shift the mean loss of a pass of 16 K3 launches) against
     one unchunked evaluation of total_objective: the restored values
     within 1e-5 of sum|loss_i|, each gradient block within 1e-3 of its
     max|g|, K3 launched 32 times and its adjoint 16 (each chunk's
     forward runs again in the backward), 1 and 1 unchunked, and the peak
     memory of each; K3 and its adjoint at Qc = 4,064 against their
     twins and their device ms (50 launches) beside their bounds; (b) the
     training golden (phase 19) through 4 chunks: the restored total
     within 1e-5 of sum|loss_i| of JAX's float64 total, gradients within
     1e-3; (c) fit_two_stage at Q = 65,024, 3 + 3 iterations: two L-BFGS
     optimizers, both stages finite, the loss falls, stage B's first
     value at stage A's end within Q ulp(float32 shift); ms and
     evaluations an iteration, peak memory, the busy share of one profiled
     iteration; (d) the script's main at Q = 2,048, 4 chunks, 20
     iterations, a 16-spectrum detection gate at Parameters(): the JAX
     artifact's keys with "device", a falling trajectory, launches K1 16,
     K2 and K3 80 in the gate and K3 / its adjoint 8 / 4 an evaluation
Every other phase asserts that the Weideman window is never launched, and
every phase before 14 that no int16 instantiation is.
Then a JSON line of the kernels, the card line, and the result line.

It imports nothing of JAX and nothing of the JAX package: both are
blocked before the port is imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the card's machine has no JAX, and the port stands alone: fail loudly if
# either is reached
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_fullscale.npz"
GOLDEN_LLS = ROOT / "tests" / "data" / "torch_golden_lls.npz"
GOLDEN_CIV = ROOT / "tests" / "data" / "torch_golden_civ.npz"
GOLDEN_I16 = ROOT / "tests" / "data" / "torch_golden_i16.npz"
GOLDEN_ZQSO = ROOT / "tests" / "data" / "torch_golden_zqso.npz"
GOLDEN_TRAIN = ROOT / "tests" / "data" / "torch_golden_train.npz"
ABLATE_SCRIPT = ROOT / "scripts" / "kernel_ablate_torch.py"
NUM_SPECTRA = 16
NUM_EXACT = 4
NUM_UNFUSED = 4
NUM_WEIDEMAN = 4
NUM_LLS = 8
NUM_I16 = 4  # spectra of each configuration in int16 storage (phase 14)
NUM_CLI = 32  # FITS spectra through the catalog CLI (phase 17)
NUM_ZQSO = 8  # zQSO spectra through the library path and the CLI (phase 18)
NUM_ZQSO_RATE = 128  # zQSO spectra timed: 4x inference_z_qso_many's 32 in flight
ZQSO_Z_SEED = 3  # their z_true, uniform in 2.4-4.6
CLI_BATCH = 8
MAX_DLAS = 4
ENSEMBLE_SEEDS = 24  # multinomial seeds whose spread holds the third chained level
SYSTEMATIC_SEEDS = 8  # more systematic runs, printed
MAX_LYA = 4
LLS_PARAMS = dict(num_dla_samples=10000, min_lambda=850.0, num_pixels_padded=1664)
LLS_LOG_NHI = 18.5
DLA_CHAIN = (32, 5000)  # walkers, steps (the reference's)
CIV_CHAIN = (40, 1000)
ODD_K = 21
NARROW_K = 5  # a GP basis narrower than the old K2 block took
WIDE_KS = (54, 65)  # one column past one K2 block at N = 1,280, one past K3's row bounds
WIDE_F64 = 2000  # samples of the wide bases held to the CPU float64 value
TAIL_ROWS = (1, 16, 20, 10_000)  # K5's and K6's row counts on the paths
CIV_PIXELS = 774  # the CIV head's padded row (CIVParameters)
CHAIN_KS = (1, 2, 8, 16, 17, 31, 32, 33, 41)  # K3 on both sides of its row bound 32
TRAIN_Q = 4096  # spectra of the training's synthetic problem (scripts/train_throughput.py)
TRAIN_ITERS = 20  # L-BFGS iterations a timed fit
TRAIN_GRAD_KS = (1, 20, 21, 64, 65)  # K3's adjoint on both sides of its row bounds
TRAIN_WIDE_Q = 256  # spectra of the k = 65 training evaluation
TRAIN_SCRIPT = ROOT / "scripts" / "train_fullscale_torch.py"
TRAIN_FULL_Q = 65_024  # the reference-scale training's spectra (phase 20)
TRAIN_CHUNKS = 16  # its chunks an evaluation: Qc = 4,064
TRAIN_GOLDEN_CHUNKS = 4  # the training golden's 64 spectra in chunks of 16
TRAIN_STAGE_ITERS = 3  # L-BFGS iterations of each stage of the two-stage fit
TRAIN_E2E_Q, TRAIN_E2E_CHUNKS, TRAIN_E2E_ITERS = 2048, 4, 20  # the script end to end
TRAIN_GATE_N = 16  # its detection gate's spectra
# the keys of scripts/train_fullscale.py's artifact (:413-448)
TRAIN_JAX_ARTIFACT_KEYS = frozenset((
    "backend", "num_spectra", "rest_grid_pixels", "rank_k", "num_iterations", "chunks", "dtype",
    "shift_schedule", "wall_s", "ms_per_iteration", "loss_first", "loss_last",
    "loss_trajectory_downsampled", "model_quality_vs_generating",
    "detection_gate_with_trained_model", "reference"))

TOL_K1 = 2e-6  # absolute, kernel vs twin (measured 2.4e-7)
# K1 with the Weideman window: the mutual bound of two float32 Weideman
# evaluations (tests/test_voigt.py), and against the float64 exact profile
# at most 1.5x the twin's own error or TOL_TRUTH_FLOOR
TOL_K1_WEIDEMAN = 5e-4
TOL_TRUTH_FLOOR = 1e-4
TOL_K5 = 1e-6  # absolute, kernel vs twin; profiles lie in [0, 1] (measured 1.8e-7)
TOL_K6 = 1e-6  # absolute, kernel vs twin; the same exp and 7-tap sum as K5
REL_K23 = 1e-6  # |dll| <= REL_K23 * max|ll|, kernel vs twin (measured 3.7e-7)
REL_K7 = 2e-6  # |d| <= REL_K7 * max|value|, the ablation's kernels vs twins
REL_GOLDEN_EVIDENCE = 1e-4  # of the largest |log evidence|, float32 vs float64 JAX
MAX_DCODE = 1  # int16 codes, kernel vs twin: a ~3e-7 float32 difference moves a code by one
# the float32 likelihood against float64: the reference kernel's budget on
# |ll| ~ 1.1e4 (gpy_dla_detection_tpu/ops/logmvn_pallas.py:206-210)
MEDIAN_VS_F64 = 7.4e-4
MAX_VS_F64 = 3.8e-3
ABS_GOLDEN_P_DLA = 1e-3
# the zQSO scans against the JAX float64 golden: every finite |dll| within
# this share of the largest finite |ll| (float32 FFTs, and far from the
# peak |ll| reaches ~1e5), and within +-0.2 of the peak within this share of
# the peak's margin (tests/test_zqso.py::test_corr_scan_matches_shift_and_exact)
REL_ZQSO_GLOBAL = 1e-4
NEAR_PEAK_ZQSO = 0.01
REL_K3_GRAD = 1e-5  # each output of K3's adjoint within this share of its max |.|, vs twin
# the training against the JAX float64 golden: losses within this share of
# max|loss|, each gradient block within this share of its max|g|
REL_TRAIN_LOSS = 1e-5
REL_TRAIN_GRAD = 1e-3

# published H100 SXM peaks (NVIDIA data sheet; 700 W): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

LOGMVN = "gpy_dla_detection_tpu/ops/logmvn_pallas.py"
KERNELS = {
    "absorption_all": (
        "gpy_dla_detection_tpu_torch/csrc/absorption_all.cu",
        "gpy_dla_detection_tpu/ops/voigt_pallas.py:239",
    ),
    # the same kernel's other window evaluator (the branch at :357)
    "absorption_all_weideman": (
        "gpy_dla_detection_tpu_torch/csrc/absorption_all.cu",
        "gpy_dla_detection_tpu/ops/voigt_pallas.py:239",
    ),
    "absorption_tail": (
        "gpy_dla_detection_tpu_torch/csrc/absorption_tail.cu",
        "gpy_dla_detection_tpu/ops/voigt_pallas.py:75",
    ),
    "absorption_windowed": (
        "gpy_dla_detection_tpu_torch/csrc/absorption_windowed.cu",
        "gpy_dla_detection_tpu/ops/voigt_pallas.py:144",
    ),
    "logmvn_cap": (
        "gpy_dla_detection_tpu_torch/csrc/logmvn_cap.cu",
        f"{LOGMVN}:238",
    ),
    "logmvn_chain": (
        "gpy_dla_detection_tpu_torch/csrc/logmvn_chain.cu",
        f"{LOGMVN}:497",
    ),
    # K3's wide chain, for k beyond the warp chain's row bounds (phase 16)
    "logmvn_chain_wide": (
        "gpy_dla_detection_tpu_torch/csrc/logmvn_chain.cu",
        f"{LOGMVN}:497",
    ),
    # K3's adjoint (phase 19): no TPU kernel; the function JAX differentiates
    "logmvn_chain_grad": (
        "gpy_dla_detection_tpu_torch/csrc/logmvn_chain_grad.cu",
        "gpy_dla_detection_tpu/ops/logmvn.py:111",
    ),
    "logmvn_chain_grad_wide": (
        "gpy_dla_detection_tpu_torch/csrc/logmvn_chain_grad.cu",
        "gpy_dla_detection_tpu/ops/logmvn.py:111",
    ),
}
GRAD_NOTE = ("no TPU kernel: the JAX training differentiates batched_quad_logdet, K3's "
             "function, by jax.grad (gpy_dla_detection_tpu/models/training.py:272)")
VOIGT_PALLAS = "gpy_dla_detection_tpu/ops/voigt_pallas.py"
# the int16 instantiations (compact storage): each kernel's storage branch,
# the encode at the store (_encode_store) or K2's decode (_decode)
KERNELS_I16 = {
    "absorption_all_i16": ("gpy_dla_detection_tpu_torch/csrc/absorption_all.cu",
                           f"{VOIGT_PALLAS}:381", "poly=True, int16 store (voigt_pallas.py:61-73)"),
    "absorption_all_weideman_i16": ("gpy_dla_detection_tpu_torch/csrc/absorption_all.cu",
                                    f"{VOIGT_PALLAS}:381",
                                    "poly=False, int16 store (voigt_pallas.py:61-73)"),
    "absorption_tail_i16": ("gpy_dla_detection_tpu_torch/csrc/absorption_tail.cu",
                            f"{VOIGT_PALLAS}:84", "int16 store (voigt_pallas.py:61-73)"),
    "absorption_windowed_i16": ("gpy_dla_detection_tpu_torch/csrc/absorption_windowed.cu",
                                f"{VOIGT_PALLAS}:174", "int16 store (voigt_pallas.py:61-73)"),
    "logmvn_cap_i16": ("gpy_dla_detection_tpu_torch/csrc/logmvn_cap.cu", f"{LOGMVN}:152",
                       "int16 a and streams, decoded in _assemble (logmvn_pallas.py:152-171)"),
}
ABLATE = "scripts/kernel_ablate.py"
# the chain variants K3 stands for: rank-1 packed (odd k), flat rank-2, flat
# rank-1, the ablation's packed chain; K2 with a flat basis is the
# ablation's decoupled stage A
ALSO_REPLACES = {
    "logmvn_chain": [f"{LOGMVN}:422", f"{LOGMVN}:319", f"{LOGMVN}:258", f"{ABLATE}:478"],
    "logmvn_cap": [f"{ABLATE}:208"],
}
ABLATE_SOURCE = "gpy_dla_detection_tpu_torch/csrc/logmvn_ablate.cu"
# the stage kernel's functions (each the function of one or more stage names)
ABLATION_FUNCTIONS = ("elementwise", "elementwise_nolog", "matmul", "full", "chain_nodot")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def write_speclite(path: Path, wavelengths, flux, noise_variance, pixel_mask) -> str:
    """An SDSS speclite FITS file: an empty primary HDU and one COADD
    binary table of flux, loglam, ivar and and_mask (BRIGHTSKY, bit 24,
    where ``pixel_mask``), big-endian, in 2,880-byte blocks."""
    def card(key, value):
        if isinstance(value, str):
            return f"{key:<8}= '{value:<8}'".ljust(80)
        text = ("T" if value else "F") if isinstance(value, bool) else str(value)
        return f"{key:<8}= {text:>20}".ljust(80)

    def block(cards):
        text = "".join(cards) + "END".ljust(80)
        return (text + " " * (-len(text) % 2880)).encode("ascii")

    rec = np.zeros(len(flux), dtype=[("flux", ">f4"), ("loglam", ">f4"), ("ivar", ">f4"),
                                     ("and_mask", ">i4")])
    rec["flux"], rec["loglam"] = flux, np.log10(wavelengths)
    rec["ivar"], rec["and_mask"] = 1.0 / noise_variance, np.where(pixel_mask, 1 << 24, 0)
    columns = [card(f"{k}{i}", v) for i, (name, form) in enumerate(
        (("flux", "E"), ("loglam", "E"), ("ivar", "E"), ("and_mask", "J")), 1)
        for k, v in (("TTYPE", name), ("TFORM", form))]
    data = rec.tobytes()
    with open(path, "wb") as f:
        f.write(block([card("SIMPLE", True), card("BITPIX", 8), card("NAXIS", 0)]))
        f.write(block([card("XTENSION", "BINTABLE"), card("BITPIX", 8), card("NAXIS", 2),
                       card("NAXIS1", rec.dtype.itemsize), card("NAXIS2", len(rec)),
                       card("PCOUNT", 0), card("GCOUNT", 1), card("TFIELDS", 4), *columns,
                       card("EXTNAME", "COADD")]))
        f.write(data + b"\x00" * (-len(data) % 2880))
    return str(path)


def same_bits(got: dict, want: dict, names) -> list[str]:
    """The names whose arrays differ in dtype, shape or any bit."""
    return [n for n in names if got[n].dtype != want[n].dtype or got[n].shape != want[n].shape
            or got[n].tobytes() != want[n].tobytes()]


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


def events_ms(fn, reps: int = 50) -> float:
    """Milliseconds a call of ``fn()`` by CUDA events around ``reps``
    back-to-back calls, after a warm-up: the device time of a kernel that
    is longer than its launch's host time."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least milliseconds for the work: bytes over HBM rate or float32
    operations over the float32 peak, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(wl, z, n_fam, consts, far_lines, lls_break=False, poly=True,
            elem=4) -> tuple[float, float]:
    """Bytes and float32 operations of one K1 call on these inputs, storing
    ``elem`` bytes an output (4 float32, 2 int16 codes: one more product
    and a conversion an output).  Per
    sample, pixel and line: 6 for the line's x and |z|^2, then 4 in the
    far field; inside it, with poly, 38 on the disk fit (degree 16) or 30
    on the wing fit (degree 10, one division); without, 180 in the Weideman
    disk (19 complex Horner steps) or 48 on the annulus (the continued
    fraction, 5 terms); per family an exp and a product per pixel and 7
    FMAs per output pixel; with the Lyman-limit break 5 per pixel (a
    product, a comparison, three products).  An exp or a division counts
    as one."""
    S, P = z.shape[0], wl.shape[0]
    ops = 5.0 * S * P if lls_break else 0.0
    one_plus_z = (1.0 + z)[:, None]
    for l, line in enumerate(consts["lines"]):
        lam_c = line["lam"] * one_plus_z
        u = ((wl[None, :] - lam_c) * (consts["c_cgs"] / lam_c) * consts["inv"]) ** 2
        far = (u + line["y2"]) > 256.0**2
        n_far = float(far.sum())
        if poly:
            n_disk = float((~far & (u <= 9.0)).sum())
            window = 38 * n_disk + 30 * (S * P - n_far - n_disk)
        else:
            n_inner = float(((u + line["y2"]) <= 49.0).sum())
            window = 180 * n_inner + 48 * (S * P - n_far - n_inner)
        ops += 6 * S * P + (4 * n_far if l < far_lines else 0) + window
    ops += n_fam * (2 * S * P + 14 * S * (P - 6))
    if elem == 2:
        ops += 2.0 * n_fam * S * (P - 6)
    n_bytes = 4 * (P + S + n_fam * S) + elem * n_fam * S * (P - 6)
    return n_bytes, ops


def k2_work(S, N, k, n_extra, elem=4) -> tuple[float, float]:
    """The two capacitance products (2 S N (k(k+1)/2 + k)) and ~12 + n_extra
    elementwise operations per sample and pixel (with int16 codes, elem = 2,
    a decode more per stream); reads A and the extras (``elem`` bytes an
    element), the rows, M and M_pair, writes B, u and misc."""
    kp = k * (k + 1) // 2
    ops = 2.0 * S * N * (kp + k) + S * N * (12 + n_extra)
    if elem == 2:
        ops += 2.0 * S * N * (1 + n_extra)
    n_bytes = (4.0 * (5 * N + N * k + N * kp + S * (kp + k + 2))
               + elem * S * N * (1 + n_extra))
    return n_bytes, ops


def k3_work(S, k) -> tuple[float, float]:
    """Per sample the Cholesky (~k^3/3), the substitution and the logs
    (~2 k^2); reads B, u, misc, writes ll."""
    kp = k * (k + 1) // 2
    return 4.0 * S * (kp + k + 2 + 1), S * (k**3 / 3.0 + 2.0 * k * k)


def k3_grad_work(S, k) -> tuple[float, float]:
    """K3's adjoint: per sample the Cholesky (~k^3/3), the inverse of its
    factor (~k^3/3), A^-1 = W^T W (~k^3/3) and ~6 k^2 for t, v and the
    outputs; reads B, u and g, writes dB, du and dmisc."""
    kp = k * (k + 1) // 2
    return 4.0 * S * (2 * kp + 2 * k + 3), S * (k**3 + 6.0 * k * k)


def k5_work(S, P, elem=4) -> tuple[float, float]:
    """An exp and a product per input pixel, 7 FMAs per output pixel (with
    int16 codes a product and a conversion more); reads unit_tau, nhi and
    the taps, writes the profile at ``elem`` bytes an output."""
    ops = S * (2.0 * P + 14.0 * (P - 6) + (2.0 * (P - 6) if elem == 2 else 0.0))
    return 4.0 * (S * P + S + 7) + elem * S * (P - 6), ops


def k6_work(parts, elem=4) -> tuple[float, float]:
    """What K6's function needs on these parts: far's first P pixels, the
    window pixels below P (from this run's window starts c0), c0 (int32),
    nhi and the taps read once, the profile written at ``elem`` bytes an
    output; an add per window pixel below P, an exp and a product per
    pixel, 7 FMAs per output pixel (with int16 codes a product and a
    conversion more)."""
    S, P, L = parts.far.shape[0], parts.num_pixels, parts.c0.shape[1]
    window = float(torch.clamp(P - 128 * parts.c0.long(), 0, 256).sum())
    n_bytes = 4.0 * (S * P + window + S * L + S + 7) + elem * S * (P - 6)
    ops = window + S * (2.0 * P + 14.0 * (P - 6) + (2.0 * (P - 6) if elem == 2 else 0.0))
    return n_bytes, ops


def k6_work_padded(parts, elem=4) -> tuple[float, float]:
    """K6's work by the earlier count: the whole padded far field and every
    window pixel (what the earlier design read), printed beside the count
    of what the function needs."""
    S, P_pad, P, L = parts.far.shape[0], parts.far.shape[1], parts.num_pixels, parts.c0.shape[1]
    n_bytes = 4.0 * (S * P_pad + S * L * 256 + S * L + S + 7) + elem * S * (P - 6)
    ops = S * (256.0 * L + 2.0 * P + 14.0 * (P - 6) + (2.0 * (P - 6) if elem == 2 else 0.0))
    return n_bytes, ops


def ablation_work(stage: str, S, N, k) -> tuple[float, float]:
    """Bytes and float32 operations that one stage's function needs: it
    reads the absorption and the rows and writes ll, with ~12 operations
    per sample and pixel in the assembly (a logf counting one).  matmul's
    output needs no product: sum B + sum u = sum_n w_n (sum_i M_ni)^2 + r_n
    sum_i M_ni, two FMAs per sample and pixel after reading M and the basis
    once.  full and chain_nodot read only the triangle of the symmetric
    pair basis, so their products are K2's 2 S N (k(k+1)/2 + k), then the
    chain's ~k^3/3 + 2 k^2 per sample."""
    kp = k * (k + 1) // 2
    n_bytes = 4.0 * (S * N + 5 * N + S)
    ops = 12.0 * S * N
    if stage == "matmul":
        n_bytes += 4.0 * (N * k + N * k * k)
        ops += 4.0 * S * N + N * (k + 2.0)
    elif stage in ("full", "chain_nodot"):
        n_bytes += 4.0 * (N * k + N * kp)
        ops += 2.0 * S * N * (kp + k) + S * (k**3 / 3.0 + 2.0 * k * k)
    return n_bytes, ops


def packed_product_work(S, N, k) -> float:
    """The packed product w [Mp_packed | M] and its assembly that the stage
    kernel computes from matmul on, K2's operations (2 S N (k(k+1)/2 + k)
    + 12 S N): the instrument's own work, which matmul's function does not
    need."""
    return k2_work(S, N, k, 0)[1]


def flat_chain_work(S, k) -> tuple[float, float]:
    """Reads the upper triangle of the flat B (the chain reads no other
    entry), u and misc, writes ll; the Cholesky, the substitution and the
    logs per sample."""
    return 4.0 * S * (k * (k + 1) // 2 + k + 2 + 1), S * (k**3 / 3.0 + 2.0 * k * k)


def load_script(path: Path, name: str):
    """A script of the repo as a module: the ablation's entry point
    (scripts/kernel_ablate_torch.py, phase 11) and the reference-scale
    training (scripts/train_fullscale_torch.py, phase 20)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")

    from gpy_dla_detection_tpu_torch.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_civ_spectrum,
        synthetic_learned_model,
        synthetic_prior_catalog,
        synthetic_spectrum,
    )
    from gpy_dla_detection_tpu_torch.models.absorber_mcmc import run_civ_mcmc, run_dla_mcmc
    from gpy_dla_detection_tpu_torch.models.civ import (
        civ_inference_many,
        civ_model_posterior,
        generate_civ_samples,
    )
    from gpy_dla_detection_tpu_torch.models.learned import (
        LearnedModel,
        build_spectrum_model,
    )
    from gpy_dla_detection_tpu_torch.models.lls import (
        generate_lya_samples,
        lls_inference_many,
        lls_log_evidences,
        lls_model_posteriors,
        with_boss_meanflux,
    )
    from gpy_dla_detection_tpu_torch.ops import _build
    from gpy_dla_detection_tpu_torch.ops.logmvn_ablate import (
        logmvn_ablate_packed,
        logmvn_ablate_reference,
        logmvn_decoupled,
        logmvn_flat_chain,
        logmvn_flat_chain_reference,
    )
    from gpy_dla_detection_tpu_torch.ops.logmvn import batched_log_mvnpdf, decode_profile_store
    from gpy_dla_detection_tpu_torch.ops.timing import (
        SENTINEL_KERNEL,
        union_busy_ms,
        device_ms,
        prime_profiler,
    )
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
        assemble_reference,
        logmvn_cap,
        logmvn_cap_reference,
        logmvn_chain,
        logmvn_chain_reference,
        packed_pair_basis,
        unpack_capacitance,
    )
    from gpy_dla_detection_tpu_torch.ops.voigt import (
        FAR_FIELD_LINES,
        instrumental_broadening,
        lyman_limit_unit_tau,
        unit_lyman_optical_depth,
        windowed_tau_parts,
    )
    from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
        K1_MAX_LINES,
        _kernel_constants,
        absorption_all,
        absorption_all_reference,
        launch_absorption_all,
        absorption_tail,
        absorption_tail_reference,
        absorption_windowed,
        absorption_windowed_reference,
    )
    from gpy_dla_detection_tpu_torch.models.pipeline import spectrum_result
    from gpy_dla_detection_tpu_torch.params import CIVParameters, Parameters
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

    # 2. kernel build: the user paths' library and the ablation's at once
    # (one nvcc a source), the first timed apart
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        ablate_build = pool.submit(_build.build, "ablate")
        (main_lib,) = _build.build("kernels")
        main_s = time.perf_counter() - t0
        (ablate_lib,) = ablate_build.result()
    for name in _build.LIBRARIES:
        _build.load_library(name)
    print(f"[2 build] {time.perf_counter() - t0:.2f} s, nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{main_lib.relative_to(ROOT)} in {main_s:.2f} s, {ablate_lib.relative_to(ROOT)}")

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
    # the LLS search: spectra drawn from the synthetic model, searched with
    # the BOSS mean flux; the first two are the golden fixture's
    lls_params = Parameters(**LLS_PARAMS)
    lls_arrays = synthetic_learned_model(lls_params)
    lls_learned = with_boss_meanflux(LearnedModel.from_numpy(lls_arrays, device, torch.float32))
    lya_samples = generate_lya_samples(lls_params.num_dla_samples)
    lls_z_qsos = [3.0 + 0.2 * (i % 2) + 0.05 * (i // 2) for i in range(NUM_LLS)]
    lls_truths = [(z - 0.2, LLS_LOG_NHI) if i % 2 else None for i, z in enumerate(lls_z_qsos)]
    lls_spectra = [
        synthetic_spectrum(lls_params, lls_arrays, z, seed=100 + i,
                           dlas=None if t is None else [t], with_lls_break=True)
        for i, (z, t) in enumerate(zip(lls_z_qsos, lls_truths))
    ]

    # the CIV head: the golden fixture's 8 spectra (odd ones with a doublet)
    gc = np.load(GOLDEN_CIV)
    civ_params = CIVParameters()
    civ_arrays = synthetic_learned_model(civ_params)
    civ_learned = LearnedModel.from_numpy(civ_arrays, device, torch.float32)
    civ_samples = generate_civ_samples(civ_params)
    civ_injected = [bool(i) for i in gc["injected"]]
    civ_spectra = [
        synthetic_civ_spectrum(civ_params, civ_arrays, float(z), seed=int(seed),
                               civ=(float(cz), float(cn), float(cs)) if inj else None)
        for z, seed, inj, cz, cn, cs in zip(gc["z_qso"], gc["obs_seed"], civ_injected,
                                            gc["civ_z"], gc["civ_log_n"], gc["civ_sigma"])
    ]
    run_civ = lambda: civ_inference_many(civ_learned, civ_spectra, civ_samples, civ_params)

    # 3. kernels vs twins at main-path shapes
    model = build_spectrum_model(learned, to_torch(spectra[1], device, torch.float32), params)
    put = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    z_s = model.min_z_dla + (model.max_z_dla - model.min_z_dla) * put(dla_samples.offset_samples)
    nhis = (put(dla_samples.nhi_samples), put(sub_samples.nhi_samples))
    wl = model.padded_wavelengths
    k1_out = absorption_all(wl, z_s, nhis)
    k1_ref = absorption_all_reference(wl, z_s, nhis)
    err_k1 = max(float((a - b).abs().max()) for a, b in zip(k1_out, k1_ref))
    check(err_k1 <= TOL_K1, f"K1 vs twin {err_k1:.3e} > {TOL_K1}")
    err = {"absorption_all": err_k1}

    # K5 on the exact unit optical depth, at the catalog's and the MCMC
    # half-steps' row counts
    unit_tau = unit_lyman_optical_depth(wl, z_s, params.num_lines)
    k5_rows = {}
    for rows_n in (unit_tau.shape[0], DLA_CHAIN[0] // 2, CIV_CHAIN[0] // 2):
        tau_r, nhi_r = unit_tau[:rows_n].contiguous(), nhis[0][:rows_n].contiguous()
        k5_rows[rows_n] = (tau_r, nhi_r)
        e5 = float((absorption_tail(tau_r, nhi_r) - absorption_tail_reference(tau_r, nhi_r))
                   .abs().max())
        check(e5 <= TOL_K5, f"K5 ({rows_n} rows) vs twin {e5:.3e} > {TOL_K5}")
        err["absorption_tail"] = max(err.get("absorption_tail", 0.0), e5)

    # K6 on the windowed unit optical depth parts of the same samples
    parts = windowed_tau_parts(wl, z_s, params.num_lines)
    err["absorption_windowed"] = max(
        float((absorption_windowed(parts, n) - absorption_windowed_reference(parts, n))
              .abs().max())
        for n in nhis
    )
    check(err["absorption_windowed"] <= TOL_K6,
          f"K6 vs twin {err['absorption_windowed']:.3e} > {TOL_K6}")

    # K1 with the Lyman-limit break at the LLS search's width
    lls_model = build_spectrum_model(
        lls_learned, to_torch(lls_spectra[1], device, torch.float32), lls_params)
    z_lls = lls_model.min_z_dla + (lls_model.max_z_dla - lls_model.min_z_dla) * put(
        lya_samples.offset_samples)
    nhi_lls = (put(lya_samples.nhi_samples),)
    wl_lls = lls_model.padded_wavelengths
    (A_lls,) = absorption_all(wl_lls, z_lls, nhi_lls, lls_break=True)
    err_k1_lls = float((A_lls - absorption_all_reference(wl_lls, z_lls, nhi_lls, lls_break=True)[0])
                       .abs().max())
    check(err_k1_lls <= TOL_K1, f"K1 with the break vs twin {err_k1_lls:.3e} > {TOL_K1}")
    err["absorption_all"] = max(err["absorption_all"], err_k1_lls)

    # K1 with the Weideman window (poly=False) at the same two widths:
    # against its twin, and against the float64 exact profile within 1.5x
    # the twin's own error
    def exact_profiles(wl_, z_, nhis_, lls_break):
        wl64, z64 = wl_.double(), z_.double()
        unit = unit_lyman_optical_depth(wl64, z64, params.num_lines)
        if lls_break:
            unit = unit + lyman_limit_unit_tau(wl64, z64)
        return [instrumental_broadening(torch.exp(-n.double()[:, None] * unit)) for n in nhis_]

    def weideman_parity(wl_, z_, nhis_, lls_break, label):
        got = absorption_all(wl_, z_, nhis_, lls_break=lls_break, poly=False)
        want = absorption_all_reference(wl_, z_, nhis_, lls_break=lls_break, poly=False)
        worst = [0.0, 0.0, 0.0]
        for g_, w_, t_ in zip(got, want, exact_profiles(wl_, z_, nhis_, lls_break)):
            e = float((g_ - w_).abs().max())
            e_kernel = float((g_.double() - t_).abs().max())
            e_twin = float((w_.double() - t_).abs().max())
            check(e <= TOL_K1_WEIDEMAN, f"K1 Weideman {label} vs twin {e:.3e} > {TOL_K1_WEIDEMAN}")
            check(e_kernel <= max(1.5 * e_twin, TOL_TRUTH_FLOOR),
                  f"K1 Weideman {label} vs float64 {e_kernel:.3e} > 1.5 x the twin's {e_twin:.3e}")
            worst = [max(a, b) for a, b in zip(worst, (e, e_kernel, e_twin))]
        return worst

    k1w = weideman_parity(wl, z_s, nhis, False, "main path")
    k1w_lls = weideman_parity(wl_lls, z_lls, nhi_lls, True, "with the break")
    err["absorption_all_weideman"] = max(k1w[0], k1w_lls[0])
    # both branches at other line counts, family counts and pixel counts
    k1_cases = {}
    for poly in (True, False):
        for n_lines in (1, 8, K1_MAX_LINES):
            for F_, P_ in ((1, 7), (3, 301)):
                wl_c, z_c = wl[:P_], z_s[:1001]
                nh_c = tuple(n[:1001] for n in (nhis * 2)[:F_])
                e = max(float((a - b).abs().max()) for a, b in zip(
                    absorption_all(wl_c, z_c, nh_c, n_lines, poly=poly),
                    absorption_all_reference(wl_c, z_c, nh_c, n_lines, poly=poly)))
                tol = TOL_K1 if poly else TOL_K1_WEIDEMAN
                name = "absorption_all" if poly else "absorption_all_weideman"
                check(e <= tol, f"K1 (poly={poly}, {n_lines} lines, F={F_}, P={P_}) vs twin "
                                f"{e:.3e} > {tol}")
                k1_cases[f"{'poly' if poly else 'weideman'} L={n_lines} F={F_} P={P_}"] = e
                err[name] = max(err[name], e)

    A = k1_out[0]
    S = A.shape[0]
    gen = torch.Generator(device=device).manual_seed(0)
    idx3 = [torch.randint(0, S, (S,), generator=gen, device=device) for _ in range(3)]
    extras3 = [A[i] for i in idx3]
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
    # K2 and K3 at the LLS search's N = 1,664 on K1's profiles with the break
    rows_lls = torch.stack([lls_model.y, lls_model.mu, lls_model.omega2, lls_model.v,
                            lls_model.mask.float()])
    Mp_lls = packed_pair_basis(lls_model.M)
    cap_lls = logmvn_cap(rows_lls, lls_model.M, Mp_lls, A_lls)
    cap_lls_ref = logmvn_cap_reference(rows_lls, lls_model.M, Mp_lls, A_lls)
    ll_lls_ref = logmvn_chain_reference(*cap_lls_ref)
    scale_lls = float(ll_lls_ref.abs().max())
    k2_lls = float((logmvn_chain_reference(*cap_lls) - ll_lls_ref).abs().max())
    k3_lls = float((logmvn_chain(*cap_lls) - logmvn_chain_reference(*cap_lls)).abs().max())
    check(k2_lls <= REL_K23 * scale_lls, f"K2 (N=1664) |dll| {k2_lls:.3e} > {REL_K23} x {scale_lls:.4g}")
    check(k3_lls <= REL_K23 * scale_lls, f"K3 (N=1664) |dll| {k3_lls:.3e} > {REL_K23} x {scale_lls:.4g}")
    k2_err.append(k2_lls)
    k3_err.append(k3_lls)
    # K2 on a narrow GP basis (k = NARROW_K: the first columns of the
    # model's), which its block takes since it is made of whole warps
    M_narrow = model.M[:, :NARROW_K].contiguous()
    Mp_narrow = packed_pair_basis(M_narrow)
    ll_narrow_ref = logmvn_chain_reference(*logmvn_cap_reference(rows, M_narrow, Mp_narrow, A))
    scale_narrow = float(ll_narrow_ref.abs().max())
    k2_narrow = float((logmvn_chain_reference(*logmvn_cap(rows, M_narrow, Mp_narrow, A))
                       - ll_narrow_ref).abs().max())
    check(k2_narrow <= REL_K23 * scale_narrow,
          f"K2 (k={NARROW_K}) |dll| {k2_narrow:.3e} > {REL_K23} x {scale_narrow:.4g}")
    k2_err.append(k2_narrow)
    err["logmvn_cap"] = max(k2_err)
    err["logmvn_chain"] = max(k3_err)

    # K3 at an odd k (the rank-1 variant's case): a GP basis of ODD_K
    # columns through K2's twin, so the capacitance is a real one
    M_odd = torch.cat([model.M, model.M[:, :ODD_K - model.M.shape[1]] * 0.5], dim=1)
    cap_odd = logmvn_cap_reference(rows, M_odd, packed_pair_basis(M_odd), A)
    ll_odd_ref = logmvn_chain_reference(*cap_odd)
    scale_odd = float(ll_odd_ref.abs().max())
    k3_odd = float((logmvn_chain(*cap_odd) - ll_odd_ref).abs().max())
    check(k3_odd <= REL_K23 * scale_odd,
          f"K3 (k={ODD_K}) |dll| {k3_odd:.3e} > {REL_K23} x {scale_odd:.4g}")
    err["logmvn_chain"] = max(err["logmvn_chain"], k3_odd)
    # K3 on both sides of its row bound 32 (64 gives a lane two rows) and
    # of a half warp, through K2's twin: GP bases of the model's first k
    # columns, and beyond its width independent seeded columns of its
    # scale, so every basis has full rank
    k3_widths = {}
    for kw in CHAIN_KS:
        gen_k = torch.Generator(device=device).manual_seed(kw)
        wider = torch.randn(model.M.shape[0], max(0, kw - model.M.shape[1]), generator=gen_k,
                            device=device) * model.M.std()
        M_k = torch.cat([model.M[:, :kw], wider], dim=1).contiguous()
        cap_k = logmvn_cap_reference(rows, M_k, packed_pair_basis(M_k), A)
        ll_k_ref = logmvn_chain_reference(*cap_k)
        scale_k = float(ll_k_ref.abs().max())
        k3_widths[kw] = float((logmvn_chain(*cap_k) - ll_k_ref).abs().max()) / scale_k
        check(k3_widths[kw] <= REL_K23, f"K3 (k={kw}) |dll| {k3_widths[kw]:.3e} of max|ll| "
                                        f"> {REL_K23}")
        err["logmvn_chain"] = max(err["logmvn_chain"], k3_widths[kw] * scale_k)
    torch.cuda.synchronize()
    print(f"[3 parity] S={S} N={A.shape[1]} k={model.M.shape[1]} F=2 | K1 max|d| "
          f"{err_k1:.3e} (tol {TOL_K1}) | K5 max|d| {err['absorption_tail']:.3e} "
          f"at {' and '.join(f'{r}x{unit_tau.shape[1]}' for r in k5_rows)} (tol {TOL_K5}) | "
          f"K2 max|dll| 0/3 streams {k2_err[0]:.3e}/{k2_err[1]:.3e}, outputs max rel "
          f"{max(k2_rel):.3e} | K3 max|dll| {k3_err[0]:.3e}/{k3_err[1]:.3e} (tol {REL_K23} x "
          f"max|ll| {scale:.4g}), k={ODD_K} {k3_odd:.3e} (tol {REL_K23} x {scale_odd:.4g}) | "
          f"K6 max|d| {err['absorption_windowed']:.3e} at {S}x{parts.far.shape[1]}, L="
          f"{parts.c0.shape[1]}, both families (tol {TOL_K6}) | K1 with the break max|d| "
          f"{err_k1_lls:.3e} at {S}x{wl_lls.shape[0]} (tol {TOL_K1}) | at N={A_lls.shape[1]}: "
          f"K2 max|dll| {k2_lls:.3e}, K3 {k3_lls:.3e} (tol {REL_K23} x {scale_lls:.4g}) | "
          f"K2 at k={NARROW_K} max|dll| {k2_narrow:.3e} (tol {REL_K23} x {scale_narrow:.4g}) | "
          f"K3 |dll|/max|ll| at k=" + ", ".join(f"{kw}: {e:.2e}" for kw, e in k3_widths.items())
          + f" (tol {REL_K23}) | K1 Weideman window max|d| {k1w[0]:.3e} at {S}x{wl.shape[0]} "
          f"F=2, {k1w_lls[0]:.3e} with the break at {S}x{wl_lls.shape[0]} (tol "
          f"{TOL_K1_WEIDEMAN}); vs float64 kernel {k1w[1]:.3e} / {k1w_lls[1]:.3e}, twin "
          f"{k1w[2]:.3e} / {k1w_lls[2]:.3e} | K1 at S={min(S, 1001)} max|d| "
          + ", ".join(f"{c}: {e:.2e}" for c, e in k1_cases.items()))

    def run_slice(base_inds=None, batch=spectra, voigt_impl="windowed", abs_dtype=None,
                  window_tier=True):
        return process_batch(
            learned, batch, dla_samples, sub_samples, prior, params,
            torch.Generator(device=device).manual_seed(1), MAX_DLAS,
            base_inds_override=base_inds, voigt_impl=voigt_impl, abs_dtype=abs_dtype,
            window_tier=window_tier,
        )

    def check_detections(results, batch_truths, label):
        dzs, p_clean, p_inj = [], [0.0], [1.0]
        for res, truth in zip(results, batch_truths):
            finite = (np.isfinite(res.log_evidence_null) and np.isfinite(res.log_evidence_subdla)
                      and np.isfinite(res.log_evidences_dla).all())
            check(finite, f"{label}: non-finite evidence")
            if truth is None:
                check(res.p_dla < 0.1, f"{label}: clean spectrum p_dla {res.p_dla:.4f} >= 0.1")
                p_clean.append(res.p_dla)
            else:
                dz = abs(float(res.map_z_dlas[0][0]) - truth[0])
                check(res.p_dla > 0.9, f"{label}: injected DLA missed: p_dla {res.p_dla:.4f}")
                check(dz < 0.01, f"{label}: injected DLA MAP z off by {dz:.4f}")
                dzs.append(dz)
                p_inj.append(res.p_dla)
        return (f"clean max p_dla {max(p_clean):.3e} | injected min p_dla {min(p_inj):.6f}, "
                f"max |MAP z - truth| {max(dzs):.2e}")

    def count_launches(fn, int16=False):
        """Run ``fn`` with the launch counts set to 0 just before; the
        counts just after.  Unless ``int16``, no int16 instantiation may
        launch (float32 storage is every entry point's default); the
        likelihood's plain composition (the CPU path) never runs."""
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        if not int16:
            i16 = {n: c for n, c in counts.items() if n.endswith("_i16")}
            check(not i16, f"an int16 instantiation launched on a float32 path: {i16}")
        check(counts.get("logmvn_composition", 0) == 0,
              f"the likelihood's composition ran on the card: {counts}")
        return out, counts

    path_launches = {}

    # 4. the default catalog path through the batch entry point
    results, launches = count_launches(run_slice)
    path_launches["windowed"] = launches
    need = {"absorption_all": NUM_SPECTRA, "logmvn_cap": 5 * NUM_SPECTRA,
            "logmvn_chain": 5 * NUM_SPECTRA}
    for name, n in need.items():
        check(launches.get(name, 0) >= n, f"{name} launched {launches.get(name, 0)} < {n} times")
    check(launches.get("absorption_all_weideman", 0) == 0, "slice: the Weideman window launched")
    print(f"[4 slice] {NUM_SPECTRA} spectra at S={params.num_dla_samples} N="
          f"{params.num_pixels_padded} k={params.k} max_dlas={MAX_DLAS} | launches {launches} | "
          f"{check_detections(results, truths, 'slice')}")

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

    def golden_parity(voigt_impl, abs_dtype=None, want_fixture=g, window_tier=True):
        """The fixture's spectra with its resampling indices (the int16
        fixture's are the float64 one's) against ``want_fixture``; where it
        holds evidences only (the int16 fixture), its p_dla and posteriors
        come from the port's model selection (models.selection, equal to
        the reference's) on those evidences.  The launches are counted, so
        the composition-free check covers the golden runs too."""
        gres, _ = count_launches(lambda: run_slice(
            g["base_inds"].astype(np.int64), golden_spectra, voigt_impl, abs_dtype, window_tier),
            int16=abs_dtype is not None)
        worst_rel, worst_dp = 0.0, 0.0
        label = (f"{voigt_impl}{'' if abs_dtype is None else ' int16'}"
                 f"{'' if window_tier else ' without the window tier'}")
        for i, (res, spec) in enumerate(zip(gres, golden_spectra)):
            want_ev = (want_fixture["log_evidence_null"][i], want_fixture["log_evidence_subdla"][i],
                       want_fixture["log_evidences_dla"][i])
            if "p_dla" in want_fixture:
                want_p, want_post = float(want_fixture["p_dla"][i]), want_fixture["model_posteriors"][i]
            else:
                sel = spectrum_result(
                    want_ev[0], want_ev[2], np.array([want_ev[1]]), np.zeros((1, MAX_DLAS)),
                    np.zeros((1, 1)), None, None, None, spec, sub_samples, prior, MAX_DLAS)
                want_p, want_post = sel.p_dla, sel.selection.model_posteriors
            got = np.concatenate([[res.log_evidence_null, res.log_evidence_subdla],
                                  res.log_evidences_dla]).astype(np.float64)
            want = np.concatenate([[want_ev[0], want_ev[1]], want_ev[2]])
            # relative to the spectrum's evidence scale (a log evidence may cross 0)
            rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
            dp = abs(res.p_dla - want_p)
            worst_rel, worst_dp = max(worst_rel, rel), max(worst_dp, dp)
            check(rel <= REL_GOLDEN_EVIDENCE, f"golden {label} {i}: log evidence rel {rel:.3e}")
            check(dp <= ABS_GOLDEN_P_DLA, f"golden {label} {i}: |dp_dla| {dp:.3e}")
            check(np.argmax(res.selection.model_posteriors) == np.argmax(want_post),
                  f"golden {label} {i}: argmax model differs")
        return (f"{len(gres)} spectra vs JAX float64 at full width, same indices | "
                f"log evidence max rel {worst_rel:.3e} (tol {REL_GOLDEN_EVIDENCE}) | "
                f"max |dp_dla| {worst_dp:.3e} (tol {ABS_GOLDEN_P_DLA}) | argmax models equal")

    print(f"[5 golden] {golden_parity('windowed')}")

    # 6. the exact-Voigt configuration: exact unit tau once per spectrum,
    # then one K5 launch per family (DLA and subDLA): 2 per spectrum
    results, launches = count_launches(
        lambda: run_slice(batch=spectra[:NUM_EXACT], voigt_impl="exact"))
    path_launches["exact"] = launches
    need = {"absorption_tail": 2 * NUM_EXACT, "logmvn_cap": 5 * NUM_EXACT,
            "logmvn_chain": 5 * NUM_EXACT, "absorption_all_weideman": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n, f"exact: {name} launched {launches.get(name, 0)} != {n}")
    check(launches.get("absorption_all", 0) == 0, "exact: K1 launched")
    print(f"[6 exact] {NUM_EXACT} spectra, voigt_impl=exact | launches {launches} "
          f"(absorption_tail 2 per spectrum: one per family) | "
          f"{check_detections(results, truths[:NUM_EXACT], 'exact')} | "
          f"golden: {golden_parity('exact')}")

    # 7. the unfused windowed configuration: the windowed unit tau parts
    # once per spectrum, then one K6 launch per family: 2 per spectrum
    results, launches = count_launches(
        lambda: run_slice(batch=spectra[:NUM_UNFUSED], voigt_impl="windowed_unfused"))
    path_launches["windowed_unfused"] = launches
    need = {"absorption_windowed": 2 * NUM_UNFUSED, "logmvn_cap": 5 * NUM_UNFUSED,
            "logmvn_chain": 5 * NUM_UNFUSED, "absorption_all": 0, "absorption_tail": 0,
            "absorption_all_weideman": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n,
              f"unfused: {name} launched {launches.get(name, 0)} != {n}")
    print(f"[7 unfused] {NUM_UNFUSED} spectra, voigt_impl=windowed_unfused | launches "
          f"{launches} (absorption_windowed 2 per spectrum: one per family) | "
          f"{check_detections(results, truths[:NUM_UNFUSED], 'unfused')} | "
          f"golden: {golden_parity('windowed_unfused')} || without the two-tier window "
          f"(window_tier=False, the reference's GPY_DLA_WINDOW_TIER=0), golden: "
          f"{golden_parity('windowed_unfused', window_tier=False)}")

    # 8. the LLS search: one K1 launch (with the break, F = 1) and max_lya
    # likelihood levels per spectrum; then the unfused windowed
    # configuration: the placed windowed unit tau plus the break and one K5
    # launch per spectrum (the reference places the LLS windows outside K6)
    def run_lls(batch=lls_spectra, voigt_impl="windowed", abs_dtype=None):
        return lls_inference_many(
            lls_learned, batch, lya_samples, torch.Generator(device=device).manual_seed(3),
            MAX_LYA, lls_params, voigt_impl=voigt_impl, abs_dtype=abs_dtype)

    def p_absorber(null_ev, evs):
        return 1.0 - float(lls_model_posteriors(float(null_ev), np.asarray(evs, np.float64))[0])

    def check_lls(outs, label):
        dzs, p_clean, p_inj = [], [0.0], [1.0]
        for (null_ev, res), truth in zip(outs, lls_truths):
            check(np.isfinite(null_ev) and np.isfinite(res.log_evidences).all(),
                  f"{label}: non-finite evidence")
            p = p_absorber(null_ev, res.log_evidences)
            if truth is None:
                check(p < 0.1, f"{label}: clean spectrum P(k >= 1) {p:.4f} >= 0.1")
                p_clean.append(p)
            else:
                dz = abs(float(res.map_z_dlas[0][0]) - truth[0])
                check(p > 0.9, f"{label}: injected LLS missed: P(k >= 1) {p:.4f}")
                check(dz < 0.01, f"{label}: injected LLS MAP z off by {dz:.4f}")
                dzs.append(dz)
                p_inj.append(p)
        return (f"clean max P(k>=1) {max(p_clean):.3e} | injected min P(k>=1) "
                f"{min(p_inj):.6f}, max |MAP z - truth| {max(dzs):.2e}")

    gl = np.load(GOLDEN_LLS)

    def golden_lls(voigt_impl, abs_dtype=None):
        worst_rel, worst_dp = 0.0, 0.0
        for i, (z, seed, inj, lz, ln) in enumerate(zip(
                gl["z_qso"], gl["obs_seed"], gl["injected"], gl["lls_z"], gl["lls_log_nhi"])):
            gspec = synthetic_spectrum(lls_params, lls_arrays, float(z), seed=int(seed),
                                       dlas=[(float(lz), float(ln))] if inj else None,
                                       with_lls_break=True)
            null_ev, res = lls_log_evidences(
                lls_learned, gspec, lya_samples, torch.Generator(device=device).manual_seed(4),
                MAX_LYA, lls_params, base_inds_override=gl["base_inds"][i].astype(np.int64),
                voigt_impl=voigt_impl, abs_dtype=abs_dtype)
            got = np.concatenate([[float(null_ev)], res.log_evidences.cpu().numpy()]).astype(
                np.float64)
            want = np.concatenate([[gl["log_evidence_null"][i]], gl["log_evidences_lls"][i]])
            rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
            post = lls_model_posteriors(got[0], got[1:])
            dp = abs((1.0 - post[0]) - (1.0 - float(gl["model_posteriors"][i][0])))
            worst_rel, worst_dp = max(worst_rel, rel), max(worst_dp, dp)
            check(rel <= REL_GOLDEN_EVIDENCE, f"golden lls {voigt_impl} {i}: log evidence rel {rel:.3e}")
            check(dp <= ABS_GOLDEN_P_DLA, f"golden lls {voigt_impl} {i}: |dP(k >= 1)| {dp:.3e}")
            check(np.argmax(post) == np.argmax(gl["model_posteriors"][i]),
                  f"golden lls {voigt_impl} {i}: argmax model differs")
        return (f"{len(gl['z_qso'])} spectra vs JAX float64 at full width, same indices | log "
                f"evidence max rel {worst_rel:.3e} (tol {REL_GOLDEN_EVIDENCE}) | max |dP(k>=1)| "
                f"{worst_dp:.3e} (tol {ABS_GOLDEN_P_DLA}) | argmax models equal")

    outs, launches = count_launches(run_lls)
    path_launches["lls"] = launches
    need = {"absorption_all": NUM_LLS, "logmvn_cap": MAX_LYA * NUM_LLS,
            "logmvn_chain": MAX_LYA * NUM_LLS, "absorption_tail": 0, "absorption_windowed": 0,
            "absorption_all_weideman": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n, f"lls: {name} launched {launches.get(name, 0)} != {n}")
    lls_line = (f"{NUM_LLS} spectra at S={lls_params.num_dla_samples} N="
                f"{lls_params.num_pixels_padded} k={lls_params.k} max_lya={MAX_LYA}, BOSS mean "
                f"flux | launches {launches} | {check_lls(outs, 'lls')} | golden: "
                f"{golden_lls('windowed')}")
    outs, launches = count_launches(lambda: run_lls(voigt_impl="windowed_unfused"))
    path_launches["lls_unfused"] = launches
    need = {"absorption_tail": NUM_LLS, "logmvn_cap": MAX_LYA * NUM_LLS,
            "logmvn_chain": MAX_LYA * NUM_LLS, "absorption_all": 0, "absorption_windowed": 0,
            "absorption_all_weideman": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n,
              f"lls unfused: {name} launched {launches.get(name, 0)} != {n}")
    print(f"[8 lls] {lls_line} || voigt_impl=windowed_unfused: launches {launches} "
          f"(absorption_tail 1 per spectrum) | {check_lls(outs, 'lls unfused')} | golden: "
          f"{golden_lls('windowed_unfused')}")

    # 9. the absorber MCMC head on an injected spectrum at full width
    z_dla, log_nhi = 2.82, 21.0
    mspec = synthetic_spectrum(params, arrays, 3.05, seed=11, dlas=[(z_dla, log_nhi)],
                               noise_level=0.05)
    mmodel = build_spectrum_model(learned, to_torch(mspec, device, torch.float32), params)
    mgen = torch.Generator(device=device).manual_seed(2)
    W, steps = DLA_CHAIN
    # walkers start near the absorber (the reference seeds them from the
    # QMC draws; the k = 1 posterior is a needle in a flat landscape)
    pos0 = torch.stack([
        z_dla + 0.01 * torch.randn(W, generator=mgen, device=device),
        log_nhi + 0.3 * torch.randn(W, generator=mgen, device=device),
    ], dim=1)
    t0 = time.perf_counter()
    (chain, lps, acc), launches = count_launches(
        lambda: run_dla_mcmc(mmodel, params, mgen, nwalkers=W, nsamples=steps,
                             initial_positions=pos0))
    dla_s = time.perf_counter() - t0
    path_launches["mcmc_dla"] = launches
    check(launches.get("absorption_tail", 0) == 2 * steps + 1,
          f"mcmc: absorption_tail launched {launches.get('absorption_tail', 0)} != {2 * steps + 1}")
    check(launches.get("absorption_all_weideman", 0) == 0, "mcmc: the Weideman window launched")
    acc = float(acc)
    tail = chain[-steps // 4:].reshape(-1, 2).cpu().numpy()
    med_z, med_n = float(np.median(tail[:, 0])), float(np.median(tail[:, 1]))
    check(bool(torch.isfinite(lps[-1]).all()), "mcmc: non-finite log posterior at the end")
    check(0.05 < acc < 0.95, f"mcmc: acceptance {acc:.3f} outside (0.05, 0.95)")
    check(abs(med_z - z_dla) < 0.01, f"mcmc: median z {med_z:.4f} vs truth {z_dla}")
    dla_rate = W * steps / dla_s

    Wc, steps_c = CIV_CHAIN
    t0 = time.perf_counter()
    (chain_c, lps_c, acc_c), launches_c = count_launches(
        lambda: run_civ_mcmc(mmodel, params, mgen, nwalkers=Wc, nsamples=steps_c))
    civ_s = time.perf_counter() - t0
    path_launches["mcmc_civ"] = launches_c
    check(launches_c.get("absorption_tail", 0) == 2 * steps_c + 1,
          f"civ mcmc: absorption_tail launched {launches_c.get('absorption_tail', 0)}")
    check(launches_c.get("absorption_all_weideman", 0) == 0,
          "civ mcmc: the Weideman window launched")
    check(bool(torch.isfinite(lps_c[-1]).all()), "civ mcmc: non-finite log posterior")
    civ_rate = Wc * steps_c / civ_s
    print(f"[9 mcmc] {card} | DLA {W} walkers x {steps} steps at full width: {dla_s:.2f} s, "
          f"{dla_rate:.1f} posterior evals/s, acceptance {acc:.3f}, tail median z {med_z:.5f} "
          f"(truth {z_dla}), logNHI {med_n:.3f} (truth {log_nhi}), launches {launches} | "
          f"CIV {Wc} walkers x {steps_c} steps: {civ_s:.2f} s, {civ_rate:.1f} posterior "
          f"evals/s, acceptance {float(acc_c):.3f}, launches {launches_c}")

    # 10. timings on the card (kernel vs twin, within this call)
    ms = {
        "absorption_all": (timed_median(lambda: absorption_all(wl, z_s, nhis)),
                           timed_median(lambda: absorption_all_reference(wl, z_s, nhis))),
        "absorption_all_lls": (
            timed_median(lambda: absorption_all(wl_lls, z_lls, nhi_lls, lls_break=True)),
            timed_median(lambda: absorption_all_reference(wl_lls, z_lls, nhi_lls, lls_break=True))),
        "absorption_all_weideman": (
            timed_median(lambda: absorption_all(wl, z_s, nhis, poly=False)),
            timed_median(lambda: absorption_all_reference(wl, z_s, nhis, poly=False))),
        "absorption_windowed": (
            timed_median(lambda: absorption_windowed(parts, nhis[0])),
            timed_median(lambda: absorption_windowed_reference(parts, nhis[0]))),
    }
    parts_ms = timed_median(lambda: windowed_tau_parts(wl, z_s, params.num_lines))
    # K1's device time: 50 back-to-back launches into one output, by CUDA
    # events and by the profiler's kernel time
    nhi_2, nhi_1 = torch.stack(nhis), torch.stack(nhi_lls)
    out_2 = torch.empty((2, S, wl.shape[0] - 6), device=device)
    out_1 = torch.empty((1, z_lls.shape[0], wl_lls.shape[0] - 6), device=device)
    k1_launches = {
        "absorption_all": lambda: launch_absorption_all(wl, z_s, nhi_2, out_2),
        "absorption_all_lls": lambda: launch_absorption_all(wl_lls, z_lls, nhi_1, out_1,
                                                            lls_break=True),
        "absorption_all_weideman": lambda: launch_absorption_all(wl, z_s, nhi_2, out_2,
                                                                 poly=False),
        "absorption_all_weideman_lls": lambda: launch_absorption_all(
            wl_lls, z_lls, nhi_1, out_1, lls_break=True, poly=False),
    }
    k1_device = {name: (events_ms(fn), device_ms(fn)[0]) for name, fn in k1_launches.items()}
    for rows_n, (tau_r, nhi_r) in k5_rows.items():
        ms[f"absorption_tail_{rows_n}"] = (
            timed_median(lambda: absorption_tail(tau_r, nhi_r)),
            timed_median(lambda: absorption_tail_reference(tau_r, nhi_r)))
    ms["absorption_tail"] = ms[f"absorption_tail_{unit_tau.shape[0]}"]
    # K5's device time over 50 launches at each row count (the profiler's
    # kernel time, and the CUDA events' span, which at 16 rows is the
    # wrapper's host time): the MCMC half-step's 16 rows launch 10,001
    # times a DLA chain
    k5_device = {f"absorption_tail_{rows_n}": device_ms(lambda: absorption_tail(tau_r, nhi_r))
                 for rows_n, (tau_r, nhi_r) in k5_rows.items()}
    cap0 = logmvn_cap(rows, model.M, Mp, A)
    for name, extra in (("logmvn_cap", []), ("logmvn_cap_3", extras3)):
        ms[name] = (timed_median(lambda: logmvn_cap(rows, model.M, Mp, A, extra)),
                    timed_median(lambda: logmvn_cap_reference(rows, model.M, Mp, A, extra)))
    ms["logmvn_chain"] = (timed_median(lambda: logmvn_chain(*cap0)),
                          timed_median(lambda: logmvn_chain_reference(*cap0)))
    ms[f"logmvn_chain_k{ODD_K}"] = (timed_median(lambda: logmvn_chain(*cap_odd)),
                                    timed_median(lambda: logmvn_chain_reference(*cap_odd)))
    ms["logmvn_cap_N1664"] = (
        timed_median(lambda: logmvn_cap(rows_lls, lls_model.M, Mp_lls, A_lls)),
        timed_median(lambda: logmvn_cap_reference(rows_lls, lls_model.M, Mp_lls, A_lls)))
    ms["logmvn_chain_N1664"] = (timed_median(lambda: logmvn_chain(*cap_lls)),
                                timed_median(lambda: logmvn_chain_reference(*cap_lls)))
    # K2's library yardstick (on no path): the two float32 products on the
    # twin's w and r, TF32 off (checked in phase 1)
    library = {}
    for name, (r_, M_, Mp_, A_) in (("logmvn_cap", (rows, model.M, Mp, A)),
                                    ("logmvn_cap_N1664", (rows_lls, lls_model.M, Mp_lls, A_lls))):
        _, w_, rr_, *_ = assemble_reference(r_, A_)
        library[name] = timed_median(lambda: (torch.matmul(w_, Mp_), torch.matmul(rr_, M_)))
    # K3's device time (50 back-to-back launches) and its library yardstick
    # (on no path; no single call computes K3's function): the batched
    # Cholesky of the unpacked I + B, then the triangular solve of u
    k3_caps = {"logmvn_chain": cap0, f"logmvn_chain_k{ODD_K}": cap_odd,
               "logmvn_chain_N1664": cap_lls}
    k3_device = {name: device_ms(lambda: logmvn_chain(*c)) for name, c in k3_caps.items()}
    for name in ("logmvn_chain", "logmvn_chain_N1664"):
        B_, u_, _ = k3_caps[name]
        full_, rhs_ = unpack_capacitance(B_, u_.shape[1]), u_[:, :, None].contiguous()
        library[name] = timed_median(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(full_)[0], rhs_, upper=False))
    def rate_of(run, n):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            runs.append(time.perf_counter() - t0)
        return n / statistics.median(runs)

    def slice_rate(batch, voigt_impl):
        return rate_of(lambda: run_slice(batch=batch, voigt_impl=voigt_impl), len(batch))

    rate = slice_rate(spectra, "windowed")
    exact_rate = slice_rate(spectra[:NUM_EXACT], "exact")
    unfused_rate = slice_rate(spectra[:NUM_UNFUSED], "windowed_unfused")
    lls_rate = rate_of(run_lls, NUM_LLS)
    civ_rate = rate_of(run_civ, len(civ_spectra))

    consts = _kernel_constants(params.num_lines)
    work = {
        "absorption_all": k1_work(wl, z_s, 2, consts, min(params.num_lines, FAR_FIELD_LINES)),
        "absorption_tail": k5_work(*unit_tau.shape),
        "absorption_windowed": k6_work(parts),
        "absorption_all_lls": k1_work(wl_lls, z_lls, 1, consts,
                                      min(params.num_lines, FAR_FIELD_LINES), lls_break=True),
        "absorption_all_weideman": k1_work(wl, z_s, 2, consts,
                                           min(params.num_lines, FAR_FIELD_LINES), poly=False),
        "absorption_all_weideman_lls": k1_work(wl_lls, z_lls, 1, consts,
                                               min(params.num_lines, FAR_FIELD_LINES),
                                               lls_break=True, poly=False),
        "logmvn_cap": k2_work(S, A.shape[1], model.M.shape[1], 0),
        "logmvn_chain": k3_work(S, model.M.shape[1]),
        f"logmvn_chain_k{ODD_K}": k3_work(S, ODD_K),
        "logmvn_cap_N1664": k2_work(S, A_lls.shape[1], lls_model.M.shape[1], 0),
        "logmvn_chain_N1664": k3_work(S, lls_model.M.shape[1]),
    }
    bounds = {name: bound(*w) for name, w in work.items()}
    timing = " | ".join(f"{n} {k:.3f} ms vs twin {p:.3f} ms" for n, (k, p) in ms.items())
    timing += "".join(
        f" | {n}: library yardstick {lib:.3f} ms, K2 {work[n][1] / ms[n][0] * 1e-9:.2f} "
        f"TFLOP/s, {bounds[n][0] / ms[n][0]:.1%} of its bound"
        for n, lib in library.items() if n.startswith("logmvn_cap"))
    timing += "".join(
        f" | {n}: device {ev:.4f} ms (CUDA events, 50 launches; profiler {prof:.4f} ms), "
        f"{bounds[n][0] / ev:.1%} of its bound"
        for n, (ev, prof) in k1_device.items())
    timing += "".join(
        f" | {n}: device {dev:.4f} ms (profiler, 50 launches); CUDA events' span {span:.4f} ms "
        f"a launch" for n, (dev, span) in k5_device.items())
    timing += "".join(
        f" | {n}: device {dev:.4f} ms (profiler, 50 launches), {bounds[n][0] / dev:.1%} of its "
        f"bound; CUDA events' span {span:.4f} ms a launch"
        + (f"; library yardstick (cholesky_ex + solve_triangular) {library[n]:.3f} ms"
           if n in library else "")
        for n, (dev, span) in k3_device.items())
    print(f"[10 timing] {card} | median of 10 synchronised calls: {timing} | windowed unit "
          f"tau parts (plain PyTorch) {parts_ms:.3f} ms | bounds "
          + ", ".join(f"{n} {b:.4f} ms ({by})" for n, (b, by) in bounds.items())
          + f" | slice {rate:.2f} spectra/s (median of 3 runs of {NUM_SPECTRA}, after warm-up), "
          f"exact configuration {exact_rate:.2f} spectra/s (median of 3 runs of {NUM_EXACT}), "
          f"unfused configuration {unfused_rate:.2f} spectra/s (median of 3 runs of "
          f"{NUM_UNFUSED}), LLS search {lls_rate:.2f} spectra/s (median of 3 runs of {NUM_LLS}), "
          f"CIV head {civ_rate:.2f} spectra/s (median of 3 runs of {len(civ_spectra)})")

    # 11. the likelihood ablation (K7) through its entry point, at full
    # width: each stage name once, the launches of each counted around it
    ablate = load_script(ABLATE_SCRIPT, "kernel_ablate_torch")
    stage_names = (sorted(ablate.STAGES) + ["decoupled_200", "decoupled_tri_200"]
                   + [f"chain_{v}_2000" for v in sorted(ablate.CHAIN_LAYOUTS)])
    ablation, stage_launches = {}, {}
    for stage in stage_names:
        fn, twin, ins = ablate.stage_runner(stage, device)
        out, stage_launches[stage] = count_launches(lambda: fn(*ins[0]))
        ablation[stage] = (out, twin, ins[0])
    launches = {}
    for counts in stage_launches.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    path_launches["ablation"] = launches
    n_stage = len(ablate.STAGES)
    n_flat = sum(ablate.CHAIN_LAYOUTS[v] != "packed" for v in ablate.CHAIN_LAYOUTS) + 2
    need = {"logmvn_ablate": n_stage, "logmvn_flat_chain": n_flat, "logmvn_cap": 2,
            "logmvn_chain": sum(v == "packed" for v in ablate.CHAIN_LAYOUTS.values()),
            "absorption_all_weideman": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n, f"ablation: {name} launched {launches.get(name, 0)} != {n}")
    rel_errs, abs_errs = {}, {}
    for stage, (out, twin, ins) in ablation.items():
        want = twin(*ins)
        out, want = out[:ablate.S], want[:ablate.S]  # the transposed layout's padding
        rel_errs[stage] = ablate.max_rel_diff(out, want)
        nan = torch.isnan(want)
        abs_errs[stage] = float((out - want)[~nan].abs().max())
        check(rel_errs[stage] <= REL_K7,
              f"ablation {stage}: kernel vs twin {rel_errs[stage]:.3e} of max|value| > {REL_K7}")
    acc, acc_scale = ablate.accuracy(device)
    rows_a, M_a, Mp_a, a_list = ablate.likelihood_inputs(device)
    a0 = a_list[0]
    kernel_rows = []  # (name, ms, plain_ms, (bound, by), launches, library_ms, replaces, err)
    yard = ablate.library_yardsticks(device)
    # the stage kernel is timed on the packed basis: its own time, without
    # the gather of the packed columns that the flat-basis entry makes
    packed_a = packed_pair_basis(M_a)
    for func in ABLATION_FUNCTIONS:
        ms_k = timed_median(lambda: logmvn_ablate_packed(func, rows_a, M_a, packed_a, a0))
        ms_t = timed_median(lambda: logmvn_ablate_reference(func, rows_a, M_a, Mp_a, a0))
        names = [st for st in ablate.STAGES if ablate.STAGES[st] == ablate.STAGES[func]]
        kernel_rows.append((
            f"logmvn_ablate[{func}]", ms_k, ms_t,
            bound(*ablation_work(func, ablate.S, ablate.N, ablate.K)),
            sum(stage_launches[st].get("logmvn_ablate", 0) for st in names),
            next(iter(yard.values())) if func == "matmul" else None,
            f"{ABLATE}:27", max(abs_errs[st] for st in names)))
    for layout, variant in (("row", "row"), ("transposed", "T_full")):
        B_c, u_c, m_c = ablate.chain_inputs(layout, 0, device)
        tr = layout == "transposed"
        names = [f"chain_{v}_2000" for v, lay in ablate.CHAIN_LAYOUTS.items() if lay == layout]
        if layout == "row":
            names += ["decoupled_200", "decoupled_tri_200"]
        kernel_rows.append((
            f"logmvn_flat_chain[{layout}]",
            timed_median(lambda: logmvn_flat_chain(B_c, u_c, m_c, transposed=tr)),
            timed_median(lambda: logmvn_flat_chain_reference(B_c, u_c, m_c, transposed=tr)),
            bound(*flat_chain_work(u_c.shape[1] if tr else u_c.shape[0], ablate.K)),
            sum(stage_launches[st].get("logmvn_flat_chain", 0) for st in names), None,
            f"{ABLATE}:400" if tr else f"{ABLATE}:235",
            max(abs_errs[st] for st in names)))
    # device ms (profiler, 50 launches): each stage beside K2 and K3 on the
    # same inputs, the decoupled split, the flat chain in both layouts, and
    # the flat chain's library yardstick (on no path): cholesky_ex of I + B
    # on its own inputs, then solve_triangular of u
    cap_a = logmvn_cap(rows_a, M_a, packed_a, a0)
    dev = {f"logmvn_ablate[{func}]": device_ms(
        lambda: logmvn_ablate_packed(func, rows_a, M_a, packed_a, a0))[0]
        for func in ABLATION_FUNCTIONS}
    dev["K2"] = device_ms(lambda: logmvn_cap(rows_a, M_a, packed_a, a0))[0]
    dev["K3"] = device_ms(lambda: logmvn_chain(*cap_a))[0]
    dev["decoupled"] = device_ms(lambda: logmvn_decoupled(rows_a, M_a, Mp_a, a0), kernels=2)[0]
    flat_library = {}
    for layout in ("row", "transposed"):
        B_c, u_c, m_c = ablate.chain_inputs(layout, 0, device)
        tr = layout == "transposed"
        name = f"logmvn_flat_chain[{layout}]"
        dev[name] = device_ms(lambda: logmvn_flat_chain(B_c, u_c, m_c, transposed=tr))[0]
        S_c, k_c = (u_c.shape[1], u_c.shape[0]) if tr else u_c.shape
        eye = torch.eye(k_c, device=device)
        full_c = (B_c.T if tr else B_c).reshape(S_c, k_c, k_c) + eye
        rhs_c = (u_c.T if tr else u_c)[:, :, None].contiguous()
        flat_library[name] = timed_median(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(full_c)[0], rhs_c, upper=False))
    kernel_rows = [row[:5] + ((flat_library[row[0]],) if row[0] in flat_library else row[5:6])
                   + row[6:] for row in kernel_rows]
    # the packed product the stage kernel computes from matmul on
    product_ms = bound(0.0, packed_product_work(ablate.S, ablate.N, ablate.K))[0]
    row_extra = {name: {"device_ms": dev[name]} for name, *_ in kernel_rows}
    for func in ("matmul", "full", "chain_nodot"):
        row_extra[f"logmvn_ablate[{func}]"]["packed_product_bound_ms"] = product_ms
    ms_stage = " | ".join(
        f"{name} {k:.3f} ms vs twin {t:.3f} ms (device {dev[name]:.4f} ms), bound {b:.4f} ms "
        f"({by}), launches {n}"
        + (f", library yardstick {lib:.3f} ms" if lib is not None else "")
        for name, k, t, (b, by), n, lib, _, _ in kernel_rows)
    ms_stage += (f" | the packed product w [Mp_packed | M] and its assembly that the stage kernel "
                 f"computes from matmul on (its own work, not matmul's function): bound "
                 f"{product_ms:.4f} ms (operations)")
    el, mm, k2 = (dev["logmvn_ablate[elementwise]"], dev["logmvn_ablate[matmul]"], dev["K2"])
    ms_stage += (f" | device ms (profiler, 50 launches) on the same inputs: K2 {k2:.4f}, K3 "
                 f"{dev['K3']:.4f}, decoupled (K2 flat + flat chain) {dev['decoupled']:.4f}; "
                 f"full {dev['logmvn_ablate[full]']:.4f} vs K2 + K3 run apart "
                 f"{k2 + dev['K3']:.4f} | the shipped K2 by stage differences: staging and "
                 f"assembly (elementwise) {el:.4f}, FMA loop (matmul - elementwise) "
                 f"{mm - el:.4f}, stores (K2 - matmul) {k2 - mm:.4f}")
    print(f"[11 ablation] {card} | S={ablate.S} N={ablate.N} k={ablate.K} via "
          f"{ABLATE_SCRIPT.relative_to(ROOT)} | {len(stage_names)} stages, launches {launches} | "
          f"kernel vs twin max |d|/max|value| "
          + ", ".join(f"{st} {e:.2e}" for st, e in rel_errs.items())
          + f" (tol {REL_K7}) | float64 accuracy (max|ll| {acc_scale:.4g}): "
          + ", ".join(f"{n} median {m:.3e} max {x:.3e}" for n, (m, x) in acc.items())
          + f" (reference budget median {ablate.BUDGET_MEDIAN} max {ablate.BUDGET_MAX}) | "
          f"{ms_stage} | library yardsticks (on no path): "
          + ", ".join(f"{n} {v:.3f} ms" for n, v in yard.items()))

    # 12. the CIV QMC head: per spectrum one K5 (the doublet's tail), one K2
    # and one K3 launch
    outs, launches = count_launches(run_civ)
    path_launches["civ"] = launches
    n_civ = len(civ_spectra)
    need = {"absorption_tail": n_civ, "logmvn_cap": n_civ, "logmvn_chain": n_civ,
            "absorption_all": 0, "absorption_windowed": 0, "absorption_all_weideman": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n, f"civ: {name} launched {launches.get(name, 0)} != {n}")
    worst_rel, worst_dp, p_clean, p_inj = 0.0, 0.0, [0.0], [1.0]
    for i, ((p, null_ev, civ_ev), inj) in enumerate(zip(outs, civ_injected)):
        check(np.isfinite(null_ev) and np.isfinite(civ_ev), "civ: non-finite evidence")
        if inj:
            check(p > 0.9, f"civ: injected doublet missed: p_civ {p:.4f}")
            p_inj.append(p)
        else:
            check(p < 0.1, f"civ: clean spectrum p_civ {p:.4f} >= 0.1")
            p_clean.append(p)
        want = np.array([gc["log_evidence_null"][i], gc["log_evidence_civ"][i]])
        rel = float(np.max(np.abs(np.array([null_ev, civ_ev]) - want)) / np.max(np.abs(want)))
        dp = abs(p - float(gc["p_civ"][i]))
        worst_rel, worst_dp = max(worst_rel, rel), max(worst_dp, dp)
        check(rel <= REL_GOLDEN_EVIDENCE, f"golden civ {i}: log evidence rel {rel:.3e}")
        check(dp <= ABS_GOLDEN_P_DLA, f"golden civ {i}: |dp_civ| {dp:.3e}")
        check((p > 0.5) == (float(gc["p_civ"][i]) > 0.5), f"golden civ {i}: argmax model differs")
        check(civ_model_posterior(null_ev, civ_ev) == p, f"civ {i}: posterior mismatch")
    print(f"[12 civ] {n_civ} spectra at S={civ_params.num_civ_samples} N="
          f"{civ_params.num_pixels_padded} k={civ_params.k} | launches {launches} | clean max "
          f"p_civ {max(p_clean):.3e} | injected min p_civ {min(p_inj):.6f} | golden: {n_civ} "
          f"spectra vs JAX float64 at full width | log evidence max rel {worst_rel:.3e} (tol "
          f"{REL_GOLDEN_EVIDENCE}) | max |dp_civ| {worst_dp:.3e} (tol {ABS_GOLDEN_P_DLA}) | "
          f"argmax models equal")

    # 13. the Weideman-window configuration: one K1 launch (poly=False, both
    # families) a spectrum; then the LLS search in it, one a spectrum
    results, launches = count_launches(
        lambda: run_slice(batch=spectra[:NUM_WEIDEMAN], voigt_impl="windowed_weideman"))
    path_launches["windowed_weideman"] = launches
    need = {"absorption_all_weideman": NUM_WEIDEMAN, "absorption_all": 0,
            "logmvn_cap": 5 * NUM_WEIDEMAN, "logmvn_chain": 5 * NUM_WEIDEMAN,
            "absorption_tail": 0, "absorption_windowed": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n,
              f"weideman: {name} launched {launches.get(name, 0)} != {n}")
    weideman_line = (f"{NUM_WEIDEMAN} spectra, voigt_impl=windowed_weideman | launches "
                     f"{launches} | {check_detections(results, truths[:NUM_WEIDEMAN], 'weideman')}"
                     f" | golden: {golden_parity('windowed_weideman')}")
    outs, launches = count_launches(lambda: run_lls(voigt_impl="windowed_weideman"))
    path_launches["lls_weideman"] = launches
    need = {"absorption_all_weideman": NUM_LLS, "absorption_all": 0,
            "logmvn_cap": MAX_LYA * NUM_LLS, "logmvn_chain": MAX_LYA * NUM_LLS,
            "absorption_tail": 0, "absorption_windowed": 0}
    for name, n in need.items():
        check(launches.get(name, 0) == n,
              f"lls weideman: {name} launched {launches.get(name, 0)} != {n}")
    print(f"[13 weideman] {weideman_line} || LLS search, {NUM_LLS} spectra: launches "
          f"{launches} | {check_lls(outs, 'lls weideman')} | golden: "
          f"{golden_lls('windowed_weideman')}")

    # 14. compact profile storage: the int16 instantiations against their
    # twins by codes, then every catalog configuration and the LLS search in
    # int16, then the int16 kernels' times beside the float32 ones'
    i16 = torch.int16

    def dcode(got, want):
        """max |dcode| and the share of codes that differ."""
        d = (got.int() - want.int()).abs()
        return int(d.max()), float((d > 0).float().mean())

    def check_codes(got, want, label):
        check(got.dtype == want.dtype == i16, f"{label}: not int16 codes")
        m, share = dcode(got, want)
        check(m <= MAX_DCODE, f"{label}: max |dcode| {m} > {MAX_DCODE}")
        return m, share

    codes_err, codes_share = {}, {}

    def note_codes(name, m, share):
        codes_err[name] = max(codes_err.get(name, 0), m)
        codes_share[name] = max(codes_share.get(name, 0.0), share)

    k1_16 = absorption_all(wl, z_s, nhis, out_dtype=i16)
    for fam, (g16, w16) in enumerate(zip(k1_16, absorption_all_reference(wl, z_s, nhis,
                                                                         out_dtype=i16))):
        note_codes("absorption_all_i16", *check_codes(g16, w16, f"K1 int16 family {fam}"))
    (A_lls16,) = absorption_all(wl_lls, z_lls, nhi_lls, lls_break=True, out_dtype=i16)
    note_codes("absorption_all_i16", *check_codes(
        A_lls16, absorption_all_reference(wl_lls, z_lls, nhi_lls, lls_break=True,
                                          out_dtype=i16)[0], "K1 int16 with the break"))
    for wl_, z_, nh_, lb in ((wl, z_s, nhis, False), (wl_lls, z_lls, nhi_lls, True)):
        for g16, w16 in zip(absorption_all(wl_, z_, nh_, lls_break=lb, poly=False, out_dtype=i16),
                            absorption_all_reference(wl_, z_, nh_, lls_break=lb, poly=False,
                                                     out_dtype=i16)):
            note_codes("absorption_all_weideman_i16",
                       *check_codes(g16, w16, f"K1 Weideman int16 (break {lb})"))
    for rows_n, (tau_r, nhi_r) in k5_rows.items():
        note_codes("absorption_tail_i16", *check_codes(
            absorption_tail(tau_r, nhi_r, i16), absorption_tail_reference(tau_r, nhi_r, i16),
            f"K5 int16 ({rows_n} rows)"))
    for n in nhis:
        note_codes("absorption_windowed_i16", *check_codes(
            absorption_windowed(parts, n, i16), absorption_windowed_reference(parts, n, i16),
            "K6 int16"))
    # K2 on K1's codes, chained streams gathered as codes; against its twin
    # on the same codes and against K2 fed them decoded to float32
    A16 = k1_16[0]
    extras16 = [A16[i] for i in idx3]
    dec = lambda c: decode_profile_store(c, torch.float32)
    k2_16, k2_16_bitwise = [], []
    for label, (r_, M_, Mp_, a_, ex_) in (
            ("0 streams", (rows, model.M, Mp, A16, [])),
            ("3 streams", (rows, model.M, Mp, A16, extras16)),
            ("N=1664", (rows_lls, lls_model.M, Mp_lls, A_lls16, []))):
        cap16 = logmvn_cap(r_, M_, Mp_, a_, ex_)
        ll_ref16 = logmvn_chain_reference(*logmvn_cap_reference(r_, M_, Mp_, a_, ex_))
        scale16 = float(ll_ref16.abs().max())
        e16 = float((logmvn_chain_reference(*cap16) - ll_ref16).abs().max())
        check(e16 <= REL_K23 * scale16, f"K2 int16 ({label}) |dll| {e16:.3e} > {REL_K23} x "
                                        f"{scale16:.4g}")
        cap32 = logmvn_cap(r_, M_, Mp_, dec(a_), [dec(e) for e in ex_])
        e32 = float((logmvn_chain_reference(*cap16) - logmvn_chain_reference(*cap32)).abs().max())
        check(e32 <= REL_K23 * scale16, f"K2 int16 ({label}) vs float32 on the decoded codes "
                                        f"{e32:.3e}")
        k2_16.append((label, e16, scale16, e32))
        k2_16_bitwise.append(all(torch.equal(x, y) for x, y in zip(cap16, cap32)))
    torch.cuda.synchronize()
    err["logmvn_cap_i16"] = max(e for _, e, _, _ in k2_16)
    for name in codes_err:
        err[name] = codes_err[name] / 32767.0  # in absorption: a code is 1/32767
    print(f"[14 int16 parity] max |dcode| (share of codes that differ) vs twin: "
          + ", ".join(f"{n} {codes_err[n]} ({codes_share[n]:.2e})" for n in codes_err)
          + f" (tol {MAX_DCODE}) | K2 int16 |dll| vs twin / vs K2 on the decoded codes: "
          + ", ".join(f"{lab} {e:.3e} / {e32:.3e} (max|ll| {sc:.4g})" for lab, e, sc, e32 in k2_16)
          + f" (tol {REL_K23} x max|ll|); bitwise equal to K2 on the decoded codes: "
          + ", ".join(f"{lab} {b}" for (lab, *_), b in zip(k2_16, k2_16_bitwise)))

    # the catalog configurations and the LLS search in int16: only the int16
    # instantiations launch
    gi = np.load(GOLDEN_I16)
    check(np.array_equal(gi["z_qso"], g["z_qso"]) and np.array_equal(gi["obs_seed"], g["obs_seed"]),
          "the int16 fixture's spectra are not the float64 fixture's")
    profile_kernels = {"windowed": "absorption_all_i16",
                       "windowed_weideman": "absorption_all_weideman_i16",
                       "exact": "absorption_tail_i16", "windowed_unfused": "absorption_windowed_i16"}
    i16_lines = []
    for impl, kname in profile_kernels.items():
        results, launches = count_launches(
            lambda: run_slice(batch=spectra[:NUM_I16], voigt_impl=impl, abs_dtype=i16), int16=True)
        path_launches[f"{impl}_i16"] = launches
        per_spectrum = 1 if kname.startswith("absorption_all") else 2
        need = {kname: per_spectrum * NUM_I16, "logmvn_cap_i16": 5 * NUM_I16,
                "logmvn_chain": 5 * NUM_I16}
        for name, n in need.items():
            check(launches.get(name, 0) == n,
                  f"{impl} int16: {name} launched {launches.get(name, 0)} != {n}")
        others = {n: c for n, c in launches.items() if n not in need}
        check(not others, f"{impl} int16: other kernels launched {others}")
        i16_lines.append(
            f"{impl}: launches {launches} | "
            f"{check_detections(results, truths[:NUM_I16], f'{impl} int16')} | golden vs JAX "
            f"float64 int16: {golden_parity(impl, i16, gi)}")
    outs, launches = count_launches(lambda: run_lls(batch=lls_spectra[:NUM_I16], abs_dtype=i16),
                                    int16=True)
    path_launches["lls_i16"] = launches
    need = {"absorption_all_i16": NUM_I16, "logmvn_cap_i16": MAX_LYA * NUM_I16,
            "logmvn_chain": MAX_LYA * NUM_I16}
    for name, n in need.items():
        check(launches.get(name, 0) == n, f"lls int16: {name} launched {launches.get(name, 0)} != {n}")
    others = {n: c for n, c in launches.items() if n not in need}
    check(not others, f"lls int16: other kernels launched {others}")
    i16_lines.append(f"LLS search: launches {launches} | {check_lls(outs, 'lls int16')} | golden "
                     f"vs JAX float64 (float64 storage): {golden_lls('windowed', i16)}")
    print(f"[14 int16 paths] {NUM_I16} spectra each, abs_dtype=torch.int16 || "
          + " || ".join(i16_lines))

    # times: each int16 kernel beside its float32 instantiation, in turns
    # (f32, i16, i16, f32), device ms by CUDA events over 50 launches (K2
    # by the profiler; K5 and K6 in phase 15); host-synchronised medians as
    # in phase 10
    def turns(fn32, fn16, timer):
        a, b, c, d = timer(fn32), timer(fn16), timer(fn16), timer(fn32)
        return (a + d) / 2, (b + c) / 2

    profiler_ms = lambda fn: device_ms(fn)[0]
    out_2_16 = torch.empty((2, S, wl.shape[0] - 6), dtype=i16, device=device)
    out_1_16 = torch.empty((1, z_lls.shape[0], wl_lls.shape[0] - 6), dtype=i16, device=device)
    dev_pairs = {
        "absorption_all_i16": turns(
            lambda: launch_absorption_all(wl, z_s, nhi_2, out_2),
            lambda: launch_absorption_all(wl, z_s, nhi_2, out_2_16), events_ms),
        "absorption_all_i16_lls": turns(
            lambda: launch_absorption_all(wl_lls, z_lls, nhi_1, out_1, lls_break=True),
            lambda: launch_absorption_all(wl_lls, z_lls, nhi_1, out_1_16, lls_break=True),
            events_ms),
        "absorption_all_weideman_i16": turns(
            lambda: launch_absorption_all(wl, z_s, nhi_2, out_2, poly=False),
            lambda: launch_absorption_all(wl, z_s, nhi_2, out_2_16, poly=False), events_ms),
    }
    for name, (r_, M_, Mp_, a32, ex32, a16, ex16) in (
            ("logmvn_cap_i16", (rows, model.M, Mp, A, [], A16, [])),
            ("logmvn_cap_i16_3", (rows, model.M, Mp, A, extras3, A16, extras16)),
            ("logmvn_cap_i16_N1664", (rows_lls, lls_model.M, Mp_lls, A_lls, [], A_lls16, []))):
        dev_pairs[name] = turns(lambda: logmvn_cap(r_, M_, Mp_, a32, ex32),
                                lambda: logmvn_cap(r_, M_, Mp_, a16, ex16), profiler_ms)
    # the chained-row gather of a DLA level: one (S, N) row gather by the
    # resampled indices
    dev_pairs["gather"] = turns(lambda: A[idx3[0]], lambda: A16[idx3[0]], events_ms)
    # host-synchronised medians, kernel and twin (the table's card ms)
    ms.update({
        "absorption_all_i16": (
            timed_median(lambda: absorption_all(wl, z_s, nhis, out_dtype=i16)),
            timed_median(lambda: absorption_all_reference(wl, z_s, nhis, out_dtype=i16))),
        "absorption_all_weideman_i16": (
            timed_median(lambda: absorption_all(wl, z_s, nhis, poly=False, out_dtype=i16)),
            timed_median(lambda: absorption_all_reference(wl, z_s, nhis, poly=False,
                                                          out_dtype=i16))),
        "absorption_tail_i16": (
            timed_median(lambda: absorption_tail(*k5_rows[S], i16)),
            timed_median(lambda: absorption_tail_reference(*k5_rows[S], i16))),
        "absorption_windowed_i16": (
            timed_median(lambda: absorption_windowed(parts, nhis[0], i16)),
            timed_median(lambda: absorption_windowed_reference(parts, nhis[0], i16))),
        "logmvn_cap_i16": (
            timed_median(lambda: logmvn_cap(rows, model.M, Mp, A16, [])),
            timed_median(lambda: logmvn_cap_reference(rows, model.M, Mp, A16, []))),
    })
    # K2's library yardstick on the codes: the two float32 products on the
    # twin's w and r from the decoded codes (on no path)
    _, w16_, r16_, *_ = assemble_reference(rows, A16)
    library["logmvn_cap_i16"] = timed_median(lambda: (torch.matmul(w16_, Mp),
                                                      torch.matmul(r16_, model.M)))
    work.update({
        "absorption_all_i16": k1_work(wl, z_s, 2, consts, min(params.num_lines, FAR_FIELD_LINES),
                                      elem=2),
        "absorption_all_i16_lls": k1_work(wl_lls, z_lls, 1, consts,
                                          min(params.num_lines, FAR_FIELD_LINES),
                                          lls_break=True, elem=2),
        "absorption_all_weideman_i16": k1_work(wl, z_s, 2, consts,
                                               min(params.num_lines, FAR_FIELD_LINES),
                                               poly=False, elem=2),
        "absorption_tail_i16": k5_work(*unit_tau.shape, elem=2),
        "absorption_windowed_i16": k6_work(parts, elem=2),
        "logmvn_cap_i16": k2_work(S, A.shape[1], model.M.shape[1], 0, elem=2),
        "logmvn_cap_i16_3": k2_work(S, A.shape[1], model.M.shape[1], 3, elem=2),
        "logmvn_cap_i16_N1664": k2_work(S, A_lls.shape[1], lls_model.M.shape[1], 0, elem=2),
        "logmvn_cap_3": k2_work(S, A.shape[1], model.M.shape[1], 3),
    })
    bounds = {name: bound(*w) for name, w in work.items()}

    # the default slice of 16 spectra in each storage: device kernel time
    # (profiler), peak device memory of one batch, spectra/s
    def slice_device(abs_dtype):
        run_slice(abs_dtype=abs_dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_slice(abs_dtype=abs_dtype)
            torch.cuda.synchronize()
        kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type != torch.autograd.DeviceType.CPU)
        return kernel_us / 1e3, (torch.cuda.max_memory_allocated(device) - base_mem) / 2**20

    slice_dev = {}
    for key in ("f32", "i16", "i16", "f32"):
        d_ms, mem = slice_device(None if key == "f32" else i16)
        slice_dev.setdefault(key, []).append((d_ms, mem))
    rates = {"f32": slice_rate(spectra, "windowed")}
    rates["i16"] = rate_of(lambda: run_slice(abs_dtype=i16), NUM_SPECTRA)
    rates["f32_again"] = slice_rate(spectra, "windowed")
    A_bytes = lambda t: t.numel() * t.element_size() / 2**20
    print(f"[14 int16 timing] {card} | device ms float32 -> int16 (CUDA events over 50 launches, "
          f"in turns f32, i16, i16, f32; K2 by the profiler; K5 and K6 in phase 15): "
          + ", ".join(f"{n} {a:.4f} -> {b:.4f}" for n, (a, b) in dev_pairs.items())
          + " | bounds at int16 bytes: "
          + ", ".join(f"{n} {bounds[n][0]:.4f} ms ({bounds[n][1]})"
                      for n in dev_pairs if n in bounds)
          + " | median of 10 synchronised calls, kernel vs twin: "
          + ", ".join(f"{n} {ms[n][0]:.3f} vs {ms[n][1]:.3f} ms" for n in KERNELS_I16)
          + f" | K2 int16 library yardstick {library['logmvn_cap_i16']:.3f} ms | default slice, "
          f"{NUM_SPECTRA} spectra: device kernel ms (profiler) f32 "
          + " / ".join(f"{d:.2f}" for d, _ in slice_dev["f32"]) + ", int16 "
          + " / ".join(f"{d:.2f}" for d, _ in slice_dev["i16"]) + "; peak memory above the "
          f"inputs, MiB: f32 " + " / ".join(f"{m:.1f}" for _, m in slice_dev["f32"])
          + ", int16 " + " / ".join(f"{m:.1f}" for _, m in slice_dev["i16"])
          + f"; profile arrays a spectrum (A of both families + 3 gathered streams): f32 "
          f"{5 * A_bytes(A):.1f} MiB, int16 {5 * A_bytes(A16):.1f} MiB | spectra/s (median of 3 "
          f"runs of {NUM_SPECTRA}): f32 {rates['f32']:.2f} / {rates['f32_again']:.2f}, int16 "
          f"{rates['i16']:.2f}")

    # 15. K5 and K6 (the streaming tail, csrc/absorption_stencil.cuh) at
    # every shape the paths give them, against their twins in both
    # storages; then their device ms beside the bound and the copy rate
    # measured here
    wl_civ = wl[:CIV_PIXELS].contiguous()  # the CIV head's row width
    tail_units = {P_: u for P_, u in (
        (wl.shape[0], unit_tau),
        (wl_lls.shape[0], unit_lyman_optical_depth(wl_lls, z_lls, params.num_lines)),
        (CIV_PIXELS, unit_lyman_optical_depth(wl_civ, z_s, params.num_lines)))}
    tail_nhi = {wl.shape[0]: nhis[0], wl_lls.shape[0]: nhi_lls[0], CIV_PIXELS: nhis[0]}
    tail_err, tail_codes, tail_cases = 0.0, 0, 0

    def tail_check(got32, want32, got16, want16, label):
        e = float((got32 - want32).abs().max())
        check(e <= TOL_K5, f"{label} vs twin {e:.3e} > {TOL_K5}")
        m, _ = check_codes(got16, want16, f"{label} int16")
        return e, m

    for P_, unit_ in tail_units.items():
        for rows_n in TAIL_ROWS:
            u_, n_ = unit_[:rows_n].contiguous(), tail_nhi[P_][:rows_n].contiguous()
            e, m = tail_check(absorption_tail(u_, n_), absorption_tail_reference(u_, n_),
                              absorption_tail(u_, n_, i16), absorption_tail_reference(u_, n_, i16),
                              f"K5 {rows_n}x{P_}")
            tail_err, tail_codes, tail_cases = max(tail_err, e), max(tail_codes, m), tail_cases + 1
    # K6: the main path's parts (L = 3), 8 lines (overlapping windows), and
    # redshifts at the grid's red end (windows clipped at the row's P)
    red = float(wl[-1]) / 1215.67 - 1.0
    z_red = red - 0.05 + 0.07 * torch.rand(S, generator=gen, device=device)
    k6_parts = {"L=3": parts, "L=8": windowed_tau_parts(wl, z_s, 8),
                "red end": windowed_tau_parts(wl, z_red, params.num_lines)}
    nc_pad = parts.far.shape[1] // 128
    clipped = int((k6_parts["red end"].c0 == nc_pad - 2).any(dim=1).sum())
    check(clipped > 0, "K6: no window reached the last chunk pair")
    k6_err, k6_codes = 0.0, 0
    for label, pt in k6_parts.items():
        for rows_n in TAIL_ROWS:
            sub = type(pt)(pt.far[:rows_n].contiguous(), pt.corr[:rows_n].contiguous(),
                           pt.c0[:rows_n].contiguous(), pt.num_pixels)
            n_ = nhis[0][:rows_n].contiguous()
            e, m = tail_check(absorption_windowed(sub, n_), absorption_windowed_reference(sub, n_),
                              absorption_windowed(sub, n_, i16),
                              absorption_windowed_reference(sub, n_, i16),
                              f"K6 {label} {rows_n}x{pt.num_pixels}")
            k6_err, k6_codes, tail_cases = max(k6_err, e), max(k6_codes, m), tail_cases + 1
    err["absorption_tail"] = max(err["absorption_tail"], tail_err)
    err["absorption_windowed"] = max(err["absorption_windowed"], k6_err)
    note_codes("absorption_tail_i16", tail_codes, codes_share.get("absorption_tail_i16", 0.0))
    note_codes("absorption_windowed_i16", k6_codes,
               codes_share.get("absorption_windowed_i16", 0.0))
    for name in ("absorption_tail_i16", "absorption_windowed_i16"):
        err[name] = codes_err[name] / 32767.0
    # the copy rate here: a 1 GiB device-to-device copy, read and written
    copy_src = torch.empty(2**28, device=device)
    copy_dst = torch.empty_like(copy_src)
    copy_gbs = 2 * copy_src.numel() * 4 / (events_ms(lambda: copy_dst.copy_(copy_src), 20)
                                          * 1e-3) / 1e9
    del copy_src, copy_dst
    # device ms by the profiler over 50 calls (the wrapper's host time is
    # longer than the 16-row kernel), each int16 instantiation beside the
    # float32 one in turns (f32, i16, i16, f32), as phase 14 times the others
    tail_pairs = {
        "absorption_tail": lambda dt=None: absorption_tail(*k5_rows[S], dt),
        "absorption_tail_16": lambda dt=None: absorption_tail(*k5_rows[DLA_CHAIN[0] // 2], dt),
        "absorption_windowed": lambda dt=None: absorption_windowed(parts, nhis[0], dt),
    }
    tail_dev = {}
    for n, fn in tail_pairs.items():
        tail_dev[n], tail_dev[f"{n}_i16"] = turns(fn, lambda: fn(i16), profiler_ms)
    for n in ("absorption_tail", "absorption_windowed"):
        dev_pairs[f"{n}_i16"] = (tail_dev[n], tail_dev[f"{n}_i16"])
    tail_dev["absorption_tail_1670"] = profiler_ms(
        lambda: absorption_tail(tail_units[wl_lls.shape[0]], nhi_lls[0]))
    tail_dev["absorption_tail_774"] = profiler_ms(
        lambda: absorption_tail(tail_units[CIV_PIXELS], nhis[0]))
    rows16 = DLA_CHAIN[0] // 2
    tail_work = {
        "absorption_tail": k5_work(*unit_tau.shape),
        "absorption_tail_i16": k5_work(*unit_tau.shape, elem=2),
        "absorption_tail_16": k5_work(rows16, unit_tau.shape[1]),
        "absorption_tail_16_i16": k5_work(rows16, unit_tau.shape[1], elem=2),
        "absorption_tail_1670": k5_work(S, wl_lls.shape[0]),
        "absorption_tail_774": k5_work(S, CIV_PIXELS),
        "absorption_windowed": k6_work(parts),
        "absorption_windowed_i16": k6_work(parts, elem=2),
    }
    tail_bound = {n: bound(*w) for n, w in tail_work.items()}
    k6_old = {n: bound(*k6_work_padded(parts, elem=e))[0]
              for n, e in (("absorption_windowed", 4), ("absorption_windowed_i16", 2))}
    tail_share = {n: (tail_bound[n][0] / d, tail_work[n][0] / (d * 1e-3) / 1e9 / copy_gbs)
                  for n, d in tail_dev.items()}
    print(f"[15 tail] {card} | K5 and K6 vs twins in {tail_cases} cases (rows "
          f"{', '.join(map(str, TAIL_ROWS))}; K5 at P = {', '.join(map(str, tail_units))}; K6 at "
          f"{S}x{parts.far.shape[1]} padded, P = {wl.shape[0]}, L = 3 and 8, and with windows "
          f"clipped at the row's end in {clipped} rows): float32 max|d| K5 {tail_err:.3e}, K6 "
          f"{k6_err:.3e} (tol {TOL_K5}); int16 max |dcode| K5 {tail_codes}, K6 {k6_codes} (tol "
          f"{MAX_DCODE}) | copy rate here {copy_gbs:.1f} GB/s (1 GiB device copy, CUDA events) | "
          f"device ms (profiler, 50 calls), share of the bound, share of the copy rate: "
          + ", ".join(f"{n} {d:.4f} ({tail_share[n][0]:.1%} of {tail_bound[n][0]:.4f} ms, "
                      f"{tail_share[n][1]:.1%} of the copy rate)" for n, d in tail_dev.items())
          + " | K6 bound by the padded count: "
          + ", ".join(f"{n} {b:.4f} ms" for n, b in k6_old.items()))

    # 16. wide GP bases through the kernels: K2 in column slices (k = 54
    # and 65, one past one block and one past K3's row bounds) and K3's wide
    # chain (k = 65), on the construction the reference's float32 budget is
    # held on in tests/test_torch_kernels_gpu.py (seeded, N = 1,280, 3
    # chained streams): the path's counts, each kernel against its twin, the
    # likelihood against the CPU float64 value of its first WIDE_F64
    # samples within the budget as it stands (no scaling)
    def wide_problem(k):
        rng = np.random.default_rng(k)
        n_ = 1280
        M_ = (rng.normal(size=(n_, k)) / np.sqrt(k) * 0.1).astype(np.float32)
        y_ = (1 + 0.1 * rng.normal(size=n_)).astype(np.float32)
        mu_ = np.ones(n_, np.float32)
        om_ = rng.uniform(0.01, 0.05, n_).astype(np.float32)
        v_ = rng.uniform(0.02, 0.1, n_).astype(np.float32)
        mask_ = rng.uniform(size=n_) > 0.1
        A_ = np.exp(-rng.random((S, n_))).astype(np.float32)
        ex_ = [np.exp(-0.3 * rng.random((S, n_))).astype(np.float32) for _ in range(3)]
        put = lambda x: torch.as_tensor(x, device=device)
        return [put(x) for x in (y_, mu_, M_, om_, v_, mask_)], put(A_), [put(e) for e in ex_]

    wide = {k_: wide_problem(k_) for k_ in WIDE_KS}
    lls_wide, launches = count_launches(
        lambda: {k_: batched_log_mvnpdf(*b_, a_, extra=e_) for k_, (b_, a_, e_) in wide.items()})
    path_launches["wide_basis"] = launches
    need = {"logmvn_cap": len(WIDE_KS), "logmvn_chain": sum(k_ <= 64 for k_ in WIDE_KS),
            "logmvn_chain_wide": sum(k_ > 64 for k_ in WIDE_KS)}
    check(launches == need, f"wide bases: launches {launches} != {need}")
    cpu64 = lambda x: x.cpu().double() if x.is_floating_point() else x.cpu()
    wide_f64, wide_twin, wide_dev, wide_lib = {}, {}, {}, {}
    for k_, (b_, a_, e_) in wide.items():
        ll_ = lls_wide[k_]
        check(bool(torch.isfinite(ll_).all()), f"k={k_}: non-finite likelihood")
        ll64_ = batched_log_mvnpdf(*[cpu64(x) for x in b_], cpu64(a_[:WIDE_F64]),
                                   extra=[cpu64(e[:WIDE_F64]) for e in e_])
        d_ = (ll_[:WIDE_F64].cpu().double() - ll64_).abs()
        wide_f64[k_] = (float(d_.median()), float(d_.max()), float(ll64_.abs().max()))
        check(wide_f64[k_][0] <= MEDIAN_VS_F64 and wide_f64[k_][1] <= MAX_VS_F64,
              f"k={k_} vs float64: median |dll| {wide_f64[k_][0]:.3e} (budget "
              f"{MEDIAN_VS_F64}), max {wide_f64[k_][1]:.3e} (budget {MAX_VS_F64})")
        # each kernel against its twin: K2 through the twin chain, K3 on the
        # twin's products
        r_ = torch.stack([b_[0], b_[1], b_[3], b_[4], b_[5].float()])
        M_ = b_[2]
        Mp_ = packed_pair_basis(M_)
        cap_t = logmvn_cap_reference(r_, M_, Mp_, a_, e_)
        ll_t = logmvn_chain_reference(*cap_t)
        scale_ = float(ll_t.abs().max())
        cap_k = logmvn_cap(r_, M_, Mp_, a_, e_)
        e2 = float((logmvn_chain_reference(*cap_k) - ll_t).abs().max())
        e3 = float((logmvn_chain(*cap_t) - ll_t).abs().max())
        check(e2 <= REL_K23 * scale_ and e3 <= REL_K23 * scale_,
              f"k={k_}: K2 |dll| {e2:.3e}, K3 |dll| {e3:.3e} > {REL_K23} x {scale_:.4g}")
        err["logmvn_cap"] = max(err["logmvn_cap"], e2)
        chain_name = "logmvn_chain_wide" if k_ > 64 else "logmvn_chain"
        err[chain_name] = max(err.get(chain_name, 0.0), e3)
        wide_twin[k_] = (e2 / scale_, e3 / scale_)
        wide_dev[f"K2 k={k_}"] = (device_ms(lambda: logmvn_cap(r_, M_, Mp_, a_, e_))[0],
                                  bound(*k2_work(S, M_.shape[0], k_, 3))[0])
        # K2's library yardstick at this width: the two float32 products on
        # the twin's w and r, TF32 off
        _, w_, rr_, *_ = assemble_reference(r_, a_, e_)
        wide_lib[k_] = timed_median(lambda: (torch.matmul(w_, Mp_), torch.matmul(rr_, M_)))
        if k_ > 64:
            # the wide chain's row of the kernels line
            name = "logmvn_chain_wide"
            ms[name] = (timed_median(lambda: logmvn_chain(*cap_t)),
                        timed_median(lambda: logmvn_chain_reference(*cap_t)))
            bounds[name] = bound(*k3_work(S, k_))
            full_, rhs_ = unpack_capacitance(cap_t[0], k_), cap_t[1][:, :, None].contiguous()
            library[name] = timed_median(lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(full_)[0], rhs_, upper=False))
            k3_device[name] = device_ms(lambda: logmvn_chain(*cap_t))
            wide_dev[f"K3 wide k={k_}"] = (k3_device[name][0], bounds[name][0])
    print(f"[16 wide bases] S={S} N=1280, 3 chained streams, k = "
          f"{', '.join(map(str, WIDE_KS))}: launches {launches} (K2 in column slices, K3's warp "
          f"chain at k <= 64 and its wide chain beyond; no composition) | vs CPU float64 (first "
          f"{WIDE_F64} samples; budget median {MEDIAN_VS_F64}, max {MAX_VS_F64}): "
          + ", ".join(f"k={k_} median |dll| {m_:.3e}, max {x_:.3e} (max|ll| {sc_:.4g})"
                      for k_, (m_, x_, sc_) in wide_f64.items())
          + f" | kernel vs twin, |dll| / max|ll| (tol {REL_K23}): "
          + ", ".join(f"k={k_} K2 {a_:.2e}, K3 {b_:.2e}" for k_, (a_, b_) in wide_twin.items())
          + " | device ms (profiler, 50 calls) and bound: "
          + ", ".join(f"{n} {d:.4f} (bound {b:.4f})" for n, (d, b) in wide_dev.items())
          + " | K2 library yardstick (two float32 SGEMMs, TF32 off, synchronised median): "
          + ", ".join(f"k={k_} {t_:.3f} ms" for k_, t_ in wide_lib.items())
          + f" | wide chain {ms['logmvn_chain_wide'][0]:.3f} ms vs twin "
          f"{ms['logmvn_chain_wide'][1]:.3f} ms, library yardstick "
          f"{library['logmvn_chain_wide']:.3f} ms | every phase took the kernels (no composition)")

    # 17. the CLIs through their run(), on FITS files written
    # here; their own per-spectrum prints are kept out of this output
    from gpy_dla_detection_tpu_torch import run_bayes_select, run_find_lls
    from gpy_dla_detection_tpu_torch import run_civ as civ_cli
    from gpy_dla_detection_tpu_torch.catalog_io import results_to_arrays
    from gpy_dla_detection_tpu_torch.data.fits import read_spec
    from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        civ_doublet_transmission,
        synthetic_observation,
    )
    from gpy_dla_detection_tpu_torch.parallel.batch import device_put_inputs, dispatch_batch
    from gpy_dla_detection_tpu_torch.utils.metrics import read_metrics

    def quiet(fn):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    per_sample = ("sample_log_likelihoods_dla", "sample_log_likelihoods_lls", "base_sample_inds")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        work = Path(work)
        z_cli = [float(z) for z in np.linspace(2.6, 3.4, NUM_CLI)]
        truths_cli = [(z - 0.3, 21.2) if i % 2 else None for i, z in enumerate(z_cli)]
        files = [
            write_speclite(work / f"spec-0001-55555-{i:04d}.fits", *synthetic_observation(
                params, arrays, z, seed=1000 + i, dlas=None if tr is None else [tr]))
            for i, (z, tr) in enumerate(zip(z_cli, truths_cli))
        ]
        out_full = work / "catalog.h5"

        def cli_argv(output, *extra):
            return ["--qso_list", *files, "--z_qso_list", *map(repr, z_cli), "--max_dlas",
                    str(MAX_DLAS), "--batch-size", str(CLI_BATCH), "--inflight", "3",
                    "--output", str(output), *extra]

        def run_cli(*args):
            return quiet(lambda: run_bayes_select.run(cli_argv(*args)))

        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_cli = time.perf_counter()
        cat, launches = count_launches(lambda: run_cli(out_full, "--checkpoint"))
        cli_s = time.perf_counter() - t_cli
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        path_launches["cli_catalog"] = launches
        need = {"absorption_all": NUM_CLI, "logmvn_cap": 5 * NUM_CLI,
                "logmvn_chain": 5 * NUM_CLI, "absorption_all_weideman": 0,
                "absorption_tail": 0, "absorption_windowed": 0}
        for name, n in need.items():
            check(launches.get(name, 0) == n,
                  f"catalog CLI: {name} launched {launches.get(name, 0)} != {n}")
        check(cat.qso_list == files and not cat.all_exceptions, "catalog CLI: spectra lost")
        det_cli = check_detections(cat.results, truths_cli, "catalog CLI")

        # the same spectra read back through the port's reader and
        # preprocessing, through process_batch with the same generators
        specs_back = [preprocess(*read_spec(f), z, params) for f, z in zip(files, z_cli)]
        direct = []
        for start in range(0, NUM_CLI, CLI_BATCH):
            direct += process_batch(
                learned, specs_back[start:start + CLI_BATCH], dla_samples, sub_samples,
                prior, params, run_bayes_select.batch_generator(0, start, device), MAX_DLAS)
        want_arrays = results_to_arrays(direct, params, MAX_DLAS)
        check(sorted(cat.arrays) == sorted(want_arrays), "catalog CLI: datasets differ")
        differ = same_bits(cat.arrays, want_arrays, want_arrays)
        check(not differ, f"catalog CLI vs process_batch: {differ} differ")

        # dispatch_batch queues its work and its readback and returns: under
        # CUDA's sync debug mode no call in it may synchronise
        inputs = device_put_inputs(arrays, dla_samples, sub_samples, device, torch.float32)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t_disp = time.perf_counter()
                pending = dispatch_batch(
                    inputs, specs_back[:CLI_BATCH], params,
                    run_bayes_select.batch_generator(0, 0, device), MAX_DLAS)
                dispatch_ms = (time.perf_counter() - t_disp) * 1e3
                still_running = not pending.done.query()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [f"{Path(w.filename).name}:{w.lineno} {w.message}" for w in caught
                 if "synchroniz" in str(w.message)]
        pending.done.synchronize()

        # resume: delete the second batch's part file and run again
        os.remove(f"{out_full}.part{CLI_BATCH:08d}.pkl")
        resumed, launches = count_launches(lambda: run_cli(out_full, "--checkpoint"))
        path_launches["cli_catalog_resume"] = launches
        check(launches.get("absorption_all", 0) == CLI_BATCH,
              f"resume: K1 launched {launches.get('absorption_all', 0)} != {CLI_BATCH}")
        differ = same_bits(resumed.arrays, cat.arrays, cat.arrays)
        check(not differ, f"resumed catalog: {differ} differ")

        # catalog-lite
        lite, launches = count_launches(lambda: run_cli(work / "lite.h5", "--no-sample-lls"))
        path_launches["cli_catalog_lite"] = launches
        check(sorted(lite.arrays) == sorted(set(cat.arrays) - set(per_sample)),
              f"lite: datasets {sorted(lite.arrays)}")
        differ = same_bits(lite.arrays, cat.arrays, lite.arrays)
        check(not differ, f"lite catalog: {differ} differ")

        # the systematic resampler against the multinomial run, held as
        # tests/test_torch_resampler.py holds it: the first two chained
        # levels within 10x their spread over two other seeds' multinomial
        # runs (the first profiled: the device's share of the wall), or 0.5.
        # The third chained level is held by the same rule with the spread
        # of ENSEMBLE_SEEDS multinomial seeds: there a level can take one of
        # a few values that the draws decide, under either resampler (a
        # clean spectrum's in the JAX package's own float64 runs,
        # tests/test_torch_resampler.py::test_third_chained_level_modes),
        # and two seeds can miss one; the ensemble's seeds that reach the
        # systematic run's value are printed, beside SYSTEMATIC_SEEDS more
        # systematic runs
        os.environ["GPY_DLA_RESAMPLER"] = "systematic"
        try:
            sysr, launches = count_launches(lambda: run_cli(work / "sys.h5"))
        finally:
            del os.environ["GPY_DLA_RESAMPLER"]
        path_launches["cli_catalog_systematic"] = launches
        det_sys = check_detections(sysr.results, truths_cli, "catalog CLI systematic")
        level0 = ("log_likelihoods_no_dla", "log_likelihoods_lls")
        differ = same_bits(sysr.arrays, cat.arrays, level0) + (
            [] if sysr.arrays["log_likelihoods_dla"][:, 0].tobytes()
            == cat.arrays["log_likelihoods_dla"][:, 0].tobytes() else ["level 1"])
        check(not differ, f"systematic: {differ} differ before any resampling")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            seed1, launches = count_launches(lambda: run_cli(work / "seed1.h5", "--seed", "1"))
            prof_ms = (time.perf_counter() - t_prof) * 1e3
        path_launches["cli_catalog_seed1"] = launches
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type != torch.autograd.DeviceType.CPU) / 1e3
        seed2, launches = count_launches(lambda: run_cli(work / "seed2.h5", "--seed", "2"))
        path_launches["cli_catalog_seed2"] = launches
        ev = lambda run_, lv: run_.arrays["log_likelihoods_dla"][:, lv].astype(np.float64)
        held, deeper = slice(1, 3), slice(3, MAX_DLAS)
        spread = np.maximum(np.abs(ev(seed1, held) - ev(cat, held)).max(axis=1),
                            np.abs(ev(seed2, held) - ev(cat, held)).max(axis=1))
        d_sys = np.abs(ev(sysr, held) - ev(cat, held)).max(axis=1)
        tol_sys = np.maximum(10 * spread, 0.5)
        sys_far = [(i, float(d), float(tl)) for i, (d, tl) in enumerate(zip(d_sys, tol_sys))
                   if not d <= tl]

        # the seed ensembles, through process_batch on the spectra read back
        # (equal to the CLI's runs at the same seed, as checked above)
        def ensemble(seeds, resampler):
            runs = []
            for seed in seeds:
                results = []
                for start in range(0, NUM_CLI, CLI_BATCH):
                    results += process_batch(
                        learned, specs_back[start:start + CLI_BATCH], dla_samples,
                        sub_samples, prior, params,
                        run_bayes_select.batch_generator(seed, start, device), MAX_DLAS,
                        resampler=resampler)
                runs.append(np.stack([r.log_evidences_dla for r in results])[:, deeper]
                            .astype(np.float64))
            return np.stack(runs)  # (seeds, spectra, deeper levels)

        multi_deep, launches = count_launches(lambda: ensemble(
            range(3, ENSEMBLE_SEEDS + 1), "multinomial"))
        path_launches["catalog_multinomial_seeds"] = launches
        multi_deep = np.concatenate([ev(seed1, deeper)[None], ev(seed2, deeper)[None],
                                     multi_deep])
        sys_deep, launches = count_launches(lambda: ensemble(
            range(1, SYSTEMATIC_SEEDS + 1), "systematic"))
        path_launches["catalog_systematic_seeds"] = launches
        spread_deep = np.abs(multi_deep - ev(cat, deeper)).max(axis=(0, 2))
        d_deep = np.abs(ev(sysr, deeper) - ev(cat, deeper)).max(axis=1)
        tol_deep = np.maximum(10 * spread_deep, 0.5)
        deep_far = [(i, float(d), float(tl)) for i, (d, tl) in enumerate(zip(d_deep, tol_deep))
                    if not d <= tl]
        # the rule with seeds 1 and 2 alone (as the first two levels): for
        # the spectra beyond it and the one nearest its bound, which
        # multinomial and systematic seeds reach the systematic run's value
        # (within 0.05)
        spread2_deep = np.abs(multi_deep[:2] - ev(cat, deeper)).max(axis=(0, 2))
        ratio2 = d_deep / np.maximum(10 * spread2_deep, 0.5)
        two_seed_far = [i for i, r in enumerate(ratio2) if not r <= 1]
        multi_seeds = range(1, ENSEMBLE_SEEDS + 1)
        deep_detail = []
        for i in sorted({*two_seed_far, int(np.argmax(ratio2))}):
            value = ev(sysr, deeper)[i]
            reach = lambda runs: [j + 1 for j, r in enumerate(runs)
                                  if np.abs(r[i] - value).max() <= 0.05]
            deep_detail.append(
                f"spectrum {i}: systematic - multinomial "
                f"{float((value - ev(cat, deeper)[i])[0]):+.4f}, multinomial seeds spread "
                f"{spread2_deep[i]:.4f} (seeds 1-2), {spread_deep[i]:.4f} "
                f"({ENSEMBLE_SEEDS} seeds), reaching the systematic value within 0.05: multinomial seeds "
                f"{reach(multi_deep)}, systematic seeds {reach(sys_deep)}, systematic seeds "
                f"1-{SYSTEMATIC_SEEDS} - multinomial "
                + ", ".join(f"{float(r[i][0] - ev(cat, deeper)[i][0]):+.4f}" for r in sys_deep))

        # steady state from a run's metrics sidecar: the batches after the
        # first over the time from the second's dispatch (its drain less its
        # span) to the last's drain; the window drains its last batches
        # together, so the drains alone are no clock
        def steady_rate(output, n_batches):
            batches = [e for e in read_metrics(f"{output}.metrics.jsonl")
                       if e["event"] == "batch_done"][:n_batches]
            t_second = batches[1]["elapsed_s"] - batches[1]["span_seconds"]
            return (sum(e["batch_size"] for e in batches[1:])
                    / (batches[-1]["elapsed_s"] - t_second))

        n_batches = NUM_CLI // CLI_BATCH
        steady = steady_rate(out_full, n_batches)
        # and over 4x the spectra (the files four times), in turns with a
        # window of one batch: 3, 1, 1, 3
        def long_run(inflight, tag):
            out = work / f"long_{tag}.h5"
            quiet(lambda: run_bayes_select.run(
                ["--qso_list", *files * 4, "--z_qso_list", *map(repr, z_cli * 4), "--max_dlas",
                 str(MAX_DLAS), "--batch-size", str(CLI_BATCH), "--inflight", str(inflight),
                 "--output", str(out)]))
            return steady_rate(out, 4 * n_batches)

        long_rates = [(w, long_run(w, i)) for i, w in enumerate((3, 1, 1, 3))]
        print(f"[17 clis] run_bayes_select.run on {NUM_CLI} FITS spectra at "
              f"S={params.num_dla_samples} N={params.num_pixels_padded} k={params.k} "
              f"max_dlas={MAX_DLAS}, float32, --batch-size {CLI_BATCH} --inflight 3 "
              f"--checkpoint | launches {path_launches['cli_catalog']} (no composition) | "
              f"{det_cli} | arrays == process_batch on the FITS read back, same per-batch "
              f"generators: {len(want_arrays)} datasets bit for bit | dispatch_batch under "
              f"sync debug mode: {len(syncs)} synchronising calls, returned in "
              f"{dispatch_ms:.2f} ms with the batch {'still running' if still_running else 'done'}"
              f" | resumed after deleting part {CLI_BATCH}: bit for bit, launches "
              f"{path_launches['cli_catalog_resume']} | --no-sample-lls: {len(lite.arrays)} "
              f"datasets bit for bit, {', '.join(per_sample)} absent | "
              f"GPY_DLA_RESAMPLER=systematic: {det_sys}; before resampling bit for bit; "
              f"first two chained levels' |d log evidence| vs multinomial max {d_sys.max():.3e} "
              f"(tol per spectrum max(10 x the spread of seeds 1 and 2, 0.5); spread max "
              f"{spread.max():.3e}; beyond it: {sys_far}); third chained level max "
              f"{d_deep.max():.3e} (tol per spectrum max(10 x the spread of "
              f"{len(multi_seeds)} multinomial seeds, 0.5); beyond it: {deep_far}; with "
              f"seeds 1 and 2 alone beyond it: {two_seed_far}); " + "; ".join(deep_detail)
              + " | steady state "
              f"{steady:.2f} spectra/s ({n_batches - 1} batches after the first, from the "
              f"second's dispatch to the last's drain, .metrics.jsonl), first run {cli_s:.2f} s; "
              f"over {4 * NUM_CLI} spectra ({4 * n_batches - 1} batches after the first), in "
              f"turns: " + ", ".join(f"--inflight {w} {r:.2f}" for w, r in long_rates)
              + " spectra/s "
              f"| profiled --seed 1 run: device busy "
              f"{busy_ms:.2f} ms of {prof_ms:.2f} ms wall ({100 * busy_ms / prof_ms:.1f}%) | "
              f"peak memory {peak_mib:.1f} MiB at --inflight 3 ({mem_before / 2**20:.1f} MiB "
              f"held before the run) | card {card}")
        check(not syncs, f"dispatch_batch synchronised {len(syncs)} times: {syncs[:4]}")
        check(not sys_far, f"systematic vs multinomial beyond the tolerance: {sys_far}")
        check(not deep_far, f"systematic vs multinomial, third chained level, beyond the "
                            f"tolerance: {deep_far}")

        # the LLS and CIV CLIs on 8 FITS spectra each
        lls_files = [
            write_speclite(work / f"spec-0002-55555-{i:04d}.fits", *synthetic_observation(
                lls_params, lls_arrays, z, seed=100 + i, dlas=None if tr is None else [tr],
                with_lls_break=True))
            for i, (z, tr) in enumerate(zip(lls_z_qsos, lls_truths))
        ]
        lls_run, launches = count_launches(lambda: quiet(lambda: run_find_lls.run(
            ["--qso_list", *lls_files, "--z_qso_list", *map(repr, lls_z_qsos),
             "--output", str(work / "lls.h5")])))
        path_launches["cli_lls"] = launches
        need = {"absorption_all": NUM_LLS, "logmvn_cap": MAX_LYA * NUM_LLS,
                "logmvn_chain": MAX_LYA * NUM_LLS, "absorption_tail": 0,
                "absorption_windowed": 0, "absorption_all_weideman": 0}
        for name, n in need.items():
            check(launches.get(name, 0) == n,
                  f"LLS CLI: {name} launched {launches.get(name, 0)} != {n}")
        p_lls = 1.0 - lls_run.arrays["model_posteriors"][:, 0]
        dz_lls = [abs(float(lls_run.arrays["MAP_z_lyas"][i, 0, 0]) - tr[0])
                  for i, tr in enumerate(lls_truths) if tr is not None]
        clean = [p for p, tr in zip(p_lls, lls_truths) if tr is None]
        inj = [p for p, tr in zip(p_lls, lls_truths) if tr is not None]
        check(max(clean) < 0.1 and min(inj) > 0.9 and max(dz_lls) < 0.01,
              f"LLS CLI detections: clean {clean}, injected {inj}, |dz| {dz_lls}")

        civ_files = []
        for i, (z, seed, inj_, cz, cn, cs) in enumerate(zip(
                gc["z_qso"], gc["obs_seed"], civ_injected, gc["civ_z"], gc["civ_log_n"],
                gc["civ_sigma"])):
            wl, fx, nv, pm = synthetic_observation(civ_params, civ_arrays, float(z), int(seed))
            if inj_:
                fx = fx * civ_doublet_transmission(wl, float(cz), float(cn), float(cs))
            civ_files.append(write_speclite(work / f"spec-0004-55555-{i:04d}.fits",
                                            wl, fx, nv, pm))
        civ_run, launches = count_launches(lambda: quiet(lambda: civ_cli.run(
            ["--qso_list", *civ_files, "--z_qso_list", *[repr(float(z)) for z in gc["z_qso"]],
             "--output", str(work / "civ.h5")])))
        path_launches["cli_civ"] = launches
        need = {"absorption_tail": len(civ_files), "logmvn_cap": len(civ_files),
                "logmvn_chain": len(civ_files), "absorption_all": 0, "absorption_windowed": 0,
                "absorption_all_weideman": 0}
        for name, n in need.items():
            check(launches.get(name, 0) == n,
                  f"CIV CLI: {name} launched {launches.get(name, 0)} != {n}")
        p_civ = civ_run.arrays["p_civs"]
        civ_clean = [p for p, inj_ in zip(p_civ, civ_injected) if not inj_]
        civ_inj = [p for p, inj_ in zip(p_civ, civ_injected) if inj_]
        check(max(civ_clean) < 0.1 and min(civ_inj) > 0.9,
              f"CIV CLI detections: clean {civ_clean}, injected {civ_inj}")
        print(f"[17 clis] run_find_lls.run on {NUM_LLS} FITS spectra (S="
              f"{lls_params.num_dla_samples}, N={lls_params.num_pixels_padded}, max_lya="
              f"{MAX_LYA}, float32): launches {path_launches['cli_lls']} | clean max P(k>=1) "
              f"{max(clean):.3e}, injected min {min(inj):.6f}, max |MAP z - truth| "
              f"{max(dz_lls):.2e} || run_civ.run on {len(civ_files)} FITS spectra (S="
              f"{civ_params.num_civ_samples}, float32): launches {path_launches['cli_civ']} | "
              f"clean max p_civ {max(civ_clean):.3e}, injected min {min(civ_inj):.6f}")

    # 18. the zQSO head at ZParameters() (Z = 10,000 candidates, k = 20,
    # P = 5,632): golden parity with the JAX float64 scans, the library
    # path (the correlation scan, its solves on K3), the CLI
    t18 = time.perf_counter()
    from gpy_dla_detection_tpu_torch import run_zqso_estimation
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_z_learned_model,
        synthetic_z_observation,
    )
    from gpy_dla_detection_tpu_torch.models import zqso_corr
    from gpy_dla_detection_tpu_torch.models.zqso import (
        dispatch_scan,
        inference_z_qso_many,
        prepare_z_spectrum,
    )
    from gpy_dla_detection_tpu_torch.params import ZParameters

    def scan_rules(got, want, grid, label):
        """The same NaN pattern and MAP; every finite |dll| within
        REL_ZQSO_GLOBAL of the largest finite |ll|, and within +-0.2 of the
        peak within NEAR_PEAK_ZQSO of the peak's margin: (global share,
        near-peak share of the margin)."""
        check(np.array_equal(np.isnan(got), np.isnan(want)), f"{label}: NaN pattern differs")
        fin = np.isfinite(want)
        peak = int(np.nanargmax(want))
        check(int(np.nanargmax(got)) == peak, f"{label}: MAP index {int(np.nanargmax(got))} "
                                              f"!= {peak}")
        d = np.abs(got.astype(np.float64) - want)
        rel = float(d[fin].max() / np.abs(want[fin]).max())
        near = fin & (np.abs(grid - grid[peak]) < 0.2)
        margin = float(want[peak] - want[fin & (np.abs(grid - grid[peak]) > 0.2)].max())
        share = float(d[near].max() / margin)
        check(rel <= REL_ZQSO_GLOBAL and 0 < margin and share <= NEAR_PEAK_ZQSO,
              f"{label}: |dll| {rel:.3e} of max|ll| (tol {REL_ZQSO_GLOBAL}), near the peak "
              f"{share:.3e} of the margin {margin:.3f} (tol {NEAR_PEAK_ZQSO})")
        return rel, share

    gz = np.load(GOLDEN_ZQSO)
    zparams = ZParameters()
    zk, z_seed = int(gz["k"]), int(gz["model_seed"])
    z_learned = synthetic_z_learned_model(z_seed, zk).to(device, torch.float32)
    step = int(gz["flux_probe_step"])
    golden_specs = []
    for z, obs_seed, probe in zip(gz["z_true"], gz["obs_seed"], gz["flux_probe"]):
        _, obs = synthetic_z_observation(float(z), seed=z_seed, k=zk, obs_seed=int(obs_seed))
        check(np.array_equal(obs[1][::step], probe), "zQSO golden: a regenerated flux differs")
        golden_specs.append(prepare_z_spectrum(*obs, zparams.num_pixels_padded))
    # the first spectrum's inputs to K3, kept as the scan hands them over
    k3_zqso_inputs = []
    chain_in_scan = zqso_corr.logmvn_chain

    def keep_first(B, u, misc):
        if not k3_zqso_inputs:
            k3_zqso_inputs.append((B, u, misc))
        return chain_in_scan(B, u, misc)

    zqso_corr.logmvn_chain = keep_first
    try:
        (corr_res, z_grid_np), launches = count_launches(lambda: inference_z_qso_many(
            z_learned, golden_specs, zparams, method="corr", keep_lls=True))
    finally:
        zqso_corr.logmvn_chain = chain_in_scan
    path_launches["zqso_golden_corr"] = launches
    check(launches.get("logmvn_chain", 0) == len(golden_specs) and set(launches) == {
        "logmvn_chain"}, f"zQSO golden corr: launches {launches}")
    check(np.array_equal(z_grid_np, gz["z_grid"]), "zQSO: the z grid differs from the golden's")
    golden_rules = [scan_rules(lls, want, z_grid_np, f"zQSO golden corr {i}")
                    for i, ((_, lls), want) in enumerate(zip(corr_res, gz["lls_corr"]))]
    check([z for z, _ in corr_res] == list(gz["z_map_corr"]),
          f"zQSO golden corr: z_map {[z for z, _ in corr_res]} != {list(gz['z_map_corr'])}")
    (exact_res, _), launches = count_launches(lambda: inference_z_qso_many(
        z_learned, golden_specs[:1], zparams, method="exact", keep_lls=True))
    path_launches["zqso_golden_exact"] = launches
    check(not launches, f"zQSO golden exact: launches {launches} (it runs no kernel)")
    exact_rules = scan_rules(exact_res[0][1], gz["lls_exact"][0], z_grid_np, "zQSO golden exact")
    check(exact_res[0][0] == gz["z_map_exact"][0],
          f"zQSO golden exact: z_map {exact_res[0][0]} != {gz['z_map_exact'][0]}")

    # K3 on the zQSO's own inputs against its twin, and its bound
    B_z, u_z, misc_z = k3_zqso_inputs[0]
    ll_zk = logmvn_chain(B_z, u_z, misc_z)
    ll_zt = logmvn_chain_reference(B_z, u_z, misc_z)
    k3_zqso_err = float((ll_zk - ll_zt).abs().max())
    check(k3_zqso_err <= REL_K23 * float(ll_zt.abs().max()),
          f"K3 at the zQSO's inputs: |dll| {k3_zqso_err:.3e} > {REL_K23} max|ll|")
    err["logmvn_chain"] = max(err["logmvn_chain"], k3_zqso_err)
    k3_zqso_bound = bound(*k3_work(*u_z.shape))
    k3_zqso_ms = device_ms(lambda: logmvn_chain(B_z, u_z, misc_z))[0]

    # the library path on NUM_ZQSO spectra of the golden's model (the
    # first NUM_ZQSO of the NUM_ZQSO_RATE that are timed)
    z_true_rate = np.random.default_rng(ZQSO_Z_SEED).uniform(2.4, 4.6, NUM_ZQSO_RATE)
    rate_specs = [
        prepare_z_spectrum(*synthetic_z_observation(float(z), seed=z_seed, k=zk,
                                                    obs_seed=50 + i)[1])
        for i, z in enumerate(z_true_rate)
    ]
    z_true_lib, lib_specs = z_true_rate[:NUM_ZQSO], rate_specs[:NUM_ZQSO]
    run_zqso = lambda: inference_z_qso_many(z_learned, lib_specs, zparams)
    (lib_res, _), launches = count_launches(run_zqso)
    path_launches["zqso"] = launches
    check(launches.get("logmvn_chain", 0) == NUM_ZQSO and set(launches) == {"logmvn_chain"},
          f"zQSO library path: launches {launches}")
    z_lib = np.array([z for z, _ in lib_res])
    dz_lib = np.abs(z_lib - z_true_lib)
    check((dz_lib < 0.5).all(), f"zQSO: |z_map - z_true| {dz_lib} not all < 0.5")

    # dispatch under CUDA's sync debug mode set to error: any synchronising
    # call in it raises
    def dispatch_all():
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            pending = [dispatch_scan(z_learned, s, zparams)[1] for s in lib_specs]
            spent = (time.perf_counter() - t0) * 1e3
            running = not pending[-1].done.query()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return pending, spent, running

    (pending_z, zqso_dispatch_ms, zqso_running), launches = count_launches(dispatch_all)
    path_launches["zqso_dispatch"] = launches
    z_disp = np.array([z_grid_np[np.nanargmax(p.result())] for p in pending_z])
    check(np.array_equal(z_disp, z_lib), "zQSO: the dispatched scans' MAPs differ")
    # the rate at steady state: NUM_ZQSO_RATE spectra keep the window of
    # scans in flight full; then one profiled pass over them
    run_rate = lambda: inference_z_qso_many(z_learned, rate_specs, zparams)
    run_rate()
    zqso_rate = rate_of(run_rate, NUM_ZQSO_RATE)
    torch.cuda.synchronize()
    zqso_mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prime_profiler()
        t_prof = time.perf_counter()
        run_rate()
        torch.cuda.synchronize()
        zqso_prof_ms = (time.perf_counter() - t_prof) * 1e3
    zqso_peak_mib = (torch.cuda.max_memory_allocated() - zqso_mem_before) / 2**20
    device_rows = [e for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and SENTINEL_KERNEL not in e.key]
    zqso_busy_ms = sum(e.self_device_time_total for e in device_rows) / 1e3
    zqso_records = sum(e.count for e in device_rows) / NUM_ZQSO_RATE

    # the CLI on NUM_ZQSO FITS spectra at full width: its synthetic
    # fallback model made the golden's (k = 20; the card has no h5py for
    # --learned-file), against the library path on the files read back
    fallback = run_zqso_estimation.synthetic_z_learned_model
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        work = Path(work)
        z_files = [
            write_speclite(work / f"spec-0005-55555-{i:04d}.fits", *synthetic_z_observation(
                float(z), seed=z_seed, k=zk, obs_seed=300 + i)[1])
            for i, z in enumerate(z_true_lib)
        ]
        run_zqso_estimation.synthetic_z_learned_model = lambda: fallback(z_seed, zk)
        try:
            zcli, launches = count_launches(lambda: quiet(lambda: run_zqso_estimation.run(
                ["--qso_list", *z_files, "--device", "cuda", "--output", str(work / "z.h5")])))
        finally:
            run_zqso_estimation.synthetic_z_learned_model = fallback
        path_launches["cli_zqso"] = launches
        check(launches.get("logmvn_chain", 0) == NUM_ZQSO and set(launches) == {"logmvn_chain"},
              f"zQSO CLI: launches {launches}")
        (read_res, _), launches = count_launches(lambda: inference_z_qso_many(
            z_learned,
            [prepare_z_spectrum(*read_spec(f), zparams.num_pixels_padded) for f in z_files],
            zparams))
        path_launches["zqso_fits_read_back"] = launches
    z_read = np.array([z for z, _ in read_res])
    check(zcli.qso_list == z_files and zcli.z_map.tobytes() == z_read.tobytes(),
          f"zQSO CLI z_map {zcli.z_map} != the library path's {z_read}")
    dz_cli = np.abs(zcli.z_map - z_true_lib)
    print(f"[18 zqso] {card} | Z={zparams.num_zqso_samples} k={zk} P="
          f"{zparams.num_pixels_padded}, float32 | golden parity vs JAX float64 "
          f"(tests/data/torch_golden_zqso.npz, {len(golden_specs)} spectra): corr z_map equal ("
          + ", ".join(f"{z:.4f}" for z in gz["z_map_corr"]) + " for z_true "
          + ", ".join(f"{z:.4f}" for z in gz["z_true"]) + "), |dll| max " + ", ".join(f"{r:.3e}" for r, _ in golden_rules)
          + f" of max|ll| (tol {REL_ZQSO_GLOBAL}), near the peak "
          + ", ".join(f"{s:.3e}" for _, s in golden_rules)
          + f" of the margin (tol {NEAR_PEAK_ZQSO}); exact z_map equal {gz['z_map_exact'][0]:.4f}, "
          f"{exact_rules[0]:.3e} / {exact_rules[1]:.3e} | K3 at the zQSO's inputs (S="
          f"{u_z.shape[0]}, k={u_z.shape[1]}): |dll| vs twin {k3_zqso_err:.3e}, device "
          f"{k3_zqso_ms:.4f} ms a launch (profiler over 50 launches, ops/timing.device_ms; the "
          f"catalog's {k3_device['logmvn_chain'][0]:.4f} ms, phase 10), bound "
          f"{k3_zqso_bound[0]:.4f} ms ({k3_zqso_bound[1]}) | library path, "
          f"{NUM_ZQSO} spectra: launches {path_launches['zqso']}, |z_map - z_true| max "
          f"{dz_lib.max():.4f}, {int((dz_lib < 0.05).sum())} of {NUM_ZQSO} within 0.05; dispatch "
          f"of {NUM_ZQSO} scans under sync debug mode 'error' {zqso_dispatch_ms:.2f} ms, the last "
          f"{'still running' if zqso_running else 'done'} at its end | {NUM_ZQSO_RATE} spectra: "
          f"{zqso_rate:.2f} spectra/s (median of 3 passes after a warm-up); profiled pass: device "
          f"busy {zqso_busy_ms:.2f} ms of {zqso_prof_ms:.2f} ms wall "
          f"({100 * zqso_busy_ms / zqso_prof_ms:.1f}%), {zqso_records:.1f} device records a "
          f"spectrum; peak memory {zqso_peak_mib:.1f} MiB above the "
          f"{zqso_mem_before / 2**20:.1f} MiB held | CLI run_zqso_estimation.run on "
          f"{NUM_ZQSO} FITS spectra (synthetic fallback model at k={zk}): launches "
          f"{path_launches['cli_zqso']}, z_map == the library path's on the files read back "
          f"bit for bit, |z_map - z_true| max {dz_cli.max():.4f} | {time.perf_counter() - t18:.1f} s")

    # 19. GP training at the reference's width: K3's adjoint against its
    # twin, the golden replay against JAX float64, a trainer taking a few
    # steps, the adjoint's device time
    t19 = time.perf_counter()
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_training_lists,
        synthetic_training_problem,
    )
    from gpy_dla_detection_tpu_torch.models import training as TT
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
        logmvn_chain_grad,
        logmvn_chain_grad_reference,
    )

    num_lines = params.num_forest_lines
    rest_pixels = int(round((params.max_lambda - params.min_lambda) / params.dlambda)) + 1

    def train_problem(Q, k, seed):
        """scripts/train_throughput.py's synthetic problem on the card in
        float32: the parameters and the fit's arrays."""
        fields, arrays = synthetic_training_problem(Q, rest_pixels, k, seed)
        return (TT.TrainingParams.from_numpy(fields, device),
                tuple(torch.as_tensor(x, device=device) for x in arrays))

    # K3's adjoint against its twin on the synthetic problem's own inputs
    grad_inputs, grad_rel = {}, {}
    for k_ in TRAIN_GRAD_KS:
        p_, args_ = train_problem(TRAIN_Q, k_, seed=k_)
        with torch.no_grad():
            B_, u_, misc_ = TT.woodbury_inputs(p_, *args_, num_lines)
        g_ = torch.as_tensor(np.random.default_rng(k_).normal(size=TRAIN_Q).astype(np.float32),
                             device=device)
        got_ = logmvn_chain_grad(B_, u_, misc_, g_)
        want_ = logmvn_chain_grad_reference(B_, u_, misc_, g_)
        check(all(bool(torch.isfinite(x).all()) for x in got_), f"K3's adjoint k={k_}: non-finite")
        grad_rel[k_] = [float((a - b).abs().max()) / float(b.abs().max())
                        for a, b in zip(got_, want_)]
        check(max(grad_rel[k_]) <= REL_K3_GRAD,
              f"K3's adjoint k={k_}: |d| / max (dB, du, dmisc) {grad_rel[k_]} > {REL_K3_GRAD}")
        name = "logmvn_chain_grad_wide" if k_ > 64 else "logmvn_chain_grad"
        err[name] = max(err.get(name, 0.0), max(float((a - b).abs().max())
                                                for a, b in zip(got_, want_)))
        grad_inputs[k_] = (B_, u_, misc_, g_)

    # the golden replay: the JAX float64 objective of 64 spectra, rebuilt
    # from their seeds
    gt = np.load(GOLDEN_TRAIN)
    gt_truth = synthetic_learned_model(params, seed=int(gt["model_seed"]))
    gt_train = TT.prepare_training_set(params, *synthetic_training_lists(
        params, gt_truth, gt["z_qso"], int(gt["obs_seed"]), float(gt["noise_level"])),
        gt["z_qso"])
    gt_mu, gt_p = TT.initialize(params, gt_train, device)
    check(np.array_equal(gt_mu, gt["mu"]), "training golden: the regenerated mu differs")
    put32 = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    gt_args = (put32(np.where(gt_train.mask, gt_train.flux - gt_mu, 0.0)),
               put32(gt_train.lya_1pz), put32(gt_train.noise_variance),
               put32(gt_train.mask, torch.bool), put32(gt_train.zqso_1pz))

    def golden_eval():
        with torch.no_grad():
            losses_ = TT.batched_spectrum_losses(gt_p, *gt_args, num_lines)
        TT.total_objective(gt_p, *gt_args, params).backward()
        return losses_

    gt_losses, launches = count_launches(golden_eval)
    path_launches["train_golden"] = launches
    check(launches == {"logmvn_chain": 2, "logmvn_chain_grad": 1},
          f"training golden: launches {launches}")
    gt_loss_rel = float(np.abs(gt_losses.double().cpu().numpy() - gt["losses"]).max()
                        / np.abs(gt["losses"]).max())
    gt_grad_rel = {n: float(np.abs(getattr(gt_p, n).grad.double().cpu().numpy()
                                   - gt[f"grad_{n}"]).max() / np.abs(gt[f"grad_{n}"]).max())
                   for n in TT.PARAM_FIELDS}
    check(gt_loss_rel <= REL_TRAIN_LOSS and max(gt_grad_rel.values()) <= REL_TRAIN_GRAD,
          f"training golden: losses {gt_loss_rel:.3e} of max|loss| (tol {REL_TRAIN_LOSS}), "
          f"gradients {gt_grad_rel} of each block's max|g| (tol {REL_TRAIN_GRAD})")

    # a trainer taking a few steps: fit_lbfgs_stepwise at Q = 4,096
    p_t, args_t = train_problem(TRAIN_Q, params.k, seed=0)
    fit = lambda n, p_=p_t: TT.fit_lbfgs_stepwise(p_, *args_t, params, n)
    fit(2)  # warm-up
    (p_fit, fit_values), launches = count_launches(lambda: fit(TRAIN_ITERS))
    path_launches["train_fit"] = launches
    evals = launches.get("logmvn_chain", 0)
    check(evals >= TRAIN_ITERS and launches == {"logmvn_chain": evals, "logmvn_chain_grad": evals},
          f"training fit: launches {launches} (K3 and its adjoint once an evaluation)")
    check(bool(np.isfinite(fit_values).all()) and fit_values[-1] < fit_values[0],
          f"training fit: the loss does not fall: {fit_values[0]} -> {fit_values[-1]}")
    fit_runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(TRAIN_ITERS)
        torch.cuda.synchronize()
        fit_runs.append((time.perf_counter() - t0) * 1e3 / TRAIN_ITERS)
    fit_ms = statistics.median(fit_runs)
    # one profiled iteration from the fitted parameters
    torch.cuda.synchronize()
    train_mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prime_profiler()
        _build.reset_launch_counts()
        t_prof = time.perf_counter()
        fit(1, p_fit)
        torch.cuda.synchronize()
        train_prof_ms = (time.perf_counter() - t_prof) * 1e3
        prof_evals = _build.launch_counts["logmvn_chain"]
    train_peak_mib = (torch.cuda.max_memory_allocated() - train_mem_before) / 2**20
    train_busy_ms = union_busy_ms(prof)
    train_sum_ms = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type != torch.autograd.DeviceType.CPU
                       and not e.is_user_annotation and SENTINEL_KERNEL not in e.key) / 1e3

    # one evaluation at k = 65: K3's wide chain and the adjoint's wide kernel
    p_w, args_w = train_problem(TRAIN_WIDE_Q, TRAIN_GRAD_KS[-1], seed=65)
    _, launches = count_launches(
        lambda: TT.total_objective(p_w, *args_w, params).backward())
    path_launches["train_wide_basis"] = launches
    check(launches == {"logmvn_chain_wide": 1, "logmvn_chain_grad_wide": 1},
          f"training at k=65: launches {launches}")
    check(all(bool(torch.isfinite(getattr(p_w, n).grad).all()) for n in TT.PARAM_FIELDS),
          "training at k=65: non-finite gradients")

    # the adjoint's device time, beside K3's forward on the same inputs,
    # its bound and the library yardstick (on no path): cholesky_ex +
    # cholesky_inverse of the unpacked I + B
    grad_extra = {}
    for name, k_ in (("logmvn_chain_grad", params.k), ("logmvn_chain_grad_wide",
                                                       TRAIN_GRAD_KS[-1])):
        B_, u_, misc_, g_ = grad_inputs[k_]
        ms[name] = (timed_median(lambda: logmvn_chain_grad(B_, u_, misc_, g_)),
                    timed_median(lambda: logmvn_chain_grad_reference(B_, u_, misc_, g_)))
        bounds[name] = bound(*k3_grad_work(TRAIN_Q, k_))
        full_ = unpack_capacitance(B_, k_)
        library[name] = timed_median(
            lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(full_)[0]))
        k3_device[name] = device_ms(lambda: logmvn_chain_grad(B_, u_, misc_, g_))
        forward = device_ms(lambda: logmvn_chain(B_, u_, misc_))[0]
        grad_extra[name] = {"note": GRAD_NOTE, "k": k_, "S": TRAIN_Q,
                            "device_ms_forward": forward,
                            "max_rel_err": max(grad_rel[k_])}
    grad_dev = {n: k3_device[n][0] for n in grad_extra}
    print(f"[19 train] {card} | R={rest_pixels} k={params.k} {num_lines} forest lines, float32 | "
          f"K3's adjoint vs twin at Q={TRAIN_Q}, |d| / max|.| (dB, du, dmisc; tol "
          f"{REL_K3_GRAD}): "
          + ", ".join(f"k={k_} " + "/".join(f"{r:.2e}" for r in rel)
                      for k_, rel in grad_rel.items())
          + f" | golden vs JAX float64 (tests/data/torch_golden_train.npz, Q="
          f"{len(gt['z_qso'])}): losses {gt_loss_rel:.3e} of max|loss| {np.abs(gt['losses']).max():.1f} "
          f"(tol {REL_TRAIN_LOSS}), gradients of each block's max|g| (tol {REL_TRAIN_GRAD}): "
          + ", ".join(f"{n} {r:.3e}" for n, r in gt_grad_rel.items())
          + f"; launches {path_launches['train_golden']} | fit_lbfgs_stepwise at Q={TRAIN_Q}: "
          f"{fit_ms:.2f} ms an iteration (median of 3 runs of {TRAIN_ITERS}: "
          + ", ".join(f"{t:.2f}" for t in fit_runs)
          + f"), {evals / TRAIN_ITERS:.2f} evaluations an iteration, launches "
          f"{path_launches['train_fit']} (no composition), loss {fit_values[0]:.1f} -> "
          f"{fit_values[-1]:.1f}; one profiled iteration ({prof_evals} evaluations): device busy "
          f"{train_busy_ms:.2f} ms (the union of the device records' intervals) of "
          f"{train_prof_ms:.2f} ms wall ({100 * train_busy_ms / train_prof_ms:.1f}%; the kernels' "
          f"times sum to {train_sum_ms:.2f} ms; user annotations left out), peak memory "
          f"{train_peak_mib:.1f} MiB "
          f"above the {train_mem_before / 2**20:.1f} MiB held | k=65 evaluation: launches "
          f"{path_launches['train_wide_basis']} | device ms (profiler, 50 launches): "
          + ", ".join(f"{n} (k={grad_extra[n]['k']}) {grad_dev[n]:.4f} vs K3 forward "
                      f"{grad_extra[n]['device_ms_forward']:.4f}, bound {bounds[n][0]:.4f} "
                      f"({bounds[n][1]}), synchronised {ms[n][0]:.3f} vs twin {ms[n][1]:.3f}, "
                      f"library cholesky_ex + cholesky_inverse {library[n]:.3f}"
                      for n in grad_extra)
          + f" | {time.perf_counter() - t19:.1f} s")

    # 20. the reference-scale training run (scripts/train_fullscale_torch.py)
    # at R = 1,217, k = 20, 31 forest lines: the chunked objective against
    # the unchunked one at Q = 65,024, the golden replay, the two-stage
    # restart, the script end to end
    t20 = time.perf_counter()
    fullscale = load_script(TRAIN_SCRIPT, "train_fullscale_torch")
    Qc = TRAIN_FULL_Q // TRAIN_CHUNKS

    # (a) one evaluation in 16 chunks against one unchunked, on phase 19's
    # synthetic problem at the reference's Q
    p_q, args_q = train_problem(TRAIN_FULL_Q, params.k, seed=0)
    shift_q, launches = count_launches(
        lambda: fullscale.mean_spectrum_loss((p_q, *args_q), params, TRAIN_CHUNKS))
    path_launches["train_full_shift"] = launches
    check(launches == {"logmvn_chain": TRAIN_CHUNKS}, f"the shift's pass: launches {launches}")

    def evaluation(objective):
        """One evaluation and its backward: the value, the gradients, the
        peak memory above what was held before it and the wall ms."""
        p_q.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value = objective(p_q, *args_q, params)
        value.backward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        grads = {n: getattr(p_q, n).grad.double().cpu().numpy() for n in TT.PARAM_FIELDS}
        return (float(value.detach()), grads, (torch.cuda.max_memory_allocated() - held) / 2**20,
                wall)

    (v_chunk, g_chunk, peak_chunk, wall_chunk), launches = count_launches(
        lambda: evaluation(fullscale.chunked_objective_factory(TRAIN_CHUNKS, shift_q)))
    path_launches["train_full_chunked"] = launches
    check(launches == {"logmvn_chain": 2 * TRAIN_CHUNKS, "logmvn_chain_grad": TRAIN_CHUNKS},
          f"the chunked evaluation: launches {launches} (K3 {2 * TRAIN_CHUNKS}, its adjoint "
          f"{TRAIN_CHUNKS})")
    (v_full, g_full, peak_full, wall_full), launches = count_launches(
        lambda: evaluation(TT.total_objective))
    path_launches["train_full_unchunked"] = launches
    check(launches == {"logmvn_chain": 1, "logmvn_chain_grad": 1},
          f"the unchunked evaluation: launches {launches}")
    p_q.zero_grad(set_to_none=True)
    with torch.no_grad():
        abs_sum_q = float(TT.batched_spectrum_losses(p_q, *args_q, num_lines).double().abs().sum())
    torch.cuda.empty_cache()
    full_rel = abs(v_chunk + TRAIN_FULL_Q * shift_q - v_full) / abs_sum_q
    full_grad_rel = {n: float(np.abs(g_chunk[n] - g_full[n]).max() / np.abs(g_full[n]).max())
                     for n in TT.PARAM_FIELDS}
    check(np.isfinite(v_chunk) and full_rel <= REL_TRAIN_LOSS
          and max(full_grad_rel.values()) <= REL_TRAIN_GRAD,
          f"chunked vs unchunked at Q={TRAIN_FULL_Q}: value {full_rel:.3e} of sum|loss| (tol "
          f"{REL_TRAIN_LOSS}), gradients {full_grad_rel} (tol {REL_TRAIN_GRAD})")

    # K3 and its adjoint at a chunk's shape (Qc = 4,064) against their twins
    with torch.no_grad():
        chunk_in = TT.woodbury_inputs(p_q, *(x[:Qc] for x in args_q), num_lines)
    g_chunk_in = torch.as_tensor(np.random.default_rng(4064).normal(size=Qc).astype(np.float32),
                                 device=device)
    ll_c, ll_ref = logmvn_chain(*chunk_in), logmvn_chain_reference(*chunk_in)
    chunk_k3_rel = float((ll_c - ll_ref).abs().max() / ll_ref.abs().max())
    got_c = logmvn_chain_grad(*chunk_in, g_chunk_in)
    want_c = logmvn_chain_grad_reference(*chunk_in, g_chunk_in)
    chunk_grad_rel = [float((a - b).abs().max()) / float(b.abs().max())
                      for a, b in zip(got_c, want_c)]
    check(chunk_k3_rel <= REL_K23 and max(chunk_grad_rel) <= REL_K3_GRAD,
          f"K3 / its adjoint at Qc={Qc}: {chunk_k3_rel:.2e} (tol {REL_K23}) / {chunk_grad_rel} "
          f"(tol {REL_K3_GRAD})")
    err["logmvn_chain"] = max(err["logmvn_chain"], float((ll_c - ll_ref).abs().max()))
    err["logmvn_chain_grad"] = max(err["logmvn_chain_grad"], max(
        float((a - b).abs().max()) for a, b in zip(got_c, want_c)))
    chunk_dev = {"logmvn_chain": device_ms(lambda: logmvn_chain(*chunk_in))[0],
                 "logmvn_chain_grad": device_ms(lambda: logmvn_chain_grad(*chunk_in,
                                                                          g_chunk_in))[0]}
    chunk_bound = {"logmvn_chain": bound(*k3_work(Qc, params.k))[0],
                   "logmvn_chain_grad": bound(*k3_grad_work(Qc, params.k))[0]}
    del chunk_in, got_c, want_c, ll_c, ll_ref

    # (b) the golden replay through four chunks (phase 19's inputs)
    gt_Q = len(gt["z_qso"])
    gt_shift, launches = count_launches(
        lambda: fullscale.mean_spectrum_loss((gt_p, *gt_args), params, TRAIN_GOLDEN_CHUNKS))
    gt_p.zero_grad(set_to_none=True)

    def golden_chunked():
        value = fullscale.chunked_objective_factory(TRAIN_GOLDEN_CHUNKS, gt_shift)(
            gt_p, *gt_args, params)
        value.backward()
        return float(value.detach())

    gt_value, launches_eval = count_launches(golden_chunked)
    path_launches["train_golden_chunked"] = {
        n: launches.get(n, 0) + launches_eval.get(n, 0) for n in {**launches, **launches_eval}}
    check(launches_eval == {"logmvn_chain": 2 * TRAIN_GOLDEN_CHUNKS,
                            "logmvn_chain_grad": TRAIN_GOLDEN_CHUNKS},
          f"the chunked golden replay: launches {launches_eval}")
    gt_chunk_rel = abs(gt_value + gt_Q * gt_shift - float(gt["objective"])) / np.abs(
        gt["losses"]).sum()
    gt_chunk_grad = {n: float(np.abs(getattr(gt_p, n).grad.double().cpu().numpy()
                                     - gt[f"grad_{n}"]).max() / np.abs(gt[f"grad_{n}"]).max())
                     for n in TT.PARAM_FIELDS}
    check(gt_chunk_rel <= REL_TRAIN_LOSS and max(gt_chunk_grad.values()) <= REL_TRAIN_GRAD,
          f"the chunked golden replay: total {gt_chunk_rel:.3e} of sum|loss| (tol "
          f"{REL_TRAIN_LOSS}), gradients {gt_chunk_grad} (tol {REL_TRAIN_GRAD})")

    # (c) the two-stage schedule at Q = 65,024, 3 + 3 iterations: a fresh
    # L-BFGS for stage B, re-shifted at stage A's end
    optimizers = []

    class CountedLBFGS(torch.optim.LBFGS):
        def __init__(self, *args, **kwargs):
            optimizers.append(self)
            super().__init__(*args, **kwargs)

    lbfgs = torch.optim.LBFGS
    torch.optim.LBFGS = CountedLBFGS
    try:
        torch.cuda.synchronize()
        two_held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (p_two, two_values, two_stages), launches = count_launches(lambda: quiet(
            lambda: fullscale.fit_two_stage(p_q, args_q, params, TRAIN_STAGE_ITERS,
                                            TRAIN_STAGE_ITERS, TRAIN_CHUNKS)))
        two_ms = (time.perf_counter() - t0) * 1e3 / (2 * TRAIN_STAGE_ITERS)
        two_peak = (torch.cuda.max_memory_allocated() - two_held) / 2**20
    finally:
        torch.optim.LBFGS = lbfgs
    path_launches["train_two_stage"] = launches
    two_evals = sum(s.evaluations for s in two_stages)
    check(len(optimizers) == 2 and len(two_stages) == 2,
          f"two-stage fit: {len(optimizers)} optimizers, {len(two_stages)} stages (want 2, 2)")
    check(launches == {"logmvn_chain": 2 * TRAIN_CHUNKS * (1 + two_evals),
                       "logmvn_chain_grad": TRAIN_CHUNKS * two_evals},
          f"two-stage fit: launches {launches} for {two_evals} evaluations and 2 shift passes")
    check(bool(np.isfinite(two_values).all()) and two_values[-1] < two_values[0],
          f"two-stage fit: the loss does not fall: {two_values}")
    stage_a, stage_b = two_stages
    # stage B restarts at stage A's end, whose true loss the shift's pass
    # gives (float32 losses summed in float64): the restored first value
    # agrees within the resolution of the float32 shift the device
    # subtracts from each loss, Q ulp(shift)
    shift_res = TRAIN_FULL_Q * float(np.spacing(np.float32(stage_b.shift)))
    check(abs(stage_b.values[0] - stage_b.start_loss) <= shift_res
          and stage_b.values[0] <= stage_a.values[-1] + shift_res,
          f"two-stage fit: stage B starts at {stage_b.values[0]:.3f}, stage A ended at "
          f"{stage_b.start_loss:.3f} (its last iteration started at {stage_a.values[-1]:.3f}); "
          f"tol {shift_res:.3f}")
    # one profiled iteration from the fitted parameters
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prime_profiler()
        t_prof = time.perf_counter()
        TT.fit_lbfgs_stepwise(p_two, *args_q, params, 1, objective=(
            fullscale.chunked_objective_factory(TRAIN_CHUNKS, stage_b.shift)))
        torch.cuda.synchronize()
        two_prof_ms = (time.perf_counter() - t_prof) * 1e3
    two_busy_ms = union_busy_ms(prof)
    del prof, p_two, p_q, args_q
    torch.cuda.empty_cache()

    # (d) the script end to end: generation, preparation, a 20-iteration
    # fit in 4 chunks, the quality numbers and a 16-spectrum detection gate
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        out_train = Path(work) / "train.json"
        art, launches = count_launches(lambda: quiet(lambda: fullscale.main([
            "--num-spectra", str(TRAIN_E2E_Q), "--chunks", str(TRAIN_E2E_CHUNKS), "--iters",
            str(TRAIN_E2E_ITERS), "--gate-n", str(TRAIN_GATE_N), "--output", str(out_train)])))
        check(json.loads(out_train.read_text()) == json.loads(json.dumps(art)),
              "the script's artifact differs from what main returned")
    path_launches["train_script"] = launches
    missing = (TRAIN_JAX_ARTIFACT_KEYS - {"backend"} | {"device"}) - set(art)
    check(not missing and "backend" not in art, f"the artifact lacks {missing}")
    traj = np.asarray(art["loss_trajectory_downsampled"]["values"])
    check(bool(np.isfinite(traj).all()) and traj[-1] < traj[0],
          f"the script's trajectory does not fall: {traj[0]} -> {traj[-1]}")
    e2e_evals = round(art["evaluations_per_iteration"] * TRAIN_E2E_ITERS)
    want = {"absorption_all": TRAIN_GATE_N, "logmvn_cap": 5 * TRAIN_GATE_N,
            "logmvn_chain": 5 * TRAIN_GATE_N + TRAIN_E2E_CHUNKS * (1 + 2 * e2e_evals),
            "logmvn_chain_grad": TRAIN_E2E_CHUNKS * e2e_evals}
    check(launches == want, f"the script's launches {launches}, want {want} (the gate's "
                            f"{TRAIN_GATE_N} spectra and {e2e_evals} evaluations)")
    gate = art["detection_gate_with_trained_model"]
    check(gate is not None and gate["n_injected"] == TRAIN_GATE_N // 2,
          f"the script's gate: {gate}")
    gate_numbers = {k: v for k, v in gate.items() if not isinstance(v, list)}
    # the K3 and adjoint rows of the kernels line: their device ms at a
    # chunk's shape and their launches an evaluation of the chunked objective
    train_chunk_extra = {
        name: {"train_chunk_S": Qc, "device_ms_train_chunk": chunk_dev[name],
               "bound_ms_train_chunk": chunk_bound[name],
               "launches_per_train_evaluation": path_launches["train_full_chunked"][name]}
        for name in chunk_dev}
    print(f"[20 train fullscale] {card} | R={rest_pixels} k={params.k} {num_lines} forest "
          f"lines, float32 | (a) Q={TRAIN_FULL_Q}: {TRAIN_CHUNKS} chunks (Qc={Qc}) vs "
          f"unchunked: value {full_rel:.3e} of sum|loss| {abs_sum_q:.4g} (tol {REL_TRAIN_LOSS}), "
          f"gradients of each block's max|g| (tol {REL_TRAIN_GRAD}): "
          + ", ".join(f"{n} {r:.3e}" for n, r in full_grad_rel.items())
          + f"; launches chunked {path_launches['train_full_chunked']}, unchunked "
          f"{path_launches['train_full_unchunked']}, the shift's pass "
          f"{path_launches['train_full_shift']}; peak memory above the data: chunked "
          f"{peak_chunk:.1f} MiB ({wall_chunk:.1f} ms), unchunked {peak_full:.1f} MiB "
          f"({wall_full:.1f} ms); at Qc={Qc} K3 vs twin {chunk_k3_rel:.2e} of max|ll|, the "
          f"adjoint " + "/".join(f"{r:.2e}" for r in chunk_grad_rel)
          + f"; device ms (profiler, 50 launches): K3 {chunk_dev['logmvn_chain']:.4f} (bound "
          f"{chunk_bound['logmvn_chain']:.4f}), adjoint {chunk_dev['logmvn_chain_grad']:.4f} "
          f"(bound {chunk_bound['logmvn_chain_grad']:.4f}) | (b) golden in "
          f"{TRAIN_GOLDEN_CHUNKS} chunks: total {gt_chunk_rel:.3e} of sum|loss| (tol "
          f"{REL_TRAIN_LOSS}), gradients " + ", ".join(f"{n} {r:.3e}"
                                                       for n, r in gt_chunk_grad.items())
          + f"; launches {path_launches['train_golden_chunked']} | (c) {TRAIN_STAGE_ITERS} + "
          f"{TRAIN_STAGE_ITERS} iterations, {len(optimizers)} optimizers: shifts "
          f"{stage_a.shift:.4f} -> {stage_b.shift:.4f} / spectrum, loss {two_values[0]:.1f} -> "
          f"{two_values[-1]:.1f}; stage B starts at {stage_b.values[0]:.3f}, stage A ended at "
          f"{stage_b.start_loss:.3f} (tol {shift_res:.3f}); {two_ms:.1f} ms an iteration, "
          f"{two_evals / (2 * TRAIN_STAGE_ITERS):.2f} evaluations an iteration, peak memory "
          f"{two_peak:.1f} MiB above the {two_held / 2**20:.1f} MiB held; one profiled "
          f"iteration: busy {two_busy_ms:.2f} ms of {two_prof_ms:.2f} ms wall "
          f"({100 * two_busy_ms / two_prof_ms:.1f}%) | (d) main at Q={TRAIN_E2E_Q}, "
          f"{TRAIN_E2E_CHUNKS} chunks, {TRAIN_E2E_ITERS} iterations: loss {traj[0]:.1f} -> "
          f"{traj[-1]:.1f}, {art['ms_per_iteration']} ms an iteration, "
          f"{art['evaluations_per_iteration']:.2f} evaluations an iteration, launches "
          f"{launches}; quality {art['model_quality_vs_generating']}; gate ({TRAIN_GATE_N} "
          f"spectra at Parameters()) {gate_numbers} | {time.perf_counter() - t20:.1f} s")

    # phase 15's numbers beside each K5 and K6 row of the kernels line
    tail_extra = {n: {"device_ms_profiler": tail_dev[n], "bound_share": tail_share[n][0],
                      "copy_rate_share": tail_share[n][1], "copy_rate_gbs": copy_gbs,
                      **({"bound_ms_padded_count": k6_old[n]} if n in k6_old else {}),
                      **({"device_ms_16_rows": tail_dev[f"{n.replace('_i16', '')}_16"
                                                        + ("_i16" if n.endswith("_i16") else "")]}
                         if n.startswith("absorption_tail") else {})}
                  for n in ("absorption_tail", "absorption_tail_i16", "absorption_windowed",
                            "absorption_windowed_i16")}
    total = {name: sum(p.get(name, 0) for p in path_launches.values())
             for name in list(KERNELS) + list(KERNELS_I16)}
    also_ablate = {
        "logmvn_flat_chain[row]": [f"{ABLATE}:367", f"{ABLATE}:459", f"{ABLATE}:468"],
        "logmvn_ablate[full]": [f"{ABLATE}:86", f"{ABLATE}:118"],
    }
    check(all(total[n] > 0 for n in KERNELS),
          f"a kernel of the paths launched no time: {[n for n in KERNELS if not total[n]]}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
         "launches": total[name], "max_abs_err": err[name],
         "ms": ms[name][0], "plain_ms": ms[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name),
         **({"device_ms": k3_device[name][0]} if name in k3_device else {}),
         **grad_extra.get(name, {}),
         **train_chunk_extra.get(name, {}),
         **({"library_ms_by_k": {f"k={k_}": t_ for k_, t_ in wide_lib.items()},
             "device_ms_by_k": {n.split()[-1]: d for n, (d, _) in wide_dev.items()
                                if n.startswith("K2")}} if name == "logmvn_cap" else {}),
         **({"launches_zqso": sum(p.get(name, 0) for n, p in path_launches.items()
                                  if "zqso" in n),
             "device_ms_zqso": k3_zqso_ms, "bound_ms_zqso": k3_zqso_bound[0],
             "max_abs_err_zqso": k3_zqso_err} if name == "logmvn_chain" else {}),
         **({"device_ms_by_rows": {n: d for n, (d, _) in k5_device.items()}}
            if name == "absorption_tail" else {}),
         **({"device_ms": k1_device[name][0], "device_ms_profiler": k1_device[name][1],
             "device_ms_lls_break": k1_device[f"{name}_lls"][0],
             "bound_ms_lls_break": bounds[f"{name}_lls"][0]} if name in k1_device else {}),
         **({"branch": "poly=False (voigt_pallas.py:357)"}
            if name == "absorption_all_weideman" else {}),
         **tail_extra.get(name, {})}
        for name, (src, rep) in KERNELS.items()
    ] + [
        {"name": name, "route": "cuda", "source": ABLATE_SOURCE, "replaces": rep,
         **({"also_replaces": also_ablate[name]} if name in also_ablate else {}),
         "launches": n, "max_abs_err": e, "ms": k, "plain_ms": t, "bound_ms": b,
         "bound_by": by, "library_ms": lib, **row_extra.get(name, {})}
        for name, k, t, (b, by), n, lib, rep, e in kernel_rows
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "branch": branch,
         "launches": total[name], "max_abs_err": err[name], "ms": ms[name][0],
         "plain_ms": ms[name][1], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name), "device_ms": dev_pairs[name][1],
         "device_ms_float32": dev_pairs[name][0],
         **({"max_dcode": codes_err[name]} if name in codes_err else {}),
         **tail_extra.get(name, {})}
        for name, (src, rep, branch) in KERNELS_I16.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
