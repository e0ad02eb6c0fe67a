"""The CIV head's batch window (``models/civ.dispatch_civ_batch`` /
``finalize_civ_batch``), its spans and its counter, and the port against
the ``civ.window`` cell's plain reference (``benchmark/reference/civ.py``)
on the cell's own generator (``benchmark/harness/gen_civ.py``), on the CPU
at a small size: S = 256 samples, k = 4, ~120 window pixels (rest
1,512-1,554 A; the normalization window moved inside it).

Tolerances:
* float64 evidences and per-sample likelihoods against the reference fed
  the same float64 inputs: 1e-9 relative (the same algorithm; only
  summation orders and the Faddeeva's terms differ);
* float32 (K5's, K2's and K3's twins) against the reference fed the same
  float32 inputs: within 1e-4 of the largest |log evidence|, the float32
  gate of ``tests/test_torch_civ.py``, and the same decision;
* ``civ_inference_many`` equal bit for bit, at windows 0, 1 and 4, to the
  new dispatch and finalize run by hand batch after batch, and to 1e-10
  relative (the single path models one spectrum, the batch all at once) to
  ``civ_log_evidences`` spectrum by spectrum;
* the benchmark's frozen copies (the preprocessing, the samples) equal the
  port's bit for bit.
"""

import json
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import gen, gen_civ  # noqa: E402
from reference import civ as ref  # noqa: E402

from gpy_dla_detection_tpu_torch.data.spectrum import Spectrum, preprocess  # noqa: E402
from gpy_dla_detection_tpu_torch.models import civ as TCIV  # noqa: E402
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel  # noqa: E402
from gpy_dla_detection_tpu_torch.ops import _build  # noqa: E402
from gpy_dla_detection_tpu_torch.params import CIVParameters  # noqa: E402
from gpy_dla_detection_tpu_torch.utils import timing  # noqa: E402
from gpy_dla_detection_tpu_torch.utils.pipeline import start_readback  # noqa: E402

torch.set_num_threads(2)

SEED = 2**31 + 2025
REL_F64 = 1e-9
REL_F64_SINGLE = 1e-10
REL_F32_EVIDENCE = 1e-4
SMALL = dict(num_civ_samples=256, k=4, min_lambda=1512.0, num_pixels_padded=128,
             normalization_min_lambda=1515.0, normalization_max_lambda=1530.0)
TRAFFIC = dict(pool=6, z_qso=[2.0, 4.5], civ_every=2, civ_log_n=14.0, civ_sigma=3e6,
               civ_z_span=[0.1, 0.9], noise_level=0.1, masked_fraction=0.01)
B = 2


@pytest.fixture(scope="module")
def case():
    cfg = dict(json.loads((BENCH / "configs" / "civ.json").read_text()), **SMALL)
    fields = set(CIVParameters.__dataclass_fields__)
    params = CIVParameters(**{k: v for k, v in cfg.items() if k in fields})
    learned = gen_civ.civ_learned_model(cfg, gen.rng_for(SEED, 1))
    pool, doublets = gen_civ.civ_pool(cfg, TRAFFIC, learned, SEED)
    return cfg, params, learned, pool, doublets, gen_civ.civ_samples(cfg)


def _port(case, dtype):
    cfg, params, learned, pool, _, samples = case
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    model = LearnedModel.from_numpy(list(learned), "cpu", dtype)
    specs = [Spectrum(*[ref.held(a, np_dt) for a in p]) for p in pool]
    return model, specs, TCIV.CIVSamples(*[ref.held(a, np_dt) for a in samples])


def _reference(case, i, inputs):
    cfg, _, learned, pool, _, samples = case
    return ref.reference_spectrum(learned, pool[i], samples, cfg, 0.5, "cpu", inputs=inputs)


def test_the_generator_makes_searchable_spectra(case):
    cfg, _, _, pool, doublets, _ = case
    assert len(pool) == TRAFFIC["pool"] and sum(d is not None for d in doublets) == 3
    for spec, civ in zip(pool, doublets):
        assert spec.flux.shape == (cfg["num_pixels_padded"],)
        assert 100 < int(spec.mask.sum()) <= 125
        assert spec.min_z_dla < spec.max_z_dla
        if civ is not None:
            assert spec.min_z_dla < civ[0] < spec.max_z_dla


def test_frozen_copies_equal_the_port(case):
    """The benchmark's preprocessing and samples are the port's, bit for bit."""
    cfg, params, learned, _, _, samples = case
    for a, b in zip(samples, TCIV.generate_civ_samples(params, cfg["num_civ_samples"],
                                                       cfg["min_sigma"], cfg["max_sigma"])):
        assert np.array_equal(a, b)
    for z in (2.0, 3.3, 4.5):
        obs = gen_civ.civ_observation(cfg, learned, z, gen.rng_for(SEED, 5), (z - 0.05, 14.0, 3e6))
        ours, port = gen_civ.civ_preprocess(cfg, *obs, z), preprocess(*obs, z, params)
        for name, a, b in zip(Spectrum._fields, ours, port):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.mark.parametrize("index", [0, 1, 3])
def test_float64_evidences_match_the_reference(case, index):
    cfg, params = case[:2]
    learned, specs, samples = _port(case, torch.float64)
    want = _reference(case, index, np.float64)
    null, civ = TCIV.civ_log_evidences(learned, specs[index], samples, params)
    model = TCIV.civ_spectrum_model(learned, specs[index], params)
    _, lls = TCIV.civ_qmc_log_evidence(model, samples, params)
    np.testing.assert_allclose(float(null), want.null, rtol=REL_F64)
    np.testing.assert_allclose(float(civ), want.civ, rtol=REL_F64)
    np.testing.assert_allclose(lls.numpy(), want.sample_lls, rtol=REL_F64)


@pytest.mark.parametrize("index", [0, 1, 5])
def test_float32_evidences_match_the_reference(case, index):
    """float32 runs K5's, K2's and K3's twins; within the float32 gate of the
    reference on the same float32 inputs, and the same decision."""
    cfg, params, _, _, doublets, _ = case
    learned, specs, samples = _port(case, torch.float32)
    want = _reference(case, index, np.float32)
    null, civ = (float(x) for x in TCIV.civ_log_evidences(learned, specs[index], samples, params))
    scale = max(abs(want.null), abs(want.civ))
    assert abs(null - want.null) <= REL_F32_EVIDENCE * scale
    assert abs(civ - want.civ) <= REL_F32_EVIDENCE * scale
    found = TCIV.civ_model_posterior(null, civ) > 0.5
    assert found == (TCIV.civ_model_posterior(want.null, want.civ) > 0.5)
    assert found == (doublets[index] is not None)


def _by_hand(learned, specs, samples, params):
    """The new dispatch and finalize, one batch after the other."""
    t = TCIV.civ_sample_tensors(samples, learned)
    out = []
    for s in range(0, len(specs), B):
        evidences, _ = start_readback(
            TCIV.dispatch_civ_batch(learned, specs[s:s + B], t, params)).result()
        out += TCIV.finalize_civ_batch(evidences)
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_inference_many_is_the_dispatch_and_finalize(case, dtype):
    params = case[1]
    learned, specs, samples = _port(case, dtype)
    want = _by_hand(learned, specs, samples, params)
    for window in (0, 1, 4):
        got = TCIV.civ_inference_many(learned, iter(specs), samples, params, batch_size=B,
                                      max_in_flight=window)
        assert got == want, window
    for spec, (p, null, civ) in zip(specs, want):
        ne, ce = TCIV.civ_log_evidences(learned, spec, samples, params)
        np.testing.assert_allclose([null, civ], [float(ne), float(ce)], rtol=REL_F64_SINGLE
                                   if dtype == torch.float64 else REL_F32_EVIDENCE)
        assert p == TCIV.civ_model_posterior(null, civ)


def test_sample_lls_read_back(case):
    """A batch's dispatch gives each spectrum's (S,) likelihoods, those of
    :func:`civ_qmc_log_evidence`."""
    params = case[1]
    learned, specs, samples = _port(case, torch.float64)
    t = TCIV.civ_sample_tensors(samples, learned)
    out = TCIV.dispatch_civ_batch(learned, specs[:B], t, params)
    evidences, lls = start_readback(out).result()
    assert lls.shape == (B, params.num_civ_samples)
    for i in range(B):
        model = TCIV.civ_spectrum_model(learned, specs[i], params)
        civ, want = TCIV.civ_qmc_log_evidence(model, t, params)
        np.testing.assert_allclose(lls[i], want.numpy(), rtol=REL_F64_SINGLE)
        np.testing.assert_allclose(evidences[1, i], float(civ), rtol=REL_F64_SINGLE)


TREE = {"gpy.civ_dispatch": 1, "gpy.civ_model": 1, "gpy.civ_profile": B,
        "gpy.civ_likelihood": B, "gpy.civ_finalize": 1}
PARENT = {"gpy.civ_dispatch": None, "gpy.civ_model": "gpy.civ_dispatch",
          "gpy.civ_profile": "gpy.civ_dispatch", "gpy.civ_likelihood": "gpy.civ_dispatch",
          "gpy.civ_finalize": None}


def test_civ_spans_names_and_nesting(case):
    params = case[1]
    learned, specs, samples = _port(case, torch.float32)
    t = TCIV.civ_sample_tensors(samples, learned)
    with timing.recording() as recorded:
        evidences, _ = TCIV.dispatch_civ_batch(learned, specs[:B], t, params)
        TCIV.finalize_civ_batch(evidences.numpy())
    assert recorded.dropped == 0
    assert Counter(s[0] for s in recorded) == TREE
    for s in recorded:
        parent = recorded[s[2]] if s[2] >= 0 else None
        assert (parent[0] if parent else None) == PARENT[s[0]], s
        if parent is not None:
            assert parent[1] == s[1] and parent[3] <= s[3] and s[4] <= parent[4]
    assert {s[1] for s in recorded} == {threading.get_native_id()}
    # each spectrum's profile comes before its likelihood
    order = [s[0] for s in recorded if s[0] in ("gpy.civ_profile", "gpy.civ_likelihood")]
    assert order == ["gpy.civ_profile", "gpy.civ_likelihood"] * B
    with timing.recording() as recorded:
        TCIV.civ_inference_many(learned, specs, samples, params, batch_size=B)
    assert Counter(s[0] for s in recorded) == {k: v * len(specs) // B for k, v in TREE.items()}


def test_civ_profile_counts_nothing_on_the_cpu(case):
    """The counter counts the doublet's evaluations on the card, where K5's
    kernel launches; on the CPU, float32 (the twins) or float64, nothing."""
    params = case[1]
    for dtype in (torch.float32, torch.float64):
        learned, specs, samples = _port(case, dtype)
        _build.reset_launch_counts()
        TCIV.civ_inference_many(learned, specs, samples, params, batch_size=B)
        assert not any(_build.launch_counts.values()), dtype


@pytest.mark.gpu
def test_civ_profile_counts_one_a_spectrum_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 runs only on the card")
    params = case[1]
    learned, specs, samples = _port(case, torch.float32)
    _build.reset_launch_counts()
    TCIV.civ_inference_many(learned.to("cuda"), specs, samples, params, batch_size=B)
    torch.cuda.synchronize()
    assert _build.launch_counts["civ_profile"] == len(specs)
    assert _build.launch_counts["absorption_tail"] == len(specs)
