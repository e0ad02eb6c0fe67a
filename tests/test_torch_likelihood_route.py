"""The float32 likelihood's route at any GP basis width, against the JAX
package.

* The kernels' geometry: K2 launches one block of every column where it
  holds the bases (``cap_geometry``; k <= 53 packed at N = 1,280) and
  column slices beyond (``sliced_cap_geometry``), in both storages and
  with chained streams; K3 its warp chain up to k = 64
  (``chain_geometry``) and its wide chain beyond
  (``wide_chain_geometry``); every basis column is staged and stored by
  exactly one thread of one slice.
* ``batched_log_mvnpdf`` in float32 at k = 54 and 65, on the CPU through
  K2's and K3's twins (the default) and through the plain composition
  (``use_kernels=False``), against the JAX package's ``use_pallas=False``
  composition in float32 and against float64: the port's error against
  float64 may reach 1.5x the larger of the JAX composition's own and the
  reference's float32 budget scaled to these inputs (3.8e-3 on |ll| ~
  1.1e4; ops/logmvn_pallas.py:206-210), and the port and the JAX float32
  composition agree in the bulk (median within 2e-6 of the largest |ll|),
  as tests/test_torch_logmvn.py holds the twins.  The composition is the
  CPU path: a tensor off the CPU refuses it.
The kernels at these widths are held in tests/test_torch_kernels_gpu.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu.ops import logmvn as J
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops import logmvn as T
from gpy_dla_detection_tpu_torch.ops._build import CSRC, MAX_DYNAMIC_SHARED_BYTES
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    CAP_MAX_THREADS,
    CAP_TILE,
    CAP_WARP_COLUMNS,
    CAP_WARP_SAMPLES,
    CHAIN_MAX_K,
    WIDE_CHAIN_THREADS,
    ChainGeometry,
    WideChainGeometry,
    cap_geometry,
    k2_geometry,
    k3_geometry,
    sliced_cap_geometry,
    wide_chain_geometry,
)

torch.set_num_threads(2)

REL_VS_JAX = 2e-6
REL_F32_BUDGET = 3.8e-3 / 1.1e4
K2_MAX_K = 53  # the widest packed basis one K2 block holds at N = 1,280


@pytest.mark.parametrize("store", [torch.float32, torch.int16])
@pytest.mark.parametrize("k", [20, 53, 54, 64, 65])
def test_route_follows_the_kernels_geometry(k, store):
    """k <= 53: one K2 block holds every column at the catalog's N = 1,280
    (also with 3 chained streams and at the LLS search's N = 1,664 and the
    CIV head's 768), the geometry K2 had; 54 and beyond: column slices.
    K3: the warp chain up to 64, the wide chain beyond."""
    kp = k * (k + 1) // 2
    elem = 2 if store == torch.int16 else 4
    for N in (1280, 1664, 768):
        for n_extra in (0, 3):
            for S in (1, 16, 10_000):
                g = k2_geometry(S, N, k, kp, n_extra, elem=elem)
                if k <= K2_MAX_K:
                    assert g == cap_geometry(S, N, k, kp, n_extra, elem=elem)
                    assert g.slices == 1 and g.slice_columns == g.columns
                else:
                    assert g == sliced_cap_geometry(S, N, k, kp, n_extra, elem=elem)
                    assert g.slices >= 2
    if k > K2_MAX_K:
        with pytest.raises(ValueError):
            cap_geometry(10_000, 1280, k, kp, 0, elem=elem)
    g3 = k3_geometry(10_000, k)
    if k <= CHAIN_MAX_K:
        assert isinstance(g3, ChainGeometry) and g3.rows >= k
    else:
        assert isinstance(g3, WideChainGeometry) and g3.threads == WIDE_CHAIN_THREADS


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("k, basis", [(54, "packed"), (65, "packed"), (100, "packed"),
                                      (341, "packed"), (40, "flat")])
def test_sliced_blocks_cover_every_column_once(k, basis, elem):
    """Every slice is launchable (whole warps within the thread bound,
    shared bytes within the card's), the slices cover the padded columns,
    and each pair-basis and M column is staged, multiplied and stored by
    exactly one thread tile of one slice, at the column the kernel's
    staging (``cap_block::run``) puts it and its epilogue stores it."""
    kp = k * (k + 1) // 2 if basis == "packed" else k * k
    gp = -(-kp // CAP_TILE)
    for S, n_extra in ((1, 0), (10_000, 3)):
        g = sliced_cap_geometry(S, 1280, k, kp, n_extra, elem=elem)
        ncb = g.slice_columns
        assert ncb % CAP_WARP_COLUMNS == 0 and ncb <= g.columns
        assert g.slices == -(-g.columns // ncb) and g.columns >= kp + k
        assert g.threads % 32 == 0 and g.threads <= CAP_MAX_THREADS
        assert g.threads == 32 * (g.samples // CAP_WARP_SAMPLES) * (ncb // CAP_WARP_COLUMNS)
        assert g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES and g.pixels == 16
        assert g.samples * g.grid >= S > g.samples * (g.grid - 1)
        wc = ncb // CAP_WARP_COLUMNS
        stored = {"B": [], "u": []}
        for y in range(g.slices):
            col0 = y * ncb
            # the thread tiles of one sample group row: each local column
            # group once
            lcgs = sorted((w % wc) * 16 + lane % 16 for w in range(g.threads // 32)
                          for lane in range(32) if (w // wc) * 2 + lane // 16 == 0)
            assert lcgs == list(range(ncb // CAP_TILE))
            for lcg in lcgs:
                cg = col0 // CAP_TILE + lcg
                for j in range(CAP_TILE):
                    c = cg * CAP_TILE + j  # staged from, and stored to, column c
                    if cg < gp:
                        if c < kp:
                            stored["B"].append(c)
                    elif c - gp * CAP_TILE < k:
                        stored["u"].append(c - gp * CAP_TILE)
        assert sorted(stored["B"]) == list(range(kp))
        assert sorted(stored["u"]) == list(range(k))


def test_wide_chain_geometry():
    """The triangle and u in shared memory while they fit a block (k <=
    339), in a global workspace beyond; no more blocks than samples; the
    kernel's block size is the one Python assumes."""
    for k in (65, 100, 339):
        g = wide_chain_geometry(10_000, k)
        assert g.workspace == 0 and g.shared_bytes >= 4 * (k * (k + 1) // 2 + k)
        assert g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES and g.grid <= 10_000
    g = wide_chain_geometry(10_000, 340)
    assert g.shared_bytes == 0 and g.workspace == 340 * 341 // 2 + 340
    assert wide_chain_geometry(7, 65).grid == 7
    src = (Path(CSRC) / "logmvn_chain.cu").read_text()
    assert int(re.search(r"constexpr int kWideThreads = (\d+);", src).group(1)) == \
        WIDE_CHAIN_THREADS


@pytest.mark.parametrize("S, N, k", [(0, 1280, 20), (10, 0, 20), (10, 1280, 0)])
def test_route_refuses_an_empty_problem(S, N, k):
    with pytest.raises(ValueError):
        sliced_cap_geometry(S, N, k, k * (k + 1) // 2)
    # the wide chain: no samples, or a k the warp chain takes
    with pytest.raises(ValueError):
        wide_chain_geometry(S, CHAIN_MAX_K + 1) if S == 0 else wide_chain_geometry(S, k)


def _problem(N=300, k=54, S=72, n_extra=0, seed=7):
    rng = np.random.default_rng(seed)
    M = (rng.normal(size=(N, k)) / np.sqrt(k) * 0.1).astype(np.float32)
    y = (1 + 0.1 * rng.normal(size=N)).astype(np.float32)
    mu = np.ones(N, np.float32)
    omega2 = rng.uniform(0.01, 0.05, N).astype(np.float32)
    v = rng.uniform(0.02, 0.1, N).astype(np.float32)
    mask = rng.uniform(size=N) > 0.1
    A = np.exp(-rng.random((S, N))).astype(np.float32)
    extra = [np.exp(-0.3 * rng.random((S, N))).astype(np.float32) for _ in range(n_extra)]
    return (y, mu, M, omega2, v, mask), A, extra


def _jax(base, A, extra, dtype):
    cast = lambda x: jnp.asarray(x.astype(dtype) if x.dtype != bool else x)
    prod = np.prod(np.stack(extra), axis=0) if extra else None
    return np.asarray(J.batched_log_mvnpdf(
        *[cast(x) for x in base], cast(A), use_pallas=False,
        extra=None if prod is None else cast(prod)))


@pytest.mark.parametrize("use_kernels", [False, None])
@pytest.mark.parametrize("n_extra", [0, 3])
@pytest.mark.parametrize("k", [54, 65])
def test_composition_matches_jax_at_a_wide_basis(k, n_extra, use_kernels):
    """The composition (False) and the kernels' twins (None) alike."""
    base, A, extra = _problem(k=k, n_extra=n_extra)
    before = _build.launch_counts["logmvn_composition"]
    got = T.batched_log_mvnpdf(*[torch.as_tensor(x) for x in base], torch.as_tensor(A),
                               extra=[torch.as_tensor(e) for e in extra],
                               use_kernels=use_kernels)
    assert _build.launch_counts["logmvn_composition"] == before + (use_kernels is False)
    assert got.dtype == torch.float32 and got.shape == (A.shape[0],)
    got = got.numpy().astype(np.float64)
    f64 = _jax(base, A, extra, np.float64)
    j32 = _jax(base, A, extra, np.float32).astype(np.float64)
    scale = np.abs(f64).max()
    err, err_jax = np.abs(got - f64).max(), np.abs(j32 - f64).max()
    assert err <= 1.5 * max(err_jax, REL_F32_BUDGET * scale), (err, err_jax, scale)
    assert np.median(np.abs(got - j32)) <= REL_VS_JAX * scale


@pytest.mark.parametrize("k", [54, 65])
def test_composition_on_int16_codes_matches_float64(k):
    """int16-stored profiles reach the composition as codes and are decoded
    on entry, as the reference's ``_decode`` does."""
    base, A, extra = _problem(k=k, n_extra=2)
    code = lambda x: torch.round(torch.as_tensor(x) * 32767.0).to(torch.int16)
    got = T.batched_log_mvnpdf(*[torch.as_tensor(x) for x in base], code(A),
                               extra=[code(e) for e in extra],
                               use_kernels=False).numpy().astype(np.float64)
    dec = lambda c: c.numpy().astype(np.float64) / 32767.0
    f64 = _jax(base, dec(code(A)), [dec(code(e)) for e in extra], np.float64)
    assert np.abs(got - f64).max() <= 2 * REL_F32_BUDGET * np.abs(f64).max()


def test_kernels_route_at_the_main_path_takes_no_composition():
    """k = 20: the default route runs K2's and K3's twins on the CPU (no
    composition); use_kernels=False takes the composition, which agrees."""
    base, A, extra = _problem(k=20, n_extra=3)
    args = ([torch.as_tensor(x) for x in base], torch.as_tensor(A),
            [torch.as_tensor(e) for e in extra])
    before = _build.launch_counts["logmvn_composition"]
    ll = T.batched_log_mvnpdf(*args[0], args[1], extra=args[2])
    assert _build.launch_counts["logmvn_composition"] == before
    plain = T.batched_log_mvnpdf(*args[0], args[1], extra=args[2], use_kernels=False)
    assert _build.launch_counts["logmvn_composition"] == before + 1
    scale = float(ll.abs().max())
    assert float((ll - plain).abs().median()) <= REL_VS_JAX * scale


def test_composition_refuses_a_tensor_off_the_cpu():
    """On the card the likelihood runs K2 and K3 at any width: the plain
    composition refuses a tensor that is not on the CPU (here the meta
    device, which stands for one without a card)."""
    base, A, _ = _problem(k=54, S=8, N=32)
    meta = [torch.as_tensor(x).to("meta") for x in base]
    with pytest.raises(ValueError):
        T.batched_log_mvnpdf(*meta, torch.as_tensor(A).to("meta"), use_kernels=False)


def test_float64_refuses_the_kernels():
    base, A, _ = _problem(k=5)
    b64 = [torch.as_tensor(x.astype(np.float64) if x.dtype != bool else x) for x in base]
    with pytest.raises(TypeError):
        T.batched_log_mvnpdf(*b64, torch.as_tensor(A.astype(np.float64)), use_kernels=True)


def _entry_runs(use_kernels):
    """The batch, LLS and CIV entries on small float32 CPU inputs (k = 8),
    each with the composition's count around it."""
    from gpy_dla_detection_tpu_torch.data.samples import (
        generate_dla_samples,
        generate_subdla_samples,
    )
    from gpy_dla_detection_tpu_torch.data.synthetic import (
        synthetic_civ_spectrum,
        synthetic_learned_model,
        synthetic_prior_catalog,
        synthetic_spectrum,
    )
    from gpy_dla_detection_tpu_torch.models import civ as TCIV
    from gpy_dla_detection_tpu_torch.models import lls as TL
    from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
    from gpy_dla_detection_tpu_torch.params import CIVParameters, Parameters
    from gpy_dla_detection_tpu_torch.parallel.batch import process_batch

    params = Parameters(num_dla_samples=64, k=8)
    arrays = synthetic_learned_model(params)
    learned = LearnedModel.from_numpy(arrays, "cpu", torch.float32)
    spectra = [synthetic_spectrum(params, arrays, 3.1, seed=0, dlas=[(2.8, 21.2)])]
    counts, out = {}, {}
    c0 = _build.launch_counts["logmvn_composition"]
    out["batch"] = process_batch(
        learned, spectra, generate_dla_samples(params), generate_subdla_samples(params),
        synthetic_prior_catalog(params), params, torch.Generator().manual_seed(0), max_dlas=3,
        use_kernels=use_kernels)[0].log_evidences_dla
    counts["batch"] = _build.launch_counts["logmvn_composition"] - c0
    c0 = _build.launch_counts["logmvn_composition"]
    out["lls"] = TL.lls_inference_many(
        TL.with_boss_meanflux(learned), spectra, TL.generate_lya_samples(64),
        torch.Generator().manual_seed(0), 2, params, use_kernels=use_kernels)[0][1].log_evidences
    counts["lls"] = _build.launch_counts["logmvn_composition"] - c0
    civ_params = CIVParameters(num_civ_samples=64, k=8)
    civ_arrays = synthetic_learned_model(civ_params)
    c0 = _build.launch_counts["logmvn_composition"]
    out["civ"] = np.array(TCIV.civ_inference_many(
        LearnedModel.from_numpy(civ_arrays, "cpu", torch.float32),
        [synthetic_civ_spectrum(civ_params, civ_arrays, 2.5, seed=1)],
        TCIV.generate_civ_samples(civ_params), civ_params, use_kernels=use_kernels)[0][1:])
    counts["civ"] = _build.launch_counts["logmvn_composition"] - c0
    return counts, out


def test_entries_thread_use_kernels():
    """``use_kernels=False`` reaches every likelihood call of the batch
    entry (3 DLA levels and the subDLA level), the LLS search (2 levels)
    and the CIV head (1); the default takes the kernels' twins at k = 8
    and agrees."""
    counts, plain = _entry_runs(False)
    assert counts == {"batch": 4, "lls": 2, "civ": 1}
    counts, kernels = _entry_runs(None)
    assert counts == {"batch": 0, "lls": 0, "civ": 0}
    for name in plain:
        a, b = np.asarray(plain[name], np.float64), np.asarray(kernels[name], np.float64)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=name)
