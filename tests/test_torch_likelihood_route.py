"""The float32 likelihood's route at any GP basis width, against the JAX
package.

* The kernels' geometry: K2 launches one block of every column where it
  holds the bases (``cap_geometry``; k <= 53 packed at N = 1,280) and its
  wide kernel's tiles beyond (``wide_cap_geometry``), in both storages and
  with chained streams; K3 its warp chain up to k = 64
  (``chain_geometry``) and its wide chain beyond
  (``wide_chain_geometry``, a warp a sample); every basis column is staged
  and stored by exactly one thread of one column tile, and the wide
  kernel's ring never hands a stage to a copy while it is read.  The wide
  chain's walk (its offsets, passes and padding) is replayed in numpy
  against K3's twin, every read inside the warp's buffer.
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
    CHAIN_MAX_K,
    WIDE_CAP_COLUMNS,
    WIDE_CAP_PIXELS,
    WIDE_CAP_SAMPLES,
    WIDE_CAP_STAGES,
    WIDE_CAP_THREADS,
    WIDE_CAP_WARP_COLUMNS,
    WIDE_CHAIN_PAD,
    WIDE_CHAIN_THREADS,
    WIDE_CHAIN_WARPS,
    ChainGeometry,
    WideCapGeometry,
    WideChainGeometry,
    cap_geometry,
    k2_geometry,
    k3_geometry,
    logmvn_chain_reference,
    wide_cap_basis,
    wide_cap_geometry,
    wide_chain_buffer_floats,
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
    CIV head's 768), the geometry K2 had; 54 and beyond: the wide kernel's
    tiles.  K3: the warp chain up to 64, the wide chain (a warp a sample,
    in shared memory) beyond."""
    kp = k * (k + 1) // 2
    elem = 2 if store == torch.int16 else 4
    for N in (1280, 1664, 768):
        for n_extra in (0, 3):
            for S in (1, 16, 10_000):
                g = k2_geometry(S, N, k, kp, n_extra, elem=elem)
                if k <= K2_MAX_K:
                    assert g == cap_geometry(S, N, k, kp, n_extra, elem=elem)
                else:
                    assert isinstance(g, WideCapGeometry)
                    assert g == wide_cap_geometry(S, N, k, kp, n_extra, elem=elem)
    if k > K2_MAX_K:
        with pytest.raises(ValueError):
            cap_geometry(10_000, 1280, k, kp, 0, elem=elem)
    g3 = k3_geometry(10_000, k)
    if k <= CHAIN_MAX_K:
        assert isinstance(g3, ChainGeometry) and g3.rows >= k
    else:
        assert isinstance(g3, WideChainGeometry) and g3.workspace == 0
        assert g3.threads == 32 * WIDE_CHAIN_WARPS


def _wide_cap_stores(g, k, kp):
    """The B and u columns each thread of the wide kernel stores, walked as
    its epilogue walks them (csrc/logmvn_cap_wide.cu): a tile's 4 warps
    across, a warp's 32 columns, each checked against the column of the
    padded basis (``wide_cap_basis``) its staging reads for it."""
    kpp = g.pair_columns
    # a basis whose every column names itself: pair column c holds c + 1,
    # M column j holds -(j + 1)
    M = -torch.arange(1, k + 1, dtype=torch.float32)[None].repeat(2, 1)
    Mp = torch.arange(1, kp + 1, dtype=torch.float32)[None].repeat(2, 1)
    P = wide_cap_basis(M, Mp, g)
    assert P.shape == (2, g.columns) and P.shape[1] % 4 == 0
    assert int((P != 0).sum()) == 2 * (kp + k)
    stored = {"B": [], "u": []}
    for t in range(g.tiles):
        col0 = t * WIDE_CAP_COLUMNS
        for wn in range(WIDE_CAP_COLUMNS // WIDE_CAP_WARP_COLUMNS):
            wc0 = col0 + wn * WIDE_CAP_WARP_COLUMNS
            warp_r = wc0 >= kpp
            if not (wc0 < kpp + k and (warp_r or wc0 < kp)):
                continue  # a warp of padding stores nothing
            for c in range(wc0, wc0 + WIDE_CAP_WARP_COLUMNS):
                # the column of P staged for padded column c
                v = int(P[0, c])
                src = ("B", v - 1) if v > 0 else ("u", -v - 1) if v < 0 else None
                if not warp_r and c < kp:
                    assert src == ("B", c)
                    stored["B"].append(c)
                elif warp_r and c - kpp < k:
                    assert src == ("u", c - kpp)
                    stored["u"].append(c - kpp)
    return stored


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("k, basis", [(54, "packed"), (65, "packed"), (100, "packed"),
                                      (341, "packed"), (40, "flat")])
def test_sliced_blocks_cover_every_column_once(k, basis, elem):
    """The wide kernel's column tiles (the slices of B | u its blocks take):
    every block launchable (the kernel's threads, shared bytes within the
    card's), each warp's 32 columns on one side of the padded pair basis
    (one operand, w or r, a warp), the tiles covering the columns, a block
    for every sample tile and column tile, and each pair-basis and M column
    staged, multiplied and stored by exactly one thread of one tile, at the
    column the kernel's staging reads it from."""
    kp = k * (k + 1) // 2 if basis == "packed" else k * k
    for S, n_extra in ((1, 0), (10_000, 3)):
        g = wide_cap_geometry(S, 1280, k, kp, n_extra, elem=elem)
        assert g.threads == WIDE_CAP_THREADS and g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES
        assert g.samples == WIDE_CAP_SAMPLES and g.pixels == WIDE_CAP_PIXELS
        assert g.pair_columns % WIDE_CAP_WARP_COLUMNS == 0
        assert kp <= g.pair_columns < kp + WIDE_CAP_WARP_COLUMNS
        assert g.columns == g.tiles * WIDE_CAP_COLUMNS
        assert g.columns - WIDE_CAP_COLUMNS < g.pair_columns + k <= g.columns
        assert g.grid == -(-S // WIDE_CAP_SAMPLES) * g.tiles
        stored = _wide_cap_stores(g, k, kp)
        assert sorted(stored["B"]) == list(range(kp))
        assert sorted(stored["u"]) == list(range(k))


def test_wide_cap_constants_match_the_kernel():
    """The .cu's tile, chunk, warps and stages are the ones Python's
    geometry assumes, and its shared layout is Python's byte count."""
    src = (Path(CSRC) / "logmvn_cap_wide.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    macro = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))
    bm, bn = macro("CAP_WIDE_BM"), macro("CAP_WIDE_BN")
    assert bm == WIDE_CAP_SAMPLES and bn == WIDE_CAP_COLUMNS
    assert const("kBK") == WIDE_CAP_PIXELS and macro("CAP_WIDE_STAGES") == WIDE_CAP_STAGES
    assert 32 * const("kWarps") == WIDE_CAP_THREADS
    # a warp's tile is 32 x 32: kWarpsM = bm / 32, kWarpsN = kWarps / kWarpsM
    assert bn // (const("kWarps") // (bm // 32)) == WIDE_CAP_WARP_COLUMNS
    # float32 and int16 streams, 0-3 extra: the basis ring, the split w | r
    # tile, the rows' ring, the stream ring, as shipped and as the sweep's
    # other builds
    for samples, columns, stages in ((bm, bn, WIDE_CAP_STAGES), (64, 256, 5), (128, 128, 3)):
        for elem in (4, 2):
            for n_extra in range(4):
                floats = (stages * 16 * (columns + 8) + 2 * 4 * 16 * (samples + 8)
                          + stages * 5 * 16)
                want = 4 * floats + elem * stages * (1 + n_extra) * samples * (16 + 16 // elem)
                g = wide_cap_geometry(1, 1280, 54, 1485, n_extra, elem, samples, columns,
                                      stages)
                assert g.shared_bytes == want <= MAX_DYNAMIC_SHARED_BYTES


@pytest.mark.parametrize("stages", [WIDE_CAP_STAGES, 5])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 80, 81])
def test_wide_cap_ring_never_hands_out_a_stage_in_use(n_chunks, stages):
    """Replay the wide kernel's schedule (csrc/logmvn_cap_wide.cu) for a
    ring of ``stages``: iteration c (from -stages; those before -1 only
    issue) issues chunk c + stages's streams and c + stages - 1's basis in
    one group after its barrier, assembles chunk c + 1 from its streams,
    multiplies chunk c's basis, and waits until at most stages - 2 groups
    are pending.  Every read finds its chunk landed, in a stage no later
    copy has claimed, and no copy goes to a stage before its last reader has
    passed a barrier."""
    n_groups, landed = 0, 0
    stage = {"s": {}, "b": {}}  # stage -> (chunk, its group)
    last_read = {"s": {}, "b": {}}  # stage -> the iteration that read it last

    def issue(kind, chunk, it):
        slot = chunk % stages
        if slot in last_read[kind]:
            # its last reader ran in an earlier iteration: a barrier between
            assert last_read[kind][slot] < it, (kind, chunk, it)
        stage[kind][slot] = (chunk, n_groups)

    def read(kind, chunk, it):
        got, group = stage[kind][chunk % stages]
        assert got == chunk and group < landed, (kind, chunk, it)
        last_read[kind][chunk % stages] = it

    for c in range(-stages, n_chunks):
        if 0 <= c + stages < n_chunks:
            issue("s", c + stages, c)
        if 0 <= c + stages - 1 < n_chunks:
            issue("b", c + stages - 1, c)
        n_groups += 1
        if c >= -1:
            if c + 1 < n_chunks:
                read("s", c + 1, c)
            if c >= 0:
                read("b", c, c)
        if c >= -2:
            landed = n_groups - (stages - 2)  # cp.async.wait_group stages - 2
    assert last_read["b"][(n_chunks - 1) % stages] == n_chunks - 1


def test_wide_chain_geometry():
    """A warp a sample with its buffer in shared memory while it fits a
    block (k <= 339), as many warps a block as fit (up to the kernel's
    eight) and every warp an even share of the samples; the global
    workspace's block a sample beyond; the kernels' constants the ones
    Python assumes."""
    for k in (65, 100, 339):
        g = wide_chain_geometry(10_000, k)
        buf = 4 * wide_chain_buffer_floats(k)
        assert buf >= 4 * (k * (k + 1) // 2 + 3 + WIDE_CHAIN_PAD + k)
        assert g.workspace == 0 and g.threads % 32 == 0
        warps = g.threads // 32
        assert 1 <= warps <= WIDE_CHAIN_WARPS and g.shared_bytes == warps * buf
        assert g.shared_bytes <= MAX_DYNAMIC_SHARED_BYTES and g.shared_bytes % (16 * warps) == 0
        assert warps == min(WIDE_CHAIN_WARPS, MAX_DYNAMIC_SHARED_BYTES // buf)
        assert g.grid * warps <= 10_000
    assert wide_chain_geometry(10_000, 65).threads == 32 * WIDE_CHAIN_WARPS
    assert wide_chain_geometry(10_000, 339).threads == 32  # one warp's buffer a block
    g = wide_chain_geometry(10_000, 340)
    assert g.shared_bytes == 0 and g.workspace == 340 * 341 // 2 + 340
    assert g.threads == WIDE_CHAIN_THREADS
    g = wide_chain_geometry(7, 65)
    assert g.grid == 1 and g.threads // 32 >= 7  # every sample its own warp
    src = (Path(CSRC) / "logmvn_chain.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kWideThreads") == WIDE_CHAIN_THREADS
    assert const("kWideWarps") == WIDE_CHAIN_WARPS and const("kWidePad") == WIDE_CHAIN_PAD


def _wide_chain_walk(tri, u, k, shift):
    """The wide warp chain (csrc/logmvn_chain.cu) replayed in float32 on a
    buffer laid out as the kernel's, the triangle at ``shift``, a pass's
    32 lanes of a slot as one vector.  Returns quad, logdet and the largest
    index a read reached."""
    f = np.float32
    kp = k * (k + 1) // 2
    tri_floats = wide_chain_buffer_floats(k) - 4 * -(-k // 4)
    buf = np.full(tri_floats, np.nan, f)
    buf[shift:shift + kp] = tri
    uu = u.astype(f).copy()
    lanes = np.arange(32)
    top = 0
    quad, logdet = f(0), f(0)
    offj = 0
    for j in range(k):
        colj = shift + offj - j  # entry (a, j) at colj + a
        for r0 in range(j, k, 128):
            rows = [r0 + 32 * q + lanes for q in range(4) if r0 + 32 * q < k]
            x = [buf[colj + a] + (a == j).astype(f) for a in rows]
            top = max([top] + [int(colj + a.max()) for a in rows])
            colc = shift
            for c in range(j):
                l_ = buf[colc + j]
                x = [(xi - buf[colc + a] * l_).astype(f) for xi, a in zip(x, rows)]
                top = max([top] + [int(colc + a.max()) for a in rows])
                colc += k - 1 - c
            if r0 == j:
                d = x[0][0]
                inv = f(1.0 / np.sqrt(np.float64(d)))
                t = f(uu[j] * inv)
            for xi, a in zip(x, rows):
                ok = a < k
                lv = (xi * inv).astype(f)
                buf[colj + a[ok]] = lv[ok]
                later = ok & (a > j)
                uu[a[later]] = (uu[a[later]] - t * lv[later]).astype(f)
        quad = f(quad + t * t)
        logdet = f(logdet + np.log(d))
        offj += k - j
    return quad, logdet, top


@pytest.mark.parametrize("k, shift", [(65, 0), (65, 3), (150, 1), (339, 2)])
def test_wide_chain_walk_matches_the_twin_inside_its_buffer(k, shift):
    """k = 65 (one pass a step), 150 (two passes while more than 128 rows
    remain), 339 (the widest buffer in shared memory), at alignment shifts
    up to 3: every read stays inside the triangle's region of the warp's
    buffer (the padding a pass's lanes past k - 1 read included), and the
    likelihood agrees with K3's twin."""
    rng = np.random.default_rng(k)
    G = rng.normal(size=(64, k)) / np.sqrt(64) * 0.3
    full = (G.T @ G).astype(np.float32)
    tri = np.concatenate([full[j:, j] for j in range(k)]).astype(np.float32)
    u = rng.normal(size=k).astype(np.float32)
    quad, logdet, top = _wide_chain_walk(tri, u, k, shift)
    tri_floats = wide_chain_buffer_floats(k) - 4 * -(-k // 4)
    assert shift + k * (k + 1) // 2 <= top < tri_floats
    ll = float(logmvn_chain_reference(torch.from_numpy(tri)[None], torch.from_numpy(u)[None],
                                      torch.zeros((1, 2)))[0])
    got = -0.5 * (-float(quad) + float(logdet))
    assert abs(got - ll) <= 1e-6 * max(1.0, abs(ll)), (got, ll)


@pytest.mark.parametrize("S, N, k", [(0, 1280, 20), (10, 0, 20), (10, 1280, 0)])
def test_route_refuses_an_empty_problem(S, N, k):
    with pytest.raises(ValueError):
        wide_cap_geometry(S, N, k, k * (k + 1) // 2)
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
