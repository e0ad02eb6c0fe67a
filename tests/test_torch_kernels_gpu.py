"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without them.
The file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances, tightened from the ported kernels' budgets (1e-5; 2e-6 |ll|)
to what the card measures (2.4e-7; 3.7e-7 |ll|): K1 <= 2e-6 absolute, with
and without the Lyman-limit break, at 1, 3, 8 and 31 lines, P = 7 to 1,670,
F = 1 to 7 and S = 1 to 10,000; K1 with poly=False (the Weideman window)
<= 5e-4 absolute and, against the float64 exact profile, within 1.5x the
twin's own error or 1e-4; K5 and K6 <= 1e-6 absolute (K5
measured 2.4e-7), at 1, 16, 20, 1,001 and 10,000 rows, K5 at P = 7 to
1,670 (the CIV head's 774, the catalog's 1,286, the LLS search's 1,670,
rows aligned to 16, 8 and 4 bytes) and beyond a block's shared memory, K6
with 3 and 8 lines and with windows clipped at the row's end; K2 and K3
|dll| <= 1e-6 |ll|, with
|ll| the largest magnitude of the sample set, at the main path's even
k = 20 and at odd k (the rank-1 chain variant's case); K2 also at the
narrow bases k = 1, 4, 5 (packed) and 4 (flat), at S = 1, 79, 81 and
10,000 and at N = 768 and 1,664; K3 also on both sides of each of its row
bounds and of a half warp, k = 1 to 41, at S = 1 to 10,000, and with NaN
where its twin gives NaN (a capacitance that is not positive definite).  K2 is isolated by passing both
stage-A outputs through the same (twin) chain, K3 by passing the same
stage-A outputs through kernel and twin; K2 also at the main path's
shapes, through the block it shares with K7's stage kernel.  K7's kernels
(the ablation's stage kernel and flat chain, K2 with the flat basis) are
held to the same 1e-6 |ll| where the value is a likelihood, and to 2e-6
of the largest |value| for the stages that stop early; ``chain_nodot``
(wrong on purpose) must give NaN where its twin does.  The stage kernel at
k = 1, 4, 5, 20, 24 and the largest k its block holds (53 at N = 1,280),
at S = 1, 79, 80, 81, 1,001 and 10,000, N = 17, 1,280 and 1,281, and its
refusal one past; the flat chain at k = 1 to 64 in both layouts, with NaN
where its twin gives NaN, and its refusal at k = 65.  Wide GP bases: K2's
wide kernel, on the tensor cores in 3xTF32 (k = 54, 65, 100 and 341
packed, 40 flat; its edges: sample counts one past and one short of a
multiple of its 64-sample tile, the odd N = 1,281 in both storages, int16 rows aligned
to 2 and 4 bytes only, k = 54 and 60 whose column tiles mix the pair
basis, padding and M, narrow bases k = 1, 5 and 20 launched on it
directly) and K3's wide chain, a warp a sample (k = 65, 100, 339 in shared
memory, 340 and 341 in its global workspace; NaN where its twin gives
NaN) to the same 1e-6 |ll|; the likelihood at k = 54 and 65 runs K2 and
K3 (never the composition, which refuses a card tensor) within the
reference's float32 budget (median |dll| 7.4e-4, max 3.8e-3) of the CPU
float64 value, in both storages, as k = 20 does.

The int16 instantiations (compact profile storage) are held to their twins
by codes: K1, K5 and K6 to max |dcode| <= 1 (kernel and twin differ by
~3e-7 in float32; a code moves where a value sits near a half-step of the
1/32767 grid), K1 at 1, 3, 8 and 31 lines, P = 7 to 1,670 with and without
the break, F = 1 and 3, both windows, and at the main path; K5 and K6 at
every shape of their float32 tests; K2 on int16 codes to 1e-6 |ll| at N =
1,280, 1,664, 768, 512 and the odd 1,281, S = 72, 1,001 and 10,000, k = 5
and 20, 0-3 streams, also on rows aligned to 2 and 4 bytes only, and
against K2 fed the same codes decoded to float32 (printed: whether they
agree bitwise).

K3's adjoint (``logmvn_chain_grad``, the backward of ``chain_loglik`` in the
GP training) is held to its twin and to the CPU float64 value within 1e-5
of each output's largest magnitude (dB, du, dmisc), at k = 1 to 100 (both
sides of the warp kernel's row bounds, the wide kernel past 64, in shared
memory and in its global workspace either side of
``CHAIN_GRAD_SHARED_MAX_K``) and S = 1 to 4,096, and on the GP training's
own inputs against the float64 twin, with NaN where its twin gives NaN;
``chain_loglik`` and one ``total_objective`` backward launch K3 and its
adjoint once each and nothing else.

zqso_cap (the zQSO exact scan's in-window inputs to K3) is held to its twin
at the main path's shapes (``ops/zqso_cap_sweep.problem``: DESI's linear
grid, P = 5,632, k = 20, C = ``EXACT_CHUNK`` and the whole grid of
10,000), at C = 1 and 37 (ragged), at k = 5, 21 and 32, on a coarse grid
(several band windows a sub-tile), with a z whose window holds no pixel
and one whose normalization median is +inf: B, u and misc within 1e-5 of
each output's largest magnitude (the order of the float32 sums, ~4,000
terms, is all that differs), the same non-finite pattern, and K3's twin on
either within ``REL_ZQSO_CAP_LL``, and B no farther from its float64
sum than the twin and within ``REL_ZQSO_CAP_F64``; it repeats bit for bit,
and k = 33 is refused on the card (the exact scan takes the composition
there).  Both zQSO scans on the card are held to the
CPU's, the exact one at 1,000 and 10,000 z with one ``zqso_cap`` and one
K3 launch a chunk.

civ_tau (the CIV doublet's unit optical depth, K5's input) is held to its
twin at the CIV head's S = 10,000 x P = 774 (sigma over 1e6-8e6 cm/s, z
over the window), at S = 1 (the MCMC's row), at the odd P = 773 and with
line centres within a pixel of each end of the row: every pixel within
``ULPS_CIV_TAU`` float32 ulps of the twin's value (the kernel follows the
twin operation by operation in round-to-nearest intrinsics; only PyTorch's
own kernels could part them), and the profile through K5 within TOL_K1 of
the twin's tau through K5's twin (K5's 1e-6 and the tau's ulps; TOL_K1 is
the ceiling); one ``civ_tau`` launch a call.
"""

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu_torch import constants as C
from gpy_dla_detection_tpu_torch.models.evidence import single_absorber_profiles
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops import logmvn as T
from gpy_dla_detection_tpu_torch.ops.logmvn_ablate import (
    FULL,
    STAGE_MAX_K,
    flat_chain_reference,
    logmvn_ablate,
    logmvn_ablate_packed,
    logmvn_ablate_reference,
    logmvn_decoupled,
    logmvn_flat_chain,
    stage_geometry,
)
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    CHAIN_GRAD_SHARED_MAX_K,
    cap_geometry,
    chain_geometry,
    flat_chain_geometry,
    logmvn_cap,
    logmvn_cap_reference,
    chain_grad_geometry,
    chain_loglik,
    logmvn_chain,
    logmvn_chain_grad,
    logmvn_chain_grad_reference,
    logmvn_chain_reference,
    packed_pair_basis,
    wide_cap_basis,
    wide_cap_geometry,
)
from gpy_dla_detection_tpu_torch.ops.voigt import (
    instrumental_broadening,
    lyman_limit_unit_tau,
    unit_lyman_optical_depth,
    windowed_tau_parts,
)
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    K1_MAX_FAMILIES,
    K1_MAX_LINES,
    K1_WARPS,
    absorption_all,
    absorption_all_reference,
    absorption_tail,
    absorption_tail_reference,
    absorption_windowed,
    absorption_windowed_reference,
    civ_unit_tau,
    civ_unit_tau_reference,
    k1_launch_name,
)

TOL_K1 = 2e-6
# K1 with poly=False (the Weideman rational and the continued fraction):
# the mutual bound of two float32 Weideman evaluations (tests/test_voigt.py),
# and against the float64 exact profile at most 1.5x the twin's own error
# or TOL_TRUTH_FLOOR
TOL_K1_WEIDEMAN = 5e-4
TOL_TRUTH_FLOOR = 1e-4
TOL_K5 = 1e-6
TOL_K6 = 1e-6
REL_K23 = 1e-6
# zqso_cap's likelihood against its twin's: K2's 1e-6 scaled by the root of
# the sums' lengths (~4,150 pixels in the window against K2's 1,280);
# 1.3e-6 measured at 10,000 z
REL_ZQSO_CAP_LL = 2e-6
# zqso_cap's B from the same float32 terms summed in float64, a share of
# its largest magnitude: 3.8e-7 measured at 10,000 z (the twin 4.0e-6)
REL_ZQSO_CAP_F64 = 1.5e-6
REL_K7_STAGE = 2e-6
# K3's adjoint: each output within this share of its largest magnitude, of
# its float32 twin and of the CPU float64 value (the float32 twin's own
# error on these capacitances: <= 8.3e-7)
REL_K3_GRAD = 1e-5
# civ_tau against its twin: ulps of float32 (2^-23 of the value) at every
# pixel; the op-by-op order gives the twin's bits in numpy
# (tests/test_torch_civ_tau.py)
ULPS_CIV_TAU = 4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _grids_and_samples(P=1286, S=1000, seed=3):
    rng = np.random.default_rng(seed)
    base = 1215.67 * 2.9 * 10 ** (1e-4 * np.arange(P))
    steps = np.diff(base) * (1.0 + 0.3 * rng.uniform(-1, 1, P - 1))
    jittered = base[0] + np.concatenate([[0.0], np.cumsum(steps)])
    z = rng.uniform(1.9, 3.3, S).astype(np.float32)
    nhi_dla = (10 ** rng.uniform(20, 23, S)).astype(np.float32)
    nhi_sub = (10 ** rng.uniform(19.5, 20.0, S)).astype(np.float32)
    return (base, jittered), z, (nhi_dla, nhi_sub)


def _problem(device, N=1280, k=20, S=1000, n_extra=0, seed=7):
    rng = np.random.default_rng(seed)
    M = (rng.normal(size=(N, k)) / np.sqrt(k) * 0.1).astype(np.float32)
    y = (1 + 0.1 * rng.normal(size=N)).astype(np.float32)
    mu = np.ones(N, np.float32)
    omega2 = rng.uniform(0.01, 0.05, N).astype(np.float32)
    v = rng.uniform(0.02, 0.1, N).astype(np.float32)
    mask = rng.uniform(size=N) > 0.1
    A = np.exp(-rng.random((S, N))).astype(np.float32)
    extra = [np.exp(-0.3 * rng.random((S, N))).astype(np.float32) for _ in range(n_extra)]
    put = lambda x: torch.as_tensor(x, device=device)
    return [put(x) for x in (y, mu, M, omega2, v, mask)], put(A), [put(e) for e in extra]


@pytest.mark.parametrize("grid_index", [0, 1])
def test_absorption_kernel_matches_twin(cuda_device, grid_index):
    grids, z, nhis = _grids_and_samples()
    wl = torch.as_tensor(grids[grid_index].astype(np.float32), device=cuda_device)
    zt = torch.as_tensor(z, device=cuda_device)
    nt = tuple(torch.as_tensor(n, device=cuda_device) for n in nhis)
    before = _build.launch_counts["absorption_all"]
    got = absorption_all(wl, zt, nt)
    torch.cuda.synchronize()
    assert _build.launch_counts["absorption_all"] == before + 1
    want = absorption_all_reference(wl, zt, nt)
    for g, w in zip(got, want):
        assert g.shape == (z.shape[0], wl.shape[0] - 6)
        assert float((g - w).abs().max()) <= TOL_K1


@pytest.mark.parametrize("n_extra", [0, 3, 4])  # 4: the oldest two are folded
@pytest.mark.parametrize("S", [1000, 1001])
def test_likelihood_kernels_match_twins(cuda_device, n_extra, S):
    (y, mu, M, omega2, v, mask), A, extra = _problem(cuda_device, S=S, n_extra=n_extra)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = packed_pair_basis(M)
    B, u, misc = logmvn_cap(rows, M, Mp, A, extra)
    Br, ur, miscr = logmvn_cap_reference(rows, M, Mp, A, extra)
    ll_kernel = logmvn_chain(B, u, misc)
    ll_twin = logmvn_chain_reference(Br, ur, miscr)
    torch.cuda.synchronize()
    scale = float(ll_twin.abs().max())
    assert torch.isfinite(ll_kernel).all()
    # K2 alone
    k2 = float((logmvn_chain_reference(B, u, misc) - ll_twin).abs().max())
    assert k2 <= REL_K23 * scale
    # K3 alone
    k3 = float((ll_kernel - logmvn_chain_reference(B, u, misc)).abs().max())
    assert k3 <= REL_K23 * scale
    assert float((ll_kernel - ll_twin).abs().max()) <= REL_K23 * scale


# the float32 likelihood against float64: the reference kernel's budget on
# |ll| ~ 1.1e4 (ops/logmvn_pallas.py:206-210; tests/test_torch_logmvn.py)
MEDIAN_VS_F64 = 7.4e-4
MAX_VS_F64 = 3.8e-3


def _route_problem(device, k, S, n_extra, store):
    """A likelihood problem at the catalog's N = 1,280 with the profiles on
    ``device`` in ``store``, and the CPU float64 value of the same inputs."""
    (y, mu, M, omega2, v, mask), A, extra = _problem("cpu", k=k, S=S, n_extra=n_extra, seed=k)
    if store == torch.int16:
        A, extra = (torch.round(A * 32767.0).to(torch.int16),
                    [torch.round(e * 32767.0).to(torch.int16) for e in extra])
    f64 = T.batched_log_mvnpdf(*[x.double() if x.is_floating_point() else x
                                 for x in (y, mu, M, omega2, v, mask)],
                               T.decode_profile_store(A, torch.float64),
                               extra=[T.decode_profile_store(e, torch.float64) for e in extra])
    put = lambda x: x.to(device)
    return [put(x) for x in (y, mu, M, omega2, v, mask)], put(A), [put(e) for e in extra], f64


# k = 54: one past one K2 block at N = 1,280; 65: one past K3's row bound
@pytest.mark.parametrize("store", [torch.float32, torch.int16])
@pytest.mark.parametrize("n_extra", [0, 3])
@pytest.mark.parametrize("k", [54, 65])
def test_likelihood_takes_the_kernels_for_a_wide_basis(cuda_device, k, n_extra, store):
    """A GP basis wider than one K2 block holds runs K2's wide kernel
    and then K3 (its wide chain past k = 64), never the composition,
    within the float32 budget of the CPU float64 path; the composition
    refuses the card's tensors."""
    base, A, extra, f64 = _route_problem(cuda_device, k, 2000, n_extra, store)
    cap = "logmvn_cap_i16" if store == torch.int16 else "logmvn_cap"
    chain = "logmvn_chain_wide" if k > 64 else "logmvn_chain"
    before = dict(_build.launch_counts)
    ll = T.batched_log_mvnpdf(*base, A, extra=extra)
    torch.cuda.synchronize()
    after = dict(_build.launch_counts)
    assert after.get("logmvn_composition", 0) == before.get("logmvn_composition", 0)
    for name in (cap, chain):
        assert after.get(name, 0) == before.get(name, 0) + 1
    d = (ll.cpu().double() - f64).abs()
    assert torch.isfinite(ll).all()
    assert float(d.median()) <= MEDIAN_VS_F64 and float(d.max()) <= MAX_VS_F64
    with pytest.raises(ValueError):
        T.batched_log_mvnpdf(*base, A, extra=extra, use_kernels=False)


@pytest.mark.parametrize("store", [torch.float32, torch.int16])
def test_likelihood_main_path_takes_the_kernels(cuda_device, store):
    """At the main path's k = 20 the route is K2 then K3, never the
    composition, which refuses the card's tensors."""
    base, A, extra, f64 = _route_problem(cuda_device, 20, 2000, 3, store)
    name = "logmvn_cap_i16" if store == torch.int16 else "logmvn_cap"
    before = dict(_build.launch_counts)
    ll = T.batched_log_mvnpdf(*base, A, extra=extra)
    torch.cuda.synchronize()
    after = dict(_build.launch_counts)
    assert after.get("logmvn_composition", 0) == before.get("logmvn_composition", 0)
    assert after[name] == before.get(name, 0) + 1
    assert after["logmvn_chain"] == before.get("logmvn_chain", 0) + 1
    d = (ll.cpu().double() - f64).abs()
    assert float(d.median()) <= MEDIAN_VS_F64 and float(d.max()) <= MAX_VS_F64
    with pytest.raises(ValueError):
        T.batched_log_mvnpdf(*base, A, extra=extra, use_kernels=False)


def _k2_ll_error(device, k, basis, S, N, n_extra, seed=7):
    """K2 against its twin through the same (twin) chain: max |dll| and
    the largest |ll|; also checks the launch count."""
    (y, mu, M, omega2, v, mask), A, extra = _problem(device, N=N, k=k, S=S,
                                                     n_extra=n_extra, seed=seed)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = packed_pair_basis(M) if basis == "packed" else T.pair_basis(M)
    before = _build.launch_counts["logmvn_cap"]
    got = logmvn_cap(rows, M, Mp, A, extra)
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_cap"] == before + 1
    want = logmvn_cap_reference(rows, M, Mp, A, extra)
    chain = logmvn_chain_reference if basis == "packed" else flat_chain_reference
    ll_twin = chain(*want)
    assert torch.isfinite(ll_twin).all()
    return float((chain(*got) - ll_twin).abs().max()), float(ll_twin.abs().max())


# the narrow bases the old block refused (fewer than 32 threads)
@pytest.mark.parametrize("k,basis", [(1, "packed"), (4, "packed"), (5, "packed"), (4, "flat")])
@pytest.mark.parametrize("n_extra", [0, 3])
def test_cap_kernel_takes_a_narrow_basis(cuda_device, k, basis, n_extra):
    err, scale = _k2_ll_error(cuda_device, k, basis, 1001, 1280, n_extra)
    assert err <= REL_K23 * scale


# k = 24 packed: 3 warps across the columns, so the warps of a block
# assemble unequal numbers of sample quads
def test_cap_kernel_with_uneven_assembly_quads(cuda_device):
    err, scale = _k2_ll_error(cuda_device, 24, "packed", 1001, 1280, 3)
    assert err <= REL_K23 * scale


# bases one block cannot hold: the wide kernel (7, 9, 21 and 230 column
# tiles; the flat k = 40 basis 7), a lone sample and an uneven count
@pytest.mark.parametrize("S", [1, 1001])
@pytest.mark.parametrize("n_extra", [0, 3])
@pytest.mark.parametrize("k,basis", [(54, "packed"), (65, "packed"), (100, "packed"),
                                     (341, "packed"), (40, "flat")])
def test_cap_kernel_in_column_slices_matches_twin(cuda_device, k, basis, n_extra, S):
    kp = k * (k + 1) // 2 if basis == "packed" else k * k
    with pytest.raises(ValueError):
        cap_geometry(S, 1280, k, kp, n_extra)  # one block cannot hold it
    err, scale = _k2_ll_error(cuda_device, k, basis, min(S, 64) if k > 300 else S, 1280,
                              n_extra)
    assert err <= REL_K23 * scale


# the wide kernel's edges: sample counts one past and one short of a
# multiple of its 64-sample tile; the odd N = 1,281 (4-byte float32
# copies); k = 54 (its M columns split over two tiles: tile 5 holds 7
# pair-basis warps, the last partly padding, and an M warp; tile 6 22 M
# columns and padding) and 60 (a tile of 2 pair-basis warps, 2 M warps
# and 4 warps of padding)
@pytest.mark.parametrize("k, N, S", [(54, 1280, 129), (54, 1280, 255), (54, 1281, 1001),
                                     (60, 1280, 1001), (60, 1281, 129)])
@pytest.mark.parametrize("n_extra", [0, 3])
def test_wide_cap_kernel_at_its_edges(cuda_device, k, N, S, n_extra):
    err, scale = _k2_ll_error(cuda_device, k, "packed", S, N, n_extra)
    assert err <= REL_K23 * scale


# int16 codes on the wide kernel: the odd N = 1,281 (plain loads), rows
# aligned to 2 bytes (offset 1: plain loads) and to 4 (offset 2: 2 codes a
# copy), and the 16-byte copies of N = 1,280
@pytest.mark.parametrize("N, offset", [(1281, 0), (1280, 1), (1280, 2), (1280, 0)])
def test_wide_cap_kernel_int16_matches_twin(cuda_device, N, offset):
    rel, rel32, _ = _k2_int16(cuda_device, N, 1001, 54, 3, offset=offset)
    assert rel <= REL_K23 and rel32 <= REL_K23


def _wide_k2_direct(device, k, S, N, n_extra):
    """The wide kernel launched on a basis one K2 block holds (its launcher
    takes any k), through the twin chain against the twin: max |dll| and
    max |ll|."""
    (y, mu, M, omega2, v, mask), A, extra = _problem(device, N=N, k=k, S=S, n_extra=n_extra)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = packed_pair_basis(M)
    kp = Mp.shape[1]
    g = wide_cap_geometry(S, N, k, kp, n_extra)
    P = wide_cap_basis(M, Mp, g)
    B = torch.empty((S, kp), device=device)
    u = torch.empty((S, k), device=device)
    misc = torch.empty((S, 2), device=device)
    e = [_build.ptr(x) for x in extra] + [_build.ptr(None)] * (3 - n_extra)
    err = _build.load_library().logmvn_cap_wide_launch(
        _build.ptr(rows), N, _build.ptr(P), k, kp, _build.ptr(A), *e,
        n_extra, 0, S, g.samples, g.pixels, g.pair_columns, g.tiles, g.threads,
        g.shared_bytes, g.grid, _build.ptr(B), _build.ptr(u), _build.ptr(misc),
        _build.stream_ptr(device))
    _build.check_launch("logmvn_cap_wide", err)
    torch.cuda.synchronize()
    ll_twin = logmvn_chain_reference(*logmvn_cap_reference(rows, M, Mp, A, extra))
    return (float((logmvn_chain_reference(B, u, misc) - ll_twin).abs().max()),
            float(ll_twin.abs().max()))


# narrow bases on the wide kernel: one tile holds B and u (k = 1, 5, 20:
# the main path's, 7 pair-basis warps and an M warp)
@pytest.mark.parametrize("k", [1, 5, 20])
@pytest.mark.parametrize("n_extra", [0, 3])
def test_wide_cap_kernel_at_narrow_bases(cuda_device, k, n_extra):
    err, scale = _wide_k2_direct(cuda_device, k, 1001, 1280, n_extra)
    assert err <= REL_K23 * scale


def test_wide_cap_launcher_refuses_another_geometry(cuda_device):
    """Any geometry but wide_cap_geometry's is refused before launch."""
    S, N, k = 16, 64, 54
    kp = k * (k + 1) // 2
    g = wide_cap_geometry(S, N, k, kp, 0)
    x = torch.zeros((S, max(N, kp)), device=cuda_device)
    lib = _build.load_library()
    for bad in (g._replace(tiles=g.tiles + 1), g._replace(shared_bytes=g.shared_bytes + 16),
                g._replace(grid=g.grid - 1), g._replace(threads=128),
                g._replace(pair_columns=kp)):
        err = lib.logmvn_cap_wide_launch(
            _build.ptr(x), N, _build.ptr(x), k, kp, _build.ptr(x), *[
                _build.ptr(None)] * 3, 0, 0, S, bad.samples, bad.pixels, bad.pair_columns,
            bad.tiles, bad.threads, bad.shared_bytes, bad.grid, _build.ptr(x), _build.ptr(x),
            _build.ptr(x), _build.stream_ptr(cuda_device))
        assert err != 0, bad


# S: a lone sample, either side of the main path's 80-sample block, the
# main path's 10,000; N: the CIV head's 768 and the LLS search's 1,664
@pytest.mark.parametrize("S", [1, 79, 81, 10_000])
@pytest.mark.parametrize("n_extra", [0, 3])
@pytest.mark.parametrize("N", [768, 1664])
def test_cap_kernel_over_sample_and_pixel_counts(cuda_device, S, n_extra, N):
    err, scale = _k2_ll_error(cuda_device, 20, "packed", S, N, n_extra)
    assert err <= REL_K23 * scale


def test_masked_pixels_with_zero_or_nan_variance_stay_finite(cuda_device):
    (y, mu, M, omega2, v, mask), A, _ = _problem(cuda_device, S=64)
    mask[:3] = False
    v[0] = 0.0
    omega2[0] = 0.0
    v[1] = float("nan")
    ll = T.batched_log_mvnpdf(y, mu, M, omega2, v, mask, A)
    assert torch.isfinite(ll).all()


def test_float64_on_card_raises(cuda_device):
    (y, mu, M, omega2, v, mask), A, _ = _problem(cuda_device, S=8)
    d = lambda t: t.double()
    with pytest.raises(TypeError):
        T.batched_log_mvnpdf(d(y), d(mu), d(M), d(omega2), d(v), mask, d(A))
    with pytest.raises(TypeError):
        single_absorber_profiles(
            torch.linspace(4000, 5000, 64, dtype=torch.float64, device=cuda_device),
            torch.full((4,), 2.5, dtype=torch.float64, device=cuda_device),
            (torch.full((4,), 1e21, dtype=torch.float64, device=cuda_device),), 3,
        )


# K5's and K6's rows: 1; 16 and 20, the MCMC half-steps of 32 DLA and 40
# CIV walkers; 1001, a catalog-sized count that is no multiple of anything;
# the catalog's 10,000.  K5's P: the CIV head's 774, the catalog's 1,286
# (rows 8-byte aligned every other row), the LLS search's 1,670, one output
# pixel (7), a row of one 128-pixel and of one 256-pixel chunk and its halo
# (134, 262), and the odd 1,287 (4-byte aligned rows: scalar loads)
TAIL_ROWS = (1, 16, 20, 1001, 10_000)
TAIL_PIXELS = (7, 134, 262, 774, 1286, 1287, 1670)


def _tail_inputs(device, S, P):
    grids, z, nhis = _grids_and_samples(P=max(P, 8), S=S)
    wl = torch.as_tensor(grids[0][:P].astype(np.float32), device=device)
    unit = unit_lyman_optical_depth(wl, torch.as_tensor(z, device=device), 3)
    return unit, torch.as_tensor(nhis[0], device=device)


@pytest.mark.parametrize("P", TAIL_PIXELS)
@pytest.mark.parametrize("S", TAIL_ROWS)
def test_absorption_tail_kernel_matches_twin(cuda_device, S, P):
    unit, nhi = _tail_inputs(cuda_device, S, P)
    before = _build.launch_counts["absorption_tail"]
    got = absorption_tail(unit, nhi)
    torch.cuda.synchronize()
    assert _build.launch_counts["absorption_tail"] == before + 1
    assert got.shape == (S, P - 6)
    assert float((got - absorption_tail_reference(unit, nhi)).abs().max()) <= TOL_K5


def test_absorption_tail_takes_rows_beyond_shared_memory(cuda_device):
    """The streaming tail keeps nothing of a row in shared memory, so a row
    longer than a block's 227 KB of it runs (the earlier design refused it)."""
    P = _build.MAX_DYNAMIC_SHARED_BYTES // 4 + 1
    rng = np.random.default_rng(9)
    unit = torch.as_tensor((rng.random((3, P)) * 3e-21).astype(np.float32), device=cuda_device)
    nhi = torch.as_tensor(np.array([1e20, 1e21, 3e21], np.float32), device=cuda_device)
    for dtype in (None, torch.int16):
        got = absorption_tail(unit, nhi, dtype)
        want = absorption_tail_reference(unit, nhi, dtype)
        torch.cuda.synchronize()
        if dtype is None:
            assert float((got - want).abs().max()) <= TOL_K5
        else:
            assert _dcode(got, want) <= MAX_DCODE


def _civ_tau_inputs(device, S, P, edges=False, seed=5):
    """A CIV window's grid (rest 1,311 A at z_QSO = 2.4, SDSS's 1e-4 dex
    pixels) and S samples of the CIV prior: z with the doublet on the grid,
    sigma over 1e6-8e6 cm/s, logN over 12.88-14.5.  With ``edges`` the rows
    take line 1548's centre within a pixel of the row's first pixel and
    line 1550's within a pixel of its last, in turn."""
    rng = np.random.default_rng(seed)
    wl = 1311.0 * 3.4 * 10 ** (1e-4 * (np.arange(P) - 3))
    lam = C.CIV_WAVELENGTHS_CM * 1e8
    z = rng.uniform(wl[0] / lam[0] - 1.0, wl[-1] / lam[1] - 1.0, S)
    if edges:
        u = rng.uniform(-1.0, 1.0, S)
        first = (wl[0] + u * (wl[1] - wl[0])) / lam[0] - 1.0
        last = (wl[-1] + u * (wl[-1] - wl[-2])) / lam[1] - 1.0
        z = np.where(np.arange(S) % 2 == 0, first, last)
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (put(wl), put(z), put(rng.uniform(1e6, 8e6, S)),
            put(10 ** rng.uniform(12.88, 14.5, S)))


@pytest.mark.parametrize("S, P, edges", [(10_000, 774, False), (1, 774, False),
                                         (1001, 773, False), (64, 774, True)],
                         ids=["civ_head", "mcmc_row", "ragged", "edges"])
def test_civ_tau_kernel_matches_twin(cuda_device, S, P, edges):
    wl, z, sigma, nciv = _civ_tau_inputs(cuda_device, S, P, edges)
    before = _build.launch_counts["civ_tau"]
    got = civ_unit_tau(wl, z, sigma)
    torch.cuda.synchronize()
    assert _build.launch_counts["civ_tau"] == before + 1
    want = civ_unit_tau_reference(wl, z, sigma)
    assert got.shape == want.shape == (S, P)
    assert bool(torch.isfinite(got).all()) and float(got.min()) > 0.0
    assert float(((got - want).abs() / want.abs()).max()) <= ULPS_CIV_TAU * 2.0**-23
    absorbed = absorption_tail(got, nciv)
    assert float((absorbed - absorption_tail_reference(want, nciv)).abs().max()) <= TOL_K1
    if edges:  # the lines absorb at both ends of the row
        assert float(absorbed[0::2, 0].min()) < 0.99 and float(absorbed[1::2, -1].min()) < 0.99


def _chain_inputs(device, k, S):
    """A real capacitance: K2's twin on a GP basis of k columns."""
    (y, mu, M, omega2, v, mask), A, _ = _problem(device, k=k, S=S, seed=k)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    return logmvn_cap_reference(rows, M, packed_pair_basis(M), A)


# k: both sides of K3's row bound 32 (64 gives a lane two rows) and of a
# half warp, narrow bases, the main path's 20, the odd 21, the 41 the
# earlier kernel's limit; S: a lone sample, one past a warp's 32, a count
# that is no multiple of anything, the main path's 10,000
@pytest.mark.parametrize("S", [1, 33, 1001, 10_000])
@pytest.mark.parametrize("k", [1, 2, 8, 16, 17, 20, 21, 31, 32, 33, 41])
def test_chain_kernel_matches_twin(cuda_device, k, S):
    B, u, misc = _chain_inputs(cuda_device, k, S)
    before = _build.launch_counts["logmvn_chain"]
    ll_kernel = logmvn_chain(B, u, misc)
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_chain"] == before + 1
    ll_twin = logmvn_chain_reference(B, u, misc)
    assert torch.isfinite(ll_kernel).all()
    assert float((ll_kernel - ll_twin).abs().max()) <= REL_K23 * float(ll_twin.abs().max())


@pytest.mark.parametrize("k", [5, 20, 41])
def test_chain_kernel_gives_the_twins_nan_where_not_positive_definite(cuda_device, k):
    """A negative pivot (at the first column, and at a later one) gives NaN
    in kernel and twin alike; the other samples are untouched."""
    B, u, misc = _chain_inputs(cuda_device, k, 100)
    diag = [j * k - j * (j - 1) // 2 for j in range(k)]  # packed (j, j)
    B[0, diag[0]] = -2.0
    B[1, diag[k // 2]] = -50.0
    ll_kernel = logmvn_chain(B, u, misc)
    ll_twin = logmvn_chain_reference(B, u, misc)
    torch.cuda.synchronize()
    nan = torch.isnan(ll_twin)
    assert bool(nan[0]) and bool(nan[1])
    assert torch.equal(torch.isnan(ll_kernel), nan)
    ok = ~nan
    assert float((ll_kernel[ok] - ll_twin[ok]).abs().max()) <= (
        REL_K23 * float(ll_twin[ok].abs().max()))


def test_chain_kernel_refuses_k_beyond_its_row_bounds(cuda_device):
    """The warp chain's geometry and launcher refuse k = 65; the wrapper
    takes it to the wide chain instead."""
    k = 65
    B = torch.zeros((4, k * (k + 1) // 2), device=cuda_device)
    u = torch.zeros((4, k), device=cuda_device)
    misc = torch.zeros((4, 2), device=cuda_device)
    ll = torch.empty((4,), device=cuda_device)
    with pytest.raises(ValueError):
        chain_geometry(4, k)
    g = chain_geometry(4, 64)
    err = _build.load_library().logmvn_chain_launch(
        _build.ptr(B), _build.ptr(u), _build.ptr(misc), 4, k, g.rows, g.warps,
        g.shared_bytes, g.grid, _build.ptr(ll), _build.stream_ptr(cuda_device))
    assert err != 0
    before = _build.launch_counts["logmvn_chain_wide"]
    logmvn_chain(B, u, misc)
    assert _build.launch_counts["logmvn_chain_wide"] == before + 1


# k: one past the warp chain's row bounds, wider, the widest whose triangle
# a block's shared memory holds (339), and two in the global workspace
@pytest.mark.parametrize("S", [1, 1001])
@pytest.mark.parametrize("k", [65, 100, 339, 340, 341])
def test_wide_chain_kernel_matches_twin(cuda_device, k, S):
    B, u, misc = _chain_inputs(cuda_device, k, S if k < 300 else min(S, 64))
    before = _build.launch_counts["logmvn_chain_wide"]
    ll_kernel = logmvn_chain(B, u, misc)
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_chain_wide"] == before + 1
    ll_twin = logmvn_chain_reference(B, u, misc)
    assert torch.isfinite(ll_kernel).all()
    assert float((ll_kernel - ll_twin).abs().max()) <= REL_K23 * float(ll_twin.abs().max())


@pytest.mark.parametrize("k", [65, 340])
def test_wide_chain_gives_the_twins_nan_where_not_positive_definite(cuda_device, k):
    B, u, misc = _chain_inputs(cuda_device, k, 40)
    diag = [j * k - j * (j - 1) // 2 for j in range(k)]  # packed (j, j)
    B[0, diag[0]] = -2.0
    B[1, diag[k // 2]] = -50.0
    ll_kernel = logmvn_chain(B, u, misc)
    ll_twin = logmvn_chain_reference(B, u, misc)
    torch.cuda.synchronize()
    nan = torch.isnan(ll_twin)
    assert bool(nan[0]) and bool(nan[1])
    assert torch.equal(torch.isnan(ll_kernel), nan)
    ok = ~nan
    assert float((ll_kernel[ok] - ll_twin[ok]).abs().max()) <= (
        REL_K23 * float(ll_twin[ok].abs().max()))


@pytest.mark.parametrize("S", TAIL_ROWS)
@pytest.mark.parametrize("num_lines", [3, 8])  # 8: overlapping windows
@pytest.mark.parametrize("grid_index", [0, 1])
def test_absorption_windowed_kernel_matches_twin(cuda_device, grid_index, num_lines, S):
    grids, z, nhis = _grids_and_samples(S=S)
    wl = torch.as_tensor(grids[grid_index].astype(np.float32), device=cuda_device)
    parts = windowed_tau_parts(wl, torch.as_tensor(z, device=cuda_device), num_lines)
    assert parts.far.shape[1] == 1408
    before = _build.launch_counts["absorption_windowed"]
    for nhi in nhis:
        nt = torch.as_tensor(nhi, device=cuda_device)
        for dtype in (None, torch.int16):
            got = absorption_windowed(parts, nt, dtype)
            want = absorption_windowed_reference(parts, nt, dtype)
            torch.cuda.synchronize()
            assert got.shape == (z.shape[0], wl.shape[0] - 6)
            if dtype is None:
                assert float((got - want).abs().max()) <= TOL_K6
            else:
                assert _dcode(got, want) <= MAX_DCODE
    assert _build.launch_counts["absorption_windowed"] == before + len(nhis)
    assert _build.launch_counts["absorption_windowed_i16"] >= len(nhis)


@pytest.mark.parametrize("num_lines", [3, 8])
@pytest.mark.parametrize("P", [1286, 1281, 1407])
def test_absorption_windowed_kernel_clips_windows_at_the_rows_end(cuda_device, P, num_lines):
    """Line centres near the grid's red end put windows at the last chunk
    pair, past the row's P pixels (P = 1,286 and 1,281 of 1,408 padded, and
    1,407: one pixel short), overlapping each other at 8 lines."""
    grids, _, nhis = _grids_and_samples(P=P, S=1001)
    wl = torch.as_tensor(grids[0].astype(np.float32), device=cuda_device)
    red = float(wl[-1]) / 1215.67 - 1.0
    rng = np.random.default_rng(P)
    z = torch.as_tensor(rng.uniform(red - 0.05, red + 0.02, 1001).astype(np.float32),
                        device=cuda_device)
    parts = windowed_tau_parts(wl, z, num_lines)
    nc = parts.far.shape[1] // 128
    assert parts.far.shape[1] == 1408 and int((parts.c0 == nc - 2).sum()) > 100
    for nhi in nhis:
        nt = torch.as_tensor(nhi, device=cuda_device)
        got = absorption_windowed(parts, nt)
        torch.cuda.synchronize()
        assert float((got - absorption_windowed_reference(parts, nt)).abs().max()) <= TOL_K6
        got16 = absorption_windowed(parts, nt, torch.int16)
        assert _dcode(got16, absorption_windowed_reference(parts, nt, torch.int16)) <= MAX_DCODE


def test_absorption_kernel_with_lyman_limit_break_matches_twin(cuda_device):
    # the LLS search's width: P = 1,670 padded pixels from 850 A rest
    rng = np.random.default_rng(5)
    wl = torch.as_tensor((850.0 * 4.2 * 10 ** (1e-4 * np.arange(1670))).astype(np.float32),
                         device=cuda_device)
    z = torch.as_tensor(rng.uniform(3.0, 3.6, 1000).astype(np.float32), device=cuda_device)
    nhi = torch.as_tensor((10 ** rng.uniform(17.2, 23.0, 1000)).astype(np.float32),
                          device=cuda_device)
    before = _build.launch_counts["absorption_all"]
    (got,) = absorption_all(wl, z, (nhi,), lls_break=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["absorption_all"] == before + 1
    (want,) = absorption_all_reference(wl, z, (nhi,), lls_break=True)
    assert float((got - want).abs().max()) <= TOL_K1
    (plain,) = absorption_all(wl, z, (nhi,))
    assert float((plain - got).max()) > 0.5  # the break is in


# K1 over its range: line counts 1, 3 (the compiled main path), 8 and the
# table's 31; P from one output pixel to the LLS search's 1,670, with and
# without the break; F = 1-3 and 7 (two launches); S = 1 to 10,000
K1_LINES = (1, 3, 8, K1_MAX_LINES)
K1_PIXEL_CASES = [(7, False), (301, False), (1286, False), (1670, False), (1670, True)]


def _k1_inputs(device, P, S, F, lls_break, seed=11):
    """A log grid from 2.9 x Lya (or, with the break, from 4.2 x 850 A, the
    LLS search's window), redshifts that put line centres on it, and F
    families of column densities cycling DLA, subDLA and LLS ranges."""
    rng = np.random.default_rng(seed)
    start = 850.0 * 4.2 if lls_break else 1215.67 * 2.9
    wl = (start * 10 ** (1e-4 * np.arange(P))).astype(np.float32)
    z = (rng.uniform(3.0, 3.6, S) if lls_break else rng.uniform(1.9, 3.3, S)).astype(np.float32)
    ranges = [(20.0, 23.0), (19.5, 20.0), (17.2, 20.5)]
    nhis = [(10 ** rng.uniform(*ranges[f % 3], S)).astype(np.float32) for f in range(F)]
    put = lambda x: torch.as_tensor(x, device=device)
    return put(wl), put(z), tuple(put(n) for n in nhis)


def _exact_profiles(wl, z, nhis, num_lines, lls_break):
    """The float64 exact profiles on the card: the exact unit optical depth
    (plus the break) of every line, exp and the 7-tap convolution."""
    wl64, z64 = wl.double(), z.double()
    unit = unit_lyman_optical_depth(wl64, z64, num_lines)
    if lls_break:
        unit = unit + lyman_limit_unit_tau(wl64, z64)
    return [instrumental_broadening(torch.exp(-n.double()[:, None] * unit)) for n in nhis]


def _check_k1(wl, z, nhis, num_lines, lls_break, poly):
    name, other = k1_launch_name(poly), k1_launch_name(not poly)
    before = dict(_build.launch_counts)
    got = absorption_all(wl, z, nhis, num_lines, lls_break, poly)
    torch.cuda.synchronize()
    launches = -(-len(nhis) // K1_MAX_FAMILIES)
    assert _build.launch_counts[name] == before.get(name, 0) + launches
    assert _build.launch_counts[other] == before.get(other, 0)
    want = absorption_all_reference(wl, z, nhis, num_lines, lls_break, poly)
    truth = None if poly else _exact_profiles(wl, z, nhis, num_lines, lls_break)
    for f, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (z.shape[0], wl.shape[0] - 6)
        err = float((g - w).abs().max())
        if poly:
            assert err <= TOL_K1, (f, err)
            continue
        assert err <= TOL_K1_WEIDEMAN, (f, err)
        e_kernel = float((g.double() - truth[f]).abs().max())
        e_twin = float((w.double() - truth[f]).abs().max())
        assert e_kernel <= max(1.5 * e_twin, TOL_TRUTH_FLOOR), (f, e_kernel, e_twin)


@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("P, lls_break", K1_PIXEL_CASES)
@pytest.mark.parametrize("num_lines", K1_LINES)
def test_absorption_kernel_over_lines_and_pixel_counts(cuda_device, num_lines, P, lls_break, poly):
    wl, z, nhis = _k1_inputs(cuda_device, P, 1001, 2, lls_break)
    _check_k1(wl, z, nhis, num_lines, lls_break, poly)


@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("F", [1, 2, 3, 7])
@pytest.mark.parametrize("S", [1, 33, 1001, 10_000])
def test_absorption_kernel_over_sample_and_family_counts(cuda_device, S, F, poly):
    wl, z, nhis = _k1_inputs(cuda_device, 1286, S, F, False)
    _check_k1(wl, z, nhis, 3, False, poly)


@pytest.mark.parametrize("field, value", [("warps", K1_WARPS // 2), ("warps", 2 * K1_WARPS),
                                          ("shared_bytes", -4), ("grid", 0)])
def test_absorption_kernel_refuses_a_geometry_it_was_not_compiled_for(
        cuda_device, monkeypatch, field, value):
    """The launcher checks what its safety needs: the compiled block, rings
    for every family, a grid; a refused launch raises and is not counted."""
    from gpy_dla_detection_tpu_torch.ops import voigt_kernels as V

    right = V.k1_geometry

    def wrong(S, P, F, sms):
        g = right(S, P, F, sms)
        return g._replace(**{field: g.shared_bytes + value if field == "shared_bytes" else value})

    monkeypatch.setattr(V, "k1_geometry", wrong)
    wl, z, nhis = _k1_inputs(cuda_device, 1286, 100, 2, False)
    before = _build.launch_counts["absorption_all"]
    with pytest.raises(RuntimeError):
        absorption_all(wl, z, nhis)
    assert _build.launch_counts["absorption_all"] == before


def _rel_err_nan_equal(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    return float((got - want)[~nan].abs().max() / want[~nan].abs().max())


ABLATION_STAGES = ["elementwise", "elementwise_nolog", "matmul", "full", "chain_nodot"]


def _largest_stage_k(N=1280):
    """The largest k the stage kernel takes at N pixels (K2's block)."""
    for k in range(STAGE_MAX_K, 0, -1):
        try:
            stage_geometry(10_000, N, k, FULL)
            return k
        except ValueError:
            continue
    raise AssertionError("the stage kernel takes no k")


def _check_stage(device, stage, k=20, S=1001, N=1280):
    (y, mu, M, omega2, v, mask), A, _ = _problem(device, N=N, k=k, S=S)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = T.pair_basis(M)
    before = _build.launch_counts["logmvn_ablate"]
    got = logmvn_ablate(stage, rows, M, Mp, A)
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_ablate"] == before + 1
    assert got.shape == (S,)
    tol = REL_K23 if stage == "full" else REL_K7_STAGE
    assert _rel_err_nan_equal(got, logmvn_ablate_reference(stage, rows, M, Mp, A)) <= tol


# k: a one-column basis, narrow ones, the main path's 20, 24 (three warps
# across the columns: uneven assembly quads), and the largest the block
# holds (53 at N = 1,280: the chain's row bound 64)
@pytest.mark.parametrize("k", [1, 4, 5, 20, 24, "largest"])
@pytest.mark.parametrize("stage", ABLATION_STAGES)
def test_ablation_stage_kernel_matches_twin(cuda_device, stage, k):
    _check_stage(cuda_device, stage, k=_largest_stage_k() if k == "largest" else k)


# S: a lone sample, both sides of the 80-sample block, the main path's
# 10,000; N: an odd count (4-byte staging), one partial chunk
@pytest.mark.parametrize("S,N", [(1, 1280), (79, 1280), (80, 1280), (81, 1280),
                                 (10_000, 1280), (1001, 1281), (1001, 17)])
@pytest.mark.parametrize("stage", ABLATION_STAGES)
def test_ablation_stage_kernel_over_sample_and_pixel_counts(cuda_device, stage, S, N):
    _check_stage(cuda_device, stage, S=S, N=N)


@pytest.mark.parametrize("stage", ABLATION_STAGES)
def test_ablation_packed_entry_equals_the_flat_entry(cuda_device, stage):
    """The stage kernel on the packed basis (what the timings time) gives
    the flat-basis entry's output bit for bit: the gathered columns are
    the packed basis's."""
    (y, mu, M, omega2, v, mask), A, _ = _problem(cuda_device, k=20, S=1001)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    flat = logmvn_ablate(stage, rows, M, T.pair_basis(M), A)
    packed = logmvn_ablate_packed(stage, rows, M, packed_pair_basis(M), A)
    assert torch.equal(torch.isnan(flat), torch.isnan(packed))
    assert torch.equal(flat[~torch.isnan(flat)], packed[~torch.isnan(flat)])


def test_ablation_stage_kernel_refuses_k_beyond_the_block(cuda_device):
    k = _largest_stage_k() + 1
    (y, mu, M, omega2, v, mask), A, _ = _problem(cuda_device, k=k, S=64)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    before = _build.launch_counts["logmvn_ablate"]
    with pytest.raises(ValueError):
        logmvn_ablate("full", rows, M, T.pair_basis(M), A)
    assert _build.launch_counts["logmvn_ablate"] == before


# K2 itself at the main path's shapes (the phase-3 shapes of chip_smoke.py),
# through the block it shares with the stage kernel
@pytest.mark.parametrize("n_extra", [0, 3])
def test_cap_kernel_at_the_main_path_shapes(cuda_device, n_extra):
    err, scale = _k2_ll_error(cuda_device, 20, "packed", 10_000, 1280, n_extra)
    assert err <= REL_K23 * scale


# k: both sides of the row bound 32 and of a half warp, the main path's 20,
# the earlier kernel's limit 41, K3's largest row bound 64
@pytest.mark.parametrize("k", [1, 2, 5, 16, 17, 20, 31, 32, 33, 41, 64])
def test_flat_basis_cap_and_flat_chain_kernels_match_twins(cuda_device, k):
    """The flat chain in the row layout and, in place, the transposed one;
    where K2's block holds the flat k^2 basis, K2 with it (the decoupled
    split's ka) and the decoupled split."""
    (y, mu, M, omega2, v, mask), A, _ = _problem(cuda_device, k=k, S=1001)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = T.pair_basis(M)
    Br, ur, miscr = logmvn_cap_reference(rows, M, Mp, A)
    ll_twin = flat_chain_reference(Br, ur, miscr)
    scale = float(ll_twin.abs().max())
    before = _build.launch_counts["logmvn_flat_chain"]
    row = logmvn_flat_chain(Br, ur, miscr)
    BT, uT, mT = (torch.cat([x, x[:23]]).T.contiguous() for x in (Br, ur, miscr))
    transposed = logmvn_flat_chain(BT, uT, mT, transposed=True)
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_flat_chain"] == before + 2
    assert float((row - ll_twin).abs().max()) <= REL_K23 * scale
    assert transposed.shape == (1024,)
    assert float((transposed[:1001] - ll_twin).abs().max()) <= REL_K23 * scale
    try:
        cap_geometry(1001, 1280, k, k * k)
    except ValueError:
        return  # K2's block does not hold the flat basis at this k
    B, u, misc = logmvn_cap(rows, M, Mp, A)
    assert B.shape == (1001, k * k)
    assert float((flat_chain_reference(B, u, misc) - ll_twin).abs().max()) <= REL_K23 * scale
    dec = logmvn_decoupled(rows, M, Mp, A)
    assert float((dec - ll_twin).abs().max()) <= REL_K23 * scale


@pytest.mark.parametrize("k", [5, 20, 41])
def test_flat_chain_gives_the_twins_nan_where_not_positive_definite(cuda_device, k):
    """A negative pivot gives NaN in kernel and twin alike, in both
    layouts."""
    (y, mu, M, omega2, v, mask), A, _ = _problem(cuda_device, k=k, S=100, seed=k)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    B, u, misc = logmvn_cap_reference(rows, M, T.pair_basis(M), A)
    B[0, 0] = -2.0
    B[1, (k // 2) * (k + 1)] = -50.0
    want = flat_chain_reference(B, u, misc)
    assert bool(torch.isnan(want[0])) and bool(torch.isnan(want[1]))
    for got in (logmvn_flat_chain(B, u, misc),
                logmvn_flat_chain(B.T.contiguous(), u.T.contiguous(), misc.T.contiguous(),
                                  transposed=True)):
        assert _rel_err_nan_equal(got, want) <= REL_K23


@pytest.mark.parametrize("field,delta", [("warps", 1), ("blocks_per_sm", 1),
                                         ("blocks_per_sm", -1)])
def test_flat_chain_launcher_refuses_other_warps_or_blocks(cuda_device, field, delta):
    """The launcher takes only the warps a block and blocks an SM it was
    compiled for, the ones flat_chain_geometry gives."""
    S, k = 100, 20
    B = torch.zeros((S, k * k), device=cuda_device)
    u = torch.zeros((S, k), device=cuda_device)
    misc = torch.zeros((S, 2), device=cuda_device)
    ll = torch.empty((S,), device=cuda_device)
    g = flat_chain_geometry(S, k)._asdict()
    lib = _build.load_library("ablate")
    P = _build.ptr
    args = lambda g: (P(B), k * k, 1, P(u), k, 1, P(misc), 2, 1, S, k, g["rows"], g["warps"],
                      g["blocks_per_sm"], g["chunk"], g["shared_bytes"], g["grid"], P(ll),
                      _build.stream_ptr(cuda_device))
    assert lib.logmvn_flat_chain_launch(*args(g)) == 0
    torch.cuda.synchronize()
    assert lib.logmvn_flat_chain_launch(*args({**g, field: g[field] + delta})) != 0


def test_flat_chain_refuses_k_beyond_its_row_bounds(cuda_device):
    k = 65
    with pytest.raises(ValueError):
        logmvn_flat_chain(torch.zeros((4, k * k), device=cuda_device),
                          torch.zeros((4, k), device=cuda_device),
                          torch.zeros((4, 2), device=cuda_device))


# ---- compact profile storage: the int16 instantiations against their twins
# (codes compared: kernel and twin differ by ~3e-7 in float32, which moves a
# code by one where a value sits near a half-step of the 1/32767 grid)

MAX_DCODE = 1


def _dcode(got: torch.Tensor, want: torch.Tensor) -> int:
    assert got.dtype == want.dtype == torch.int16 and got.shape == want.shape
    return int((got.int() - want.int()).abs().max())


@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("P, lls_break", K1_PIXEL_CASES)
@pytest.mark.parametrize("num_lines", K1_LINES)
@pytest.mark.parametrize("F", [1, 3])
def test_absorption_kernel_int16_matches_twin(cuda_device, F, num_lines, P, lls_break, poly):
    wl, z, nhis = _k1_inputs(cuda_device, P, 1001, F, lls_break)
    name = k1_launch_name(poly, torch.int16)
    before = dict(_build.launch_counts)
    got = absorption_all(wl, z, nhis, num_lines, lls_break, poly, torch.int16)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before.get(name, 0) + 1
    assert _build.launch_counts[k1_launch_name(poly)] == before.get(k1_launch_name(poly), 0)
    want = absorption_all_reference(wl, z, nhis, num_lines, lls_break, poly, torch.int16)
    for g, w in zip(got, want):
        assert _dcode(g, w) <= MAX_DCODE
        assert int(g.min()) >= 0 and int(g.max()) <= 32767


@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("F", [1, 2, 3])
def test_absorption_kernel_int16_at_the_main_path(cuda_device, F, poly):
    wl, z, nhis = _k1_inputs(cuda_device, 1286, 10_000, F, False)
    got = absorption_all(wl, z, nhis, 3, False, poly, torch.int16)
    want = absorption_all_reference(wl, z, nhis, 3, False, poly, torch.int16)
    f32 = absorption_all(wl, z, nhis, 3, False, poly)
    torch.cuda.synchronize()
    for g, w, g32 in zip(got, want, f32):
        assert _dcode(g, w) <= MAX_DCODE
        # the instantiations differ only at the store
        assert _dcode(g, torch.round(g32 * 32767.0).to(torch.int16)) <= MAX_DCODE


@pytest.mark.parametrize("P", TAIL_PIXELS)
@pytest.mark.parametrize("S", TAIL_ROWS)
def test_absorption_tail_kernel_int16_matches_twin(cuda_device, S, P):
    unit, nhi = _tail_inputs(cuda_device, S, P)
    before = _build.launch_counts["absorption_tail_i16"]
    got = absorption_tail(unit, nhi, torch.int16)
    torch.cuda.synchronize()
    assert _build.launch_counts["absorption_tail_i16"] == before + 1
    assert _dcode(got, absorption_tail_reference(unit, nhi, torch.int16)) <= MAX_DCODE


def test_absorption_windowed_kernel_int16_at_the_main_path(cuda_device):
    grids, z, nhis = _grids_and_samples(S=10_000)
    wl = torch.as_tensor(grids[0].astype(np.float32), device=cuda_device)
    parts = windowed_tau_parts(wl, torch.as_tensor(z, device=cuda_device), 3)
    before = _build.launch_counts["absorption_windowed_i16"]
    for nhi in nhis:
        nt = torch.as_tensor(nhi, device=cuda_device)
        got = absorption_windowed(parts, nt, torch.int16)
        torch.cuda.synchronize()
        assert _dcode(got, absorption_windowed_reference(parts, nt, torch.int16)) <= MAX_DCODE
    assert _build.launch_counts["absorption_windowed_i16"] == before + len(nhis)


def _k2_int16(device, N, S, k, n_extra, offset=0):
    """K2 on int16 codes against its twin on the same codes (through the
    same twin chain), and against K2 fed the codes decoded to float32: the
    two |dll| and whether the latter agree bitwise.  ``offset`` shifts the
    rows by that many codes in their buffer (2-byte alignment only)."""
    (y, mu, M, omega2, v, mask), A, extra = _problem(device, N=N, k=k, S=S, n_extra=n_extra)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = packed_pair_basis(M)

    def codes(x):
        c = torch.round(x * 32767.0).to(torch.int16)
        if not offset:
            return c
        buf = torch.empty(c.numel() + offset, dtype=torch.int16, device=device)
        out = buf[offset:].view(c.shape)
        out.copy_(c)
        return out

    cA, cE = codes(A), [codes(e) for e in extra]
    before = dict(_build.launch_counts)
    got = logmvn_cap(rows, M, Mp, cA, cE)
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_cap_i16"] == before.get("logmvn_cap_i16", 0) + 1
    assert _build.launch_counts["logmvn_cap"] == before.get("logmvn_cap", 0)
    ll_twin = logmvn_chain_reference(*logmvn_cap_reference(rows, M, Mp, cA, cE))
    assert torch.isfinite(ll_twin).all()
    scale = float(ll_twin.abs().max())
    dec = lambda c: T.decode_profile_store(c, torch.float32).contiguous()
    got32 = logmvn_cap(rows, M, Mp, dec(cA), [dec(c) for c in cE])
    ll = logmvn_chain_reference(*got)
    ll32 = logmvn_chain_reference(*got32)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, got32))
    return (float((ll - ll_twin).abs().max()) / scale, float((ll - ll32).abs().max()) / scale,
            bitwise)


# N: the catalog's 1,280, the LLS search's 1,664, the CIV head's 768, the
# reference test's 512 (16-byte copies), and the odd 1,281 (plain loads);
# S: the reference test's 72, a count no multiple of the block, 10,000
@pytest.mark.parametrize("n_extra", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("S", [72, 1001, 10_000])
@pytest.mark.parametrize("N", [1280, 1664, 768, 512, 1281])
def test_cap_kernel_int16_matches_twin(cuda_device, N, S, k, n_extra):
    rel, rel32, bitwise = _k2_int16(cuda_device, N, S, k, n_extra)
    print(f"K2 int16 N={N} S={S} k={k} streams={n_extra}: |dll|/max|ll| vs twin {rel:.2e}, "
          f"vs float32 on the decoded codes {rel32:.2e}, bitwise {bitwise}")
    assert rel <= REL_K23
    assert rel32 <= REL_K23


# a row offset of 1 code (2-byte aligned rows: plain loads) and of 2 codes
# (4-byte aligned: 2 codes a copy), at an even N
@pytest.mark.parametrize("offset", [1, 2])
def test_cap_kernel_int16_on_unaligned_rows(cuda_device, offset):
    rel, rel32, _ = _k2_int16(cuda_device, 1280, 1001, 20, 3, offset=offset)
    assert rel <= REL_K23 and rel32 <= REL_K23


def test_cap_kernel_folds_deep_int16_chains_in_float32(cuda_device):
    """Four streams: the oldest two are folded after decoding, and the
    float32 instantiation runs (codes are not encoded twice)."""
    (y, mu, M, omega2, v, mask), A, extra = _problem(cuda_device, S=1001, n_extra=4)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = packed_pair_basis(M)
    codes = lambda x: torch.round(x * 32767.0).to(torch.int16)
    before = dict(_build.launch_counts)
    got = logmvn_cap(rows, M, Mp, codes(A), [codes(e) for e in extra])
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_cap"] == before.get("logmvn_cap", 0) + 1
    assert _build.launch_counts["logmvn_cap_i16"] == before.get("logmvn_cap_i16", 0)
    ll_twin = logmvn_chain_reference(*logmvn_cap_reference(rows, M, Mp, codes(A),
                                                           [codes(e) for e in extra]))
    scale = float(ll_twin.abs().max())
    assert float((logmvn_chain_reference(*got) - ll_twin).abs().max()) <= REL_K23 * scale


def test_chain_kernel_on_zqso_shaped_inputs(cuda_device):
    """K3 at the zQSO correlation scan's shape (Z = 10,000 candidates, k =
    20): B = med^2 * a weighted Gram matrix, packed, with med^2 from 1 to
    1e6, and u = med * fMi - med^2 * muMi, against its twin."""
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import _packed_maps

    Z, k, m = 10_000, 20, 64
    g = torch.Generator(device=cuda_device).manual_seed(13)
    A = torch.randn((Z, m, k), generator=g, device=cuda_device) / m**0.5
    w = torch.rand((Z, m, 1), generator=g, device=cuda_device) * 100.0
    gram = torch.einsum("zpi,zpj->zij", A * w, A)
    med2 = 10.0 ** (6.0 * torch.rand((Z,), generator=g, device=cuda_device))
    cols, rows = _packed_maps(k)
    B = (med2[:, None] * gram[:, list(rows), list(cols)]).contiguous()
    fMi = torch.randn((Z, k), generator=g, device=cuda_device) * 50.0
    muMi = torch.randn((Z, k), generator=g, device=cuda_device) * 40.0
    u = (med2.sqrt()[:, None] * fMi - med2[:, None] * muMi).contiguous()
    misc = torch.stack([1e3 * torch.rand((Z,), generator=g, device=cuda_device) + 5e3,
                        torch.randn((Z,), generator=g, device=cuda_device) * 100.0], dim=1)
    before = _build.launch_counts["logmvn_chain"]
    ll_kernel = logmvn_chain(B, u, misc)
    torch.cuda.synchronize()
    assert _build.launch_counts["logmvn_chain"] == before + 1
    ll_twin = logmvn_chain_reference(B, u, misc)
    assert torch.isfinite(ll_kernel).all() and torch.isfinite(ll_twin).all()
    assert float((ll_kernel - ll_twin).abs().max()) <= REL_K23 * float(ll_twin.abs().max())


@pytest.mark.parametrize("method, num_z", [("corr", 10_000), ("exact", 1_000),
                                           ("exact", 10_000)])
def test_zqso_scan_on_the_card_matches_the_cpu(cuda_device, method, num_z):
    """A zQSO scan at ZParameters()'s width (k = 20, P = 5,632) on the card
    (float32; the correlation scan's solves on K3, once; the exact scan's
    in-window inputs on zqso_cap and its solves on K3, once a chunk)
    against the same scan on the CPU in float32 (the exact scan through
    the twins): the same NaN pattern and MAP, every |dll| within 1e-4 of
    the largest |ll| and, within +-0.2 of the peak, within 1% of the
    peak's margin."""
    from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_z_observation
    from gpy_dla_detection_tpu_torch.models import zqso
    from gpy_dla_detection_tpu_torch.models.zqso import inference_z_qso, prepare_z_spectrum
    from gpy_dla_detection_tpu_torch.params import ZParameters

    learned, obs = synthetic_z_observation(3.45, seed=0, k=20, obs_seed=9)
    spec = prepare_z_spectrum(*obs)
    params = ZParameters(num_zqso_samples=num_z)
    before = dict(_build.launch_counts)
    z_card, got, grid = inference_z_qso(learned.to(cuda_device, torch.float32), spec, params,
                                        method=method)
    launched = {n: _build.launch_counts[n] - before.get(n, 0)
                for n in ("logmvn_chain", "zqso_cap")}
    chunks = -(-num_z // zqso.EXACT_CHUNK)
    assert launched == ({"logmvn_chain": 1, "zqso_cap": 0} if method == "corr"
                        else {"logmvn_chain": chunks, "zqso_cap": chunks})
    assert _build.launch_counts["logmvn_composition"] == before.get("logmvn_composition", 0)
    z_cpu, want, _ = inference_z_qso(learned.to("cpu", torch.float32), spec, params,
                                     method=method)
    assert got.dtype == want.dtype == np.float32
    assert z_card == z_cpu and abs(z_card - 3.45) < 0.05
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    d = np.abs(got.astype(np.float64) - want)
    assert d[fin].max() <= 1e-4 * np.abs(want[fin]).max()
    peak = np.nanargmax(want)
    near = fin & (np.abs(grid - grid[peak]) < 0.2)
    margin = want[peak] - want[fin & (np.abs(grid - grid[peak]) > 0.2)].max()
    assert d[near].max() <= 0.01 * margin


# zqso_cap's inputs: ops/zqso_cap_sweep.problem (DESI's linear 0.8 A grid of
# 5,600 pixels padded to 5,632, C consecutive redshifts of a grid's step)
@pytest.mark.parametrize("C, k, special, step", [
    (None, 20, None, 4.02e-4),  # the main path: C = EXACT_CHUNK
    (10_000, 20, None, 4.02e-4),  # the whole grid
    (1, 20, None, 4.02e-4),
    (37, 21, None, 4.02e-4),  # odd k (five pieces), a ragged chunk
    (200, 5, None, 0.02),  # a coarse grid: several band windows a sub-tile
    (64, 32, None, 4.02e-4),
    (40, 20, "window", 0.01),
    (40, 20, "median", 0.01),
])
def test_zqso_cap_kernel_matches_twin(cuda_device, C, k, special, step):
    """zqso_cap against its twin on the same inputs: B, u and misc within
    1e-5 of each output's largest magnitude (the sums' order is all that
    differs: float32 sums of ~4,000 terms, a 256-pixel tile's in sequence,
    against the library's SGEMM; 4.1e-6 measured on B at C = 1,000), the
    same non-finite pattern, and K3's twin on either within
    ``REL_ZQSO_CAP_LL`` of the largest |ll|; one launch.  Both against B's
    float64 sum of the same float32 terms: the kernel within
    ``REL_ZQSO_CAP_F64`` of its largest magnitude and no farther than the
    twin, which a kernel whose products were rounded lower would miss."""
    from gpy_dla_detection_tpu_torch.models import zqso
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import zqso_cap, zqso_cap_reference
    from gpy_dla_detection_tpu_torch.ops.zqso_cap_sweep import float64_sum, problem

    C = zqso.EXACT_CHUNK if C is None else C
    args = problem(cuda_device, C, k, special, step=step)
    before = _build.launch_counts["zqso_cap"]
    got = zqso_cap(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["zqso_cap"] == before + 1
    want = zqso_cap_reference(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        fin = torch.isfinite(w)
        scale = float(w[fin].abs().max())
        assert float((g[fin] - w[fin]).abs().max()) <= 1e-5 * scale
    exact = float64_sum(*args)
    fin = torch.isfinite(exact)
    scale = float(exact[fin].abs().max())
    err_kernel, err_twin = (float((x.double() - exact)[fin].abs().max()) / scale
                            for x in (got[0], want[0]))
    assert err_kernel <= REL_ZQSO_CAP_F64 and err_kernel <= err_twin, (err_kernel, err_twin)
    ll_k, ll_t = logmvn_chain_reference(*got), logmvn_chain_reference(*want)
    assert torch.equal(torch.isfinite(ll_k), torch.isfinite(ll_t))
    fin = torch.isfinite(ll_t)
    assert float((ll_k[fin] - ll_t[fin]).abs().max()) <= (
        REL_ZQSO_CAP_LL * float(ll_t[fin].abs().max()))
    if special == "window":
        assert float(ll_k[-1]) == 0.0
    if special == "median":
        assert not bool(torch.isfinite(ll_k[3]))


def test_zqso_cap_repeats_bit_for_bit_and_refuses_wide_bases(cuda_device):
    """Two launches on the same inputs give the same bits (the tiles'
    partial sums are added in order, no atomics).  k = 33, past the
    kernel's row bounds, is refused on the card; the exact scan sends such
    a model to the composition (interp_uniform + log_mvnpdf_low_rank) and
    launches no zqso_cap."""
    from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_z_observation
    from gpy_dla_detection_tpu_torch.models import zqso
    from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import ZQSO_CAP_MAX_K, zqso_cap
    from gpy_dla_detection_tpu_torch.ops.zqso_cap_sweep import problem
    from gpy_dla_detection_tpu_torch.params import ZParameters

    args = problem(cuda_device, 1_000, 20)
    a, b = zqso_cap(*args), zqso_cap(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    k = ZQSO_CAP_MAX_K + 1
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError, match=f"k={k}"):
        zqso_cap(*problem(cuda_device, 8, k))
    learned, obs = synthetic_z_observation(3.45, seed=0, k=k, obs_seed=9)
    model = learned.to(cuda_device, torch.float32)
    assert zqso._exact_route(model) == "basis"
    zqso.inference_z_qso(model, zqso.prepare_z_spectrum(*obs),
                         ZParameters(k=k, num_zqso_samples=64), method="exact")
    assert _build.launch_counts["zqso_cap"] == before.get("zqso_cap", 0)


def test_device_ms_windows_hold_every_launch(cuda_device):
    """The profiler can miss the kernels launched right after it starts
    until the device has synchronised under it; ``ops/timing`` first runs
    and waits for a sentinel kernel.  Twenty timings of K2 and K3 in a row
    each take a full window (a short one raises after three)."""
    from gpy_dla_detection_tpu_torch.ops.timing import device_ms

    B, u, misc = _chain_inputs(cuda_device, 20, 10_000)
    (y, mu, M, omega2, v, mask), A, extra = _problem(cuda_device, k=54, S=10_000, n_extra=3)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = packed_pair_basis(M)
    for _ in range(10):
        assert device_ms(lambda: logmvn_chain(B, u, misc), tries=1)[0] > 0
        # K2 at k = 54 is the wide kernel: its wrapper lays the basis out
        # (a fill and two copies) and launches it, 4 device records a call
        assert device_ms(lambda: logmvn_cap(rows, M, Mp, A, extra), kernels=4, tries=1)[0] > 0


def _grad_inputs(device, k, S):
    B, u, misc = _chain_inputs(device, k, S)
    g = torch.as_tensor(np.random.default_rng(k + S).normal(size=S).astype(np.float32),
                        device=device)
    return B, u, misc, g


def _assert_grads_close(got, want, rel=REL_K3_GRAD):
    for name, a, b in zip(("dB", "du", "dmisc"), got, want):
        b = b.to(a.device, a.dtype)
        assert torch.isfinite(a).all(), name
        err = float((a - b).abs().max())
        assert err <= rel * float(b.abs().max()), (name, err, float(b.abs().max()))


# k: both sides of the row bounds 24, 32 and 64 and of a half warp in a
# lane's first and second rows (16/17, 48/49), 8/9, the main path's 20,
# the odd 21, past 64 the wide kernel; S: a lone sample, one past a warp,
# an uneven count, the training's 4,096
@pytest.mark.parametrize("S", [1, 33, 1001, 4096])
@pytest.mark.parametrize("k", [1, 2, 8, 9, 16, 17, 20, 21, 24, 25, 31, 32, 33, 41, 48, 49, 63,
                               64, 65, 100])
def test_chain_grad_kernel_matches_twin(cuda_device, k, S):
    B, u, misc, g = _grad_inputs(cuda_device, k, S)
    name = "logmvn_chain_grad_wide" if k > 64 else "logmvn_chain_grad"
    before = _build.launch_counts[name]
    got = logmvn_chain_grad(B, u, misc, g)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    _assert_grads_close(got, logmvn_chain_grad_reference(B, u, misc, g))


# the last in shared memory, the first past it
@pytest.mark.parametrize("k", [CHAIN_GRAD_SHARED_MAX_K, CHAIN_GRAD_SHARED_MAX_K + 1])
def test_chain_grad_wide_kernel_in_shared_memory_and_workspace(cuda_device, k):
    assert (chain_grad_geometry(8, k).workspace > 0) == (k == CHAIN_GRAD_SHARED_MAX_K + 1)
    B, u, misc, g = _grad_inputs(cuda_device, k, 8)
    got = logmvn_chain_grad(B, u, misc, g)
    torch.cuda.synchronize()
    _assert_grads_close(got, logmvn_chain_grad_reference(B, u, misc, g))


@pytest.mark.parametrize("k", [1, 20, 21, 64, 65])
def test_chain_grad_kernel_on_the_training_inputs_against_float64(cuda_device, k):
    """The GP training's own capacitances (``woodbury_inputs`` of the
    synthetic training problem at Q = 1,024, R = 1,217, 31 forest lines,
    as chip_smoke.py phase 19): the kernel within REL_K3_GRAD of each
    output's max of the twin in float64 on the card."""
    from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_training_problem
    from gpy_dla_detection_tpu_torch.models import training as TT

    fields, arrays = synthetic_training_problem(1024, 1217, k, seed=k)
    p = TT.TrainingParams.from_numpy(fields, cuda_device)
    with torch.no_grad():
        B, u, misc = TT.woodbury_inputs(
            p, *(torch.as_tensor(x, device=cuda_device) for x in arrays), 31)
    g = torch.as_tensor(np.random.default_rng(k).normal(size=1024).astype(np.float32),
                        device=cuda_device)
    got = logmvn_chain_grad(B, u, misc, g)
    want = logmvn_chain_grad_reference(*(x.double() for x in (B, u, misc, g)))
    torch.cuda.synchronize()
    _assert_grads_close(got, want)


@pytest.mark.parametrize("k", [5, 20, 41, 65])
def test_chain_grad_kernel_gives_the_twins_nan_where_not_positive_definite(cuda_device, k):
    """A negative pivot (the first column's, a later one's) makes the
    sample's dB and du NaN in kernel and twin alike; the other samples are
    held to the twin."""
    B, u, misc, g = _grad_inputs(cuda_device, k, 100)
    diag = [j * k - j * (j - 1) // 2 for j in range(k)]  # packed (j, j)
    B[0, diag[0]] = -2.0
    B[1, diag[k // 2]] = -50.0
    got = logmvn_chain_grad(B, u, misc, g)
    want = logmvn_chain_grad_reference(B, u, misc, g)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], want[:2]):
        nan = torch.isnan(b).any(dim=1)
        assert nan[:2].all() and not nan[2:].any()
        assert torch.isnan(a[:2]).all()
    _assert_grads_close([x[2:] for x in got], [x[2:] for x in want])


@pytest.mark.parametrize("k", [1, 20, 21, 64, 65])
def test_chain_loglik_gradients_on_the_card_against_cpu_float64(cuda_device, k):
    """gradcheck-style: chain_loglik's value and its autograd gradients on
    the card in float32 (K3 and its adjoint) against the same on the CPU in
    float64 (the twins), each within 1e-5 of its largest magnitude; one
    launch each."""
    B, u, misc, g = _grad_inputs(cuda_device, k, 1001)
    cpu = [x.cpu().double().requires_grad_() for x in (B, u, misc)]
    card = [x.clone().requires_grad_() for x in (B, u, misc)]
    _build.reset_launch_counts()
    ll = chain_loglik(*card)
    (ll * g).sum().backward()
    torch.cuda.synchronize()
    wide = "_wide" if k > 64 else ""
    assert dict(_build.launch_counts) == {f"logmvn_chain{wide}": 1, f"logmvn_chain_grad{wide}": 1}
    ll64 = chain_loglik(*cpu)
    (ll64 * g.cpu().double()).sum().backward()
    assert float((ll.detach().double().cpu() - ll64.detach()).abs().max()) <= (
        REL_K3_GRAD * float(ll64.detach().abs().max()))
    _assert_grads_close([x.grad for x in card], [x.grad for x in cpu])


def test_chain_grad_launcher_refuses_k_beyond_its_row_bound(cuda_device):
    k = 65
    B = torch.zeros((4, k * (k + 1) // 2), device=cuda_device)
    u = torch.zeros((4, k), device=cuda_device)
    g = torch.zeros((4,), device=cuda_device)
    dB, du, dmisc = torch.empty_like(B), torch.empty_like(u), torch.empty((4, 2), device=cuda_device)
    geo = chain_grad_geometry(4, 64)
    err = _build.load_library().logmvn_chain_grad_launch(
        _build.ptr(B), _build.ptr(u), _build.ptr(g), 4, k, geo.rows, geo.warps,
        geo.shared_bytes, geo.grid, _build.ptr(dB), _build.ptr(du), _build.ptr(dmisc),
        _build.stream_ptr(cuda_device))
    assert err != 0


@pytest.mark.parametrize("k", [20, 65])
def test_total_objective_backward_launches_k3_and_its_adjoint(cuda_device, k):
    """One total_objective forward and backward at Q = 256 on the card:
    one K3 and one adjoint launch (the wide pair past k = 64), no
    composition; the gradients finite and within phase 19's 1e-3 of each
    block's largest magnitude of the CPU float64 gradients."""
    from gpy_dla_detection_tpu_torch.models import training as TT
    from gpy_dla_detection_tpu_torch.params import Parameters

    rng = np.random.default_rng(k)
    Q, R = 256, 300
    fields = (rng.normal(0, 0.3, (R, k)), np.log(rng.uniform(0.1, 0.3, R)), np.log(0.1),
              np.log(0.0023), np.log(3.65))
    mask = rng.uniform(size=(Q, R)) > 0.2
    arrays = (rng.normal(0, 1, (Q, R)) * mask, np.linspace(3.0, 4.2, R)[None].repeat(Q, 0),
              rng.uniform(0.01, 0.3, (Q, R)), mask, rng.uniform(2.5, 4.5, Q))
    params = Parameters(k=k)

    def grads(device, dtype):
        p = TT.TrainingParams.from_numpy(fields, device, dtype)
        args = [torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else dtype,
                                device=device) for a in arrays]
        TT.total_objective(p, *args, params).backward()
        return {n: getattr(p, n).grad.double().cpu() for n in TT.PARAM_FIELDS}

    _build.reset_launch_counts()
    got = grads(cuda_device, torch.float32)
    torch.cuda.synchronize()
    wide = "_wide" if k > 64 else ""
    assert dict(_build.launch_counts) == {f"logmvn_chain{wide}": 1, f"logmvn_chain_grad{wide}": 1}
    want = grads("cpu", torch.float64)
    for n in TT.PARAM_FIELDS:
        assert torch.isfinite(got[n]).all(), n
        assert float((got[n] - want[n]).abs().max()) <= 1e-3 * float(want[n].abs().max()), n
