"""Compact profile storage (int16 fixed-point codes) in the PyTorch port,
against the JAX package's ``GPY_DLA_ABS_DTYPE=i16`` and ``i16p``.

* ``encode_profile_store`` equals the reference's encode for float32 and
  float64 profiles, exact half-step ties included (half to even), codes
  in [0, 32767]; the reference's packed int32 pairs (``i16p``) unpack to
  exactly the port's int16 codes, and ``profile_store_dtype("i16p")`` is
  int16.
* ``decode_profile_store`` is the reference's decode (``code * (1 /
  32767)``, a product with the reciprocal) in float32 and float64, and the
  float64 likelihood on codes equals the reference's XLA composition on
  its int16 and int32 codes to 1e-10 relative.
* K1's, K5's and K6's twins with int16 output against the interpret-mode
  Pallas kernels with ``out_dtype=jnp.int16``: the codes are compared, not
  floats.  Each side's codes are the rounding of its own float32 profile
  (checked exactly on both sides), so two float32 profiles that differ by
  d give codes that differ by at most ceil(32767 d).  Where the float32
  profiles agree to the 1e-6 of their own tests (K1 with the polynomial
  window, K5, K6) that is max |dcode| <= 1, with the share of codes that
  differ printed (measured 3e-4 to 1.3e-3).  K1's Weideman window
  (poly=False) differs from the interpret-mode Pallas kernel by up to its
  own float test's bound, 5e-4 (2.5e-3 at the LLS search's column
  densities), because the Pallas kernel's float32 rational cancels near a
  line centre (tests/test_torch_absorption_kernel.py); its codes are held
  to that bound on the 1/32767 grid (17 and 82 codes; measured 4 and 11,
  and 29 with the break), the DLA family's to max |dcode| <= 1 like the
  polynomial window's.
* K2's twin on int16 codes, with 1 and 3 streams, at the reference test's
  shape (N = 512, k = 4, S = 72) and at an odd N, against
  ``batched_log_mvnpdf_pallas(..., interpret=True)`` on int16 and on
  packed int32 codes: held as tests/test_torch_logmvn.py holds the float32
  twins (the float64 composition of the same decoded inputs is the
  referee; max error within 1.5x the Pallas kernel's own or the reference
  budget, and the median |dll| within 2e-6 of the largest |ll|), and
  directly within 1e-6 of the largest |ll| (measured <= 3.2e-7); the
  Pallas kernel on int16 and on int32 codes agrees exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu import constants as JC
from gpy_dla_detection_tpu.ops import logmvn as J
from gpy_dla_detection_tpu.ops import voigt as JV
from gpy_dla_detection_tpu.ops.kernel_config import ABS_I16_SCALE as J_SCALE
from gpy_dla_detection_tpu.ops.logmvn_pallas import batched_log_mvnpdf_pallas
from gpy_dla_detection_tpu.ops.voigt import encode_profile_store as J_encode
from gpy_dla_detection_tpu.ops.voigt_pallas import (
    absorption_all_pallas,
    absorption_from_unit_tau_pallas,
    absorption_windowed_pallas,
)
from gpy_dla_detection_tpu_torch.ops import _build
from gpy_dla_detection_tpu_torch.ops import logmvn as T
from gpy_dla_detection_tpu_torch.ops import voigt as TV
from gpy_dla_detection_tpu_torch.ops.kernel_config import (
    ABS_I16_SCALE,
    profile_store_dtype,
)
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    logmvn_cap,
    logmvn_cap_reference,
    logmvn_chain_reference,
    packed_pair_basis,
)
from gpy_dla_detection_tpu_torch.ops.voigt_kernels import (
    absorption_all,
    absorption_all_reference,
    absorption_tail,
    absorption_tail_reference,
    absorption_windowed,
    absorption_windowed_reference,
    k1_launch_name,
)

torch.set_num_threads(2)

MAX_DCODE = 1
TOL_WEIDEMAN = 5e-4  # tests/test_torch_absorption_kernel.py
TOL_WEIDEMAN_LLS = 2.5e-3
REL_VS_JAX_KERNEL = 2e-6  # tests/test_torch_logmvn.py
REL_K2 = 1e-6
REL_F32_BUDGET = 3.8e-3 / 1.1e4
REL_F64 = 1e-10


def _unpack_i16p(packed: np.ndarray) -> np.ndarray:
    """The reference's packed pairs as plain codes: low halves are pixels
    0..N/2 - 1, high halves N/2..N - 1 (ops/kernel_config.py)."""
    p = packed.astype(np.int64)
    return np.concatenate([p & 0xFFFF, p >> 16], axis=-1)


def _ties(dtype, seed=0, n=4000):
    """Profiles whose scaled value is exactly a half step k + 1/2 in
    ``dtype`` (candidates near (k + 1/2) / 32767, kept where the product
    rounds to the tie)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 32767, n)
    a = ((k + 0.5) / 32767.0).astype(dtype)
    cand = (a[:, None] + np.arange(-3, 4).astype(dtype) * np.spacing(a)[:, None]).ravel()
    prod = cand * dtype(ABS_I16_SCALE)
    return cand[(prod - np.floor(prod)) == 0.5]


def test_profile_store_dtype_and_the_reference_constant():
    assert ABS_I16_SCALE == J_SCALE == 32767.0
    assert profile_store_dtype("f32") == torch.float32
    assert profile_store_dtype("i16") == profile_store_dtype("i16p") == torch.int16
    with pytest.raises(ValueError):
        profile_store_dtype("bf16")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode_matches_reference_with_half_step_ties(dtype):
    rng = np.random.default_rng(1)
    ties = _ties(dtype)
    assert ties.size > 100
    a = np.concatenate([rng.uniform(0.0, 1.0, 20000).astype(dtype), ties,
                        np.array([0.0, 1.0], dtype)])
    got = TV.encode_profile_store(torch.as_tensor(a), torch.int16).numpy()
    want = np.asarray(J_encode(jnp.asarray(a), jnp.int16))
    assert got.dtype == np.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() == 32767
    # half to even at every tie
    tie_codes = got[-ties.size - 2:-2].astype(np.int64)
    assert np.all(tie_codes % 2 == 0)
    np.testing.assert_array_equal(np.abs(tie_codes - ties * dtype(ABS_I16_SCALE)), 0.5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_packed_i16p_codes_are_the_i16_codes(dtype):
    """The reference's i16p stores two codes a lane; unpacked, they are
    exactly the port's int16 codes, which ``"i16p"`` stores."""
    a = np.random.default_rng(2).uniform(0.0, 1.0, (6, 512)).astype(dtype)
    packed = np.asarray(J_encode(jnp.asarray(a), jnp.int32))
    assert packed.dtype == np.int32 and packed.shape == (6, 256)
    got = TV.encode_profile_store(torch.as_tensor(a), profile_store_dtype("i16p")).numpy()
    np.testing.assert_array_equal(_unpack_i16p(packed), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decode_is_the_references(dtype):
    codes = np.arange(0, 32768, dtype=np.int16)
    got = T.decode_profile_store(torch.as_tensor(codes), dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    # the reference's _decode: x.astype(dtype) * (1.0 / ABS_I16_SCALE)
    want = np.asarray(jnp.asarray(codes).astype(np_dtype) * (1.0 / J_SCALE))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[-1]) == 1.0 and float(got[0]) == 0.0
    # round trip: a code decodes and encodes to itself
    np.testing.assert_array_equal(TV.encode_profile_store(got, torch.int16).numpy(), codes)


def _problem(N=512, k=4, S=72, n_extra=1, seed=3):
    """The masked Woodbury problem of tests/test_logmvn.py's
    test_pallas_i16_profile_decode (S = 72 pads in the Pallas kernel)."""
    rng = np.random.default_rng(seed)
    M = (rng.normal(size=(N, k)) / np.sqrt(k) * 0.1).astype(np.float32)
    y = (1 + 0.1 * rng.normal(size=N)).astype(np.float32)
    mu = np.ones(N, np.float32)
    omega2 = rng.uniform(0.01, 0.05, N).astype(np.float32)
    v = rng.uniform(0.02, 0.1, N).astype(np.float32)
    mask = rng.uniform(size=N) > 0.1
    A = np.exp(-rng.random((S, N))).astype(np.float32)
    extra = [np.exp(-rng.random((S, N))).astype(np.float32) for _ in range(n_extra)]
    return (y, mu, M, omega2, v, mask), A, extra


def _codes(x: np.ndarray) -> np.ndarray:
    return TV.encode_profile_store(torch.as_tensor(x), torch.int16).numpy()


@pytest.mark.parametrize("n_extra", [1, 3])
def test_float64_likelihood_on_codes_matches_reference(n_extra):
    base, A, extra = _problem(n_extra=n_extra)
    b64 = [x.astype(np.float64) if x.dtype != bool else x for x in base]
    jb = [jnp.asarray(x) for x in b64]
    codes = [_codes(x) for x in [A] + extra]
    got = T.batched_log_mvnpdf(*[torch.as_tensor(x) for x in b64], torch.as_tensor(codes[0]),
                               extra=[torch.as_tensor(c) for c in codes[1:]]).numpy()
    for store in (jnp.int16, jnp.int32):
        jA = J_encode(jnp.asarray(A), store)
        jE = tuple(J_encode(jnp.asarray(e), store) for e in extra)
        want = np.asarray(J.batched_log_mvnpdf(*jb, jA, use_pallas=False,
                                               extra=jE if n_extra > 1 else jE[0]))
        np.testing.assert_allclose(got, want, rtol=REL_F64, atol=0, err_msg=str(store))


def _assert_codes_close(got: np.ndarray, want: np.ndarray, max_dcode: int, label: str):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    share = float(np.mean(d > 0))
    print(f"{label}: max |dcode| {d.max()}, share of codes that differ {share:.2e}")
    assert got.shape == want.shape and got.dtype == want.dtype == np.int16
    assert d.max() <= max_dcode, (label, d.max(), share)


def _grids_and_samples(P=300, S=24, seed=3):
    """The inputs of tests/test_torch_absorption_kernel.py (and of
    tests/test_voigt.py's K1 tests): a regular log grid, its +-30%
    jittered twin, DLA and subDLA families."""
    rng = np.random.default_rng(seed)
    base = 1215.67 * 3.9 * 10 ** (1e-4 * np.arange(P))
    steps = np.diff(base) * (1.0 + 0.3 * rng.uniform(-1, 1, P - 1))
    jittered = base[0] + np.concatenate([[0.0], np.cumsum(steps)])
    z = rng.uniform(2.9, 3.8, S).astype(np.float32)
    nhi_dla = (10 ** rng.uniform(20, 22, S)).astype(np.float32)
    nhi_sub = (10 ** rng.uniform(19.5, 20.3, S)).astype(np.float32)
    return {"regular": base, "jittered": jittered}, z, (nhi_dla, nhi_sub)


def _lls_grid(P=1664, S=16, seed=5):
    """The inputs of tests/test_torch_lls.py's K1 test with the break."""
    rng = np.random.default_rng(seed)
    wl = (850.0 * 4.2 * 10 ** (1e-4 * np.arange(P))).astype(np.float32)
    z = rng.uniform(3.0, 3.6, S).astype(np.float32)
    nhi = (10 ** rng.uniform(17.5, 20.5, S)).astype(np.float32)
    return wl, z, (nhi,)


K1_CASES = [(g, lb) for g in ("regular", "jittered") for lb in (False,)] + [("lls", True)]


@pytest.mark.parametrize("poly", [True, False])
@pytest.mark.parametrize("grid_name, lls_break", K1_CASES)
def test_k1_twin_int16_matches_pallas_int16(grid_name, lls_break, poly):
    if lls_break:
        wl, z, nhis = _lls_grid()
    else:
        grids, z, nhis = _grids_and_samples()
        wl = grids[grid_name].astype(np.float32)
    jargs = (jnp.asarray(wl), jnp.asarray(z), tuple(jnp.asarray(n) for n in nhis), 3)
    want = absorption_all_pallas(*jargs, interpret=True, out_dtype=jnp.int16,
                                 lls_break=lls_break, poly=poly)
    want_f32 = absorption_all_pallas(*jargs, interpret=True, lls_break=lls_break, poly=poly)
    targs = (torch.as_tensor(wl), torch.as_tensor(z), tuple(torch.as_tensor(n) for n in nhis), 3,
             lls_break, poly)
    got = absorption_all_reference(*targs, out_dtype=torch.int16)
    got_f32 = absorption_all_reference(*targs)
    tol = TOL_WEIDEMAN_LLS if lls_break else TOL_WEIDEMAN
    for f, (g, w, g32, w32) in enumerate(zip(got, want, got_f32, want_f32)):
        g, w, w32 = g.numpy(), np.asarray(w), np.asarray(w32)
        # each side's codes are its own float32 profile's, rounded
        np.testing.assert_array_equal(np.asarray(J_encode(jnp.asarray(w32), jnp.int16)), w)
        np.testing.assert_array_equal(np.asarray(J_encode(jnp.asarray(g32.numpy()), jnp.int16)),
                                      g)
        label = f"K1 poly={poly} {grid_name} family {f}"
        weideman_subdla = not poly and (f == 1 or lls_break)
        _assert_codes_close(
            g, w, math.ceil(tol * ABS_I16_SCALE) if weideman_subdla else MAX_DCODE, label)


def test_k1_wrapper_stores_int16_on_the_cpu():
    grids, z, nhis = _grids_and_samples(S=8)
    args = (torch.as_tensor(grids["regular"].astype(np.float32)), torch.as_tensor(z),
            tuple(torch.as_tensor(n) for n in nhis))
    _build.reset_launch_counts()
    for poly in (True, False):
        got = absorption_all(*args, poly=poly, out_dtype=torch.int16)
        want = absorption_all_reference(*args, poly=poly, out_dtype=torch.int16)
        assert all(g.dtype == torch.int16 and torch.equal(g, w) for g, w in zip(got, want))
        assert k1_launch_name(poly, torch.int16) == k1_launch_name(poly) + "_i16"
    assert sum(_build.launch_counts.values()) == 0  # the twin launches nothing
    with pytest.raises(TypeError):
        absorption_all(*args, out_dtype=torch.float64)


@pytest.mark.parametrize("S", [523, 16])
def test_k5_twin_int16_matches_pallas_int16(S):
    grids, _, _ = _grids_and_samples(P=1286, S=1)
    rng = np.random.default_rng(S)
    wl = torch.as_tensor(grids["regular"].astype(np.float32))
    z = torch.as_tensor(rng.uniform(2.9, 3.8, S).astype(np.float32))
    nhi = torch.as_tensor((10 ** rng.uniform(19.5, 22.5, S)).astype(np.float32))
    unit = TV.unit_lyman_optical_depth(wl, z, 3)
    want = np.asarray(absorption_from_unit_tau_pallas(
        jnp.asarray(unit.numpy()), jnp.asarray(nhi.numpy()), interpret=True,
        out_dtype=jnp.int16))
    got = absorption_tail_reference(unit, nhi, torch.int16).numpy()
    _assert_codes_close(got, want, MAX_DCODE, f"K5 S={S}")
    assert torch.equal(absorption_tail(unit, nhi, torch.int16), torch.as_tensor(got))
    # the float64 conformance path encodes after the exact profile
    u64 = unit.double()
    np.testing.assert_array_equal(
        TV.absorption_from_unit_tau(u64, nhi.double(), torch.int16).numpy(),
        np.asarray(J_encode(JV.absorption_from_unit_tau(jnp.asarray(u64.numpy()),
                                                        jnp.asarray(nhi.double().numpy())),
                            jnp.int16)))


@pytest.mark.parametrize("num_lines", [3, 8])
def test_k6_twin_int16_matches_pallas_int16(num_lines, monkeypatch):
    grids, _, _ = _grids_and_samples(P=1286, S=1)
    rng = np.random.default_rng(num_lines)
    wl = grids["jittered"].astype(np.float32)
    z = rng.uniform(2.9, 3.8, 48).astype(np.float32)
    nhi = (10 ** rng.uniform(19.5, 22.5, 48)).astype(np.float32)
    monkeypatch.setattr(JV, "WINDOW_TIER", True)
    parts = JV._windowed_tau_parts(jnp.asarray(wl), jnp.asarray(z), num_lines,
                                   JC.THERMAL_SIGMA_CGS)
    want = np.asarray(absorption_windowed_pallas(parts, jnp.asarray(nhi), interpret=True,
                                                 out_dtype=jnp.int16))
    tparts = TV.WindowedTauParts(
        torch.tensor(np.asarray(parts.far)), torch.tensor(np.asarray(parts.corr)),
        torch.tensor(np.asarray(parts.c0)), parts.num_pixels)
    got = absorption_windowed_reference(tparts, torch.as_tensor(nhi), torch.int16).numpy()
    _assert_codes_close(got, want, MAX_DCODE, f"K6 L={num_lines}")
    assert torch.equal(absorption_windowed(tparts, torch.as_tensor(nhi), torch.int16),
                       torch.as_tensor(got))


def _f64_on_codes(base, codes):
    """The float64 composition of the decoded codes: the referee."""
    b64 = [x.astype(np.float64) if x.dtype != bool else x for x in base]
    dec = [c.astype(np.float64) * (1.0 / ABS_I16_SCALE) for c in codes]
    prod = np.prod(np.stack(dec[1:]), axis=0) if len(dec) > 1 else None
    return np.asarray(J.batched_log_mvnpdf(
        *[jnp.asarray(x) for x in b64], jnp.asarray(dec[0]), use_pallas=False,
        extra=None if prod is None else jnp.asarray(prod)))


# N = 512: the reference test's shape; N = 301: odd (int16 only; the
# reference's packed pairs need an even N)
@pytest.mark.parametrize("N", [512, 301])
@pytest.mark.parametrize("n_extra", [1, 3])
def test_k2_twin_on_codes_matches_pallas_on_codes(N, n_extra):
    base, A, extra = _problem(N=N, n_extra=n_extra)
    k = base[2].shape[1]
    codes = [_codes(x) for x in [A] + extra]
    ja = [jnp.asarray(x) for x in base]
    stores = (jnp.int16, jnp.int32) if N % 2 == 0 else (jnp.int16,)
    pallas = []
    for store in stores:
        jA = J_encode(jnp.asarray(A), store)
        jE = tuple(J_encode(jnp.asarray(e), store) for e in extra)
        pallas.append(np.asarray(batched_log_mvnpdf_pallas(
            *ja, jA, J.pair_basis(ja[2]), k, interpret=True, extra=jE)))
    for p in pallas[1:]:
        np.testing.assert_array_equal(p, pallas[0])  # packed pairs: the same codes
    y, mu, M, omega2, v, mask = [torch.as_tensor(x) for x in base]
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    tcodes = [torch.as_tensor(c) for c in codes]
    _build.reset_launch_counts()
    cap = logmvn_cap(rows, M, packed_pair_basis(M), tcodes[0], tcodes[1:])
    assert sum(_build.launch_counts.values()) == 0
    got = logmvn_chain_reference(*cap).numpy()
    # the twin's assembly decodes exactly as its caller would
    dec = [T.decode_profile_store(c, torch.float32) for c in tcodes]
    want_dec = logmvn_chain_reference(*logmvn_cap_reference(
        rows, M, packed_pair_basis(M), dec[0], dec[1:])).numpy()
    np.testing.assert_array_equal(got, want_dec)
    f64 = _f64_on_codes(base, codes)
    scale = np.abs(f64).max()
    err_twin = np.abs(got.astype(np.float64) - f64).max()
    err_jax = np.abs(pallas[0].astype(np.float64) - f64).max()
    print(f"K2 N={N} streams={n_extra}: twin vs f64 {err_twin / scale:.2e}, Pallas vs f64 "
          f"{err_jax / scale:.2e}, twin vs Pallas max {np.abs(got - pallas[0]).max() / scale:.2e}"
          f" of max|ll| {scale:.4g}")
    assert err_twin <= 1.5 * max(err_jax, REL_F32_BUDGET * scale)
    assert np.median(np.abs(got - pallas[0])) <= REL_VS_JAX_KERNEL * scale
    assert np.abs(got - pallas[0]).max() <= REL_K2 * scale


def test_k2_refuses_mixed_storage():
    base, A, extra = _problem(n_extra=1)
    y, mu, M, omega2, v, mask = [torch.as_tensor(x) for x in base]
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    with pytest.raises(TypeError):
        logmvn_cap(rows, M, packed_pair_basis(M), torch.as_tensor(_codes(A)),
                   [torch.as_tensor(extra[0])])
