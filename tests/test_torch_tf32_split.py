"""The 3xTF32 product of K2's wide kernel (``csrc/logmvn_cap_wide.cu``),
emulated in numpy, against the float32 twin and the JAX package's float64
likelihood.

The wide kernel splits every operand x of B = w @ M_pair and u = r @ M
into hi = tf32(x) and lo = tf32(x - hi), TF32 being float32 rounded to
nearest (ties away from zero) with the 13 low mantissa bits dropped, as
``cvt.rna.tf32.f32`` does.  For each 16-pixel chunk (two 8-pixel mma
steps) it sums lo.hi, hi.lo and hi.hi on the tensor cores into a fresh sum
and adds that to its running sum in IEEE float32.  The model here: each
TF32 product is exact, each
tensor-core accumulation (8 products and the sum it adds to) is exact and
then truncated to float32 (rounded toward zero), as the card's showed: with
every step accumulated into one running sum on the tensor cores, the wide
route's likelihood carried a one-sided error, median |dll| 7.69e-4 against
float64 (budget 7.4e-4; NVIDIA H100 80GB HBM3, 700.00 W, k = 54, 3
streams).  The products are formed from the twin's own w and r
(``assemble_reference``) at the wide bases k = 54 and 65, N = 1,280, 3
chained streams, 128 samples; the twin's chain
(``logmvn_chain_reference``) turns them into log-likelihoods.  Held:

* the kernel's summation within REL_K23 = 1e-6 of max|ll| of the float32
  twin (the bound every K2 and K3 kernel meets against its twin on the
  card), and within the reference's float32 budget of the JAX package's
  float64 ``batched_log_mvnpdf`` (its XLA composition on the CPU): median
  |dll| 7.4e-4, max 3.8e-3 (ops/logmvn_pallas.py:206-210);
* one TF32 product alone misses the twin's bound (~4-7e-6 here), which is
  why the kernel pays for three;
* the three products summed over all steps in one truncated running sum
  miss the float64 budget, which is why each step starts a fresh sum.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpy_dla_detection_tpu.ops import logmvn as J
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    assemble_reference,
    logmvn_cap_reference,
    logmvn_chain_reference,
    packed_pair_basis,
)

torch.set_num_threads(2)

REL_K23 = 1e-6
MEDIAN_VS_F64 = 7.4e-4
MAX_VS_F64 = 3.8e-3
N_PIXELS, N_SAMPLES, N_STREAMS = 1280, 128, 3
STEP = 8  # pixels an mma.sync.m16n8k8 sums
CHUNK = 16  # pixels of a fresh sum (the kernel's chunk)


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (round to nearest, ties away from zero, 13
    mantissa bits dropped), kept in float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def truncate(x: np.ndarray) -> np.ndarray:
    """float64 to float32 rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _mma_terms(L: np.ndarray, R: np.ndarray):
    """Per 8-pixel step, the three exact float64 products lo.hi, hi.lo,
    hi.hi of the split operands."""
    (lh, ll), (rh, rl) = split(L), split(R)
    mm = lambda a, b: (torch.from_numpy(a.astype(np.float64))
                       @ torch.from_numpy(b.astype(np.float64))).numpy()
    for n0 in range(0, L.shape[1], STEP):
        s = slice(n0, n0 + STEP)
        yield mm(ll[:, s], rh[s]), mm(lh[:, s], rl[s]), mm(lh[:, s], rh[s])


def product_3xtf32(L: np.ndarray, R: np.ndarray) -> np.ndarray:
    """L @ R as the wide kernel forms it: a fresh truncated tensor-core sum
    of lo.hi + hi.lo + hi.hi over a chunk's steps, added to the running sum
    in IEEE float32."""
    acc = np.zeros((L.shape[0], R.shape[1]), np.float32)
    steps = list(_mma_terms(L, R))
    for c0 in range(0, len(steps), CHUNK // STEP):
        t = np.zeros_like(acc)
        for terms in steps[c0:c0 + CHUNK // STEP]:
            for term in terms:
                t = truncate(t.astype(np.float64) + term)
        acc = acc + t
    return acc


def product_3xtf32_one_sum(L: np.ndarray, R: np.ndarray) -> np.ndarray:
    """The three products of every step accumulated on the tensor cores
    into one truncated running sum."""
    acc = np.zeros((L.shape[0], R.shape[1]), np.float32)
    for terms in _mma_terms(L, R):
        for term in terms:
            acc = truncate(acc.astype(np.float64) + term)
    return acc


def product_1xtf32(L: np.ndarray, R: np.ndarray) -> np.ndarray:
    return (torch.from_numpy(tf32(L)) @ torch.from_numpy(tf32(R))).numpy()


def _problem(k: int):
    """tests/test_torch_kernels_gpu.py's wide construction (seed k)."""
    rng = np.random.default_rng(k)
    N = N_PIXELS
    M = (rng.normal(size=(N, k)) / np.sqrt(k) * 0.1).astype(np.float32)
    y = (1 + 0.1 * rng.normal(size=N)).astype(np.float32)
    mu = np.ones(N, np.float32)
    omega2 = rng.uniform(0.01, 0.05, N).astype(np.float32)
    v = rng.uniform(0.02, 0.1, N).astype(np.float32)
    mask = rng.uniform(size=N) > 0.1
    A = np.exp(-rng.random((N_SAMPLES, N))).astype(np.float32)
    extra = [np.exp(-0.3 * rng.random((N_SAMPLES, N))).astype(np.float32)
             for _ in range(N_STREAMS)]
    return (y, mu, M, omega2, v, mask), A, extra


@functools.lru_cache(maxsize=None)
def _likelihoods(k: int, product):
    """The float32 twin's ll and the ll with both products formed by
    ``product`` from the twin's w and r; the base arrays, A and streams."""
    base, A, extra = _problem(k)
    y, mu, M, omega2, v, mask = (torch.as_tensor(x) for x in base)
    rows = torch.stack([y, mu, omega2, v, mask.float()])
    Mp = packed_pair_basis(M)
    A_t, extra_t = torch.as_tensor(A), [torch.as_tensor(e) for e in extra]
    B, u, misc = logmvn_cap_reference(rows, M, Mp, A_t, extra_t)
    ll32 = logmvn_chain_reference(B, u, misc).double().numpy()
    _, w, r, *_ = assemble_reference(rows, A_t, extra_t)
    B_t = torch.from_numpy(product(w.numpy(), Mp.numpy()))
    u_t = torch.from_numpy(product(r.numpy(), M.numpy()))
    ll_t = logmvn_chain_reference(B_t, u_t, misc).double().numpy()
    return ll32, ll_t, base, A, extra


def test_tf32_rounding_drops_thirteen_bits_to_nearest():
    x = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11),
                  3.0e-20, -7.5], np.float32)
    got = tf32(x)
    assert np.array_equal(got, np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0,
                                         -(1.0 + 2.0**-10), got[5], -7.5], np.float32))
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # hi + lo keeps x to 2^-22 of |x| (two 11-bit pieces of its 24 bits)
    hi, lo = split(x)
    resid = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
    assert (resid <= 2.0**-22 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("k", [54, 65])
def test_3xtf32_products_meet_the_twins_bound(k):
    ll32, ll3, *_ = _likelihoods(k, product_3xtf32)
    scale = np.abs(ll32).max()
    assert np.isfinite(ll3).all()
    assert np.abs(ll3 - ll32).max() <= REL_K23 * scale


@pytest.mark.parametrize("k", [54, 65])
def test_one_tf32_product_misses_the_twins_bound(k):
    ll32, ll1, *_ = _likelihoods(k, product_1xtf32)
    assert np.abs(ll1 - ll32).max() > REL_K23 * np.abs(ll32).max()


def _vs_jax_float64(ll, base, A, extra):
    f64 = lambda x: jnp.asarray(x.astype(np.float64) if x.dtype != bool else x)
    ll64 = np.asarray(J.batched_log_mvnpdf(
        *[f64(x) for x in base], f64(A), use_pallas=False,
        extra=f64(np.prod(np.stack(extra).astype(np.float64), axis=0))))
    d = np.abs(ll - ll64)
    return float(np.median(d)), float(d.max())


@pytest.mark.parametrize("k", [54, 65])
def test_3xtf32_likelihood_within_the_float32_budget_of_jax_float64(k):
    _, ll3, base, A, extra = _likelihoods(k, product_3xtf32)
    median, worst = _vs_jax_float64(ll3, base, A, extra)
    assert median <= MEDIAN_VS_F64 and worst <= MAX_VS_F64, (median, worst)


@pytest.mark.parametrize("k", [54, 65])
def test_one_truncated_running_sum_misses_the_float64_budget(k):
    _, ll1, base, A, extra = _likelihoods(k, product_3xtf32_one_sum)
    median, _ = _vs_jax_float64(ll1, base, A, extra)
    assert median > MEDIAN_VS_F64
