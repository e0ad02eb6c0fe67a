"""The arithmetic of K3's adjoint (``csrc/logmvn_chain_grad.cu``), replayed
in numpy, against its float64 twin and the JAX package's ``jax.grad``.

Both of the kernel's routes run Goodnight's symmetric sweep: A = I + B
inverted in place by k pivot steps, u riding along as one more column;
step p, with d = A_pp,

    A_ij -= A_ip A_pj / d (i, j != p),  A_ip = A_pi = A_ip / d,  A_pp = -1/d,

leaves -A^-1 and v = A^-1 u; then dB(i, j) = -g/2 (v_i v_j + (A^-1)_ij),
doubled off the diagonal, and du = g v.  Modelled here in the kernels' own
orders:

* :func:`sweep_rows` (k <= 64, the warp kernel): lane a owns row a in full
  and a scale sig_a; step p broadcasts the true column c_j = sig_j A_jp,
  every row but p takes A_aj -= (A_ap / d) c_j (one FMA an entry), and row
  p keeps its stored values with sig_p = 1/d and its entry p = -1;
* :func:`sweep_blocks` (k > 64, the wide kernel): the packed lower
  triangle, pivots four at a time: the 4 x 4 pivot block swept as above
  (G = -P, P its inverse), F_j = P E_j from row j's entries in the pivot
  columns (E_j), A_ij -= E_i . F_j for i >= j outside the block (four FMAs
  in order), then A_iS = F_i, A_SS = G, u_S = F_u.

In float32 an FMA is the float64 product of two float32 values (exact)
plus the addend, rounded to float64 and then to float32, and 1/d the
float64 quotient rounded to float32 (``__frcp_rn``): each may differ from
the card's single rounding by one ulp where the double rounding falls on a
tie, which is far below the bounds held.  Held:

* each output (dB, du) of the float32 model within MODEL_VS_F64 = 2.5e-6 of
  its largest magnitude of the float64 twin
  (``logmvn_chain_grad_reference``), at k = 1, 2, 20, 21, 32, 33, 64 and 65,
  on tests/test_torch_training.py's capacitances and on the GP training's
  own (``woodbury_inputs`` of ``synthetic_training_problem``, Q = 32, R =
  1,217, 31 forest lines); and the model's error plus the float32 twin's
  own within REL_K3_GRAD = 1e-5, the bound the card holds the kernel to
  against the float32 twin (``chip_smoke.py``,
  ``tests/test_torch_kernels_gpu.py``): by the triangle inequality a
  kernel that rounds as the model does meets it.  MODEL_VS_F64 is a
  quarter of REL_K3_GRAD (the model measured <= 9.6e-7 here, the twin <=
  8.0e-7);
* the rows where a pivot is not positive NaN in dB and du, as the twin's;
* both sweeps in float64 against ``jax.grad`` of the JAX package's
  ``batched_quad_logdet`` (``gpy_dla_detection_tpu/ops/logmvn.py:111``,
  the function the JAX training differentiates) at k = 1, 5 and 20 to
  rtol 1e-9 (two float64 routes to the same gradient on capacitances of
  condition ~1e3: they differ by ~1e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu.ops.logmvn import batched_quad_logdet
from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_training_problem
from gpy_dla_detection_tpu_torch.models import training as TT
from gpy_dla_detection_tpu_torch.ops.logmvn_kernels import (
    CHAIN_MAX_K,
    _packed_maps,
    logmvn_chain_grad_reference,
)

torch.set_num_threads(2)

REL_K3_GRAD = 1e-5
MODEL_VS_F64 = REL_K3_GRAD / 4
JAX_RTOL = 1e-9
KS = (1, 2, 20, 21, 32, 33, 64, 65)
PIVOTS = 4  # the wide kernel's pivots a step
F32, F64 = np.float32, np.float64


def _fma(a, b, c, dt):
    if dt == F64:
        return a * b + c
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def _rcp(d, dt):
    return (1.0 / np.asarray(d, F64)).astype(dt)


def _full(B, k, dt):
    """(S, k(k+1)/2) packed -> (S, k, k) I + B in ``dt`` (the +1 rounded
    in ``dt``, as the kernels add it)."""
    cols, rows = (np.asarray(x) for x in _packed_maps(k))
    A = np.zeros((B.shape[0], k, k), dt)
    A[:, rows, cols] = B
    A[:, cols, rows] = B
    idx = np.arange(k)
    A[:, idx, idx] = (A[:, idx, idx] + dt(1)).astype(dt)
    return A


def _outputs(Minus, v, g, bad, dt):
    """dB = h (v_i v_j - M_ij) with M = -A^-1 (h = -g/2 on the diagonal,
    -g off it), du = g v; NaN in a bad sample's rows."""
    k = v.shape[1]
    cols, rows = (np.asarray(x) for x in _packed_maps(k))
    g = g.astype(dt)
    h = np.where(rows == cols, (dt(-0.5) * g)[:, None], -g[:, None]).astype(dt)
    t = ((v[:, rows] * v[:, cols]).astype(dt) - Minus[:, rows, cols]).astype(dt)
    dB = (h * t).astype(dt)
    du = (g[:, None] * v).astype(dt)
    dB[bad], du[bad] = np.nan, np.nan
    return dB, du


def sweep_rows(B, u, g, dt=F32):
    """The warp kernel (k <= 64): rows in full, a scale a row."""
    S, k = u.shape
    R = _full(B.astype(dt), k, dt)
    ru = u.astype(dt).copy()
    sig = np.ones((S, k), dt)
    bad = np.zeros(S, bool)
    for p in range(k):
        c = (sig * R[:, :, p]).astype(dt)  # the broadcast column: true entries (j, p)
        cu = ru[:, p].copy()  # u_p (sig_p is 1 until step p)
        d = c[:, p]
        bad |= ~(d > 0)
        inv = _rcp(d, dt)
        gq = (R[:, :, p] * inv[:, None]).astype(dt)
        gq[:, p] = 0  # row p is left as stored
        R = _fma(-gq[:, :, None], c[:, None, :], R, dt)
        ru = _fma(-gq, cu[:, None], ru, dt)
        R[:, :, p] = gq
        R[:, p, p] = -1
        sig[:, p] = inv
    v = (sig * ru).astype(dt)
    return _outputs((sig[:, :, None] * R).astype(dt), v, g, bad, dt)


def _sweep_pivot_block(G, dt):
    """Goodnight's sweep of the (S, 4, 4) pivot blocks in place, as every
    lane runs it: G = -P; returns whether each pivot was positive."""
    ok = np.ones(G.shape[0], bool)
    for t in range(PIVOTS):
        d = G[:, t, t].copy()
        ok &= d > 0
        inv = _rcp(d, dt)
        col = G[:, :, t].copy()
        f = (col * inv[:, None]).astype(dt)
        for x in range(PIVOTS):
            for y in range(PIVOTS):
                if x != t and y != t:
                    G[:, x, y] = _fma(-f[:, x], col[:, y], G[:, x, y], dt)
        for x in range(PIVOTS):
            if x != t:
                G[:, x, t] = G[:, t, x] = f[:, x]
        G[:, t, t] = -inv
    return ok


def sweep_blocks(B, u, g, dt=F32):
    """The wide kernel (k > 64, and any k in this model): the packed lower
    triangle (here a full array whose upper half mirrors the lower after
    every step, so that reads of entry (i, c) return the stored (max,
    min)), pivots four at a time."""
    S, k = u.shape
    T = _full(B.astype(dt), k, dt)
    U = u.astype(dt).copy()
    bad = np.zeros(S, bool)
    lower = np.tril(np.ones((k, k), bool))
    for p in range(0, k, PIVOTS):
        nb = min(PIVOTS, k - p)
        piv = np.zeros(k, bool)
        piv[p:p + nb] = True
        G = np.zeros((S, PIVOTS, PIVOTS), dt)
        G[:, np.arange(PIVOTS), np.arange(PIVOTS)] = 1
        G[:, :nb, :nb] = T[:, p:p + nb, p:p + nb]
        bad |= ~_sweep_pivot_block(G, dt)
        E = np.zeros((S, k, PIVOTS), dt)  # row j's entries in the pivot columns
        E[:, :, :nb] = T[:, :, p:p + nb]
        E[:, piv] = 0
        Eu = np.zeros((S, PIVOTS), dt)
        Eu[:, :nb] = U[:, p:p + nb]

        def times_p(e):  # P e = -G e, the terms in order
            f = np.zeros(e.shape, dt)
            for x in range(PIVOTS):
                acc = (-G[:, x, 0]).reshape((S,) + (1,) * (e.ndim - 2)) * e[..., 0]
                for y in range(1, PIVOTS):
                    gxy = (-G[:, x, y]).reshape((S,) + (1,) * (e.ndim - 2))
                    acc = _fma(gxy, e[..., y], acc.astype(dt), dt)
                f[..., x] = acc
            return f

        F = times_p(E)
        F[:, piv] = 0
        Fu = times_p(Eu[:, None, :])[:, 0]
        upd = T.copy()
        for t in range(PIVOTS):
            upd = _fma(-E[:, :, None, t], F[:, None, :, t], upd, dt)
        keep = ~lower[None] | piv[None, :, None] | piv[None, None, :]
        T = np.where(keep, T, upd)
        for t in range(PIVOTS):
            U = np.where(piv[None], U, _fma(-E[:, :, t], Fu[:, None, t], U, dt))
        T[:, ~piv, p:p + nb] = F[:, ~piv, :nb]
        T[:, p:p + nb, ~piv] = np.swapaxes(F[:, ~piv, :nb], 1, 2)
        T[:, p:p + nb, p:p + nb] = G[:, :nb, :nb]
        U[:, p:p + nb] = Fu[:, :nb]
        T = np.where(lower[None], T, np.swapaxes(T, 1, 2))  # the upper half mirrors the lower
    return _outputs(T, U, g, bad, dt)


def adjoint_model(B, u, g, dt=F32):
    """The route the kernel's wrapper takes for this k."""
    return (sweep_rows if u.shape[1] <= CHAIN_MAX_K else sweep_blocks)(B, u, g, dt)


def _chain_problem(k, S=7):
    """tests/test_torch_training.py's capacitances: I + B with B = M^T D^-1
    M over 3k + 5 pixels, packed; u, misc and g."""
    rng = np.random.default_rng(k)
    N = 3 * k + 5
    M = rng.normal(size=(S, N, k)) * 0.3
    d_inv = rng.uniform(0.5, 5, size=(S, N))
    B = np.einsum("sni,sn,snj->sij", M, d_inv, M)
    cols, rows = (np.asarray(x) for x in _packed_maps(k))
    return B[:, rows, cols], rng.normal(size=(S, k)), rng.normal(size=(S, 2)), rng.normal(size=S)


def _training_problem(k, Q=32):
    """The GP training's own capacitances: ``woodbury_inputs`` of the
    synthetic training problem (R = 1,217 rest pixels, 31 forest lines) in
    float32, and g drawn from seed k."""
    fields, arrays = synthetic_training_problem(Q, 1217, k, seed=k)
    p = TT.TrainingParams.from_numpy(fields, "cpu", torch.float32)
    with torch.no_grad():
        B, u, misc = TT.woodbury_inputs(p, *(torch.as_tensor(x) for x in arrays), 31)
    return B.numpy(), u.numpy(), misc.numpy(), np.random.default_rng(k).normal(size=Q)


def _twin(B, u, misc, g, dtype):
    t = [torch.as_tensor(x, dtype=dtype) for x in (B, u, misc, g)]
    return [x.numpy() for x in logmvn_chain_grad_reference(*t)[:2]]


def _rel(got, want):
    return [float(np.abs(a.astype(F64) - b).max() / np.abs(b).max()) for a, b in zip(got, want)]


@pytest.mark.parametrize("source", ["chain", "training"])
@pytest.mark.parametrize("k", KS)
def test_float32_model_within_the_bound_of_the_float64_twin(k, source):
    B, u, misc, g = _chain_problem(k) if source == "chain" else _training_problem(k)
    B, u, misc, g = (x.astype(F32) for x in (B, u, misc, g))
    want = _twin(B, u, misc, g, torch.float64)
    model = _rel(adjoint_model(B, u, g), want)
    twin32 = _rel(_twin(B, u, misc, g, torch.float32), want)
    assert max(model) <= MODEL_VS_F64, (model, twin32)
    assert all(m + t <= REL_K3_GRAD for m, t in zip(model, twin32)), (model, twin32)


@pytest.mark.parametrize("k", [6, 65])
def test_model_gives_the_twins_nan_where_not_positive_definite(k):
    """A negative pivot (the first column's, a later one's) makes the
    sample's dB and du NaN in the model and the twin alike; the other
    samples stay finite."""
    B, u, misc, g = (x.astype(F32) for x in _chain_problem(k, S=5))
    diag = [j * k - j * (j - 1) // 2 for j in range(k)]
    B[1, diag[0]] = -5.0
    B[3, diag[k // 2]] = -500.0
    got = adjoint_model(B, u, g)
    want = _twin(B, u, misc, g, torch.float32)
    for a, b in zip(got, want):
        bad = np.isnan(b).any(axis=1)
        assert bad.tolist() == [False, True, False, True, False]
        assert np.isnan(a[bad]).all() and np.isfinite(a[~bad]).all()


def _jax_grads(B, u, misc, g):
    """jax.grad of sum g ll, ll = -1/2 (misc0 - quad + misc1 + logdet)
    with (quad, logdet) = batched_quad_logdet(I + B, u), float64: the
    packed lower entries of dll/dA (the chain reads the lower triangle
    only, so an off-diagonal entry's gradient is both halves') and
    dll/du."""
    k = u.shape[1]
    A = jnp.asarray(_full(B, k, F64))

    def total(A, u):
        quad, logdet = batched_quad_logdet(A, u)
        return jnp.sum(g * -0.5 * (misc[:, 0] - quad + misc[:, 1] + logdet))

    gA, gu = jax.grad(total, argnums=(0, 1))(A, jnp.asarray(u))
    cols, rows = (np.asarray(x) for x in _packed_maps(k))
    return np.asarray(gA)[:, rows, cols], np.asarray(gu)


@pytest.mark.parametrize("model", [sweep_rows, sweep_blocks])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_float64_sweeps_match_jax_grad(k, model):
    B, u, misc, g = _chain_problem(k)
    want = _jax_grads(B, u, misc, g)
    got = model(B, u, g, F64)
    for name, a, b in zip(("dB", "du"), got, want):
        np.testing.assert_allclose(a, b, rtol=JAX_RTOL, atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)
