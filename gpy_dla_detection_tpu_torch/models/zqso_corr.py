"""zQSO redshift scan as strided cross-correlations (FFT), the k x k
solves on K3.

The port of ``gpy_dla_detection_tpu/models/zqso_corr.py``.  On a
log-uniform pixel grid EVERY per-z reduction of the low-rank evidence
(reference: zqso_gp.py:92-212, log_mvnpdf_low_rank zqso_gp.py:252-284) is
a strided cross-correlation

    C[s] = sum_p A[p] * S[s + O*p]

between a z-independent spectrum-side weight stream ``A`` (e.g.
valid/noise, valid*flux/noise) and a z-independent table-side model
stream ``S`` (e.g. M_i*M_j, mu*M_i), evaluated at the per-z integer shift
``s0(z)``.  All shifts are computed at once per (weight, stream) pair by
FFT over the ``O`` polyphase components (``torch.fft``), after which each
z needs one row of the correlation matrix plus scalar algebra:

* capacitance  B(z) = I + med^2 * sum_f w_f(frac) C[iv x MiMj-family]
* projection   u(z), data quad, log dets, pixel counts — same shape
* the k x k solves of all z at once on K3 (``ops/logmvn_kernels.
  logmvn_chain``, its plain twin on the CPU), where the reference runs
  ``ops/logmvn.batched_quad_logdet``: K3 computes
  ``-1/2 (misc0 - quad + misc1 + logdet)`` of ``I + B`` from the packed
  lower triangle, column-major, which for a symmetric matrix is the
  upper pairs' row-major order of :func:`_stream_layout`.

The fractional part of the shift (the linear blend between adjacent
table rows) is folded into the STREAMS: for every product stream the
``_pp`` variant carries both factors at t+1 and the ``_pm`` variant the
symmetrized cross term, so a single correlation row per z covers the
exact (1-f)^2 / f^2 / f(1-f) blend — no second gather.

Approximations against the exact scan: the in-model mask comes from the
resampled grid's rest window (``val`` stream) instead of per-pixel exact
rest comparisons (<=1 edge pixel per window edge per z); the strict
observable cut against the spectrum's own first/last valid wavelength is
applied statically in the weights; correlations accumulate in float32
FFTs (~1e-5 relative — the scan's margins are orders of magnitude
larger).

The per-z O(P) parts that cannot be correlations (the masked-median
normalization and the blue/redwards iid tails) stay as elementwise
passes in the spectrum's dtype, ``CORR_CHUNK`` candidates at a time.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.logmvn import LOG_2PI
from ..ops.logmvn_kernels import logmvn_chain
from ..params import ZParameters
from ..utils.memo import memo_by_identity
from .zqso import (
    SCAN_OVERSAMPLE,
    SCAN_WL_BOUNDS,
    ZLearnedModel,
    ZSpectrum,
    _flat_resampled_model,
    _iid_ll,
    _model_placement,
    _normalization_median,
    _sorted_flux_view,
    _z_grid_for,
    device_spectrum,
)


# candidate redshifts a median and iid pass takes at once.  Each chunk
# costs ~60 launches: at 500 the host set the pace (45 spectra/s on an
# H100), at 5,000 the device does (90, within 5% of one chunk of the whole
# grid, and no more memory than the correlation itself); measured by
# ``scripts/profile_torch_slice.py --path zqso --chunk-sizes``, PERF.md
CORR_CHUNK = 5_000


class ZCorrTable(NamedTuple):
    """FFTs of the polyphase model streams + assembly metadata."""

    stream_fft: torch.Tensor  # (ns, O, F) complex64 on the model's device
    log_x0: float
    dlog: float
    oversample: int
    k: int
    nfft: int


def _stream_layout(k: int):
    """Column indices of each stream family in the stream stack.

    Order: val, mu, mu2, mu_pp, mumu_pm, mu2_pp, Mi (k), Mi_pp (k),
    muMi (k), muMi_pp (k), muMi_pm (k), then the k(k+1)/2 upper pairs
    of MiMj, MiMj_pp, MiMj_pm.
    """
    idx = {}
    pos = 0
    for name in ("val", "mu", "mu2", "mu_pp", "mumu_pm", "mu2_pp"):
        idx[name] = pos
        pos += 1
    for name in ("Mi", "Mi_pp", "muMi", "muMi_pp", "muMi_pm"):
        idx[name] = pos
        pos += k
    n_pairs = k * (k + 1) // 2
    for name in ("MiMj", "MiMj_pp", "MiMj_pm"):
        idx[name] = pos
        pos += n_pairs
    return idx, pos


def corr_streams(
    learned: ZLearnedModel,
    pixel_dlog: float,
    num_pixels: int,
    params: ZParameters,
    oversample: int = SCAN_OVERSAMPLE,
    z_min: float = 2.14,
    z_max: float = 6.16,
    wl_bounds: tuple = SCAN_WL_BOUNDS,
):
    """The model streams on the flat log-uniform grid, destrided into
    ``oversample`` polyphase components: the host numpy half of the
    table, the reference's code.

    :return: (S_poly (ns, O, R) float32, log_x0, dlog, k, nfft)
    """
    grid, mu_t, M_t, log_x0, dlog, T = _flat_resampled_model(
        learned, pixel_dlog, num_pixels, oversample, z_min, z_max, wl_bounds
    )
    k = M_t.shape[1]
    idx, ns = _stream_layout(k)

    # in-model mask on the grid (the rest window; reference:
    # zqso_gp.py:150-156 model_ind)
    val = (
        (grid >= params.min_lambda) & (grid <= params.max_lambda)
    ).astype(np.float64)

    # flat streams, t axis length T+1; "+1"-offset factors use t+1
    mu1 = np.empty_like(mu_t)
    mu1[:-1], mu1[-1] = mu_t[1:], mu_t[-1]
    M1 = np.empty_like(M_t)
    M1[:-1], M1[-1] = M_t[1:], M_t[-1]

    S = np.zeros((ns, T + 1))
    S[idx["val"]] = val
    S[idx["mu"]] = val * mu_t
    S[idx["mu2"]] = val * mu_t * mu_t
    S[idx["mu_pp"]] = val * mu1
    S[idx["mumu_pm"]] = val * mu_t * mu1
    S[idx["mu2_pp"]] = val * mu1 * mu1
    for i in range(k):
        S[idx["Mi"] + i] = val * M_t[:, i]
        S[idx["Mi_pp"] + i] = val * M1[:, i]
        S[idx["muMi"] + i] = val * mu_t * M_t[:, i]
        S[idx["muMi_pp"] + i] = val * mu1 * M1[:, i]
        S[idx["muMi_pm"] + i] = val * (
            mu_t * M1[:, i] + mu1 * M_t[:, i]
        )
    p = 0
    for i in range(k):
        for j in range(i, k):
            S[idx["MiMj"] + p] = val * M_t[:, i] * M_t[:, j]
            S[idx["MiMj_pp"] + p] = val * M1[:, i] * M1[:, j]
            S[idx["MiMj_pm"] + p] = val * (
                M_t[:, i] * M1[:, j] + M1[:, i] * M_t[:, j]
            )
            p += 1

    # destride: S_c[r] = S[O*r + c]  (polyphase components)
    O = oversample
    R = (T + 1) // O
    S_poly = np.stack(
        [S[:, c : c + O * R : O] for c in range(O)], axis=1
    )  # (ns, O, R)

    nfft = 1 << int(np.ceil(np.log2(R + num_pixels + 2)))
    return S_poly.astype(np.float32), log_x0, dlog, k, nfft


def build_corr_table(
    learned: ZLearnedModel,
    pixel_dlog: float,
    num_pixels: int,
    params: ZParameters,
    oversample: int = SCAN_OVERSAMPLE,
    z_min: float = 2.14,
    z_max: float = 6.16,
    wl_bounds: tuple = SCAN_WL_BOUNDS,
    device=None,
) -> ZCorrTable:
    """The streams of :func:`corr_streams`, rFFT'd once on ``device``
    (default: the learned model's) and kept there: cacheable per learned
    model, device and pixel grid, shared by every spectrum."""
    if device is None:
        device, _ = _model_placement(learned)
    S_poly, log_x0, dlog, k, nfft = corr_streams(
        learned, pixel_dlog, num_pixels, params, oversample, z_min, z_max, wl_bounds
    )
    stream_fft = torch.fft.rfft(torch.from_numpy(S_poly).to(device), n=nfft, dim=-1)
    return ZCorrTable(
        stream_fft=stream_fft, log_x0=log_x0, dlog=dlog, oversample=oversample, k=k, nfft=nfft,
    )


class _CorrRows(NamedTuple):
    """Every correlation row's (weight, stream) pair, as index tensors on
    one device, and the first row of each family."""

    weight: torch.Tensor  # (nc,) int64
    stream: torch.Tensor  # (nc,) int64
    first: dict


# the spectrum-side weights, in their order in the weight stack
IV, IVF, IVF2, LGN, ONE = range(5)


@functools.lru_cache(maxsize=16)
def _corr_rows(k: int, device: torch.device) -> _CorrRows:
    """The correlation rows of a rank-k model, uploaded once per device
    (an upload from pageable memory waits for the device's queue)."""
    idx, _ = _stream_layout(k)
    kp = k * (k + 1) // 2
    pw, ps, first = [], [], {}
    for name, w, s, count in (
        ("mu2", IV, "mu2", 1), ("mu2pp", IV, "mu2_pp", 1), ("mumupm", IV, "mumu_pm", 1),
        ("muMi", IV, "muMi", k), ("muMipp", IV, "muMi_pp", k), ("muMipm", IV, "muMi_pm", k),
        ("MiMj", IV, "MiMj", kp), ("MiMjpp", IV, "MiMj_pp", kp), ("MiMjpm", IV, "MiMj_pm", kp),
        ("fmu", IVF, "mu", 1), ("fmupp", IVF, "mu_pp", 1),
        ("fMi", IVF, "Mi", k), ("fMipp", IVF, "Mi_pp", k),
        ("f2val", IVF2, "val", 1), ("lgn", LGN, "val", 1), ("n", ONE, "val", 1),
    ):
        first[name] = len(pw)
        pw += [w] * count
        ps += range(idx[s], idx[s] + count)
    put = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
    return _CorrRows(put(pw), put(ps), first)


def take_rows(corr: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """The correlation row of every flat shift ``s0`` (Z,): (nc, Z).

    ``corr`` (nc, O, nfft) holds flat shift ``s = O*r + c`` at phase c,
    row r; the rows are gathered there, with no interleaved copy of the
    whole array.  Indices follow the reference's ``jnp.take`` on the
    interleaved (O*nfft, nc) array: a negative one down to ``-O*nfft``
    wraps, any other outside the range gives a row of NaN."""
    nc, O, nfft = corr.shape
    L = O * nfft
    s = torch.where(s0 < 0, s0 + L, s0)
    inside = (s >= 0) & (s < L)
    s = torch.where(inside, s, 0)
    rows = corr.reshape(nc, L).index_select(1, (s % O) * nfft + s // O)
    return torch.where(inside, rows, math.nan)


def z_log_evidences_corr(
    learned: ZLearnedModel,
    stream_fft: torch.Tensor,
    spec: ZSpectrum,
    z_grid: torch.Tensor,
    params: ZParameters,
    log_x0: float,
    dlog: float,
    oversample: int,
    k: int,
    nfft: int,
):
    """log p(D | z) over the grid via the correlation scan.

    :param spec: the spectrum on the model's device (``device_spectrum``).
    :param z_grid: (Z,) float64 on the model's device.
    :return: (Z,) in the spectrum's dtype (float32 on the card).
    """
    wl = spec.wavelengths
    valid = spec.valid
    f32 = torch.float32

    # --- spectrum-side weights (z-independent) ---------------------
    wl_lo = torch.min(torch.where(valid, wl, math.inf))
    wl_hi = torch.max(torch.where(valid, wl, -math.inf))
    # static part of the observable cut (reference: zqso_gp.py:135-139)
    sv = (valid & (wl > wl_lo) & (wl < wl_hi)).to(f32)
    noise = spec.noise_variance.to(f32)
    flux = spec.flux.to(f32)
    on = sv > 0
    inv_n = torch.where(on, 1.0 / noise, 0.0)
    weights = torch.stack([
        sv * inv_n,  # iv
        sv * inv_n * flux,  # ivf
        sv * inv_n * flux * flux,  # ivf2
        sv * torch.where(on, torch.log(noise), 0.0),  # lgn
        sv,  # one
    ])  # (5, P)
    w_fft = torch.fft.rfft(weights, n=nfft, dim=-1)  # (5, F)

    # --- all-shift correlations ------------------------------------
    # C_c[r] = sum_p A[p] S_c[r+p]  ==  irfft(conj(fft A) * fft S_c)
    pairs = _corr_rows(k, stream_fft.device)
    prod = stream_fft.index_select(0, pairs.stream)  # (nc, O, F)
    prod.mul_(torch.conj_physical(w_fft).index_select(0, pairs.weight)[:, None, :])
    corr = torch.fft.irfft(prod, n=nfft, dim=-1)  # (nc, O, nfft)
    del prod

    # --- per-z shift + one correlation row per z -------------------
    log_wl0 = torch.log10(wl[0])
    s_real = (log_wl0 - torch.log10(1.0 + z_grid) - log_x0) / dlog
    s0 = torch.floor(s_real).to(torch.int64)
    f = (s_real - s0).to(f32)
    rows = take_rows(corr, s0)  # (nc, Z)
    del corr
    c = pairs.first
    kp = k * (k + 1) // 2

    w00 = (1.0 - f) * (1.0 - f)
    w11 = f * f
    w01 = f * (1.0 - f)

    def blend2(base, basepp, basepm, count):
        return (w00 * rows[c[base]:c[base] + count] + w11 * rows[c[basepp]:c[basepp] + count]
                + w01 * rows[c[basepm]:c[basepm] + count])

    def blend1(base, basepp, count):
        return (1.0 - f) * rows[c[base]:c[base] + count] + f * rows[c[basepp]:c[basepp] + count]

    n_in = rows[c["n"]]  # (Z,) in-window pixel count
    sum_lgn = rows[c["lgn"]]
    sum_f2 = rows[c["f2val"]]
    mu2_b = blend2("mu2", "mu2pp", "mumupm", 1)[0]
    fmu_b = blend1("fmu", "fmupp", 1)[0]
    muMi_b = blend2("muMi", "muMipp", "muMipm", k)  # (k, Z)
    fMi_b = blend1("fMi", "fMipp", k)  # (k, Z)
    MiMj_b = blend2("MiMj", "MiMjpp", "MiMjpm", kp)  # (kp, Z)
    # NOTE: mumu_pm stream stores mu[t]*mu[t+1] once; the (1-f)f cross
    # term needs it twice
    mu2_b = mu2_b + w01 * rows[c["mumupm"]]

    # --- per-z normalization + iid tails (elementwise, in chunks) --
    sorted_aux = _sorted_flux_view(spec)
    min_obs = torch.maximum(params.min_lambda * (1.0 + z_grid), wl_lo)
    max_obs = torch.minimum(params.max_lambda * (1.0 + z_grid), wl_hi)
    meds, iids = [], []
    for i in range(0, z_grid.shape[0], CORR_CHUNK):
        lo = min_obs[i:i + CORR_CHUNK, None]
        hi = max_obs[i:i + CORR_CHUNK, None]
        med = _normalization_median(sorted_aux, z_grid[i:i + CORR_CHUNK, None], lo, hi,
                                    params)  # (C,)
        # (C, P) masked iid loglik (reference: zqso_gp.py:196-212)
        v = spec.noise_variance / (med * med)[:, None]
        y = spec.flux / med[:, None]
        bw = (wl < lo) & valid
        rw = (wl > hi) & valid
        iid_ll = _iid_ll(bw, y, v, learned.bluewards_mu, learned.bluewards_sigma)
        iid_ll = iid_ll + _iid_ll(rw, y, v, learned.redwards_mu, learned.redwards_sigma)
        meds.append(med)
        iids.append(iid_ll)
    med = torch.cat(meds).to(f32)
    iid_ll = torch.cat(iids)

    # --- assemble the in-window evidence ---------------------------
    # a fully-masked SPECTRUM has med = +inf with every correlation
    # term 0; neutralize med so the 0 * inf products cannot poison the
    # flat-zero scan.  A per-z empty NORMALIZATION WINDOW on an
    # otherwise-valid spectrum is different: the normalized likelihood
    # is undefined there, so the candidate must come back NaN (excluded
    # by the caller's nanargmax) exactly like the exact path — not a
    # finite garbage value competing in the argmax.
    med_bad = ~torch.isfinite(med)
    med = torch.where(med_bad, 1.0, med)
    med2 = med * med
    # K3 takes B without the +I, packed (Z, k(k+1)/2), and u (Z, k)
    B = (med2 * MiMj_b).T.contiguous()
    u = (med * fMi_b - med2 * muMi_b).T.contiguous()
    quad0 = sum_f2 - 2.0 * med * fmu_b + med2 * mu2_b
    logdet0 = sum_lgn - 2.0 * n_in * torch.log(med)
    misc = torch.stack([quad0, logdet0 + n_in * LOG_2PI], dim=1)
    in_ll = logmvn_chain(B, u, misc)
    in_ll = torch.where(med_bad & torch.any(valid), math.nan, in_ll)
    return in_ll + iid_ll


# table FFTs memoized per (learned model identity, device, pixel grid step)
_CORR_TABLE_CACHE: dict = {}


def corr_table_for(
    learned, pixel_dlog, num_pixels, params, z_qso_min, z_qso_max
):
    device, _ = _model_placement(learned)
    key = (
        id(learned), device, pixel_dlog, num_pixels, params, z_qso_min, z_qso_max,
    )
    return memo_by_identity(
        _CORR_TABLE_CACHE,
        key,
        learned,
        lambda: build_corr_table(
            learned, pixel_dlog, num_pixels, params,
            z_min=z_qso_min, z_max=z_qso_max, device=device,
        ),
    )


def z_scan_corr(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    params: ZParameters,
    pixel_dlog: float,
    z_qso_min: float = 2.14,
    z_qso_max: float = 6.16,
):
    """Build (or reuse) the correlation table and scan one spectrum: the
    correlation branch of ``zqso.dispatch_scan``.  Returns (the host z
    grid, the (Z,) lls tensor on the model's device)."""
    device, dtype = _model_placement(learned)
    table = corr_table_for(
        learned, pixel_dlog, int(spec.wavelengths.shape[0]), params,
        z_qso_min, z_qso_max,
    )
    z_np, z_grid = _z_grid_for(params.num_zqso_samples, z_qso_min, z_qso_max, device)
    lls = z_log_evidences_corr(
        learned, table.stream_fft, device_spectrum(spec, device, dtype), z_grid, params,
        table.log_x0, table.dlog, table.oversample, table.k, table.nfft,
    )
    return z_np, lls
