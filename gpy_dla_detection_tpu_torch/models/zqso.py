"""Quasar redshift estimation with a GP prior over the emission spectrum.

The port of ``gpy_dla_detection_tpu/models/zqso.py`` (reference: the
``ZGP`` of gpy_dla_detection/zqso_gp.py:14-319): log p(D | z) over a grid
of candidate redshifts, each a fixed-shape, mask-recomputed evaluation of
the padded spectrum, batched over chunks of the grid to bound memory.

Two scans compute it.  The exact scan (:func:`z_log_evidences`)
interpolates the learned model onto the observed pixels at every z and
runs the low-rank Woodbury per z, by one of three routes
(:func:`_exact_route`): on the card a float32 model's K3 inputs come from
``ops/logmvn_kernels.zqso_cap``, one kernel that interpolates in registers
and never writes the (C, P, k) basis, and K3 solves them; on the CPU their
plain twins do the same; a float64 model, or a float32 basis wider than
the kernel takes, forms the basis and runs
``ops/logmvn.log_mvnpdf_low_rank`` (a library Cholesky).  The
correlation scan (``models/zqso_corr.py``) turns every per-z reduction into
an FFT cross-correlation and runs the k x k solves on K3; "auto" takes it
wherever the pixel grid is log-uniform within ``SCAN_WL_BOUNDS``.  The
reference's third scan, the shift scan, is a TPU workaround the port
leaves out: ``method="shift"`` is refused by name.

The host-side numpy (``prepare_z_spectrum``, ``sample_z_qsos``,
``_flat_resampled_model``, ``detect_pixel_dlog``) is a copy of the
reference's, bit for bit.  The learned model's tensors decide the device
and dtype of a scan (:meth:`ZLearnedModel.to`); wavelengths stay float64
on every device, since they only enter comparisons against the grid and
the shift s0(z), which float32 would move by ~0.02 table entries.

Stages are marked with ``utils.timing.span``: ``gpy.scan_dispatch``
around :func:`dispatch_scan`, ``gpy.scan_chunk`` around each chunk of the
exact scan and the correlation scan's call, ``gpy.scan_wait`` around
:meth:`ScanReadback.result`.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.interp import interp_uniform
from ..ops.logmvn import LOG_2PI, log_mvnpdf_low_rank
from ..ops.logmvn_kernels import (
    ZQSO_CAP_MAX_K,
    logmvn_chain,
    logmvn_chain_reference,
    zqso_cap,
    zqso_cap_reference,
)
from ..params import ZParameters
from ..utils.timing import span

# candidate redshifts the exact scan evaluates at once on the "kernel"
# route (:func:`_exact_route`), where zqso_cap forms the in-window inputs
# without the (C, P, k) basis: what stays are the per-z median and iid
# passes' (C, P) temporaries, 0.179 GiB a thousand candidates at P = 5,632
# on an H100 (a scan's peak: 1.79 GiB for the whole grid of 10,000 in one
# chunk), so the largest chunk within the 2.4 GiB that a chunk of 1,000
# took before the kernel (PERF.md)
EXACT_CHUNK = 13_000
# ... and on the routes that form the interpolated basis ("twin", "basis"),
# at most this many: each candidate holds (P, k) floats in the Woodbury's
# temporaries; on an H100 a chunk of 1,000 took 2.4 GiB, the whole grid at
# once 24 GiB
BASIS_CHUNK = 1_000


class ZLearnedModel(NamedTuple):
    """Trained zQSO GP (reference: zqso_gp.py:36-64, ZGPMAT:288-319):
    numpy arrays as loaded or generated, tensors after :meth:`to`."""

    rest_wavelengths: np.ndarray | torch.Tensor  # (R,)
    mu: np.ndarray | torch.Tensor  # (R,)
    M: np.ndarray | torch.Tensor  # (R, k)
    bluewards_mu: np.ndarray | torch.Tensor  # scalar
    bluewards_sigma: np.ndarray | torch.Tensor  # scalar
    redwards_mu: np.ndarray | torch.Tensor  # scalar
    redwards_sigma: np.ndarray | torch.Tensor  # scalar

    def to(self, device="cuda", dtype: torch.dtype = torch.float32) -> "ZLearnedModel":
        """Every field as a tensor on ``device`` in ``dtype`` (the
        reference's ``astype``): the card in float32 by default."""
        def put(f):
            if isinstance(f, torch.Tensor):
                return f.to(device=device, dtype=dtype)
            return torch.as_tensor(np.asarray(f), dtype=dtype, device=device)

        return ZLearnedModel(*[put(f) for f in self])


class ZSpectrum(NamedTuple):
    """A full observed spectrum, fixed-shape (no windowing yet: windows
    depend on the candidate redshift)."""

    wavelengths: np.ndarray | torch.Tensor  # (P,)
    flux: np.ndarray | torch.Tensor  # (P,)
    noise_variance: np.ndarray | torch.Tensor  # (P,)
    valid: np.ndarray | torch.Tensor  # (P,) bool: real, unmasked pixel


def prepare_z_spectrum(
    wavelengths, flux, noise_variance, pixel_mask, num_pixels: int | None = None
) -> ZSpectrum:
    """Pad one observed spectrum to a fixed pixel count (host-side).

    ``num_pixels`` defaults to ``ZParameters.num_pixels_padded`` — the
    single source of truth for the zQSO padding size.
    """
    if num_pixels is None:
        num_pixels = ZParameters().num_pixels_padded
    wavelengths = np.asarray(wavelengths, np.float64)
    flux = np.asarray(flux, np.float64)
    noise_variance = np.asarray(noise_variance, np.float64)
    pixel_mask = np.asarray(pixel_mask, bool)

    n = wavelengths.shape[0]
    if n > num_pixels:
        raise ValueError(f"spectrum has {n} > {num_pixels} pixels")
    # infinite/NaN variances are unusable pixels (reference kludges them
    # to the mean, zqso_gp.py:177; masking is cleaner)
    bad = pixel_mask | ~np.isfinite(noise_variance) | ~np.isfinite(flux)

    wl = np.full(num_pixels, wavelengths[-1] if n else 1.0)
    fx = np.zeros(num_pixels)
    nv = np.ones(num_pixels)
    valid = np.zeros(num_pixels, bool)
    wl[:n] = wavelengths
    fx[:n] = np.where(bad, 0.0, np.nan_to_num(flux))
    nv[:n] = np.where(bad, 1.0, np.nan_to_num(noise_variance, nan=1.0))
    valid[:n] = ~bad
    return ZSpectrum(wl, fx, nv, valid)


def _put(x, device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a tensor on ``device`` in ``dtype``.  A host array goes
    through a pinned buffer and a non-blocking copy to a CUDA device: a
    copy from pageable memory would wait for the work queued on the
    stream, so a caller could not queue one scan behind the last."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    host = torch.as_tensor(np.asarray(x)).to(dtype)
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def device_spectrum(spec: ZSpectrum, device, dtype: torch.dtype) -> ZSpectrum:
    """``spec`` on ``device``: flux and noise in ``dtype``, wavelengths in
    float64 (they enter only comparisons and s0(z)), ``valid`` boolean."""
    return ZSpectrum(
        wavelengths=_put(spec.wavelengths, device, torch.float64),
        flux=_put(spec.flux, device, dtype),
        noise_variance=_put(spec.noise_variance, device, dtype),
        valid=_put(spec.valid, device, torch.bool),
    )


def _model_placement(learned: ZLearnedModel) -> tuple[torch.device, torch.dtype]:
    """The device and dtype of a scan: the learned model's."""
    if not isinstance(learned.mu, torch.Tensor):
        raise TypeError(
            "the learned model holds numpy arrays: move it with "
            "ZLearnedModel.to(device, dtype) first"
        )
    return learned.mu.device, learned.mu.dtype


def _masked_median(values, mask):
    """Median over masked entries (fixed shape), batched over the mask's
    leading axes; +inf for an empty mask."""
    x = torch.sort(torch.where(mask, values, math.inf), dim=-1).values
    n = torch.sum(mask, dim=-1, keepdim=True)
    last = x.shape[-1] - 1
    hi = torch.clamp(n // 2, 0, last)
    lo = torch.clamp((n - 1) // 2, 0, last)
    return (0.5 * (x.gather(-1, lo) + x.gather(-1, hi)))[..., 0]


def _sorted_flux_view(spec: ZSpectrum):
    """(flux, wavelengths, valid) permuted into ascending-flux order.

    The flux ordering does not depend on the candidate redshift — only
    the (wavelength-determined) normalization mask does — so the z scan
    sorts ONCE and each candidate's masked median becomes a cumsum rank
    selection in sorted space."""
    order = torch.argsort(spec.flux, stable=True)
    return spec.flux[order], spec.wavelengths[order], spec.valid[order]


def _masked_median_sorted(flux_sorted, mask_sorted):
    """Exact masked median given ascending-flux-ordered inputs, batched
    over the mask's leading axes: the lo/hi-ranked masked elements
    selected by cumulative count.  Returns +inf for an empty mask
    (matching ``_masked_median``).  Ties of equal flux cannot change it:
    the ranks select values, whichever of the tied pixels holds them."""
    n = torch.sum(mask_sorted, dim=-1, keepdim=True)
    csum = torch.cumsum(mask_sorted.to(torch.int32), dim=-1)
    lo_rank = (n - 1) // 2 + 1
    hi_rank = n // 2 + 1

    def pick(rank):
        return torch.sum(torch.where(mask_sorted & (csum == rank), flux_sorted, 0.0), dim=-1)

    med = 0.5 * (pick(lo_rank) + pick(hi_rank))
    return torch.where(n[..., 0] > 0, med, math.inf)


def _normalization_median(sorted_aux, zc, min_obs, max_obs, params: ZParameters):
    """The flux's masked median over the rest-frame normalization window
    and the observable cut at each z of ``zc`` (C, 1), from
    ``_sorted_flux_view``'s arrays (reference: zqso_gp.py:141-148)."""
    flux_s, wl_s, valid_s = sorted_aux
    rest_s = wl_s / (1.0 + zc)
    norm_ind_s = (
        (rest_s >= params.normalization_min_lambda)
        & (rest_s <= params.normalization_max_lambda)
        & (wl_s > min_obs)
        & (wl_s < max_obs)
        & valid_s
    )
    return _masked_median_sorted(flux_s, norm_ind_s)


def _iid_ll(ind, y, v, m, s):
    """(C,) iid Gaussian log likelihood of the pixels ``ind`` outside the
    model window (reference: zqso_gp.py:196-212)."""
    d = s * s + v
    delta = torch.where(ind, y - m, 0.0)
    d_inv = torch.where(ind, 1.0 / d, 0.0)
    log_d = torch.where(ind, torch.log(d), 0.0)
    n = torch.sum(ind, dim=-1).to(y.dtype)
    return -0.5 * (
        torch.sum(delta * delta * d_inv, dim=-1) + torch.sum(log_d, dim=-1) + n * LOG_2PI
    )


def _z_log_evidences_at(
    learned: ZLearnedModel, spec: ZSpectrum, z: torch.Tensor, params: ZParameters,
    sorted_aux=None,
):
    """log p(D | z) at each candidate redshift of ``z`` (C, float64), in
    the spectrum's dtype, for a spectrum on the model's device
    (:func:`device_spectrum`): the reference's ``z_log_evidence`` over a
    batch of z, its in-window likelihood by :func:`_exact_route`'s route."""
    wl = spec.wavelengths
    dtype = spec.flux.dtype
    zc = z[:, None]

    # observable cut: the part of the spectrum the GP window can cover
    max_obs = torch.minimum(
        params.max_lambda * (1.0 + z), torch.max(torch.where(spec.valid, wl, -math.inf))
    )[:, None]
    min_obs = torch.maximum(
        params.min_lambda * (1.0 + z), torch.min(torch.where(spec.valid, wl, math.inf))
    )[:, None]

    # normalization over the rest-frame window (reference: zqso_gp.py:141-148)
    rest = None
    if sorted_aux is not None:
        median = _normalization_median(sorted_aux, zc, min_obs, max_obs, params)
    else:
        rest = wl / (1.0 + zc)  # (C, P)
        norm_ind = (
            (rest >= params.normalization_min_lambda)
            & (rest <= params.normalization_max_lambda)
            & (wl > min_obs) & (wl < max_obs)
            & spec.valid
        )
        median = _masked_median(spec.flux, norm_ind)

    median = median[:, None]
    y = spec.flux / median
    v = spec.noise_variance / (median * median)

    route = _exact_route(learned)
    if route == "basis":
        if rest is None:
            rest = wl / (1.0 + zc)
        # in-model window
        model_ind = ((rest >= params.min_lambda) & (rest <= params.max_lambda)
                     & (wl > min_obs) & (wl < max_obs) & spec.valid)
        x0 = learned.rest_wavelengths[0]
        dx = learned.rest_wavelengths[1] - learned.rest_wavelengths[0]
        rest_q = rest.to(dtype)
        mu = interp_uniform(x0, dx, learned.mu, rest_q)
        M = interp_uniform(x0, dx, learned.M, rest_q)
        in_window_ll = log_mvnpdf_low_rank(y, mu, M, v, model_ind)
    else:
        cap, chain = ((zqso_cap, logmvn_chain) if route == "kernel"
                      else (zqso_cap_reference, logmvn_chain_reference))
        B, u, misc = cap(z, median[:, 0], min_obs[:, 0], max_obs[:, 0], wl, spec.flux,
                         spec.noise_variance, spec.valid, learned.rest_wavelengths, learned.mu,
                         learned.M, params.min_lambda, params.max_lambda)
        in_window_ll = chain(B, u, misc)

    # out-of-window pixels: iid Gaussians (reference: zqso_gp.py:196-212)
    bw_ind = (wl < min_obs) & spec.valid
    rw_ind = (wl > max_obs) & spec.valid
    bw_ll = _iid_ll(bw_ind, y, v, learned.bluewards_mu, learned.bluewards_sigma)
    rw_ll = _iid_ll(rw_ind, y, v, learned.redwards_mu, learned.redwards_sigma)
    return in_window_ll + bw_ll + rw_ll


def z_log_evidence(
    learned: ZLearnedModel, spec: ZSpectrum, z_qso, params: ZParameters, sorted_aux=None,
):
    """log p(D | z_qso) for one candidate redshift, a 0-d tensor on the
    learned model's device (reference: zqso_gp.py:92-212).

    :param spec: a :class:`ZSpectrum`, on the host or the model's device.
    :param sorted_aux: optional ``_sorted_flux_view`` of the device
        spectrum — lets a scan share one flux sort across all candidates
        (identical median values).
    """
    device, dtype = _model_placement(learned)
    spec = device_spectrum(spec, device, dtype)
    z = torch.full((1,), float(z_qso), dtype=torch.float64, device=device)
    return _z_log_evidences_at(learned, spec, z, params, sorted_aux)[0]


def sample_z_qsos(num_samples: int, z_qso_min: float = 2.14, z_qso_max: float = 6.16):
    """The linear redshift grid scanned by the estimator
    (reference: zqso_samples.py:26-29)."""
    return np.linspace(z_qso_min, z_qso_max, num_samples)


@functools.lru_cache(maxsize=16)
def _z_grid_for(num_samples: int, z_qso_min: float, z_qso_max: float, device: torch.device):
    """The grid on the host (read-only) and in float64 on ``device``,
    uploaded once per device."""
    host = sample_z_qsos(num_samples, z_qso_min, z_qso_max)
    on_device = _put(host, device, torch.float64)
    host.setflags(write=False)
    return host, on_device


# the correlation scan's shared configuration: table layout (oversample)
# and observed-wavelength coverage (wl_bounds) are read by the table
# build, the coverage guard and the row decode — ONE definition so they
# can never desynchronize
SCAN_OVERSAMPLE = 4
SCAN_WL_BOUNDS = (3.0e3, 1.3e4)


def _host64(x) -> np.ndarray:
    """A learned-model field as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _flat_resampled_model(
    learned: ZLearnedModel,
    pixel_dlog: float,
    num_pixels: int,
    oversample: int = SCAN_OVERSAMPLE,
    z_min: float = 2.14,
    z_max: float = 6.16,
    wl_bounds: tuple = SCAN_WL_BOUNDS,
):
    """mu/M resampled onto the flat log-uniform rest grid of the
    correlation scan: entry t sits at rest wavelength
    ``10**(log_x0 + dlog*t)``, edge-clamped outside the model window.

    :return: (grid (T+1,), mu_t (T+1,), M_t (T+1, k), log_x0, dlog, T)
    """
    rest = _host64(learned.rest_wavelengths)
    dlog = pixel_dlog / oversample
    lo_rest = min(rest[0], wl_bounds[0] / (1.0 + z_max)) * 0.999
    log_x0 = np.log10(lo_rest)
    # highest table entry any shift can touch: the window starts at the
    # FIRST pixel (<= wl_bounds[1]) and always spans the full padded
    # P-pixel window, which can extend far past the last real pixel
    hi_log_obs = np.log10(wl_bounds[1]) + num_pixels * pixel_dlog
    hi_log_rest = hi_log_obs - np.log10(1.0 + z_min) + 1e-3
    T = int(np.ceil((hi_log_rest - log_x0) / dlog)) + 8 * oversample
    T = -(-T // oversample) * oversample  # whole strided rows
    grid = 10.0 ** (log_x0 + dlog * np.arange(T + 1))
    mu_t = np.interp(grid, rest, _host64(learned.mu))
    M = _host64(learned.M)
    M_t = np.stack(
        [np.interp(grid, rest, M[:, j]) for j in range(M.shape[1])], axis=1
    )
    return grid, mu_t, M_t, float(log_x0), float(dlog), T


def detect_pixel_dlog(wavelengths, max_drift: float = 0.02):
    """The per-pixel log10-wavelength step if the grid is log-uniform
    (trailing padded pixels — zero diffs — are ignored), else None.

    The step is fit from the endpoints and validated against the
    CUMULATIVE deviation ``max |log(wl_p) - (log(wl_0) + p d)|`` — a
    per-diff jitter bound would accept quasi-uniform grids (e.g. a
    linear grid over a narrow band) whose accumulated drift misplaces
    the model by many pixels.  The returned step is quantized to 1e-9
    dex so float jitter between spectra of the same survey cannot
    produce distinct values (each distinct value is a table build).
    """
    logs = np.log10(np.asarray(wavelengths, np.float64))
    diffs = np.diff(logs)
    real = diffs > 0
    if real.sum() < 2:
        return None
    # padding must be a pure tail
    last_real = np.nonzero(real)[0][-1]
    if not real[: last_real + 1].all():
        return None
    d = (logs[last_real + 1] - logs[0]) / (last_real + 1)
    d = round(float(d), 9)
    if d <= 0:
        return None
    p = np.arange(last_real + 2)
    drift = np.max(np.abs(logs[: last_real + 2] - (logs[0] + p * d)))
    if drift > max_drift * d:
        return None
    return d


def _exact_route(learned: ZLearnedModel) -> str:
    """How the exact scan forms its in-window likelihood, and so its chunk:
    "kernel" (``zqso_cap`` and K3 on the card: a float32 model whose basis
    the kernel's row bounds hold), "twin" (their plain twins: a float32
    model on the CPU), else "basis" (the (C, P, k) basis by
    ``interp_uniform``, then ``log_mvnpdf_low_rank``: a float64 model, and a
    float32 one on the card wider than ``ZQSO_CAP_MAX_K``)."""
    M = learned.M
    if M.dtype != torch.float32:
        return "basis"
    if M.device.type != "cuda":
        return "twin"
    return "kernel" if M.shape[1] <= ZQSO_CAP_MAX_K else "basis"


def z_log_evidences(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    z_grid: torch.Tensor,
    params: ZParameters,
):
    """log p(D | z) over the whole grid by the exact scan, ``EXACT_CHUNK``
    candidates at a time to bound memory (at most ``BASIS_CHUNK`` on the
    routes that form the basis), one flux sort for the grid.

    :param spec: the spectrum on the model's device (:func:`device_spectrum`).
    :param z_grid: (Z,) float64 on the model's device.
    """
    sorted_aux = _sorted_flux_view(spec)
    chunk = EXACT_CHUNK
    if _exact_route(learned) != "kernel":
        chunk = min(EXACT_CHUNK, BASIS_CHUNK)
    chunks = []
    for i in range(0, z_grid.shape[0], chunk):
        with span("gpy.scan_chunk"):
            chunks.append(_z_log_evidences_at(learned, spec, z_grid[i:i + chunk],
                                              params, sorted_aux))
    return torch.cat(chunks)


def _dispatch_scan(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    params: ZParameters,
    z_qso_min: float,
    z_qso_max: float,
    method: str,
):
    """Enqueue one spectrum's z scan on the model's device; returns (the
    host z grid, the (Z,) log-likelihood tensor).  Nothing here waits
    for the device: the grid and the table key come from the host
    spectrum, the spectrum goes up through pinned buffers, and the grid
    and the correlation table are built once per device."""
    if method == "shift":
        raise ValueError(
            "the shift scan (method='shift') is not ported: use 'corr', the "
            "correlation scan that 'auto' takes on a log-uniform grid, or 'exact'"
        )
    if method not in ("auto", "corr", "exact"):
        raise ValueError(
            f"unknown method {method!r}: expected 'auto', 'corr' or 'exact'"
        )
    wl_np = _host64(spec.wavelengths)
    pixel_dlog = detect_pixel_dlog(wl_np) if method != "exact" else None
    # the shared table covers observed wavelengths within SCAN_WL_BOUNDS;
    # anything outside falls back to the exact scan
    if pixel_dlog is not None and (
        wl_np[0] < SCAN_WL_BOUNDS[0] or wl_np[-1] > SCAN_WL_BOUNDS[1]
    ):
        pixel_dlog = None
    if method == "corr" and pixel_dlog is None:
        raise ValueError(
            f"the corr scan requires a log-uniform pixel grid within "
            f"{SCAN_WL_BOUNDS[0]:.0f}-{SCAN_WL_BOUNDS[1]:.0f} A"
        )
    if pixel_dlog is not None:
        # default fast path: the all-shifts correlation scan
        # (models/zqso_corr.py) — no per-z table reads at all
        from .zqso_corr import z_scan_corr

        with span("gpy.scan_chunk"):
            return z_scan_corr(learned, spec, params, pixel_dlog, z_qso_min, z_qso_max)
    device, dtype = _model_placement(learned)
    z_np, z_grid = _z_grid_for(params.num_zqso_samples, z_qso_min, z_qso_max, device)
    return z_np, z_log_evidences(learned, device_spectrum(spec, device, dtype), z_grid, params)


def inference_z_qso(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    params: ZParameters,
    z_qso_min: float = 2.14,
    z_qso_max: float = 6.16,
    method: str = "auto",
):
    """MAP redshift over the sample grid (reference: zqso_gp.py:214-250).

    :param learned: the model on the scan's device (:meth:`ZLearnedModel.to`).
    :param method: "corr" (the correlation scan; requires a log-uniform
        pixel grid within ``SCAN_WL_BOUNDS``), "exact" (per-z
        interp_uniform), or "auto" — corr when the grid allows it, exact
        otherwise.  "shift" is refused: the port leaves it out.
    :return: (z_map, sample_log_likelihoods, z_grid), numpy.
    """
    z_np, lls = _dispatch_scan(learned, spec, params, z_qso_min, z_qso_max, method)
    lls_np = lls.cpu().numpy()
    if not np.isfinite(lls_np).any():
        # same contract as inference_z_qso_many: an all-NaN scan is NaN
        return float("nan"), lls_np, z_np
    idx = np.nanargmax(lls_np)
    return float(z_np[idx]), lls_np, z_np


class ScanReadback(NamedTuple):
    """One dispatched scan's (Z,) result, being copied to ``host``: a
    pinned buffer written by a non-blocking copy on a CUDA device, with
    ``done`` the event recorded after it (None on the CPU, where the copy
    is plain).  Held here, so the buffer outlives its copy."""

    host: torch.Tensor
    done: torch.cuda.Event | None

    def result(self) -> np.ndarray:
        """The scan's log likelihoods, after waiting on its copy alone."""
        with span("gpy.scan_wait"):
            if self.done is not None:
                self.done.synchronize()
            return self.host.numpy()


def dispatch_scan(
    learned: ZLearnedModel,
    spec: ZSpectrum,
    params: ZParameters,
    z_qso_min: float = 2.14,
    z_qso_max: float = 6.16,
    method: str = "auto",
) -> tuple[np.ndarray, ScanReadback]:
    """Enqueue one spectrum's scan and the copy of its result to the
    host, behind the work already queued on the current stream, and
    return at once (the reference's ``copy_to_host_async``); no call in
    it waits for the device.

    :return: (the host z grid, the result's :class:`ScanReadback`).
    """
    with span("gpy.scan_dispatch"):
        z_np, lls = _dispatch_scan(learned, spec, params, z_qso_min, z_qso_max, method)
        cuda = lls.is_cuda
        host = torch.empty(lls.shape, dtype=lls.dtype, pin_memory=cuda)
        host.copy_(lls, non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        return z_np, ScanReadback(host, done)


def inference_z_qso_many(
    learned: ZLearnedModel,
    specs,
    params: ZParameters,
    z_qso_min: float = 2.14,
    z_qso_max: float = 6.16,
    method: str = "auto",
    keep_lls: bool = False,
    max_in_flight: int = 32,
):
    """Pipelined multi-spectrum redshift estimation: scans are enqueued
    up to ``max_in_flight`` ahead of the readback, so each scan's copy to
    the host overlaps the device's next scans while device memory stays
    bounded (only the (Z,) results stay alive).  Draining waits on the
    oldest scan's copy event alone (:func:`dispatch_scan`).

    ``specs`` may be any iterable (e.g. a prefetching generator —
    spectra are pulled as scans dispatch, so file reads also overlap).

    :param keep_lls: include each spectrum's full (num_zqso_samples,)
        log-likelihood array in the results (large; off by default so
        survey runs don't accumulate them in host memory).
    :return: ([(z_map, lls or None), ...], z_grid).  ``z_map`` is NaN
        for a spectrum whose scan produced no finite evidence.
    """
    in_flight: collections.deque = collections.deque()
    results = []
    z_np = None

    def drain_one():
        lls_np = in_flight.popleft().result()
        finite = np.isfinite(lls_np)
        z_map = (
            float(z_np[np.nanargmax(np.where(finite, lls_np, -np.inf))])
            if finite.any()
            else float("nan")
        )
        results.append((z_map, lls_np if keep_lls else None))

    for spec in specs:
        z_np, pending = dispatch_scan(learned, spec, params, z_qso_min, z_qso_max, method)
        in_flight.append(pending)
        if len(in_flight) > max_in_flight:
            drain_one()
    while in_flight:
        drain_one()
    return results, z_np
