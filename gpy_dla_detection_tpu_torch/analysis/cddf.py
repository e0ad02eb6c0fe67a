"""Column-density-function (CDDF) and abundance statistics.

Host-side science post-processing of the processed catalog — the
rebuild of the reference's ``DLACatalogue`` engine (reference:
CDDF_analysis/calc_cddf.py:43-1342).  Computes, from the per-spectrum
QMC sample likelihoods and model posteriors:

* ``column_density_function``: f(N) = n_DLA / dN / dX,
* ``line_density``: dN/dX(z),
* ``omega_dla``: the HI mass density in DLAs,
* exact Poisson-binomial confidence intervals via a DFT
  (reference: calc_cddf.py:1282-1317), with Le Cam's Poisson
  approximation for small per-sample probabilities.

Everything here is numpy on the host: the data are per-catalog
reductions of already-computed device outputs.

The port's copy of ``gpy_dla_detection_tpu/analysis/cddf.py``: numpy
and scipy, with h5py imported inside ``from_file``, so it runs on the
host wherever the catalog arrays are (``run_bayes_select.run``'s
``CatalogRun.arrays`` on a machine without h5py).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import integrate
from scipy.stats import poisson

OMEGA_M = 0.279  # WMAP9, as in the reference (calc_cddf.py:1239-1245)


# ---------------------------------------------------------------------------
# cosmology helpers (reference: calc_cddf.py:1239-1333)
# ---------------------------------------------------------------------------
def hubble_by_h0(z, omega_m=OMEGA_M):
    return np.sqrt(omega_m * (1 + z) ** 3 + (1 - omega_m))


def path_length_integrand(z, omega_m=OMEGA_M):
    """dX/dz = (1+z)^2 H0 / H(z)."""
    return (1 + z) ** 2 / hubble_by_h0(z, omega_m)


def rho_crit(hubble=0.7):
    """Critical density at z=0 in g cm^-3."""
    h100 = 3.2407789e-18 * hubble
    gravcgs = 6.674e-8
    return 3 * h100**2 / (8 * math.pi * gravcgs)


# ---------------------------------------------------------------------------
# Poisson-binomial machinery (reference: calc_cddf.py:1247-1317)
# ---------------------------------------------------------------------------
def _stable_complex_product(values):
    """prod(z) = exp(sum log|z| + i sum arg z), with stable summation."""
    rr = np.absolute(values)
    theta = np.angle(values)
    return np.exp(math.fsum(np.log(rr))) * np.exp(1j * math.fsum(theta))


def poisson_binomial_pdf(probabilities):
    """Exact PDF of the number of successes of independent Bernoulli
    trials with the given probabilities, via the DFT method
    (Fernandez & Williams 2010; reference: calc_cddf.py:1282-1305)."""
    if len(probabilities) == 0:
        return np.ones(1)
    pp = np.concatenate([np.atleast_1d(p) for p in probabilities]).astype(np.float64)
    n = pp.size
    coeffs = np.empty((n + 1) // 2 + 1, dtype=np.complex128)
    for k in range(coeffs.size):
        w = np.exp(-2j * math.pi * k / (n + 1)) - 1.0
        coeffs[k] = _stable_complex_product(1.0 + pp * w)
    pdf = np.fft.irfft(coeffs, n=n + 1)
    assert abs(math.fsum(pdf) - 1.0) < 1e-6
    return pdf


def interval(cdf, level, offset=0):
    """Confidence interval of a discrete CDF at the given level
    (reference: calc_cddf.py:1247-1266)."""
    if np.size(cdf) == 1:
        return (offset, offset)
    high = 1 + offset
    low = offset
    idown = np.where(cdf < 0.5 - level / 2)[0]
    if idown.size:
        low += idown[-1] + 1
    iup = np.where(cdf > 0.5 + level / 2)[0]
    if iup.size:
        high += iup[0]
    else:
        high = np.size(cdf)
    return (low, high)


def pdf_confidence(pdf, offset):
    """(MAP, 68% interval, 95% interval) of a discrete pdf
    (reference: calc_cddf.py:1268-1280)."""
    cdf = np.cumsum(pdf)
    maxlike = interval(cdf, 0.0, offset=offset)[0]
    ll68 = interval(cdf, 0.68, offset=offset)
    ll95 = interval(cdf, 0.95, offset=offset)
    return maxlike, ll68, ll95


def combine_with_poisson(pdf_pb, pmean):
    """Convolve the Poisson-binomial pdf of the high-probability events
    with a Poisson(pmean) for the low-probability tail
    (reference: calc_cddf.py:1041-1059)."""
    if pmean == 0.0:
        return pdf_pb, 0
    weak = poisson(pmean)
    plow, phigh = (int(v) for v in weak.interval(1 - 1e-4))
    dlow, dhigh = interval(np.cumsum(pdf_pb), 1 - 1e-4)
    # the clamp applies only to the inner sum's support; the outer
    # range keeps the unclamped dhigh (reference: calc_cddf.py:1058 —
    # clamping both dropped the last support point whenever dhigh hit
    # the end of a short pdf)
    dstop = min(dhigh + 1, np.size(pdf_pb))
    pdf_comb = np.array(
        [
            math.fsum(weak.pmf(N - i) * pdf_pb[i] for i in range(dlow, dstop))
            for N in range(plow + dlow, phigh + dhigh + 1)
        ]
    )
    return pdf_comb, plow + dlow


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------
class ProcessedCatalog:
    """Statistics over a processed DLA catalog.

    :param min_z_dlas, max_z_dlas: (Q,) per-spectrum search ranges.
    :param model_posteriors: (Q, 1 + sub_dla + max_dlas).
    :param sample_log_likelihoods: (Q, S, max_dlas) per-sample log
        likelihoods (with the per-sample 1/S Occam factor, as stored by
        the driver).
    :param log_likelihoods_dla: (Q, max_dlas) DLA model log evidences.
    :param base_sample_inds: (Q, S, max_dlas - 1) or (max_dlas-1, S, Q)
        chained-sample indices (0-based).
    :param offset_samples, log_nhi_samples: (S,) the QMC sample set.
    :param snrs: optional (Q,) signal-to-noise ratios for SNR cuts.
    :param occams_razor: extra posterior penalty on absorber models
        (reference: calc_cddf.py:162-203).
    """

    def __init__(
        self,
        min_z_dlas,
        max_z_dlas,
        model_posteriors,
        sample_log_likelihoods,
        log_likelihoods_dla,
        base_sample_inds,
        offset_samples,
        log_nhi_samples,
        snrs=None,
        sub_dla=True,
        occams_razor=1,
        snr_thresh=-2.0,
        lowzcut=False,
        max_k=1,
        pixel_noise=None,
        noise_thresh=0.25,
    ):
        self._z_min = np.asarray(min_z_dlas)
        self._z_max = np.asarray(max_z_dlas)
        self.sub_dla = int(bool(sub_dla))
        self.max_k = max_k

        self.sample_log_likelihoods = np.asarray(sample_log_likelihoods)
        self.log_likelihoods_dla = np.atleast_2d(np.asarray(log_likelihoods_dla))
        base = np.asarray(base_sample_inds)
        Q = self.sample_log_likelihoods.shape[0]
        if base.ndim == 3 and base.shape[0] != Q and base.shape[-1] == Q:
            # the reference driver's MATLAB layout (max_dlas-1, S, Q)
            base = np.transpose(base, (2, 1, 0))  # -> (Q, S, k-1)
        self.base_sample_inds = base

        self.z_offsets = np.asarray(offset_samples)
        self.lnhi_vals = np.asarray(log_nhi_samples)

        self.snrs = np.asarray(snrs) if snrs is not None else None
        self.snr_thresh = snr_thresh
        # optional arbitrary per-spectrum boolean mask ANDed into every
        # spectrum filter — the reference's z_qso / path-length split
        # hook (reference: calc_cddf.py:140,498)
        self.condition: np.ndarray | None = None
        self.lowzcut = lowzcut
        self.proximity_zone = 0.1
        self.bins_per_z = 6

        # optional per-spectrum pixel-noise filtering (reference:
        # calc_cddf.py:120-124, 605-657): pixel_noise[i] is the noise
        # variance along spectrum i's searchable z range
        self.pixel_noise = pixel_noise
        self.noise_thresh = noise_thresh
        self.filter_noisy_pixels = pixel_noise is not None

        # thresholds (reference: calc_cddf.py:88-96)
        self.p_thresh_spec = 5e-2
        self.p_thresh_sample = 1e-4
        self.p_switch = 0.25

        # occam renormalization of the model posteriors
        # (reference: calc_cddf.py:182-203)
        mp = np.array(model_posteriors, dtype=np.float64)
        mp[:, 1:] = mp[:, 1:] / occams_razor
        mp = mp / mp.sum(axis=1, keepdims=True)
        self.model_posteriors = mp
        self.p_dla = mp[:, 1 + self.sub_dla :].sum(axis=1)
        self.p_no_dla = mp[:, : 1 + self.sub_dla].sum(axis=1)

        self._log_norm_like_cache: dict = {}

        # bootstrap resampling state (reference: calc_cddf.py:286-324):
        # when set, an index array into the original catalog; all
        # per-spectrum accessors read through it
        self._resample: np.ndarray | None = None

    # ------------------------------------------------------------------
    @classmethod
    def from_file(cls, processed_file, sample_file=None, snrs_file=None, **kw):
        """Load from a processed HDF5 catalog written by this framework
        or by the reference driver (reference: calc_cddf.py:72-158)."""
        import h5py

        with h5py.File(processed_file, "r") as f:
            min_z = np.ravel(f["min_z_dlas"])
            max_z = np.ravel(f["max_z_dlas"])
            Q = min_z.size  # ground truth for orienting MATLAB layouts

            sll = np.asarray(f["sample_log_likelihoods_dla"])
            # reference/MATLAB layouts can be transposed; want (Q, S, k)
            if sll.ndim == 2:
                sll = (sll if sll.shape[0] == Q else sll.T)[:, :, None]
            elif sll.shape[0] != Q:
                matches = np.nonzero(np.asarray(sll.shape) == Q)[0]
                if matches.size == 0:
                    raise ValueError(
                        "sample_log_likelihoods_dla has shape "
                        f"{sll.shape} but the catalog has {Q} spectra "
                        "(min_z_dlas); cannot orient the array"
                    )
                sll = np.moveaxis(sll, int(matches[0]), 0)
                if sll.shape[1] < sll.shape[2]:  # want (Q, S, k)
                    sll = np.swapaxes(sll, 1, 2)
            lld = np.atleast_2d(np.asarray(f["log_likelihoods_dla"]))
            if lld.shape[0] != Q:
                lld = lld.T
            mp = np.asarray(f["model_posteriors"])
            if mp.shape[0] != Q:
                mp = mp.T
            base = np.asarray(f["base_sample_inds"])
            # this framework writes (Q, S, max_dlas-1) 0-BASED indices
            # (catalog_io.py); the reference driver's files are MATLAB
            # (max_dlas-1, S, Q) — or (S, Q) at max_dlas == 2 — and
            # 1-BASED (the reference subtracts 1 on load,
            # calc_cddf.py:392-404).  Detect by orientation.
            if base.ndim == 3 and base.shape[0] != Q and base.shape[-1] == Q:
                base = np.transpose(base, (2, 1, 0)) - 1
            elif base.ndim == 2:
                if base.shape[0] != Q and base.shape[-1] == Q:
                    base = base.T - 1
                base = base[:, :, None]

            if sample_file is not None:
                with h5py.File(sample_file, "r") as sf:
                    offsets = sf["offset_samples"][:, 0]
                    lnhi = sf["log_nhi_samples"][:, 0]
            else:
                raise ValueError("sample_file required")

        snrs = None
        if snrs_file is not None:
            with h5py.File(snrs_file, "r") as ff:
                arr = np.asarray(ff["snrs"])
                snrs = arr[0] if arr.ndim == 2 else arr

        return cls(
            min_z, max_z, mp, sll, lld, base, offsets, lnhi, snrs=snrs, **kw
        )

    # ------------------------------------------------------------------
    # bootstrap view plumbing: vector accessors return the resampled
    # view; per-spectrum accessors map view index -> original index
    def _orig(self, spec):
        return spec if self._resample is None else int(self._resample[spec])

    def _view(self, arr):
        return arr if self._resample is None else arr[self._resample]

    def z_min(self, spec=None):
        return self._view(self._z_min) if spec is None else self._z_min[self._orig(spec)]

    def z_max(self, spec=None):
        return self._view(self._z_max) if spec is None else self._z_max[self._orig(spec)]

    def proximity(self, zqso):
        return zqso - self.proximity_zone

    def _snr_mask(self):
        mask = (
            np.ones_like(self.z_min(), dtype=bool)
            if self.snrs is None
            else self._view(self.snrs) > self.snr_thresh
        )
        if self.condition is not None:
            mask = mask & self._view(np.asarray(self.condition, bool))
        return mask

    def _p_dla_k(self, second):
        """P(at least 1 DLA) for second=0; P(exactly k+1 DLAs) else."""
        if not second:
            return self._view(self.p_dla)
        return self._view(self.model_posteriors)[:, int(second) + 1 + self.sub_dla]

    def filter_dla_spectra(self, second=0):
        """Spectra above the DLA-probability and SNR thresholds
        (reference: calc_cddf.py:477-492)."""
        return np.where(
            (self._p_dla_k(second) > self.p_thresh_spec) & self._snr_mask()
        )[0]

    def log_norm_like(self, spec, second=0):
        """Per-sample normalized log likelihood of the DLA(second+1)
        model for one spectrum (reference: calc_cddf.py:407-476)."""
        spec = self._orig(spec)
        key = (spec, second)
        if key not in self._log_norm_like_cache:
            ll = np.array(self.sample_log_likelihoods[spec, :, second])
            ll[np.isnan(ll)] = -1e30
            S = ll.shape[0]
            norm = self.log_likelihoods_dla[spec, second] + np.log(S) * (second + 1)
            self._log_norm_like_cache[key] = ll - norm
        return self._log_norm_like_cache[key]

    def sample_params(self, spec, second=0):
        """(log_nhi, z) of each sample for this spectrum; for k >= 2
        the chained sample's parameters (reference: calc_cddf.py:903-920)."""
        spec = self._orig(spec)
        redshifts = self._z_min[spec] + (
            self._z_max[spec] - self._z_min[spec]
        ) * self.z_offsets
        lnhi = self.lnhi_vals
        if second:
            base = self.base_sample_inds[spec, :, second - 1]
            lnhi = lnhi[base]
            redshifts = redshifts[base]
        return lnhi, redshifts

    def prob_dla_per_sample(self, spec, index, second=0):
        """P(DLA at the sampled parameters) for the selected samples
        (reference: calc_cddf.py:922-943)."""
        orig = self._orig(spec)
        if not second:
            return (
                np.exp(self.log_norm_like(spec, 0)[index]) * self.p_dla[orig]
            )
        # one exp of the (up to S-element) normalized likelihood slice,
        # scaled by the summed posterior of models 1..second+1 — the
        # loop body is identical per model (reference: calc_cddf.py:
        # 922-943 re-evaluates it; this is the hottest analysis loop)
        like = np.exp(self.log_norm_like(spec, second)[index])
        p_k = self.model_posteriors[
            orig, 1 + self.sub_dla : second + 2 + self.sub_dla
        ].sum()
        return like * p_k

    # ------------------------------------------------------------------
    def path_length(self, z_min, z_max):
        """Total absorption path dX searched between z_min and z_max
        (reference: calc_cddf.py:552-604)."""
        assert z_min < z_max
        ind = self._snr_mask()
        max_z = self._view(self._z_max)[ind].copy()
        min_z = self._view(self._z_min)[ind]
        if self.lowzcut:
            max_z = np.maximum(np.minimum(max_z, self.proximity(max_z)), min_z)
        sel = (min_z < z_max) & (max_z > z_min)
        max_z, min_z = max_z[sel], min_z[sel]

        whole = (max_z > z_max) & (min_z < z_min)
        tbin, _ = integrate.quad(path_length_integrand, z_min, z_max)

        if not self.filter_noisy_pixels:
            total = np.count_nonzero(whole) * tbin
            for zmin, zmax in zip(min_z[~whole], max_z[~whole]):
                lo, hi = max(z_min, zmin), min(z_max, zmax)
                if hi > lo:
                    ans, _ = integrate.quad(path_length_integrand, lo, hi)
                    total += ans
            return total

        # noisy-pixel filtering: integrate only over contiguous
        # low-noise regions of each spectrum (reference: calc_cddf.py:605-657)
        view_ids = (
            self._resample if self._resample is not None
            else np.arange(self._z_min.size)
        )
        pn_all = [self.pixel_noise[view_ids[i]] for i in np.where(ind)[0]]
        pn_all = [pn_all[i] for i in np.where(sel)[0]]
        no_filter = np.array(
            [np.all(np.asarray(pn) < self.noise_thresh) for pn in pn_all]
        )
        total = np.count_nonzero(whole & no_filter) * tbin
        for i in np.where(~(whole & no_filter))[0]:
            zmin, zmax, pn = min_z[i], max_z[i], np.asarray(pn_all[i])
            lo, hi = max(z_min, zmin), min(z_max, zmax)
            if hi <= lo:
                continue
            if no_filter[i]:
                ans, _ = integrate.quad(path_length_integrand, lo, hi)
                total += ans
                continue
            zzs = zmin + (zmax - zmin) * np.arange(pn.size) / max(pn.size - 1, 1)
            good = (pn < self.noise_thresh) & (zzs >= lo) & (zzs <= hi)
            # contiguous good runs -> piecewise integration
            edges = np.flatnonzero(np.diff(np.concatenate([[0], good.view(np.int8), [0]])))
            for start, end in zip(edges[::2], edges[1::2]):
                a, b = zzs[start], zzs[end - 1]
                if b > a:
                    ans, _ = integrate.quad(path_length_integrand, a, b)
                    total += ans
        return total

    # ------------------------------------------------------------------
    def _split_distributions_single(
        self, q_bins, lred, ured, lnhi_min, lnhi_max, nhi, second=0
    ):
        """Per-bin lists of per-sample DLA probabilities (large ones kept
        exactly, small ones accumulated for the Poisson approximation)
        (reference: calc_cddf.py:970-1039)."""
        probs = [[] for _ in q_bins[:-1]]
        poisson_list = [[] for _ in q_bins[:-1]]
        for spec in self.filter_dla_spectra(second=second):
            lnhi, redshifts = self.sample_params(spec, second=second)
            upper_z = ured
            if self.lowzcut:
                upper_z = min(self.proximity(self.z_max(spec)), ured)
            desired = (
                (lnhi > lnhi_min)
                & (lnhi < lnhi_max)
                & (redshifts < upper_z)
                & (redshifts > lred)
            )
            if self.filter_noisy_pixels:
                # exclude samples sitting on noisy pixels
                # (reference: calc_cddf.py:1003-1008)
                pn = np.asarray(self.pixel_noise[self._orig(spec)])
                pind = np.clip(
                    (
                        (redshifts - self.z_min(spec))
                        / (self.z_max(spec) - self.z_min(spec))
                        * pn.size
                    ).astype(int),
                    0,
                    pn.size - 1,
                )
                desired &= pn[pind] < self.noise_thresh
            ind = np.where(desired)[0]
            if ind.size == 0:
                continue
            p = self.prob_dla_per_sample(spec, ind, second=second)
            keep = p > self.p_thresh_sample
            if not np.any(keep):
                continue
            quantity = (lnhi if nhi else redshifts)[ind]
            for iz in range(len(q_bins) - 1):
                in_bin = keep & (quantity > q_bins[iz]) & (quantity < q_bins[iz + 1])
                p_bin = p[in_bin]
                if p_bin.size == 0:
                    continue
                small = p_bin < self.p_switch
                if np.any(small):
                    poisson_list[iz].append(math.fsum(p_bin[small]))
                if np.any(~small):
                    probs[iz].append(p_bin[~small])
        poissons = np.array([math.fsum(pl) for pl in poisson_list])
        return probs, poissons

    def _split_distributions(self, q_bins, lred, ured, lnhi_min, lnhi_max, nhi):
        """Combine the per-bin distributions over DLA(1..max_k)
        (reference: calc_cddf.py:945-957)."""
        probs, poissons = self._split_distributions_single(
            q_bins, lred, ured, lnhi_min, lnhi_max, nhi, second=0
        )
        for k in range(2, self.max_k + 1):
            p2, po2 = self._split_distributions_single(
                q_bins, lred, ured, lnhi_min, lnhi_max, nhi, second=k - 1
            )
            probs = [a + b for a, b in zip(probs, p2)]
            poissons = poissons + po2
        return probs, poissons

    def confidence_intervals(
        self, q_bins, lred=2.0, ured=4.0, lnhi_min=20.3, lnhi_max=23.0, nhi=False
    ):
        """Poisson-binomial MAP + 68/95% intervals of the number of DLAs
        per bin (reference: calc_cddf.py:1061-1088)."""
        probs, poissons = self._split_distributions(
            q_bins, lred, ured, lnhi_min, lnhi_max, nhi
        )
        maxlikes, levels68, levels95 = [], [], []
        for pp, pmean in zip(probs, poissons):
            pdf = poisson_binomial_pdf(pp)
            pdf_comb, offset = combine_with_poisson(pdf, pmean)
            maxlike, ll68, ll95 = pdf_confidence(pdf_comb, offset)
            maxlikes.append(maxlike)
            levels68.append(ll68)
            levels95.append(ll95)
        return maxlikes, levels68, levels95

    def z_nhi_histogram(
        self,
        q_bins,
        lred=2.0,
        ured=4.0,
        lnhi_min=20.3,
        lnhi_max=23.0,
        nhi=False,
        moment=False,
    ):
        """Mean and variance of the DLA count (or total NHI if
        ``moment``) per bin (reference: calc_cddf.py:1090-1131)."""
        means = np.zeros(len(q_bins) - 1)
        variances = np.zeros(len(q_bins) - 1)
        for spec in self.filter_dla_spectra():
            lnhi, redshifts = self.sample_params(spec)
            ind = np.where(
                (lnhi > lnhi_min)
                & (lnhi < lnhi_max)
                & (redshifts < ured)
                & (redshifts > lred)
            )[0]
            if ind.size == 0:
                continue
            p = self.prob_dla_per_sample(spec, ind)
            weight = 10.0 ** lnhi[ind] if moment else 1.0
            quantity = (lnhi if nhi else redshifts)[ind]
            t_hist, _ = np.histogram(quantity, bins=q_bins, weights=weight * p)
            means += t_hist
            t_var, _ = np.histogram(
                quantity, bins=q_bins, weights=weight * weight * (1 - p) * p
            )
            variances += t_var
        variances += means  # Poisson sampling term
        return means, variances

    # ------------------------------------------------------------------
    def column_density_function(
        self, z_min=1.0, z_max=6.0, lnhi_nbins=30, lnhi_min=20.0, lnhi_max=23.0
    ):
        """f(N) = n_DLA / dN / dX with confidence intervals
        (reference: calc_cddf.py:658-683).

        :return: (log10 N centers, cddf, cddf68, cddf95, xerrs)
        """
        l_nhi = np.linspace(lnhi_min, lnhi_max, num=lnhi_nbins + 1)
        ndlas, l68, l95 = self.confidence_intervals(
            q_bins=l_nhi, lred=z_min, ured=z_max, lnhi_min=lnhi_min, nhi=True
        )
        dX = self.path_length(z_min, z_max)
        dN = 10.0 ** l_nhi[1:] - 10.0 ** l_nhi[:-1]
        cddf = np.array(ndlas) / dX / dN
        cddf68 = np.array(l68) / dX / np.vstack([dN, dN]).T
        cddf95 = np.array(l95) / dX / np.vstack([dN, dN]).T
        l_cent = 0.5 * (l_nhi[:-1] + l_nhi[1:])
        xerrs = (10**l_cent - 10 ** l_nhi[:-1], 10 ** l_nhi[1:] - 10**l_cent)
        return l_cent, cddf, cddf68, cddf95, xerrs

    def line_density(self, z_min=2.0, z_max=4.0):
        """dN/dX(z) with confidence intervals
        (reference: calc_cddf.py:708-726)."""
        nbins = max(int((z_max - z_min) * self.bins_per_z), 1)
        z_bins = np.linspace(z_min, z_max, nbins + 1)
        maxlike, l68, l95 = self.confidence_intervals(
            q_bins=z_bins, lred=z_min, ured=z_max, lnhi_min=20.3, nhi=False
        )
        dX = np.array(
            [self.path_length(a, b) for a, b in zip(z_bins[:-1], z_bins[1:])]
        )
        # keep every bin (NaN where the searched path is zero) so the
        # output shape is a pure function of (z_min, z_max) — bootstrap
        # resamples must stack (get_sample_errors)
        dX_safe = np.where(dX > 0, dX, np.nan)
        dNdX = np.array(maxlike) / dX_safe
        dndx68 = np.array(l68) / np.vstack([dX_safe, dX_safe]).T
        dndx95 = np.array(l95) / np.vstack([dX_safe, dX_safe]).T
        z_cent = 0.5 * (z_bins[:-1] + z_bins[1:])
        xerrs = (z_cent - z_bins[:-1], z_bins[1:] - z_cent)
        return z_cent, dNdX, dndx68, dndx95, xerrs

    def _omega_confidence_intervals(self, lnhi_bins, lred, ured, tailprob=5e-4):
        """Confidence interval on the total NHI in DLAs over a redshift
        range, by combining the per-NHI-bin count PDFs into a total-mass
        PDF (reference: calc_cddf.py:780-855)."""
        probs, poissons = self._split_distributions(
            lnhi_bins, lred, ured, lnhi_bins[0], lnhi_bins[-1], nhi=True
        )
        pdf_comb = np.ones(1)
        nhi_comb = np.zeros(1)
        nhi_cent = 10.0 ** (0.5 * (lnhi_bins[:-1] + lnhi_bins[1:]))
        for pp, pmean, nhi_cc in zip(probs, poissons, nhi_cent):
            pdf = poisson_binomial_pdf(pp)
            pdf_one, offset_one = combine_with_poisson(pdf, pmean)
            dlow, dhigh = interval(np.cumsum(pdf_one), 1 - 1e-4)
            maxr = min(dhigh + 1, np.size(pdf_one))
            pdf_comb = np.ravel(
                pdf_comb[:, None] * pdf_one[None, dlow:maxr]
            )
            nhi_comb = np.ravel(
                nhi_comb[:, None]
                + (offset_one + np.arange(dlow, maxr))[None, :] * nhi_cc
            )
            order = np.argsort(nhi_comb)
            nhi_comb, pdf_comb = nhi_comb[order], pdf_comb[order]
            # trim the tails and merge near-identical mass options so the
            # combined support stays tractable (reference: :816-848)
            cdf = np.cumsum(pdf_comb)
            lo_t = np.where(cdf < tailprob)[0]
            hi_t = np.where(cdf > 1 - tailprob)[0]
            if hi_t.size:
                pdf_comb = np.append(pdf_comb[: hi_t[0]], pdf_comb[hi_t].sum())
                nhi_comb = np.append(nhi_comb[: hi_t[0]], nhi_comb[hi_t].min())
            if lo_t.size:
                pdf_comb = np.insert(pdf_comb[lo_t[-1] + 1 :], 0, pdf_comb[lo_t].sum())
                nhi_comb = np.insert(nhi_comb[lo_t[-1] + 1 :], 0, nhi_comb[lo_t].max())
            # merge options within 0.1% in NHI
            new_pdf = [pdf_comb[0]]
            new_nhi = [nhi_comb[0]]
            i = 1
            while i < pdf_comb.size:
                base = nhi_comb[i] if nhi_comb[i] > 0 else 1.0
                j = i
                while j < pdf_comb.size and nhi_comb[j] / base < 1 + 1e-3:
                    j += 1
                new_pdf.append(math.fsum(pdf_comb[i:j]))
                new_nhi.append(float(np.median(nhi_comb[i:j])))
                i = j
            pdf_comb = np.asarray(new_pdf)
            nhi_comb = np.asarray(new_nhi)
        maxlike, l68, l95 = pdf_confidence(pdf_comb, 0)
        hi95 = min(l95[1], nhi_comb.size - 1)
        hi68 = min(l68[1], nhi_comb.size - 1)
        return (
            nhi_comb[maxlike],
            (nhi_comb[l68[0]], nhi_comb[hi68]),
            (nhi_comb[l95[0]], nhi_comb[hi95]),
        )

    def omega_dla_cddf(self, z_min=2.0, z_max=4.0, hubble=0.7, lnhi_nbins=30):
        """Omega_DLA from the summed CDDF with full Poisson-binomial
        confidence intervals (reference: calc_cddf.py:739-778).

        :return: (z_cent, omega, omega68 (n,2), omega95 (n,2), xerrs)
        """
        nbins = max(int((z_max - z_min) * self.bins_per_z), 1)
        z_bins = np.linspace(z_min, z_max, nbins + 1)
        protonmass = 1.67262178e-24
        h100 = 3.2407789e-18 * hubble
        light = 2.99e10
        conversion = protonmass / light * h100 / rho_crit(hubble)
        lnhi_bins = np.linspace(20.3, 23.0, num=lnhi_nbins + 1)

        # keep every bin (NaN rows where the searched path is zero) so
        # the output shape is a pure function of (z_min, z_max) and
        # bootstrap resamples stack (get_sample_errors)
        z_cent, omega, omega68, omega95, xerrs = [], [], [], [], []
        for zz in range(nbins):
            dX = self.path_length(z_bins[zz], z_bins[zz + 1])
            z_c = 0.5 * (z_bins[zz] + z_bins[zz + 1])
            z_cent.append(z_c)
            xerrs.append((z_c - z_bins[zz], z_bins[zz + 1] - z_c))
            if dX == 0.0:
                omega.append(np.nan)
                omega68.append(np.full(2, np.nan))
                omega95.append(np.full(2, np.nan))
                continue
            nhi_like, nhi_68, nhi_95 = self._omega_confidence_intervals(
                lnhi_bins, z_bins[zz], z_bins[zz + 1]
            )
            omega.append(conversion * nhi_like / dX)
            omega68.append(conversion * np.asarray(nhi_68) / dX)
            omega95.append(conversion * np.asarray(nhi_95) / dX)
        return (
            np.asarray(z_cent),
            np.asarray(omega),
            np.asarray(omega68),
            np.asarray(omega95),
            np.asarray(xerrs).T,
        )

    def omega_dla(
        self, z_min=2.0, z_max=4.0, hubble=0.7, lnhi_max=23.0, lnhi_min=20.3
    ):
        """HI mass density in DLAs relative to critical:
        Omega_DLA = m_P H0 / (c rho_c) * sum(NHI) / dX
        (reference: calc_cddf.py:856-905)."""
        nbins = max(int((z_max - z_min) * self.bins_per_z), 1)
        z_bins = np.linspace(z_min, z_max, nbins + 1)
        mean, variance = self.z_nhi_histogram(
            q_bins=z_bins,
            lred=z_min,
            ured=z_max,
            lnhi_min=lnhi_min,
            lnhi_max=lnhi_max,
            nhi=False,
            moment=True,
        )
        protonmass = 1.67262178e-24
        h100 = 3.2407789e-18 * hubble
        light = 2.99e10
        conversion = protonmass / light * h100 / rho_crit(hubble)
        dX = np.array(
            [self.path_length(a, b) for a, b in zip(z_bins[:-1], z_bins[1:])]
        )
        ii = dX > 0
        omega = conversion * mean[ii] / dX[ii]
        omega_err = conversion * np.sqrt(variance[ii]) / dX[ii]
        z_cent = 0.5 * (z_bins[:-1] + z_bins[1:])
        return z_cent[ii], omega, omega_err

    # ------------------------------------------------------------------
    def map_from_samples(self, second=0, chunk=4096):
        """Re-derive the MAP (z_dla, logNHI) of the DLA(second+1) model
        directly from the stored per-sample likelihoods, processing the
        catalog in chunks to bound memory
        (reference: qso_loader.py:303-408 prepare_roman_map_vals).

        Spectra whose evidence is NaN get NaN MAPs.

        :return: (map_z_dlas, map_log_nhis) arrays of shape (Q,).
        """
        Q = self.sample_log_likelihoods.shape[0]
        map_z = np.full(Q, np.nan)
        map_n = np.full(Q, np.nan)
        for start in range(0, Q, chunk):
            end = min(start + chunk, Q)
            lls = self.sample_log_likelihoods[start:end, :, second]
            ok = ~np.all(np.isnan(lls), axis=1)
            best = np.nanargmax(np.where(np.isnan(lls), -np.inf, lls), axis=1)
            z = (
                self._z_min[start:end]
                + (self._z_max[start:end] - self._z_min[start:end])
                * self.z_offsets[best]
            )
            map_z[start:end] = np.where(ok, z, np.nan)
            map_n[start:end] = np.where(ok, self.lnhi_vals[best], np.nan)
        return map_z, map_n

    # ------------------------------------------------------------------
    # bootstrap sample errors (reference: calc_cddf.py:286-378)
    def resample(self, do_it=True, nspec=0, rng=None, min_per_bin=10):
        """Draw a new catalog of the same size with replacement,
        stratified in ~10 quantile bins of z_max so the quasar redshift
        distribution is roughly preserved (high-z quasars are rare and
        a plain bootstrap could lose them entirely)
        (reference: calc_cddf.py:286-324).

        ``resample(False)`` restores the original catalog.
        """
        if not do_it:
            self._resample = None
            return
        rng = np.random.default_rng(rng) if not isinstance(
            rng, np.random.Generator
        ) else rng
        Q = self._z_max.size
        if nspec == 0:
            nspec = Q
        # quantile bin edges on z_max; merge bins thinner than min_per_bin
        n_bins = min(10, max(Q // max(min_per_bin, 1), 1))
        edges = np.quantile(self._z_max, np.linspace(0.0, 1.0, n_bins + 1))
        edges[0], edges[-1] = -np.inf, np.inf
        self._resample = None  # draw from the original catalog
        draws = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            ii = np.where((self._z_max > lo) & (self._z_max <= hi))[0]
            if ii.size == 0:
                continue
            n_here = int(round(ii.size / Q * nspec))
            draws.append(ii[rng.integers(0, ii.size, n_here)])
        inds = np.concatenate(draws) if draws else np.array([], int)
        # rounding can leave the sample short/long: top up with
        # catalog-uniform draws (proportional to strata in expectation)
        # and trim AFTER a permutation — a tail trim would remove draws
        # exclusively from the last (highest-z) stratum, defeating the
        # stratification
        if inds.size < nspec:
            extra = rng.integers(0, Q, nspec - inds.size)
            inds = np.concatenate([inds, extra])
        self._resample = rng.permutation(inds)[:nspec]

    def get_sample_errors(self, z_min=2.0, z_max=5.0, nsample=5, rng=None):
        """Bootstrap percentiles of dN/dX and Omega_DLA over ``nsample``
        resamplings (reference: calc_cddf.py:325-344).

        :return: dict with keys dndx_sample, dndx_68, dndx_95,
            omega_sample (x1000), omega_68, omega_95.
        """
        rng = np.random.default_rng(rng)
        dndx_sample, om_sample = [], []
        try:
            for _ in range(nsample):
                self.resample(True, rng=rng)
                _, dNdX, _, _, _ = self.line_density(z_min=z_min, z_max=z_max)
                _, omega, _, _, _ = self.omega_dla_cddf(
                    z_min=z_min, z_max=z_max, lnhi_nbins=15
                )
                om_sample.append(1000 * omega)
                dndx_sample.append(dNdX)
        finally:
            self.resample(False)
        dndx_sample = np.array(dndx_sample)
        om_sample = np.array(om_sample)
        # nan-aware reductions: a resample can leave individual z bins
        # with zero searched path (NaN rows from line_density /
        # omega_dla_cddf)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return {
                "dndx_sample": np.nanmedian(dndx_sample, axis=0),
                "dndx_68": np.array(
                    [np.nanpercentile(dndx_sample, 84, axis=0),
                     np.nanpercentile(dndx_sample, 16, axis=0)]
                ),
                "dndx_95": np.array(
                    [np.nanpercentile(dndx_sample, 97.5, axis=0),
                     np.nanpercentile(dndx_sample, 2.5, axis=0)]
                ),
                "omega_sample": np.nanmedian(om_sample, axis=0),
                "omega_68": np.array(
                    [np.nanpercentile(om_sample, 84, axis=0),
                     np.nanpercentile(om_sample, 16, axis=0)]
                ),
                "omega_95": np.array(
                    [np.nanpercentile(om_sample, 97.5, axis=0),
                     np.nanpercentile(om_sample, 2.5, axis=0)]
                ),
            }
