"""Multi-DLA paper-figure drivers: one function per figure family of
the multi-DLA paper (reference: CDDF_analysis/make_multi_dla_plots.py).

These orchestrate the comparison machinery (analysis/comparison.py,
analysis/external.py) and the plotting primitives (plotting.py) into
the reference's named figure set: MAP-accuracy histograms, ROC and
confusion comparisons, external-catalog (Parks CNN / Noterdaeme) CDDF
and dN/dX overlays with SNR checks, and the learned-model procedure
figures.

The port of ``gpy_dla_detection_tpu/analysis/paper_plots_multi.py``: a
learned model's arrays (the buffers of ``models.learned.LearnedModel``,
on any device, or numpy fields) reach the figures through the host
(``plotting.to_host``); the spectrum curves are ``plotting``'s.
"""

from __future__ import annotations

import os
from os import path

import numpy as np

# np.trapz was renamed in numpy 2.0; support both
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

from .comparison import ComparisonResult
from .external import (
    ExternalEstimations,
    column_density_function_external,
    line_density_external,
)
from .paper_plots import _plot_cddf, _plot_line_density, _plt, save_figure


# ---------------------------------------------------------------------------
# MAP-accuracy and classifier comparisons
# ---------------------------------------------------------------------------
def do_MAP_comparison(
    result: ComparisonResult, subdir: str, label: str = "concordance",
    num_bins: int = 100,
):
    """Histograms of the MAP parameter residuals against a truth
    catalog (reference: make_multi_dla_plots.py:210-300
    do_MAP_concordance_comparison / do_MAP_parks_comparison)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)

    plt.hist(result.delta_z, bins=np.linspace(-0.01, 0.01, num_bins))
    plt.xlabel(r"$z_\mathrm{MAP} - z_\mathrm{%s}$" % label)
    plt.ylabel("sightlines")
    save_figure(path.join(subdir, f"MAP_z_delta_{label}"))
    plt.clf()

    plt.hist(result.delta_log_nhi, bins=np.linspace(-1.0, 1.0, num_bins))
    plt.xlabel(r"$\log N_\mathrm{HI,MAP} - \log N_\mathrm{HI,%s}$" % label)
    plt.ylabel("sightlines")
    save_figure(path.join(subdir, f"MAP_lognhi_delta_{label}"))
    plt.clf()


def do_ROC_comparisons(results: dict, subdir: str, name: str = "roc"):
    """Overlay ROC curves of several runs/catalogs
    (reference: make_multi_dla_plots.py:347-369)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    for label, res in results.items():
        plt.plot(res.fpr, res.tpr, label=f"{label} (AUC={res.auc:.3f})")
    plt.plot([0, 1], [0, 1], ls=":", color="k", lw=0.5)
    plt.xlabel("false positive rate")
    plt.ylabel("true positive rate")
    plt.legend(loc=0)
    save_figure(path.join(subdir, name))
    plt.clf()


def multi_roc(model_posteriors, truth_counts, sub_dla: int = 1, max_k: int = 4):
    """Multi-DLA ROC over "sub-sightlines": tier k of sightline i is a
    positive iff the truth catalog has more than k DLAs there, scored
    by the posterior odds of at least k+1 DLAs vs no DLA
    (reference: qso_loader.py:618-661 make_multi_ROC).

    :return: (fpr, tpr, auc)
    """
    mp = np.asarray(model_posteriors, np.float64)
    counts = np.asarray(truth_counts)
    p_no = mp[:, : 1 + sub_dla].sum(axis=1)
    # P(>= k DLAs) for k = 1..max_k as reversed-cumulative sums
    p_dla_blocks = mp[:, 1 + sub_dla :]
    p_at_least = np.cumsum(p_dla_blocks[:, ::-1], axis=1)[:, ::-1]

    scores, labels = [], []
    for k in range(min(max_k, p_at_least.shape[1])):
        scores.append(p_at_least[:, k] / np.maximum(p_no, 1e-300))
        labels.append(counts > k)
    scores = np.concatenate(scores)
    labels = np.concatenate(labels)

    order = np.argsort(-scores, kind="stable")
    s_sorted = scores[order]
    labels = labels[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(~labels)
    # collapse tied scores to one ROC point (see catalog_tools.
    # roc_curve) — posterior saturation makes exact ties common here
    last = np.nonzero(np.append(np.diff(s_sorted) != 0, True))[0]
    tp, fp = tp[last], fp[last]
    tpr = tp / max(tp[-1], 1)
    fpr = fp / max(fp[-1], 1)
    auc = float(_trapezoid(tpr, fpr))
    return fpr, tpr, auc


def do_multi_ROC(
    model_posteriors, truth_counts, subdir: str, sub_dla: int = 1,
    max_k: int = 4, label: str = "parks",
):
    """Multi-DLA ROC figure (reference: make_multi_dla_plots.py:371-389)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    fpr, tpr, auc = multi_roc(model_posteriors, truth_counts, sub_dla, max_k)
    plt.plot(fpr, tpr, label=f"multi-DLA vs {label} (AUC={auc:.3f})")
    plt.plot([0, 1], [0, 1], ls=":", color="k", lw=0.5)
    plt.xlabel("false positive rate")
    plt.ylabel("true positive rate")
    plt.legend(loc=0)
    save_figure(path.join(subdir, f"multi_roc_{label}"))
    plt.clf()
    return fpr, tpr, auc


def do_confusion(
    result: ComparisonResult, subdir: str, label: str = "parks",
    normalize: bool = True,
):
    """Multi-DLA confusion-matrix figure
    (reference: make_multi_dla_plots.py:321-345 do_confusion_parks)."""
    from ..plotting import plot_confusion

    os.makedirs(subdir, exist_ok=True)
    ax = plot_confusion(result.confusion, normalize=normalize)
    save_figure(path.join(subdir, f"confusion_{label}"), fig=ax.figure)


# ---------------------------------------------------------------------------
# external-catalog population overlays
# ---------------------------------------------------------------------------
def do_external_CDDF(
    cat, est: ExternalEstimations, subdir: str, label: str = "parks",
    snr_thresh: float = -2.0, p_thresh: float = 0.98, zmax: float = 5.0,
    apply_p_dlas: bool = False,
):
    """GP CDDF with the external catalog's point-estimate CDDF overlaid
    (reference: make_multi_dla_plots.py:391-430 do_NoterdaemeDR12_CDDF,
    :447-494 do_Parks_CDDF)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    _plot_cddf(cat, zmax=zmax)
    l_cent, cddf, xerrs = column_density_function_external(
        est, z_max=zmax, snr_thresh=snr_thresh, apply_p_dlas=apply_p_dlas
    )
    ii = cddf > 0
    plt.errorbar(
        10.0 ** l_cent[ii], cddf[ii], xerr=(xerrs[0][ii], xerrs[1][ii]),
        fmt="s", label=label, alpha=0.8,
    )
    np.savetxt(path.join(subdir, f"cddf_{label}.txt"), (l_cent, cddf))
    plt.xlim(1e20, 1e23)
    plt.legend(loc=0)
    save_figure(path.join(subdir, f"cddf_gp_{label}"))
    plt.clf()
    return l_cent, cddf


def do_external_dNdX(
    cat, est: ExternalEstimations, subdir: str, label: str = "parks",
    snr_thresh: float = -2.0, zmax: float = 5.0, apply_p_dlas: bool = False,
):
    """GP dN/dX with the external catalog's overlaid
    (reference: make_multi_dla_plots.py:431-446, 495-513)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    _plot_line_density(cat, zmax=zmax)
    z_cent, dNdX, xerrs = line_density_external(
        est, z_max=zmax, snr_thresh=snr_thresh, apply_p_dlas=apply_p_dlas
    )
    plt.errorbar(z_cent, dNdX, xerr=xerrs, fmt="s", label=label, alpha=0.8)
    np.savetxt(path.join(subdir, f"dndx_{label}.txt"), (z_cent, dNdX))
    plt.legend(loc=0)
    save_figure(path.join(subdir, f"dndx_gp_{label}"))
    plt.clf()
    return z_cent, dNdX


def do_external_snr_check(
    est: ExternalEstimations, subdir: str, label: str = "parks",
    zmax: float = 5.0,
):
    """External-catalog CDDF and dN/dX at several SNR cuts — external
    curves only, like the reference's figure
    (reference: make_multi_dla_plots.py:514-583)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    for snr, lbl in [(-2.0, "all"), (2.0, "SNR > 2"), (4.0, "SNR > 4")]:
        l_cent, cddf, xerrs = column_density_function_external(
            est, z_max=zmax, snr_thresh=snr
        )
        ii = cddf > 0
        plt.errorbar(
            10.0 ** l_cent[ii], cddf[ii],
            xerr=(xerrs[0][ii], xerrs[1][ii]), fmt="s",
            label=f"{label} {lbl}", alpha=0.8,
        )
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel(r"$N_\mathrm{HI}$ (cm$^{-2}$)")
    plt.ylabel(r"$f(N_\mathrm{HI})$")
    plt.legend(loc=0)
    save_figure(path.join(subdir, f"cddf_{label}_snr"))
    plt.clf()

    for snr, lbl in [(-2.0, "all"), (2.0, "SNR > 2"), (4.0, "SNR > 4")]:
        z_cent, dNdX, xerrs = line_density_external(
            est, z_max=zmax, snr_thresh=snr
        )
        plt.errorbar(
            z_cent, dNdX, xerr=xerrs, fmt="s",
            label=f"{label} {lbl}", alpha=0.8,
        )
    plt.xlabel("z")
    plt.ylabel("dN/dX")
    plt.legend(loc=0)
    save_figure(path.join(subdir, f"dndx_{label}_snr"))
    plt.clf()


# ---------------------------------------------------------------------------
# learned-model procedure figures
# ---------------------------------------------------------------------------
def do_procedure_plots(learned_a, learned_b, subdir: str,
                       labels=("re-trained", "original")):
    """Compare two learned models' omega curves and show the
    correlation structure of the first
    (reference: make_multi_dla_plots.py:87-150)."""
    from ..plotting import build_correlation_matrix, to_host

    plt = _plt()
    os.makedirs(subdir, exist_ok=True)

    plt.figure(figsize=(16, 5))
    plt.plot(
        to_host(learned_a.rest_wavelengths),
        np.exp(to_host(learned_a.log_omega)),
        label=rf"{labels[0]} $\omega$",
    )
    plt.plot(
        to_host(learned_b.rest_wavelengths),
        np.exp(to_host(learned_b.log_omega)),
        label=rf"{labels[1]} $\omega$",
        color="lightblue",
    )
    plt.legend()
    plt.xlabel(r"rest-wavelength $\lambda_\mathrm{rest}$ [$\AA$]")
    plt.ylabel("normalized flux")
    save_figure(path.join(subdir, "mu_omega_changes"))
    plt.clf()

    C = build_correlation_matrix(learned_a.M)
    plt.figure(figsize=(6, 6))
    plt.imshow(C, origin="lower")
    plt.colorbar()
    save_figure(path.join(subdir, "covariance_matrix"))
    plt.clf()


def do_meanflux_samples(learned, wavelengths, flux, z_qso, subdir: str,
                        tag: str = "0"):
    """Mean-flux suppression demo for one spectrum
    (reference: make_multi_dla_plots.py:152-169 do_meanflux_samples)."""
    from ..plotting import plot_mean_flux, to_host

    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    plot_mean_flux(learned, wavelengths, flux, z_qso, ax=plt.gca())
    plt.plot(
        to_host(learned.rest_wavelengths), to_host(learned.mu),
        label=r"$\mu$, before suppression", color="red", ls=":",
    )
    plt.ylim(-1, 8)
    plt.legend()
    save_figure(path.join(subdir, f"meanflux_{tag}"))
    plt.clf()


def do_lyman_series_suppression(
    learned, wavelengths, flux, z_qso, subdir: str, tag: str = "0"
):
    """Full 31-line Lyman-series suppression vs Lya-only for one
    spectrum (reference: make_multi_dla_plots.py:182-208)."""
    from ..plotting import plot_mean_flux

    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    rest_wl, mu_31 = plot_mean_flux(
        learned, wavelengths, flux, z_qso, num_lines=31
    )
    plt.clf()
    rest_wl, mu_1 = plot_mean_flux(
        learned, wavelengths, flux, z_qso, num_lines=1
    )
    plt.clf()

    plt.figure(figsize=(16, 5))
    plt.plot(
        np.asarray(wavelengths) / (1.0 + z_qso), np.asarray(flux),
        label=f"z_qso = {z_qso:.3g}", lw=0.5,
    )
    plt.plot(rest_wl, mu_31, label="num_lines = 31", color="red")
    plt.plot(rest_wl, mu_1, label="num_lines =  1", color="red", ls=":")
    plt.legend()
    save_figure(path.join(subdir, f"test_num_lines_{tag}"))
    plt.clf()
    return mu_31, mu_1


def do_this_mu_examples(
    models, params, map_z_dlas, map_log_nhis, subdir: str,
    truth_dlas=None,
):
    """Annotated-spectrum example figures, one per model
    (reference: make_multi_dla_plots.py:171-180 do_this_mu_examples,
    qso_loader.py:1654-1823 plot_this_mu)."""
    from ..plotting import plot_annotated_spectrum

    os.makedirs(subdir, exist_ok=True)
    for i, model in enumerate(models):
        ax = plot_annotated_spectrum(
            model,
            params,
            map_z_dlas=map_z_dlas[i],
            map_log_nhis=map_log_nhis[i],
            truth_dlas=(
                truth_dlas if truth_dlas is not None else [None] * len(models)
            )[i],
        )
        save_figure(path.join(subdir, f"this_mu_{i}"), fig=ax.figure)


def do_Lya_demo(
    observations, z_qsos, subdir: str,
    normalization_min_lambda: float = 1310.0,
    normalization_max_lambda: float = 1325.0,
    zmin: float = 2.0, zmax: float = 6.0, nbins: int = 9,
    num_spec_bin: int = 1, dlambda: float = 2.5, seed: int = 1,
):
    """Lyman-alpha forest evolution demo: one representative spectrum
    per quasar-redshift bin, normalized redward of Lya and smoothed,
    overplotted in the rest frame
    (reference: make_multi_dla_plots.py:584-655 do_Lya_demo — there the
    spectra are downloaded on demand; here the caller supplies
    ``observations`` as (wavelengths, flux, noise_variance, pixel_mask)
    tuples aligned with ``z_qsos``).
    """
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    z_qsos = np.asarray(z_qsos)
    zbins = np.linspace(zmin, zmax, num=nbins + 1)
    rng = np.random.RandomState(seed)
    cmap = plt.get_cmap("viridis")

    plt.figure(figsize=(16, 5))
    plotted = 0
    for i, (z1, z2) in enumerate(zip(zbins[:-1], zbins[1:])):
        nspecs = np.where((z_qsos > z1) & (z_qsos < z2))[0]
        if nspecs.size == 0:
            continue
        zcent = 0.5 * (z1 + z2)
        for nspec in rng.choice(nspecs, size=min(num_spec_bin, nspecs.size),
                                replace=False):
            wl, flux, nv, pm = observations[nspec]
            rest = np.asarray(wl) / (1.0 + z_qsos[nspec])
            flux = np.asarray(flux, np.float64)
            inds = (
                (rest >= normalization_min_lambda)
                & (rest <= normalization_max_lambda)
                & ~np.asarray(pm, bool)
            )
            med = np.nanmedian(flux[inds]) if inds.any() else np.nan
            if not np.isfinite(med) or med == 0:
                continue
            flux = flux / med
            grid = np.arange(rest.min(), rest.max(), step=dlambda)
            smoothed = np.interp(grid, rest, flux)
            plt.plot(
                grid, smoothed, color=cmap((i + 1) / nbins), lw=1.5,
                label=f"zcent={zcent:.3g}", alpha=0.8,
            )
            plotted += 1
    plt.xlabel(r"rest wavelength $\lambda_\mathrm{rest}$ [$\AA$]")
    plt.ylabel("normalized flux")
    plt.ylim(-1, 8)
    if plotted:
        plt.legend()
    save_figure(path.join(subdir, "Lya_forest_demo"))
    plt.clf()
    return plotted


def check_skylines(
    observations, map_z_dlas,
    min_flux_thresh: float = 8.0, min_z_separation: float = 0.01,
):
    """Flag MAP DLA detections that coincide with skyline-like flux
    glitches: pixels with a negative spike whose implied Lya absorber
    redshift lands within ``min_z_separation`` of a MAP z_dla
    (reference: make_multi_dla_plots.py:657-691 check_skylines).

    :param observations: list of (wavelengths, flux, ...) per spectrum.
    :param map_z_dlas: (Q, ...) MAP absorber redshifts (NaN padded).
    :return: list of (spectrum index, z_dla) suspicious detections.
    """
    lya = 1215.6701
    suspects = []
    map_z_dlas = np.asarray(map_z_dlas)
    for nspec, obs in enumerate(observations):
        wl = np.asarray(obs[0], np.float64)
        flux = np.asarray(obs[1], np.float64)
        jump = np.abs(flux[:-1] - flux[1:]) > min_flux_thresh
        neg = flux[:-1] < -min_flux_thresh
        glitch = jump & neg
        if not glitch.any():
            continue
        z_glitch = wl[:-1][glitch] / lya - 1.0
        z_dlas = map_z_dlas[nspec].ravel()
        for z_dla in z_dlas[np.isfinite(z_dlas)]:
            if np.any(np.abs(z_glitch - z_dla) < min_z_separation):
                suspects.append((nspec, float(z_dla)))
    return suspects
