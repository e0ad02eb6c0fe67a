"""Diagnostic and science plots.

Rewrites of the reference's plotting helpers (reference:
gpy_dla_detection/plottings/plot_model.py:12-135,
plot_raw_spectrum.py:14-62, examples/plot_mcmc.py:42-78, and the CDDF
plot wrappers in CDDF_analysis/calc_cddf.py:684-901).

The port of ``gpy_dla_detection_tpu/plotting.py``.  Where a plot draws a
curve through the model, a function of its own computes that curve and
imports no matplotlib: :func:`absorbed_mean` (the MAP-absorbed mean of
``plot_dla_model`` and ``plot_annotated_spectrum``),
:func:`sample_prediction_curves` (``plot_sample_predictions``' posterior
draws) and :func:`mean_flux_curve` (``plot_mean_flux``).  They run on the
model's device in its dtype and return tensors there: on the card in
float32, the absorption through K5 (``ops.voigt.voigt_absorption``), which
raises there rather than fall back; the float64 path is the CPU's.  The
plot functions draw what they return on the host (:func:`to_host`), and
only they import matplotlib.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import LYA_WAVELENGTH_A
from .models.learned import SpectrumModel
from .ops.optical_depth import mean_flux_suppression
from .ops.voigt import voigt_absorption
from .params import Parameters


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """Host values as a tensor on ``ref``'s device in its dtype."""
    return torch.as_tensor(np.asarray(x), dtype=ref.dtype, device=ref.device)


def absorbed_mean(model: SpectrumModel, params: Parameters, z_dlas, log_nhis) -> torch.Tensor:
    """The GP mean times the broadened absorption of every absorber,
    ``mu * prod_j a(z_j, 10^logNHI_j)``, on the model's device in its
    dtype (the absorbers' rows through K5 on the card in float32).

    :param z_dlas, log_nhis: (k,) absorbers, host arrays or tensors;
        with none the mean comes back unabsorbed.
    :return: (N,) tensor.
    """
    z_dlas = np.ravel(to_host(z_dlas))
    log_nhis = np.ravel(to_host(log_nhis))
    if z_dlas.size == 0:
        return model.mu
    absorption = voigt_absorption(
        model.padded_wavelengths,
        _like(10.0**log_nhis, model.mu),
        _like(z_dlas, model.mu),
        params.num_lines,
    )
    return model.mu * torch.prod(absorption, dim=0)


def sample_prediction_curves(
    chain,
    model: SpectrumModel,
    params: Parameters,
    n_draws: int = 200,
    burn_in: int = 0,
    seed: int = 0,
) -> torch.Tensor:
    """The absorbed GP mean at ``n_draws`` posterior draws of an MCMC
    chain (num_steps, W, 2k) of k absorbers' (z, logNHI), the draws taken
    by ``np.random.default_rng(seed)`` as the reference's; one absorption
    call over all draws x absorbers (K5 at ``n_draws * k`` rows on the
    card in float32).

    :return: (n_draws, N) tensor on the model's device.
    """
    rng = np.random.default_rng(seed)
    samples = to_host(chain)[burn_in:]
    samples = samples.reshape(-1, samples.shape[-1])
    k = samples.shape[1] // 2
    idx = rng.integers(0, samples.shape[0], size=n_draws)
    z_flat = samples[idx, :k].reshape(-1)
    nhi_flat = 10.0 ** samples[idx, k:].reshape(-1)
    absorptions = voigt_absorption(
        model.padded_wavelengths,
        _like(nhi_flat, model.mu),
        _like(z_flat, model.mu),
        params.num_lines,
    ).reshape(n_draws, k, -1).prod(dim=1)
    return model.mu * absorptions


def mean_flux_curve(learned, z_qso: float, suppressed: bool = True, num_lines: int = 31):
    """The learned GP mean on its rest grid, optionally times the
    mean-flux suppression ``exp(-tau_0 (1 + z)^beta)`` of ``num_lines``
    Lyman-series lines at the quasar redshift, on the learned model's
    device in its dtype (numpy fields: on the CPU in theirs).

    :return: (rest_wavelengths, mu) tensors.
    """
    as_tensor = lambda x: x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    rest_wl = as_tensor(learned.rest_wavelengths)
    mu = as_tensor(learned.mu).to(rest_wl.dtype)
    if suppressed:
        tau_0 = torch.exp(as_tensor(learned.log_tau_0).to(rest_wl.dtype))
        beta = torch.exp(as_tensor(learned.log_beta).to(rest_wl.dtype))
        mu = mu * mean_flux_suppression(
            rest_wl * (1.0 + z_qso), beta, tau_0, z_qso, num_lines
        )
    return rest_wl, mu


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _subplots(nrows: int = 1, ncols: int = 1, figsize=None, **kw):
    """``plt.subplots`` on an UNMANAGED figure.

    Figures created here never enter pyplot's figure registry, so batch
    callers (surveys, test suites) can render hundreds of plots without
    tripping matplotlib's open-figure cap or leaking memory — the figure
    is garbage-collected when the caller drops it.  ``fig.savefig``
    works as usual; in a notebook, display the returned figure (or
    ``ax.figure``) as the cell value.  Callers that want pyplot
    integration (``plt.show``) pass their own ``ax``.
    """
    from matplotlib.figure import Figure

    fig = Figure(figsize=figsize)
    axs = fig.subplots(nrows, ncols, **kw)
    return fig, axs


def plot_raw_spectrum(wavelengths, flux, z_qso, ax=None):
    """Observed spectrum with a rest-frame secondary axis
    (reference: plottings/plot_raw_spectrum.py:14-62)."""
    if ax is None:
        _, ax = _subplots(figsize=(12, 4))
    ax.plot(wavelengths, flux, lw=0.4, color="C0")
    ax.set_xlabel(r"observed wavelength [$\AA$]")
    ax.set_ylabel(r"flux [$10^{-17}$ erg s$^{-1}$ cm$^{-2}$ $\AA^{-1}$]")
    secax = ax.secondary_xaxis(
        "top",
        functions=(lambda x: x / (1 + z_qso), lambda x: x * (1 + z_qso)),
    )
    secax.set_xlabel(r"rest wavelength [$\AA$]")
    return ax


def plot_dla_model(
    model: SpectrumModel,
    params: Parameters,
    sample_z_dlas=None,
    log_nhi_samples=None,
    sample_log_likelihoods=None,
    map_z_dlas=None,
    map_log_nhis=None,
    nth_dla: int = 1,
    title: str = "",
    label: str = "",
):
    """Two-panel DLA inference plot: sample-likelihood scatter in
    (z_dla, logNHI) and the MAP-absorbed GP mean over the data
    (reference: plottings/plot_model.py:12-135)."""
    fig, (ax1, ax2) = _subplots(2, 1, figsize=(14, 8))

    mask = to_host(model.mask)
    wavelengths = to_host(model.padded_wavelengths)[3:-3]
    y = to_host(model.y)

    if sample_log_likelihoods is not None:
        lls = to_host(sample_log_likelihoods)[:, 0]
        finite = np.isfinite(lls)
        sc = ax1.scatter(
            to_host(sample_z_dlas)[finite],
            to_host(log_nhi_samples)[finite],
            c=lls[finite],
            s=4,
            cmap="viridis",
        )
        fig.colorbar(sc, ax=ax1, label=r"$\log p(D\,|\,z_{DLA}, N_{HI})$")
    ax1.set_xlabel(r"$z_{DLA}$")
    ax1.set_ylabel(r"$\log N_{HI}$")
    ax1.set_title(title)

    ax2.plot(
        wavelengths[mask] / (1 + float(model.z_qso)),
        y[mask],
        lw=0.4,
        color="C0",
        label="observed",
    )
    mu = model.mu
    if map_z_dlas is not None and nth_dla >= 1:
        mu = absorbed_mean(
            model,
            params,
            to_host(map_z_dlas)[nth_dla - 1, :nth_dla],
            to_host(map_log_nhis)[nth_dla - 1, :nth_dla],
        )
    mu = to_host(mu)
    ax2.plot(
        wavelengths[mask] / (1 + float(model.z_qso)),
        mu[mask],
        lw=1.0,
        color="C3",
        label=label or "GP mean",
    )
    ax2.axvline(LYA_WAVELENGTH_A, ls=":", color="k", lw=0.5)
    ax2.set_xlabel(r"rest wavelength [$\AA$]")
    ax2.set_ylabel("normalized flux")
    ax2.legend()
    fig.tight_layout()
    return fig


def plot_corner(chain, labels=None, burn_in: int = 0, bins: int = 40):
    """Corner (pair) plot of an MCMC chain (num_steps, W, D)
    (reference: examples/plot_mcmc.py:42-59; corner-free)."""
    samples = to_host(chain)[burn_in:]
    samples = samples.reshape(-1, samples.shape[-1])
    D = samples.shape[1]
    fig, axes = _subplots(D, D, figsize=(2.2 * D, 2.2 * D))
    axes = np.atleast_2d(axes)
    for i in range(D):
        for j in range(D):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
            elif i == j:
                ax.hist(samples[:, i], bins=bins, histtype="step", color="k")
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=bins, cmap="Greys")
            if i == D - 1 and labels:
                ax.set_xlabel(labels[j])
            if j == 0 and labels and i > 0:
                ax.set_ylabel(labels[i])
    fig.tight_layout()
    return fig


def plot_sample_predictions(
    chain,
    model: SpectrumModel,
    params: Parameters,
    n_draws: int = 200,
    burn_in: int = 0,
    seed: int = 0,
):
    """Posterior draws of the absorbed GP mean over the data
    (reference: examples/plot_mcmc.py:60-78); the draws' curves come from
    :func:`sample_prediction_curves`."""
    mask = to_host(model.mask)
    rest = (to_host(model.padded_wavelengths)[3:-3] / (1 + float(model.z_qso)))[mask]
    fig, ax = _subplots(figsize=(14, 5))
    ax.plot(rest, to_host(model.y)[mask], lw=0.4, color="C0", label="observed")
    curves = to_host(
        sample_prediction_curves(chain, model, params, n_draws, burn_in, seed)
    )
    for curve in curves:
        ax.plot(
            rest,
            curve[mask],
            lw=0.1,
            color="C3",
            alpha=0.05,
        )
    ax.set_xlabel(r"rest wavelength [$\AA$]")
    ax.set_ylabel("normalized flux")
    fig.tight_layout()
    return fig


def plot_cddf(l_cent, cddf, cddf68, cddf95, xerrs, label="GP", ax=None):
    """CDDF with 68/95% intervals (reference: calc_cddf.py:684-707)."""
    if ax is None:
        _, ax = _subplots()
    ax.fill_between(10.0**l_cent, cddf95[:, 0], cddf95[:, 1], color="grey", alpha=0.5)
    yerr = (cddf - cddf68[:, 0], cddf68[:, 1] - cddf)
    ii = cddf68[:, 0] > 0
    ax.errorbar(
        10.0 ** l_cent[ii],
        cddf[ii],
        yerr=(yerr[0][ii], yerr[1][ii]),
        xerr=(xerrs[0][ii], xerrs[1][ii]),
        fmt="o",
        label=label,
    )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(r"$N_\mathrm{HI}$ (cm$^{-2}$)")
    ax.set_ylabel(r"$f(N_\mathrm{HI})$")
    return ax


def plot_line_density(z_cent, dNdX, dndx68, dndx95, xerrs, label="GP", ax=None):
    """dN/dX(z) (reference: calc_cddf.py:727-738)."""
    if ax is None:
        _, ax = _subplots()
    ax.fill_between(z_cent, dndx95[:, 0], dndx95[:, 1], color="grey", alpha=0.5)
    ax.errorbar(
        z_cent,
        dNdX,
        yerr=(dNdX - dndx68[:, 0], dndx68[:, 1] - dNdX),
        xerr=xerrs,
        fmt="o",
        label=label,
    )
    ax.set_xlabel("z")
    ax.set_ylabel("dN/dX")
    return ax


def plot_omega_dla(z_cent, omega, omega_err, label="GP", ax=None):
    """Omega_DLA(z) (reference: calc_cddf.py:882-901)."""
    if ax is None:
        _, ax = _subplots()
    ax.errorbar(z_cent, 1000 * omega, yerr=1000 * omega_err, fmt="o", label=label)
    ax.set_xlabel("z")
    ax.set_ylabel(r"$10^3 \times \Omega_\mathrm{DLA}$")
    return ax


# ---------------------------------------------------------------------------
# comparison figures (reference: qso_loader.py:618-968,
# make_multi_dla_plots.py, make_plots.py)
# ---------------------------------------------------------------------------
def plot_roc(fpr, tpr, auc=None, label="GP", ax=None):
    """ROC curve of the p_dla classifier against a truth catalog
    (reference: qso_loader.py:618-718 make_ROC)."""
    if ax is None:
        _, ax = _subplots()
    lbl = f"{label} (AUC={auc:.3f})" if auc is not None else label
    ax.plot(fpr, tpr, label=lbl)
    ax.plot([0, 1], [0, 1], ls=":", color="k", lw=0.5)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.legend()
    return ax


def plot_confusion(confusion, ax=None, normalize=False):
    """Multi-DLA confusion matrix heatmap with annotated counts
    (reference: qso_loader.py:878-968 make_multi_confusion)."""
    if ax is None:
        _, ax = _subplots()
    conf = np.asarray(confusion, np.float64)
    shown = conf / conf.sum(axis=1, keepdims=True).clip(min=1) if normalize else conf
    im = ax.imshow(shown, cmap="Blues")
    ax.figure.colorbar(im, ax=ax)
    for i in range(conf.shape[0]):
        for j in range(conf.shape[1]):
            val = f"{shown[i, j]:.2f}" if normalize else f"{int(conf[i, j])}"
            ax.text(j, i, val, ha="center", va="center", fontsize=8)
    ax.set_xlabel("MAP number of DLAs")
    ax.set_ylabel("true number of DLAs")
    return ax


def plot_annotated_spectrum(
    model: SpectrumModel,
    params: Parameters,
    map_z_dlas=None,
    map_log_nhis=None,
    truth_dlas: dict | None = None,
    label: str = "GP MAP model",
    ax=None,
):
    """Spectrum with the absorbed GP mean and per-catalog absorber tick
    marks — the reference's plot_this_mu overlay
    (reference: qso_loader.py:1654-1823).

    :param map_z_dlas, map_log_nhis: (k,) MAP absorbers applied to the
        mean.
    :param truth_dlas: {catalog name: [(z_dla, log_nhi), ...]} — each
        catalog's absorbers are marked with labelled vertical lines.
    """
    if ax is None:
        _, ax = _subplots(figsize=(14, 5))
    mask = to_host(model.mask)
    z_qso = float(model.z_qso)
    wavelengths = to_host(model.padded_wavelengths)[3:-3]
    rest = (wavelengths / (1 + z_qso))[mask]
    y = to_host(model.y)

    ax.plot(rest, y[mask], lw=0.4, color="C0", label="observed")

    mu = model.mu
    if map_z_dlas is not None and np.size(to_host(map_z_dlas)):
        z_dlas = np.ravel(to_host(map_z_dlas))
        log_nhis = np.ravel(to_host(map_log_nhis))
        finite = np.isfinite(z_dlas)
        mu = absorbed_mean(model, params, z_dlas[finite], log_nhis[finite])
    ax.plot(rest, to_host(mu)[mask], lw=1.0, color="C3", label=label)

    # absorber tick marks: rest-frame Lya position of each absorber
    colors = ["C2", "C4", "C5", "C6"]
    ymax = float(np.nanmax(y[mask]))
    for c, (name, absorbers) in enumerate(
        (truth_dlas or {}).items()
    ):
        for j, (z_dla, log_nhi) in enumerate(absorbers):
            x = LYA_WAVELENGTH_A * (1 + z_dla) / (1 + z_qso)
            ax.axvline(x, ls="--", color=colors[c % len(colors)], lw=0.8)
            ax.text(
                x,
                ymax * (0.95 - 0.08 * c),
                f"{name}: logNHI={log_nhi:.2f}" if j == 0 else f"{log_nhi:.2f}",
                color=colors[c % len(colors)],
                fontsize=7,
                rotation=90,
                va="top",
            )
    ax.axvline(LYA_WAVELENGTH_A, ls=":", color="k", lw=0.5)
    ax.set_xlabel(r"rest wavelength [$\AA$]")
    ax.set_ylabel("normalized flux")
    ax.legend(loc="upper right")
    return ax


def plot_mean_flux(
    learned,
    wavelengths,
    flux,
    z_qso,
    suppressed: bool = True,
    num_lines: int = 31,
    ax=None,
):
    """Observed flux with the (optionally mean-flux-suppressed) learned
    GP mean on the rest grid (reference: qso_loader.py:1629-1652
    plot_mean_flux).

    :return: (rest_wavelengths, mu) — the plotted mean curve
        (:func:`mean_flux_curve`), on the host.
    """
    if ax is None:
        _, ax = _subplots(figsize=(14, 5))
    rest_wl, mu = (to_host(x) for x in mean_flux_curve(learned, z_qso, suppressed, num_lines))
    ax.plot(
        to_host(wavelengths) / (1.0 + z_qso),
        to_host(flux),
        label="observed flux",
        color="C0",
        lw=0.5,
    )
    ax.plot(
        rest_wl, mu,
        label=r"mean-flux $\mu \circ \exp(-\tau(1+z)^\beta)$", color="red",
    )
    ax.set_xlabel(r"rest wavelength [$\AA$]")
    ax.set_ylabel("normalized flux")
    ax.legend()
    return rest_wl, mu


def plot_cddf_external(l_cent, cddf, xerrs, label="Parks", ax=None, moment=False):
    """Point-estimate CDDF of an external catalog, for overplotting
    against the GP CDDF (reference: qso_loader.py:1192-1282)."""
    if ax is None:
        _, ax = _subplots()
    y = cddf * 10.0**l_cent if moment else cddf
    ii = y > 0
    ax.errorbar(
        10.0 ** l_cent[ii], y[ii], xerr=(xerrs[0][ii], xerrs[1][ii]), fmt="s",
        label=label, alpha=0.8,
    )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(r"$N_\mathrm{HI}$ (cm$^{-2}$)")
    ax.set_ylabel(r"$f(N_\mathrm{HI})$")
    return ax


def plot_line_density_external(z_cent, dNdX, xerrs, label="Parks", ax=None):
    """Point-estimate dN/dX of an external catalog
    (reference: qso_loader.py:1283-1356)."""
    if ax is None:
        _, ax = _subplots()
    ax.errorbar(z_cent, dNdX, xerr=xerrs, fmt="s", label=label, alpha=0.8)
    ax.set_xlabel("z")
    ax.set_ylabel("dN/dX")
    return ax


def build_correlation_matrix(M):
    """Correlation matrix of the learned low-rank covariance K = M M^T
    (reference: qso_loader.py:50-73 GPLoader.build_correlation_matrix)."""
    M = to_host(M)
    d = np.sqrt(np.sum(M * M, axis=1, keepdims=True))
    M_div_d = M / np.where(d > 0, d, 1.0)
    return M_div_d @ M_div_d.T


def plot_model_correlation(rest_wavelengths, M, ax=None):
    """Heatmap of the learned GP's pixel-pixel correlation structure
    (reference: qso_loader.py:32-73 GPLoader + its plotting use)."""
    if ax is None:
        _, ax = _subplots(figsize=(7, 6))
    rest_wavelengths = to_host(rest_wavelengths)
    C = build_correlation_matrix(M)
    extent = [
        rest_wavelengths[0],
        rest_wavelengths[-1],
        rest_wavelengths[-1],
        rest_wavelengths[0],
    ]
    im = ax.imshow(C, cmap="RdBu_r", vmin=-1, vmax=1, extent=extent)
    ax.figure.colorbar(im, ax=ax, label="correlation")
    ax.set_xlabel(r"rest wavelength [$\AA$]")
    ax.set_ylabel(r"rest wavelength [$\AA$]")
    return ax


# ---------------------------------------------------------------------------
# split / bootstrap figures (reference: make_plots.py:1-310,
# make_multi_dla_plots.py, calc_cddf.py:345-378)
# ---------------------------------------------------------------------------
def plot_cddf_by_z(catalog, z_edges=(2.0, 2.5, 3.0, 4.0, 5.0), ax=None, **kw):
    """CDDF in redshift slices (reference: make_plots.py per-z panels)."""
    if ax is None:
        _, ax = _subplots()
    for z_lo, z_hi in zip(z_edges[:-1], z_edges[1:]):
        l_cent, cddf, cddf68, cddf95, xerrs = catalog.column_density_function(
            z_min=z_lo, z_max=z_hi, **kw
        )
        ii = cddf > 0
        ax.errorbar(
            10.0 ** l_cent[ii],
            cddf[ii],
            yerr=(
                (cddf - cddf68[:, 0])[ii],
                np.maximum(cddf68[:, 1] - cddf, 0)[ii],
            ),
            fmt="o",
            ms=3,
            label=f"{z_lo} < z < {z_hi}",
        )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(r"$N_\mathrm{HI}$ (cm$^{-2}$)")
    ax.set_ylabel(r"$f(N_\mathrm{HI})$")
    ax.legend()
    return ax


def plot_cddf_by_snr(catalog, snr_threshs=(-2.0, 2.0, 4.0), ax=None, **kw):
    """CDDF under successive SNR cuts
    (reference: make_plots.py snr-split panels)."""
    if ax is None:
        _, ax = _subplots()
    prev = catalog.snr_thresh
    try:
        for thresh in snr_threshs:
            catalog.snr_thresh = thresh
            l_cent, cddf, _, _, _ = catalog.column_density_function(**kw)
            ii = cddf > 0
            ax.errorbar(
                10.0 ** l_cent[ii], cddf[ii], fmt="o-", ms=3, lw=0.5,
                label=f"SNR > {thresh}",
            )
    finally:
        catalog.snr_thresh = prev
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(r"$N_\mathrm{HI}$ (cm$^{-2}$)")
    ax.set_ylabel(r"$f(N_\mathrm{HI})$")
    ax.legend()
    return ax


def plot_dndx_sample_errors(catalog, z_min=2.0, z_max=5.0, nsample=5, rng=0, ax=None):
    """dN/dX with bootstrap-resampled error bands
    (reference: calc_cddf.py:345-360)."""
    if ax is None:
        _, ax = _subplots()
    errs = catalog.get_sample_errors(z_min=z_min, z_max=z_max, nsample=nsample, rng=rng)
    z_cent, dNdX, dndx68, _, xerrs = catalog.line_density(z_min=z_min, z_max=z_max)
    ax.errorbar(
        z_cent, dNdX, yerr=(dNdX - dndx68[:, 0], dndx68[:, 1] - dNdX),
        xerr=xerrs, fmt="o", label="Total",
    )
    med = errs["dndx_sample"]
    ax.errorbar(
        z_cent,
        med,
        yerr=(
            np.maximum(med - errs["dndx_68"][1], 0),
            np.maximum(errs["dndx_68"][0] - med, 0),
        ),
        xerr=xerrs,
        fmt="s",
        label="Resampled",
    )
    ax.set_xlabel("z")
    ax.set_ylabel("dN/dX")
    ax.legend()
    return ax


def plot_omega_sample_errors(catalog, z_min=2.0, z_max=5.0, nsample=5, rng=0, ax=None):
    """Omega_DLA with bootstrap-resampled error bands
    (reference: calc_cddf.py:361-378)."""
    if ax is None:
        _, ax = _subplots()
    errs = catalog.get_sample_errors(z_min=z_min, z_max=z_max, nsample=nsample, rng=rng)
    z_cent, omega, omega68, _, xerrs = catalog.omega_dla_cddf(z_min=z_min, z_max=z_max)
    ax.errorbar(
        z_cent,
        1000 * omega,
        yerr=(1000 * (omega - omega68[:, 0]), 1000 * (omega68[:, 1] - omega)),
        xerr=xerrs,
        fmt="o",
        label="Total",
    )
    med = errs["omega_sample"]
    ax.errorbar(
        z_cent,
        med,
        yerr=(
            np.maximum(med - errs["omega_68"][1], 0),
            np.maximum(errs["omega_68"][0] - med, 0),
        ),
        xerr=xerrs,
        fmt="s",
        label="Resampled",
    )
    ax.set_xlabel("z")
    ax.set_ylabel(r"$10^3 \times \Omega_\mathrm{DLA}$")
    ax.legend()
    return ax
