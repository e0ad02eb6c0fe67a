"""Paper-figure drivers: one function per figure family of the DLA
population papers (reference: CDDF_analysis/make_plots.py:12-246).

Each ``do_*`` function mirrors its reference namesake: it renders the
figure(s) into ``subdir`` (PDF) and writes the plotted data as plain
``np.savetxt`` tables next to them, exactly like the reference does, so
the LaTeX table emitters (analysis/tables.py) can consume them.

The catalog argument is a :class:`~.cddf.ProcessedCatalog`; state
knobs (snr_thresh, lowzcut, condition, p_thresh_*, noise_thresh,
max_k) are toggled and restored around each figure like the reference
drivers do.

The port's copy of ``gpy_dla_detection_tpu/analysis/paper_plots.py``:
its data files are byte for byte the reference's, which
``analysis.tables`` reads.
"""

from __future__ import annotations

import os
from os import path

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure(fname: str, fig=None):
    """Save ``fig`` (or the current pyplot figure) as <fname>.pdf
    (reference: make_plots.py uses save_figure from its helper module).

    The explicit ``fig`` form is for the unmanaged figures the
    ``plotting`` helpers create when no axes are passed in — those never
    become pyplot's current figure."""
    os.makedirs(path.dirname(fname) or ".", exist_ok=True)
    if fig is not None:
        fig.savefig(fname + ".pdf")
    else:
        _plt().savefig(fname + ".pdf")


def _plot_cddf(cat, zmin=1.0, zmax=6.0, label="GP", moment=False, twosigma=True):
    """Accumulate a CDDF curve on the current axes
    (reference: calc_cddf.py:684-707 plot_cddf)."""
    plt = _plt()
    l_cent, cddf, cddf68, cddf95, xerrs = cat.column_density_function(
        z_min=zmin, z_max=zmax
    )
    cddf, cddf68, cddf95 = cddf.copy(), cddf68.copy(), cddf95.copy()
    if moment:
        m = 10.0**l_cent
        cddf *= m
        cddf68 *= m[:, None]
        cddf95 *= m[:, None]
    if twosigma:
        plt.fill_between(
            10.0**l_cent, cddf95[:, 0], cddf95[:, 1], color="grey", alpha=0.5
        )
    yerr = (cddf - cddf68[:, 0], cddf68[:, 1] - cddf)
    ii = cddf68[:, 0] > 0
    if ii.any():
        plt.errorbar(
            10.0 ** l_cent[ii],
            cddf[ii],
            yerr=(yerr[0][ii], yerr[1][ii]),
            xerr=(xerrs[0][ii], xerrs[1][ii]),
            fmt="o",
            label=label,
        )
    i2 = ~ii
    if i2.any():  # upper limits where the 68% interval touches zero
        plt.errorbar(
            10.0 ** l_cent[i2],
            cddf95[i2, 1],
            yerr=0.3 * cddf95[i2, 1],
            uplims=True,
            fmt="none",
        )
    plt.xscale("log")
    plt.yscale("log")
    plt.xlabel(r"$N_\mathrm{HI}$ (cm$^{-2}$)")
    plt.ylabel(r"$f(N_\mathrm{HI})$")
    return l_cent, cddf, cddf68, cddf95


def _plot_line_density(cat, zmin=2.0, zmax=4.0, label="GP", twosigma=True):
    """Accumulate a dN/dX curve (reference: calc_cddf.py:727-738)."""
    plt = _plt()
    z_cent, dNdX, dndx68, dndx95, xerrs = cat.line_density(z_min=zmin, z_max=zmax)
    if twosigma:
        plt.fill_between(z_cent, dndx95[:, 0], dndx95[:, 1], color="grey", alpha=0.5)
    plt.errorbar(
        z_cent,
        dNdX,
        yerr=(dNdX - dndx68[:, 0], dndx68[:, 1] - dNdX),
        xerr=xerrs,
        fmt="o",
        label=label,
    )
    plt.xlabel("z")
    plt.ylabel("dN/dX")
    return z_cent, dNdX, dndx68, dndx95


def _plot_omega_dla(cat, zmin=2.0, zmax=4.0, label="GP", twosigma=True):
    """Accumulate an Omega_DLA curve with full Bayesian errors
    (reference: calc_cddf.py:940-952 plot_omega_dla)."""
    plt = _plt()
    z_cent, omega, omega68, omega95, xerrs = cat.omega_dla_cddf(
        z_min=zmin, z_max=zmax
    )
    if z_cent.size == 0:  # no searchable path under the current filters
        return z_cent, omega, omega68, omega95
    if twosigma:
        plt.fill_between(
            z_cent, 1000 * omega95[:, 0], 1000 * omega95[:, 1],
            color="grey", alpha=0.5,
        )
    om = 1000 * omega
    plt.errorbar(
        z_cent,
        om,
        yerr=(om - 1000 * omega68[:, 0], 1000 * omega68[:, 1] - om),
        xerr=xerrs,
        fmt="s",
        label=label,
    )
    plt.xlabel("z")
    plt.ylabel(r"$10^3 \times \Omega_\mathrm{DLA}$")
    return z_cent, om, omega68, omega95


def _plot_omega_dla_var(cat, zmin=2.0, zmax=4.0, label="GP"):
    """Omega_DLA with variance-approximation errors
    (reference: calc_cddf.py:925-938 plot_omega_dla_var)."""
    plt = _plt()
    z_cent, omega, omega_err = cat.omega_dla(z_min=zmin, z_max=zmax)
    if z_cent.size == 0:
        return
    plt.errorbar(
        z_cent, 1000 * omega, yerr=1000 * omega_err, fmt="s", label=label
    )
    plt.xlabel("z")
    plt.ylabel(r"$10^3 \times \Omega_\mathrm{DLA}$")


def do_data_plots(cat, subdir):
    """The headline CDDF / dN/dX / Omega_DLA figures plus their data
    tables (reference: make_plots.py:12-67)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)

    l_N, cddf, cddf68, cddf95 = _plot_cddf(cat, zmax=5)
    np.savetxt(
        path.join(subdir, "cddf_all.txt"),
        (l_N, cddf, cddf68[:, 0], cddf68[:, 1], cddf95[:, 0], cddf95[:, 1]),
    )
    plt.xlim(1e20, 1e23)
    plt.legend(loc=0)
    save_figure(path.join(subdir, "cddf_gp"))
    plt.clf()

    _plot_cddf(cat, zmax=5, moment=True)
    plt.xlim(1e20, 1e23)
    plt.legend(loc=0)
    save_figure(path.join(subdir, "cddf_moment_gp"))
    plt.clf()

    # evolution with redshift (reference: make_plots.py:29-42)
    for (zmin, zmax), tag in [
        ((4.0, 5.0), "z45"),
        ((3.0, 4.0), "z34"),
        ((2.5, 3.0), "z253"),
        ((2.0, 2.5), "z225"),
    ]:
        l_N, cddf, cddf68, cddf95 = _plot_cddf(
            cat, zmin=zmin, zmax=zmax, label=f"{zmin}-{zmax}"
        )
        np.savetxt(
            path.join(subdir, f"cddf_{tag}.txt"),
            (l_N, cddf, cddf68[:, 0], cddf68[:, 1], cddf95[:, 0], cddf95[:, 1]),
        )
    plt.xlim(1e20, 1e23)
    plt.legend(loc=0)
    save_figure(path.join(subdir, "cddf_zz_gp"))
    plt.clf()

    z_cent, dNdX, dndx68, dndx95 = _plot_line_density(cat, zmax=5)
    np.savetxt(
        path.join(subdir, "dndx_all.txt"),
        (z_cent, dNdX, dndx68[:, 0], dndx68[:, 1], dndx95[:, 0], dndx95[:, 1]),
    )
    plt.legend(loc=0)
    save_figure(path.join(subdir, "dndx_gp"))
    plt.clf()

    z_cent, om, om68, om95 = _plot_omega_dla(cat, zmax=5)
    np.savetxt(
        path.join(subdir, "omega_dla_all.txt"),
        (z_cent, om, om68[:, 0], om68[:, 1], om95[:, 0], om95[:, 1]),
    )
    plt.legend(loc=0)
    save_figure(path.join(subdir, "omega_gp"))
    plt.clf()


def do_sample_error_check(cat, subdir, nsample=13, rng=0):
    """Bootstrap-resampling error bands on dN/dX and Omega_DLA
    (reference: make_plots.py:69-81)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    errs = cat.get_sample_errors(z_min=2.0, z_max=5.0, nsample=nsample, rng=rng)

    nb = errs["dndx_sample"].size
    z_cent = np.linspace(2.0, 5.0, nb + 1)
    z_cent = 0.5 * (z_cent[:-1] + z_cent[1:])
    plt.fill_between(
        z_cent, errs["dndx_95"][1], errs["dndx_95"][0], color="grey", alpha=0.5
    )
    plt.fill_between(
        z_cent, errs["dndx_68"][1], errs["dndx_68"][0], color="C0", alpha=0.5
    )
    plt.plot(z_cent, errs["dndx_sample"], label="bootstrap median")
    plt.xlabel("z")
    plt.ylabel("dN/dX")
    plt.legend(loc=0)
    save_figure(path.join(subdir, "dndx_gp_resample"))
    plt.clf()

    plt.fill_between(
        z_cent, errs["omega_95"][1], errs["omega_95"][0], color="grey", alpha=0.5
    )
    plt.fill_between(
        z_cent, errs["omega_68"][1], errs["omega_68"][0], color="C0", alpha=0.5
    )
    plt.plot(z_cent, errs["omega_sample"], label="bootstrap median")
    plt.xlabel("z")
    plt.ylabel(r"$10^3 \times \Omega_\mathrm{DLA}$")
    plt.legend(loc=0)
    save_figure(path.join(subdir, "omega_gp_resample"))
    plt.clf()


def do_check_p_thresh(cat, subdir):
    """Sensitivity of dN/dX to the per-sample / per-spectrum posterior
    thresholds (reference: make_plots.py:83-94)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    old_sample, old_spec = cat.p_thresh_sample, cat.p_thresh_spec
    try:
        cat.p_thresh_sample = 1e-4
        _plot_line_density(cat, zmax=5, label=r"$p_\mathrm{sample} = 10^{-4}$")
        cat.p_thresh_sample = 1e-2
        _plot_line_density(cat, zmax=5, label=r"$p_\mathrm{sample} = 10^{-2}$")
        cat.p_thresh_sample = 1e-4
        cat.p_thresh_spec = 0.1
        _plot_line_density(cat, zmax=5, label=r"$p_\mathrm{spec} = 10^{-1}$")
        plt.legend(loc=0)
        save_figure(path.join(subdir, "dndx_p_thresh"))
        plt.clf()
    finally:
        cat.p_thresh_sample, cat.p_thresh_spec = old_sample, old_spec


def do_pixel_noise_check(cat, subdir):
    """Effect of the noisy-pixel filter threshold
    (reference: make_plots.py:96-118)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    old_thresh, old_flag, old_snr = (
        cat.noise_thresh, cat.filter_noisy_pixels, cat.snr_thresh,
    )
    try:
        cat.snr_thresh = 1.0
        cat.filter_noisy_pixels = cat.pixel_noise is not None
        for nt, lbl in [(0.5, "N < 0.5"), (1.0, "N < 1"), (0.25**2, "N < 0.25")]:
            cat.noise_thresh = nt
            _plot_omega_dla(cat, zmax=5, label=lbl, twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "omega_gp_pix_noise"))
        plt.clf()

        for nt, lbl in [(0.5, "N < 0.5"), (1.0, "N < 1"), (0.25**2, "N < 0.25")]:
            cat.noise_thresh = nt
            _plot_line_density(cat, zmax=5, label=lbl, twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "dndx_gp_pix_noise"))
        plt.clf()
    finally:
        cat.noise_thresh, cat.filter_noisy_pixels, cat.snr_thresh = (
            old_thresh, old_flag, old_snr,
        )


def do_snr_check(cat, subdir):
    """Effect of the spectrum SNR cut (reference: make_plots.py:120-146)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    first = cat.snr_thresh
    try:
        for snr, lbl in [(-2, "All GP"), (2, "SNR > 2"), (4, "SNR > 4")]:
            cat.snr_thresh = snr
            _plot_omega_dla(cat, zmax=5, label=lbl, twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "omega_gp_snr"))
        plt.clf()

        for snr, lbl in [(-2, "All GP"), (2, "SNR > 2"), (4, "SNR > 4")]:
            cat.snr_thresh = snr
            _plot_line_density(cat, zmax=5, label=lbl, twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "dndx_gp_snr"))
        plt.clf()
    finally:
        cat.snr_thresh = first


def do_lowzcut_check(cat, subdir):
    """Effect of cutting the low-z end of each sightline
    (reference: make_plots.py:148-167)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    old = cat.lowzcut
    try:
        for flag, lbl in [(True, "Cutting"), (False, "Not cutting")]:
            cat.lowzcut = flag
            _plot_omega_dla(cat, zmax=5, label=lbl, twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "omega_gp_lowz"))
        plt.clf()

        for flag, lbl in [(True, "Cutting"), (False, "Not cutting")]:
            cat.lowzcut = flag
            _plot_line_density(cat, zmax=5, label=lbl, twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "dndx_gp_lowz"))
        plt.clf()
    finally:
        cat.lowzcut = old


def do_2dla_plots(cat, subdir):
    """Effect of including the second (and higher) DLA per sightline,
    and the variance-mode Omega_DLA errors
    (reference: make_plots.py:170-197)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    old_k = cat.max_k
    try:
        cat.max_k = 1
        _plot_omega_dla(cat, zmax=5, label="Confidence interval", twosigma=False)
        cat.max_k = old_k
        _plot_omega_dla_var(cat, zmax=5, label="Variance")
        plt.legend(loc=0)
        save_figure(path.join(subdir, "omega_gp_diff"))
        plt.clf()

        multi_lbl = f"{old_k}-DLA" if old_k > 1 else "Two-DLA"
        _plot_line_density(cat, zmax=5, label=multi_lbl, twosigma=False)
        cat.max_k = 1
        _plot_line_density(cat, zmax=5, label="One-DLA", twosigma=False)
        cat.max_k = old_k
        plt.legend(loc=0)
        save_figure(path.join(subdir, "dndx_2dla"))
        plt.clf()

        _plot_omega_dla(cat, zmax=5, label=multi_lbl, twosigma=False)
        cat.max_k = 1
        _plot_omega_dla(cat, zmax=5, label="One-DLA", twosigma=False)
        cat.max_k = old_k
        plt.legend(loc=0)
        save_figure(path.join(subdir, "omega_2dla"))
        plt.clf()
    finally:
        cat.max_k = old_k


def do_qso_split(cat, subdir):
    """Population statistics split by quasar redshift via the
    ``condition`` mask (reference: make_plots.py:199-220)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    oldcond = cat.condition
    high_z = (2.5, 3.0, 3.5, 5.0)
    low_z = (2.0, 2.5, 3.0, 3.5)
    try:
        for hi, lo in zip(high_z, low_z):
            cat.condition = (cat._z_max < hi) & (cat._z_max > lo)
            _plot_omega_dla(
                cat,
                label=rf"${hi} > z_\mathrm{{QSO}} > {lo}$",
                twosigma=False,
            )
        plt.legend(loc=0)
        save_figure(path.join(subdir, "omega_gp_zqso" + str(cat.lowzcut)))
        plt.clf()

        for hi, lo in zip(high_z, low_z):
            cat.condition = (cat._z_max < hi) & (cat._z_max > lo)
            _plot_line_density(
                cat,
                label=rf"${hi} > z_\mathrm{{QSO}} > {lo}$",
                twosigma=False,
            )
        plt.legend(loc=0)
        save_figure(path.join(subdir, "dndx_gp_zqso" + str(cat.lowzcut)))
        plt.clf()
    finally:
        cat.condition = oldcond


def do_length_split(cat, subdir):
    """Population statistics split by searchable path length per
    sightline (reference: make_plots.py:222-244)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    oldcond = cat.condition
    high = (0.2, 0.4, 0.6, 0.8, 2.0)
    low = (0.0, 0.2, 0.4, 0.6, 0.8)
    z_diff = cat._z_max - cat._z_min
    try:
        for hi, lo in zip(high, low):
            cat.condition = (z_diff < hi) & (z_diff > lo)
            _plot_omega_dla(cat, label=f"{hi} > dz > {lo}", twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "omega_gp_zdiff"))
        plt.clf()

        for hi, lo in zip(high, low):
            cat.condition = (z_diff < hi) & (z_diff > lo)
            _plot_line_density(cat, label=f"{hi} > dz > {lo}", twosigma=False)
        plt.legend(loc=0)
        save_figure(path.join(subdir, "dndx_gp_zdiff"))
        plt.clf()
    finally:
        cat.condition = oldcond


def do_compare_plots(cat_a, cat_b, subdir, label):
    """Overlay two catalogs' dN/dX, CDDF and Omega_DLA
    (reference: make_plots.py:246-269)."""
    plt = _plt()
    os.makedirs(subdir, exist_ok=True)
    _plot_line_density(cat_a, zmax=5)
    _plot_line_density(cat_b, zmax=5, label=label, twosigma=False)
    plt.legend(loc=0)
    save_figure(path.join(subdir, "dndx_" + label))
    plt.clf()

    _plot_cddf(cat_a, zmax=4)
    _plot_cddf(cat_b, zmax=4, label=label, twosigma=False)
    plt.xlim(1e20, 1e23)
    plt.legend(loc=0)
    save_figure(path.join(subdir, "cddf_" + label))
    plt.clf()

    _plot_omega_dla(cat_a, zmax=5)
    _plot_omega_dla(cat_b, zmax=5, label=label, twosigma=False)
    plt.legend(loc=0)
    save_figure(path.join(subdir, "omega_" + label))
    plt.clf()


def make_all_plots(cat, subdir):
    """Render the full reference figure set for one catalog
    (reference: make_plots.py:271-310 __main__ block)."""
    do_data_plots(cat, subdir)
    old = cat.lowzcut
    for flag in (False, True):
        cat.lowzcut = flag
        do_qso_split(cat, subdir)
    cat.lowzcut = old
    do_lowzcut_check(cat, subdir)
    do_snr_check(cat, subdir)
    do_sample_error_check(cat, subdir, nsample=5)
    do_length_split(cat, subdir)
    do_check_p_thresh(cat, subdir)
    do_2dla_plots(cat, subdir)
    if cat.pixel_noise is not None:
        do_pixel_noise_check(cat, subdir)
