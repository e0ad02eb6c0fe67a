"""LaTeX table emitters for the survey statistics.

Rebuild of the reference's table generators
(reference: CDDF_analysis/make_tables.py:1-119).

The port's copy of ``gpy_dla_detection_tpu/analysis/tables.py``.
"""

from __future__ import annotations

import numpy as np


def cddf_table(l_cent, cddf, cddf68, cddf95) -> str:
    """CDDF results as a LaTeX tabular."""
    lines = [
        r"\begin{tabular}{ccccc}",
        r"$\log N_\mathrm{HI}$ & $f(N)$ & 68\% & 95\% \\",
        r"\hline",
    ]
    for i in range(len(l_cent)):
        lines.append(
            f"{l_cent[i]:.2f} & {cddf[i]:.3e} & "
            f"[{cddf68[i, 0]:.3e}, {cddf68[i, 1]:.3e}] & "
            f"[{cddf95[i, 0]:.3e}, {cddf95[i, 1]:.3e}] \\\\"
        )
    lines.append(r"\end{tabular}")
    return "\n".join(lines)


def line_density_table(z_cent, dndx, dndx68, dndx95) -> str:
    lines = [
        r"\begin{tabular}{cccc}",
        r"$z$ & $dN/dX$ & 68\% & 95\% \\",
        r"\hline",
    ]
    for i in range(len(z_cent)):
        lines.append(
            f"{z_cent[i]:.2f} & {dndx[i]:.4f} & "
            f"[{dndx68[i, 0]:.4f}, {dndx68[i, 1]:.4f}] & "
            f"[{dndx95[i, 0]:.4f}, {dndx95[i, 1]:.4f}] \\\\"
        )
    lines.append(r"\end{tabular}")
    return "\n".join(lines)


def omega_table(z_cent, omega, omega_err) -> str:
    lines = [
        r"\begin{tabular}{ccc}",
        r"$z$ & $10^3\,\Omega_\mathrm{DLA}$ & $\sigma$ \\",
        r"\hline",
    ]
    for i in range(len(z_cent)):
        lines.append(
            f"{z_cent[i]:.2f} & {1e3 * omega[i]:.4f} & {1e3 * omega_err[i]:.4f} \\\\"
        )
    lines.append(r"\end{tabular}")
    return "\n".join(lines)


def format_latex_num(number, prec=3, trans=-3) -> str:
    """Format a number as e.g. ``3.1 \\times 10^4``
    (reference: make_tables.py:7-16)."""
    if number == 0.0:
        return "$0$"
    if not np.isfinite(number):
        return "--"
    exponent = int(np.floor(np.log10(number)))
    if 1 >= exponent > trans:
        return f"$ {number:.{prec}f} $"
    return f"$ {number / 10**exponent:.2f} \\times 10^{{ {exponent:d} }}$"


def format_latex_two_num(number, number2, prec=3, trans=-3) -> str:
    """Format an interval as e.g. ``[3.1 - 2.5] x 10^4``
    (reference: make_tables.py:18-27)."""
    if not (np.isfinite(number) and np.isfinite(number2)):
        return "--"
    if number == 0.0:
        return "$0 - " + format_latex_num(number2)[1:]
    exponent = int(np.min(np.floor(np.log10([number, number2]))))
    if 1 >= exponent > trans:
        return f"$ {number:.{prec}f} - {number2:.{prec}f} $"
    return (
        f"$ [{number / 10**exponent:.2f}  - {number2 / 10**exponent:.2f} ]"
        f"\\times 10^{{ {exponent:d} }}$"
    )


def load_table(txtname, colheaders=None, caption="", omega=False) -> str:
    """LaTeX table from a (6, n) np.savetxt file written by the
    paper-plot drivers: (x, value, 68lo, 68hi, 95lo, 95hi)
    (reference: make_tables.py:29-61)."""
    table = np.loadtxt(txtname).T
    prec = 4
    if omega:
        # the drivers store the omega column pre-scaled by 1000 but the
        # interval columns raw, exactly like the reference files
        table = table.copy()
        table[:, 2:] *= 1000
        prec = 3
    nrow, ncol = table.shape
    out = ["\\begin{table*}", "\\centering",
           "\\begin{tabular}{" + "c" * ncol + "}", "\\hline"]
    header = colheaders[0]
    for ch in colheaders[1:]:
        header += " & " + ch
    header += " & $68$\\% limits & $95$\\% limits \\\\"
    out += [header, "\\hline"]
    xerr = (table[1, 0] - table[0, 0]) / 2.0
    for row in table:
        if not np.isfinite(row[1]):  # zero-path bins
            continue
        out.append(
            format_latex_two_num(row[0] - xerr, row[0] + xerr, prec=2)
            + " & " + format_latex_num(row[1], prec=prec)
            + " & " + format_latex_two_num(row[2], row[3], prec=prec)
            + " & " + format_latex_two_num(row[4], row[5], prec=prec)
            + "  \\\\"
        )
    out += ["\\hline", "\\end{tabular}",
            "\\caption{" + caption + "}",
            "\\label{tab:" + str(txtname) + "}", "\\end{table*}"]
    return "\n".join(out)


def load_cddf_table(txtname, caption="") -> str:
    """LaTeX CDDF table from a paper-plot txt file, values scaled to
    1e-21 (reference: make_tables.py:63-93)."""
    table = np.loadtxt(txtname).T
    nrow, ncol = table.shape
    scalefact = 1e-21
    scalestr = f" $( 10^{{ {int(np.log10(scalefact)):d} }} )$"
    out = ["\\begin{table*}", "\\centering",
           "\\begin{tabular}{" + "c" * ncol + "}", "\\hline",
           r"$\log_{10} \mathrm{N}_\mathrm{HI}$ & $f(N_\mathrm{HI})$ "
           + scalestr
           + " & $68$\\% limits" + scalestr
           + " & $95$\\% limits" + scalestr + " \\\\",
           "\\hline"]
    xerr = (table[1, 0] - table[0, 0]) / 2.0
    for row in table:
        if row[1] == row[3] == row[5] == 0.0:
            break
        if not np.isfinite(row[1]):
            continue
        out.append(
            format_latex_two_num(row[0] - xerr, row[0] + xerr, prec=1)
            + " & " + format_latex_num(row[1] / scalefact, trans=-2)
            + " & " + format_latex_two_num(
                row[2] / scalefact, row[3] / scalefact, trans=-2)
            + " & " + format_latex_two_num(
                row[4] / scalefact, row[5] / scalefact, trans=-2)
            + "  \\\\"
        )
    out += ["\\hline", "\\end{tabular}",
            "\\caption{" + caption + "}",
            "\\label{tab:" + str(txtname) + "}", "\\end{table*}"]
    return "\n".join(out)


def all_tables(subdir) -> str:
    """Every LaTeX table for one figure directory written by
    analysis/paper_plots.py (reference: make_tables.py:95-119
    print_all_tables / print_all_multi_dlas_tables)."""
    import glob
    import os

    parts = [
        load_table(
            os.path.join(subdir, "dndx_all.txt"),
            colheaders=("$z$", "dN/dX"),
            caption="Table of dN/dX values",
        ),
        load_table(
            os.path.join(subdir, "omega_dla_all.txt"),
            colheaders=("$z$", r"$\Omega_\mathrm{DLA} (10^{-3}) $"),
            caption=r"$\Omega_\mathrm{DLA}$ values",
            omega=True,
        ),
    ]
    for ctxt in sorted(glob.glob(os.path.join(subdir, "cddf_*.txt"))):
        parts.append(load_cddf_table(ctxt, caption="CDDF"))
    return "\n".join(parts)


def detection_table(ids, z_qsos, p_dlas, map_z_dlas, map_log_nhis,
                    p_thresh: float = 0.9, max_rows: int | None = None) -> str:
    """Per-sightline detection table (reference: make_tables.py MAP
    catalog emitters)."""
    idx = np.where(np.asarray(p_dlas) > p_thresh)[0]
    if max_rows:
        idx = idx[:max_rows]
    lines = [
        r"\begin{tabular}{ccccc}",
        r"ID & $z_\mathrm{QSO}$ & $p_\mathrm{DLA}$ & $z_\mathrm{DLA}$ & $\log N_\mathrm{HI}$ \\",
        r"\hline",
    ]
    for i in idx:
        lines.append(
            f"{ids[i]} & {z_qsos[i]:.3f} & {p_dlas[i]:.3f} & "
            f"{map_z_dlas[i, 0, 0]:.3f} & {map_log_nhis[i, 0, 0]:.2f} \\\\"
        )
    lines.append(r"\end{tabular}")
    return "\n".join(lines)
