"""Quasar/DLA catalog construction from SDSS release files.

Native rebuild of the MATLAB catalog construction (reference:
build_catalogs.m:1-119, multi_dlas/build_catalogs.m with the ZWARNING
filter): reads the DR9Q/DR10Q/DR12Q quasar catalogs with the built-in
FITS reader, applies the filtering flags, cross-matches the DLA
catalogs, and writes an HDF5 catalog plus the spectra download list.

The port's own copy of ``gpy_dla_detection_tpu/data/build_catalog.py``, kept equal
to it name for name, so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

from .fits import read_fits_tables

# plates processed with the 5.7.2 pipeline in DR12
# (reference: build_catalogs.m:96-100)
V_5_7_2_PLATES = np.array([
    7339, 7340, 7386, 7388, 7389, 7391, 7396, 7398, 7401, 7402, 7404,
    7406, 7407, 7408, 7409, 7411, 7413, 7416, 7419, 7422, 7425, 7426,
    7428, 7455, 7512, 7513, 7515, 7516, 7517, 7562, 7563, 7564, 7565,
])

# filter-flag bits (reference: build_catalogs.m:40-48,
# multi_dlas/build_catalogs.m:53-59)
FILTER_Z_QSO = 1 << 0  # z_QSO < z_qso_cut
FILTER_BAL = 1 << 1  # broad absorption line QSO
FILTER_NORMALIZATION = 1 << 2  # set by the preloader
FILTER_MIN_PIXELS = 1 << 3  # set by the preloader
FILTER_ZWARNING = 1 << 4  # multi-DLA pipeline only


def _columns(fits_file: str, names: list[str]) -> dict[str, np.ndarray]:
    tables = read_fits_tables(fits_file)
    cols = tables[0]["columns"]
    lookup = {k.upper(): k for k in cols}
    return {n: cols[lookup[n.upper()]] for n in names}


def load_dla_catalog_txt(dla_catalog: str, los_catalog: str):
    """Plain-text (thing_id, z_dla, log_nhi) + line-of-sight catalogs
    (reference: model_priors.py:98-112)."""
    dla = np.atleast_2d(np.loadtxt(dla_catalog))
    los = np.loadtxt(los_catalog).astype(np.int64)
    return dla[:, 0].astype(np.int64), dla[:, 1], dla[:, 2], los


def build_catalog(
    dr12q_fits: str,
    dr9q_fits: str | None = None,
    dr10q_fits: str | None = None,
    dla_catalogs: dict[str, tuple[str, str]] | None = None,
    z_qso_cut: float = 2.15,
    zwarning_filter: bool = False,
) -> dict:
    """Build the quasar catalog dictionary.

    :param dla_catalogs: {name: (dla_catalog_txt, los_catalog_txt)}.
    :return: dict with the reference catalog's variable names
        (reference: build_catalogs.m:85-91).
    """
    cols = _columns(
        dr12q_fits,
        ["THING_ID", "RA", "DEC", "PLATE", "MJD", "FIBERID", "Z_VI",
         "SNR_SPEC", "BAL_FLAG_VI"]
        + (["ZWARNING"] if zwarning_filter else []),
    )
    thing_ids = cols["THING_ID"].astype(np.int64)
    z_qsos = np.asarray(cols["Z_VI"], np.float64)
    n = thing_ids.shape[0]

    filter_flags = np.zeros(n, dtype=np.uint8)
    filter_flags[z_qsos < z_qso_cut] |= FILTER_Z_QSO
    filter_flags[np.asarray(cols["BAL_FLAG_VI"]) > 0] |= FILTER_BAL
    if zwarning_filter:
        # keep ONLY the pure MANY_OUTLIERS flag (zwarning == 16
        # exactly, not any combination containing the bit) like the
        # reference (multi_dlas/build_catalogs.m:53-57:
        # zwarning == bin2dec('10000'))
        zw = np.asarray(cols["ZWARNING"], np.int64)
        bad = (zw > 0) & (zw != (1 << 4))
        filter_flags[bad] |= FILTER_ZWARNING

    in_dr9 = np.zeros(n, bool)
    in_dr10 = np.zeros(n, bool)
    if dr9q_fits:
        dr9_ids = _columns(dr9q_fits, ["THING_ID"])["THING_ID"].astype(np.int64)
        in_dr9 = np.isin(thing_ids, dr9_ids)
    if dr10q_fits:
        dr10_ids = _columns(dr10q_fits, ["THING_ID"])["THING_ID"].astype(np.int64)
        in_dr10 = np.isin(thing_ids, dr10_ids)

    catalog = {
        "thing_ids": thing_ids,
        "ras": np.asarray(cols["RA"], np.float64),
        "decs": np.asarray(cols["DEC"], np.float64),
        "plates": cols["PLATE"].astype(np.int64),
        "mjds": cols["MJD"].astype(np.int64),
        "fiber_ids": cols["FIBERID"].astype(np.int64),
        "z_qsos": z_qsos,
        "snrs": np.asarray(cols["SNR_SPEC"], np.float64),
        "bal_visual_flags": np.asarray(cols["BAL_FLAG_VI"]) > 0,
        "in_dr9": in_dr9,
        "in_dr10": in_dr10,
        "filter_flags": filter_flags,
        "los_inds": {},
        "dla_inds": {},
        "z_dlas": {},
        "log_nhis": {},
    }

    for name, (dla_file, los_file) in (dla_catalogs or {}).items():
        ids_dla, z_dlas, log_nhis, ids_los = load_dla_catalog_txt(dla_file, los_file)
        catalog["los_inds"][name] = np.isin(thing_ids, ids_los)
        catalog["dla_inds"][name] = np.isin(thing_ids, ids_dla)
        z_map = np.full(n, np.nan)
        n_map = np.full(n, np.nan)
        order = np.argsort(ids_dla, kind="stable")
        pos = np.searchsorted(ids_dla[order], thing_ids)
        pos = np.clip(pos, 0, len(ids_dla) - 1)
        hit = ids_dla[order][pos] == thing_ids
        z_map[hit] = z_dlas[order][pos[hit]]
        n_map[hit] = log_nhis[order][pos[hit]]
        catalog["z_dlas"][name] = z_map
        catalog["log_nhis"][name] = n_map

    return catalog


def write_catalog_h5(filename: str, catalog: dict) -> None:
    import h5py

    with h5py.File(filename, "w") as f:
        for key, value in catalog.items():
            if isinstance(value, dict):
                grp = f.create_group(key)
                for name, arr in value.items():
                    grp.create_dataset(name, data=arr)
            else:
                f.create_dataset(key, data=value)


def write_file_list(filename: str, catalog: dict) -> int:
    """Download list of unfiltered spectra
    (reference: build_catalogs.m:102-119)."""
    n = 0
    v572 = np.isin(catalog["plates"], V_5_7_2_PLATES)
    with open(filename, "w") as f:
        for i in range(catalog["thing_ids"].shape[0]):
            if catalog["filter_flags"][i] > 0:
                continue
            p, m, fib = (
                catalog["plates"][i],
                catalog["mjds"][i],
                catalog["fiber_ids"][i],
            )
            if v572[i]:
                f.write(f"v5_7_2/spectra/lite/./{p}/spec-{p}-{m}-{fib:04d}.fits\n")
            f.write(f"v5_7_0/spectra/lite/./{p}/spec-{p}-{m}-{fib:04d}.fits\n")
            n += 1
    return n
