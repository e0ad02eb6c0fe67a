"""Catalog post-processing utilities.

Rebuilds of the reference's shard-merge and catalog-emission tooling:

* ``merge_catalogs`` — concatenate per-shard processed files into one
  catalog, validating that model posteriors stay normalized
  (reference: CDDF_analysis/sbatch_reunion.py:13-63);
* ``generate_json_catalog`` — Parks-style JSON catalog of detections
  (reference: CDDF_analysis/qso_loader.py:1927-2095);
* ``generate_ascii_catalog`` — plain-text MAP catalog
  (reference: generate_ascii_catalog.m:48-83);
* ``roc_curve`` / ``multi_dla_confusion`` — classifier comparisons
  against a truth catalog (reference: qso_loader.py:618-718, 878-968).

The port's copy of ``gpy_dla_detection_tpu/analysis/catalog_tools.py``:
numpy and h5py (imported inside the file functions) only, so it runs on
the host wherever the catalog files are.
"""

from __future__ import annotations

import json

import numpy as np

# np.trapz was renamed in numpy 2.0; support both
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

# per-spectrum datasets concatenated along the spectrum axis when
# merging shards (axis 0 in this framework's writer layout)
_PER_SPECTRUM = [
    "min_z_dlas",
    "max_z_dlas",
    "log_priors_no_dla",
    "log_priors_lls",
    "log_priors_dla",
    "log_likelihoods_no_dla",
    "log_likelihoods_lls",
    "log_likelihoods_dla",
    "log_posteriors_no_dla",
    "log_posteriors_lls",
    "log_posteriors_dla",
    "sample_log_likelihoods_dla",
    "sample_log_likelihoods_lls",
    "base_sample_inds",
    "MAP_z_dlas",
    "MAP_log_nhis",
    "model_posteriors",
    "p_dlas",
    "p_no_dlas",
    "z_qsos",
    "qso_list",
]


def merge_catalogs(shard_files: list[str], output_file: str) -> int:
    """Concatenate processed shard catalogs into one file.

    :return: total number of spectra merged.
    (reference: sbatch_reunion.py:13-63)
    """
    import h5py

    merged: dict[str, list] = {}
    scalars: dict[str, np.ndarray] = {}
    total = 0
    for path in shard_files:
        with h5py.File(path, "r") as f:
            n = f["p_dlas"].shape[0]
            total += n
            for name in f.keys():
                data = f[name][()]
                if name in _PER_SPECTRUM:
                    merged.setdefault(name, []).append(data)
                else:
                    scalars[name] = data

    with h5py.File(output_file, "w") as f:
        for name, data in scalars.items():
            f.create_dataset(name, data=data)
        for name, parts in merged.items():
            f.create_dataset(name, data=np.concatenate(parts, axis=0))

        # sanity: posteriors must stay normalized after the merge
        # (reference: sbatch_reunion.py:60-61)
        mp = f["model_posteriors"][()]
        sums = np.nansum(mp, axis=1)
        ok = np.isfinite(sums)
        assert np.all(np.abs(sums[ok] - 1.0) < 1e-4), "posterior normalization broken"
    return total


def generate_json_catalog(
    p_dlas,
    map_z_dlas,
    map_log_nhis,
    model_posteriors,
    z_qsos,
    ids=None,
    p_thresh: float = 0.9,
    sub_dla: int = 1,
):
    """Parks-format JSON catalog: one record per sightline with the MAP
    absorbers of the most probable multi-DLA model
    (reference: qso_loader.py:1927-2095).
    """
    p_dlas = np.asarray(p_dlas)
    map_z_dlas = np.asarray(map_z_dlas)
    map_log_nhis = np.asarray(map_log_nhis)
    mp = np.asarray(model_posteriors)
    z_qsos = np.asarray(z_qsos)
    ids = ids if ids is not None else np.arange(p_dlas.shape[0])

    catalog = []
    for i in range(p_dlas.shape[0]):
        # most probable number of DLAs = argmax posterior among DLA models
        num_dlas = int(np.argmax(mp[i])) - sub_dla
        num_dlas = max(num_dlas, 0)
        record = {
            "id": str(ids[i]),
            "z_qso": float(z_qsos[i]),
            "p_dla": float(p_dlas[i]),
            "num_dlas": num_dlas,
            "dlas": [],
        }
        if num_dlas > 0 and p_dlas[i] > p_thresh:
            for j in range(num_dlas):
                record["dlas"].append(
                    {
                        "z_dla": float(map_z_dlas[i, num_dlas - 1, j]),
                        "log_nhi": float(map_log_nhis[i, num_dlas - 1, j]),
                    }
                )
        catalog.append(record)
    return catalog


def write_json_catalog(filename: str, *args, **kw) -> None:
    with open(filename, "w") as f:
        json.dump(generate_json_catalog(*args, **kw), f, indent=1)


def generate_ascii_catalog(
    filename: str,
    p_dlas,
    map_z_dlas,
    map_log_nhis,
    z_qsos,
    ids=None,
):
    """Plain-text MAP catalog: one line per sightline
    (reference: generate_ascii_catalog.m:48-83)."""
    p_dlas = np.asarray(p_dlas)
    map_z_dlas = np.asarray(map_z_dlas)
    map_log_nhis = np.asarray(map_log_nhis)
    ids = ids if ids is not None else np.arange(p_dlas.shape[0])
    with open(filename, "w") as f:
        f.write("# id z_qso p_dla map_z_dla map_log_nhi\n")
        for i in range(p_dlas.shape[0]):
            f.write(
                f"{ids[i]} {z_qsos[i]:.6f} {p_dlas[i]:.6f} "
                f"{map_z_dlas[i, 0, 0]:.6f} {map_log_nhis[i, 0, 0]:.6f}\n"
            )


def generate_sub_dla_catalog(
    model_posteriors,
    z_qsos,
    ids=None,
    snrs=None,
    sub_dla: int = 1,
):
    """Catalog of sub-DLA *candidates*: sightlines whose most probable
    model is the sub-DLA model, with its posterior
    (reference: qso_loader.py:2035-2094)."""
    mp = np.asarray(model_posteriors)
    z_qsos = np.asarray(z_qsos)
    ids = ids if ids is not None else np.arange(mp.shape[0])
    records = []
    for i in np.where(np.argmax(mp, axis=1) == sub_dla)[0]:
        rec = {
            "id": str(ids[i]),
            "p_sub_dla": float(mp[i, sub_dla]),
            "z_qso": float(z_qsos[i]),
        }
        if snrs is not None:
            rec["snr"] = float(np.asarray(snrs)[i])
        records.append(rec)
    return records


def write_sub_dla_catalog(filename: str, *args, **kw) -> None:
    with open(filename, "w") as f:
        json.dump(generate_sub_dla_catalog(*args, **kw), f, indent=1)


# ---------------------------------------------------------------------------
# MATLAB v7.3 export (reference: sbatch_reunion.py:65-86 save2mat73)
# ---------------------------------------------------------------------------
_MATLAB_CLASS = {
    "f8": b"double",
    "f4": b"single",
    "i8": b"int64",
    "i4": b"int32",
    "u1": b"uint8",
    "b1": b"logical",
}


def write_mat73(filename: str, variables: dict) -> None:
    """Write a MATLAB v7.3 (HDF5-based) .mat file.

    The v7.3 container is plain HDF5 plus (a) a 512-byte userblock with
    the MATLAB file signature and (b) a ``MATLAB_class`` attribute per
    dataset.  Arrays are stored transposed (MATLAB is column-major).
    Implemented directly on h5py — no hdf5storage dependency
    (reference: sbatch_reunion.py:65-86 uses hdf5storage.write).
    """
    import h5py

    with h5py.File(filename, "w", userblock_size=512) as f:
        for name, value in variables.items():
            arr = np.asarray(value)
            if arr.dtype == bool:
                data = arr.astype(np.uint8).T
                mcls = b"logical"
            elif arr.dtype.kind in "fiu":
                data = arr.T
                mcls = _MATLAB_CLASS.get(arr.dtype.str[1:], b"double")
            else:  # strings -> a MATLAB char matrix (space-padded rows):
                # v7.3 chars are uint16 code units with
                # MATLAB_class='char' + MATLAB_int_decode=2; a uint8
                # export would load as an unusable numeric matrix
                s = np.atleast_1d(arr.astype(str))
                flat = s.reshape(-1)
                width = max((len(x) for x in flat), default=1) or 1
                codes = np.full((flat.size, width), ord(" "), np.uint16)
                for i, x in enumerate(flat):
                    u = np.frombuffer(x.encode("utf-16-le"), np.uint16)
                    codes[i, : u.size] = u
                data = codes.reshape(s.shape + (width,)).T
                mcls = b"char"
            # MATLAB represents scalars as 1x1 matrices
            if data.ndim == 0:
                data = data.reshape(1, 1)
            elif data.ndim == 1:
                data = data.reshape(1, -1)
            ds = f.create_dataset(name, data=data)
            ds.attrs["MATLAB_class"] = np.bytes_(mcls)
            if mcls == b"logical":
                ds.attrs["MATLAB_int_decode"] = np.int32(1)
            elif mcls == b"char":
                ds.attrs["MATLAB_int_decode"] = np.int32(2)

    # the MATLAB 7.3 header lives in the HDF5 userblock:
    # 116 bytes of text + 8 reserved + version 0x0200 + endian "IM"
    header = b"MATLAB 7.3 MAT-file, Platform: posix, Created by: gpy_dla_detection_tpu"
    header = header[:116].ljust(116, b" ") + b" " * 8 + bytes([0x00, 0x02]) + b"IM"
    with open(filename, "r+b") as f:
        f.write(header)


def save2mat73(filename: str, out_filename: str, small_file: bool = False) -> None:
    """Convert a processed HDF5 catalog to MATLAB v7.3 format
    (reference: sbatch_reunion.py:65-86).

    :param small_file: drop the per-sample datasets (the bulk of the
        file) for a portable summary catalog.
    """
    import h5py

    variables = {}
    with h5py.File(filename, "r") as f:
        for key in f.keys():
            if small_file and (
                "sample_log_likelihoods" in key or "base_sample_inds" in key
            ):
                continue
            variables[key] = f[key][()]
    write_mat73(out_filename, variables)


def occam_model_posteriors(model_posteriors, occams_razor: float = 10000.0):
    """Re-normalize model posteriors with an extra occam's razor factor
    against the absorber models (reference: qso_loader.py:134-173
    _occams_model_posteriors)."""
    mp = np.array(model_posteriors, np.float64)
    mp[:, 1:] = mp[:, 1:] / occams_razor
    return mp / mp.sum(axis=1, keepdims=True)


def zwarning_occam_patch(
    filename: str,
    filter_flags,
    out_filename: str,
    occams_razor: float = 10000.0,
    small_file: bool = False,
    mat73: bool = False,
):
    """Post-fix a merged catalog: drop sightlines whose catalog
    ``filter_flags`` are nonzero (the retro-fitted ZWARNING bit) and
    apply the extra occam's razor to the absorber-model posteriors
    (reference: sbatch_reunion.py:87-181 save2mat73_zpatch).

    ``filter_flags`` is aligned with the catalog rows (one per processed
    spectrum).  Writes either HDF5 (default) or MATLAB v7.3.
    """
    import h5py

    filter_flags = np.ravel(np.asarray(filter_flags))
    keep = filter_flags == 0

    variables = {}
    with h5py.File(filename, "r") as f:
        n = f["p_dlas"].shape[0]
        assert filter_flags.size == n, (filter_flags.size, n)
        for key in f.keys():
            if small_file and (
                "sample_log_likelihoods" in key or "base_sample_inds" in key
            ):
                continue
            data = f[key][()]
            if isinstance(data, np.ndarray) and data.ndim >= 1 and data.shape[0] == n:
                data = data[keep]
                if occams_razor and occams_razor != 1:
                    if key == "model_posteriors":
                        data = occam_model_posteriors(data, occams_razor)
                        variables["p_no_dlas"] = data[:, 0]
                        variables["p_lls"] = data[:, 1]
                        variables["p_dlas"] = np.clip(
                            1.0 - data[:, 0] - data[:, 1], 0.0, 1.0
                        )
                    elif key in ("p_dlas", "p_lls", "p_no_dlas"):
                        continue  # recomputed from the rescaled posteriors
                    elif key in (
                        "log_likelihoods_dla",
                        "log_likelihoods_lls",
                        "log_posteriors_dla",
                        "log_posteriors_lls",
                        "sample_log_likelihoods_dla",
                        "sample_log_likelihoods_lls",
                    ):
                        data = data - np.log(occams_razor)
            variables[key] = data

    if mat73:
        write_mat73(out_filename, variables)
    else:
        with h5py.File(out_filename, "w") as f:
            for key, data in variables.items():
                f.create_dataset(key, data=data)
    return int(keep.sum())


def roc_curve(p_dlas, truth):
    """ROC of the p_dla classifier against a boolean truth catalog.

    :return: (false_positive_rate, true_positive_rate, thresholds, auc)
    (reference: qso_loader.py:618-718)
    """
    p = np.asarray(p_dlas, np.float64)
    t = np.asarray(truth, bool)
    order = np.argsort(-p, kind="stable")
    p_sorted = p[order]
    t_sorted = t[order]
    tp = np.cumsum(t_sorted)
    fp = np.cumsum(~t_sorted)
    # one ROC point per DISTINCT threshold: keeping a point per sample
    # makes tied scores an order-dependent staircase (AUC 1.0 or 0.0
    # depending on input order for p=[.5,.5], truth=[T,F]); collapsing
    # a tie run to its last cumulative count draws the diagonal
    # segment, giving ties the correct 0.5 credit
    last = np.nonzero(np.append(np.diff(p_sorted) != 0, True))[0]
    tp, fp, p_sorted = tp[last], fp[last], p_sorted[last]
    P = t.sum()
    N = (~t).sum()
    tpr = np.concatenate([[0.0], tp / max(P, 1)])
    fpr = np.concatenate([[0.0], fp / max(N, 1)])
    auc = float(_trapezoid(tpr, fpr))
    thresholds = np.concatenate([[np.inf], p_sorted])
    return fpr, tpr, thresholds, auc


def multi_dla_confusion(map_num_dlas, true_num_dlas, max_k: int = 4):
    """Confusion matrix between predicted and true absorber counts
    (reference: qso_loader.py:878-968)."""
    pred = np.clip(np.asarray(map_num_dlas, int), 0, max_k)
    true = np.clip(np.asarray(true_num_dlas, int), 0, max_k)
    conf = np.zeros((max_k + 1, max_k + 1), dtype=np.int64)
    np.add.at(conf, (true, pred), 1)
    return conf
