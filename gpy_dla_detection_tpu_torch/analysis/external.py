"""CDDF / line-density estimators for external (non-GP) DLA catalogs.

The reference overplots its GP results against re-derivations of the
same statistics from the Parks+ 2018 CNN catalog and the Noterdaeme+
2012 DR12 catalog (reference: CDDF_analysis/qso_loader.py:1055-1551).
These are *point-estimate* statistics — a plain histogram of the
catalog's absorbers over the absorption path searched — rather than the
GP pipeline's sample-posterior machinery in ``analysis.cddf``.

Everything here is host-side numpy over small catalog arrays.

The port's copy of ``gpy_dla_detection_tpu/analysis/external.py``, on
the port's ``constants`` and ``analysis.cddf``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import integrate

from .. import constants as C
from .cddf import path_length_integrand

LYA_A = C.LYMAN_WAVELENGTHS_A[0]  # 1215.6701
LYB_A = C.LYMAN_WAVELENGTHS_A[1]  # 1025.7223
LYMAN_LIMIT_A = 911.7633


def _kms_to_z(kms: float) -> float:
    """velocity -> redshift-interval conversion
    (reference: CDDF_analysis/set_parameters.py kms_to_z)."""
    return kms * 1e5 / C.SPEED_OF_LIGHT_CGS


def path_length_flat(min_z_dlas, max_z_dlas, z_min, z_max) -> float:
    """Total absorption path dX = integral (1+z)^2 H0/H(z) dz over the
    per-sightline search windows clipped to [z_min, z_max]
    (reference: qso_loader.py:1553-1590)."""
    min_z_dlas = np.asarray(min_z_dlas, np.float64)
    max_z_dlas = np.asarray(max_z_dlas, np.float64)
    sel = (min_z_dlas < z_max) & (max_z_dlas > z_min)
    min_z_dlas, max_z_dlas = min_z_dlas[sel], max_z_dlas[sel]

    whole = (max_z_dlas > z_max) & (min_z_dlas < z_min)
    tbin, _ = integrate.quad(path_length_integrand, z_min, z_max)
    total = np.count_nonzero(whole) * tbin
    for zmin, zmax in zip(min_z_dlas[~whole], max_z_dlas[~whole]):
        lo, hi = max(z_min, zmin), min(z_max, zmax)
        if hi > lo:
            ans, _ = integrate.quad(path_length_integrand, lo, hi)
            total += ans
    return total


@dataclass
class ExternalEstimations:
    """Point estimates extracted from an external catalog, restricted to
    the sightlines of the processed GP catalog."""

    ids: np.ndarray  # (D,) sightline id per catalog absorber
    log_nhis: np.ndarray  # (D,)
    z_dlas: np.ndarray  # (D,)
    p_dlas: np.ndarray  # (D,) confidence (1.0 where the catalog has none)
    snrs: np.ndarray  # (D,) SNR of each absorber's sightline
    min_z_dlas: np.ndarray  # (L,) per-sightline search window
    max_z_dlas: np.ndarray  # (L,)
    all_snrs: np.ndarray  # (L,) SNR of every overlapping sightline


# ---------------------------------------------------------------------------
# Parks (CNN) catalog
# ---------------------------------------------------------------------------
def load_parks_json(filename: str) -> dict:
    """Flatten a Parks-style predictions JSON into per-absorber arrays
    (reference: qso_loader.py:969-1054 prediction_json2dict).

    Records carry an ``id`` (or plate/mjd/fiber_id triplet), ``z_qso``
    and a ``dlas`` list of {z_dla, log_nhi/column_density, dla_confidence/p_dla}.
    """
    import json

    with open(filename) as f:
        records = json.load(f)
    ids, z_qsos, confs, z_dlas, log_nhis = [], [], [], [], []
    for rec in records:
        rid = rec.get("id")
        if rid is None:
            rid = rec.get("thing_id")
        if rid is None:
            rid = make_unique_id(rec["plate"], rec["mjd"], rec["fiber_id"])
        dlas = rec.get("dlas", [])
        if not dlas:
            # keep absorber-free sightlines so the path length includes them
            ids.append(rid)
            z_qsos.append(rec["z_qso"])
            confs.append(0.0)
            z_dlas.append(np.nan)
            log_nhis.append(np.nan)
            continue
        for dla in dlas:
            ids.append(rid)
            z_qsos.append(rec["z_qso"])
            confs.append(dla.get("dla_confidence", dla.get("p_dla", rec.get("p_dla", 1.0))))
            z_dlas.append(dla["z_dla"])
            log_nhis.append(dla.get("log_nhi", dla.get("column_density")))
    return {
        "ids": np.asarray(ids),
        "z_qso": np.asarray(z_qsos, np.float64),
        "dla_confidences": np.asarray(confs, np.float64),
        "z_dlas": np.asarray(z_dlas, np.float64),
        "log_nhis": np.asarray(log_nhis, np.float64),
    }


def make_unique_id(plate, mjd, fiber_id):
    """Reference's unique sightline id: plate*10^9 + mjd*10^4 + fiber
    (reference: qso_loader.py make_unique_id)."""
    return (
        np.asarray(plate, np.int64) * 10**9
        + np.asarray(mjd, np.int64) * 10**4
        + np.asarray(fiber_id, np.int64)
    )


def parks_estimations(
    parks: dict,
    our_ids,
    our_snrs=None,
    p_thresh: float = 0.98,
    conf_floor: float = 0.005,
) -> ExternalEstimations:
    """Restrict the Parks catalog to our sightlines and apply the
    confidence threshold (reference: qso_loader.py:1055-1190).

    The per-sightline search window is the fixed rest-frame range
    [Lyman limit, Lya] (Parks chap. 3.2; reference: qso_loader.py:1102-1104).
    """
    our_ids = np.asarray(our_ids)
    our_snrs = (
        np.asarray(our_snrs, np.float64)
        if our_snrs is not None
        else np.zeros(our_ids.shape[0])
    )
    snr_of = {i: s for i, s in zip(our_ids.tolist(), our_snrs)}

    in_ours = np.isin(parks["ids"], our_ids)
    # unique overlapping sightlines define the absorption path
    uids, first = np.unique(parks["ids"][in_ours], return_index=True)
    z_qsos_los = parks["z_qso"][in_ours][first]
    min_z_dlas = (1 + z_qsos_los) * LYMAN_LIMIT_A / LYA_A - 1
    max_z_dlas = z_qsos_los.copy()  # (1+z)*lya/lya - 1
    all_snrs = np.array([snr_of[u] for u in uids.tolist()])

    # DLA rows: confidence floor, overlap, threshold, z sanity cut
    keep = (parks["dla_confidences"] > conf_floor) & in_ours
    ids = parks["ids"][keep]
    log_nhis = parks["log_nhis"][keep]
    z_dlas = parks["z_dlas"][keep]
    z_qsos = parks["z_qso"][keep]
    p_dlas = parks["dla_confidences"][keep]

    keep = p_dlas > p_thresh
    ids, log_nhis, z_dlas, z_qsos, p_dlas = (
        a[keep] for a in (ids, log_nhis, z_dlas, z_qsos, p_dlas)
    )
    # drop z_dlas outside [lyman limit, lya] in the QSO rest frame
    # (reference: qso_loader.py:1155-1160)
    zcut = (z_dlas > (1 + z_qsos) * LYMAN_LIMIT_A / LYA_A - 1) & (z_dlas < z_qsos)
    ids, log_nhis, z_dlas, p_dlas = (
        a[zcut] for a in (ids, log_nhis, z_dlas, p_dlas)
    )
    snrs = np.array([snr_of[u] for u in ids.tolist()])

    return ExternalEstimations(
        ids=ids,
        log_nhis=log_nhis,
        z_dlas=z_dlas,
        p_dlas=p_dlas,
        snrs=snrs,
        min_z_dlas=min_z_dlas,
        max_z_dlas=max_z_dlas,
        all_snrs=all_snrs,
    )


# ---------------------------------------------------------------------------
# Noterdaeme DR12 catalog
# ---------------------------------------------------------------------------
def noterdaeme_estimations(
    dla_rows,
    los_ids,
    our_ids,
    our_z_qsos,
    our_snrs=None,
) -> ExternalEstimations:
    """Restrict the Noterdaeme DR12 catalog to our sightlines
    (reference: qso_loader.py:1498-1551).

    :param dla_rows: (D, 3) array of (thing_id, z_dla, log_nhi) rows —
        the layout of ``data/dla_catalogs/dr12q_noterdaeme/processed/dla_catalog``.
    :param los_ids: (L,) thing_ids of every searched sightline.

    The search window follows Noterdaeme 2012 section 2.2: 3000 km/s
    redwards of Ly-beta to 5000 km/s bluewards of Ly-alpha.
    """
    our_ids = np.asarray(our_ids)
    our_z_qsos = np.asarray(our_z_qsos, np.float64)
    our_snrs = (
        np.asarray(our_snrs, np.float64)
        if our_snrs is not None
        else np.zeros(our_ids.shape[0])
    )

    in_ours = np.isin(our_ids, np.asarray(los_ids))
    z_qsos_los = our_z_qsos[in_ours]
    all_snrs = our_snrs[in_ours]
    # reference: qso_loader.py:1526-1527 — NOTE the reference adds the
    # km/s offsets to the WAVELENGTHS in Angstroms (kms_to_z(3000) =
    # 0.01 A against 1025.7 A, a numeric no-op), so its effective
    # window is [(1+z) lyb/lya - 1, z].  Reproduced exactly: applying
    # the offsets as redshift factors instead shrinks dX ~17% and every
    # Noterdaeme overlay point would sit off the reference's curves.
    min_z_dlas = (1 + z_qsos_los) * (LYB_A + _kms_to_z(3000.0)) / LYA_A - 1
    max_z_dlas = (1 + z_qsos_los) * (LYA_A - _kms_to_z(5000.0)) / LYA_A - 1

    dla_rows = np.atleast_2d(np.asarray(dla_rows, np.float64))
    thing_ids = dla_rows[:, 0].astype(np.int64)
    z_dlas = dla_rows[:, 1]
    log_nhis = dla_rows[:, 2]
    keep = np.isin(thing_ids, our_ids)
    thing_ids, z_dlas, log_nhis = thing_ids[keep], z_dlas[keep], log_nhis[keep]

    pos = {tid: i for i, tid in enumerate(our_ids.tolist())}
    snrs = np.array([our_snrs[pos[t]] for t in thing_ids.tolist()])

    return ExternalEstimations(
        ids=thing_ids,
        log_nhis=log_nhis,
        z_dlas=z_dlas,
        p_dlas=np.ones_like(z_dlas),
        snrs=snrs,
        min_z_dlas=min_z_dlas,
        max_z_dlas=max_z_dlas,
        all_snrs=all_snrs,
    )


# ---------------------------------------------------------------------------
# the statistics (shared by both catalogs)
# ---------------------------------------------------------------------------
def column_density_function_external(
    est: ExternalEstimations,
    z_min: float = 1.0,
    z_max: float = 6.0,
    lnhi_nbins: int = 30,
    lnhi_min: float = 20.0,
    lnhi_max: float = 23.0,
    snr_thresh: float = -2.0,
    apply_p_dlas: bool = False,
):
    """f(N) = n_DLA / dN / dX from catalog point estimates
    (reference: qso_loader.py:1212-1282, 1358-1429).

    :return: (log10 N bin centers, cddf, xerrs)
    """
    lnhis = np.linspace(lnhi_min, lnhi_max, num=lnhi_nbins + 1)

    los_keep = est.all_snrs > snr_thresh
    min_z = est.min_z_dlas[los_keep]
    max_z = est.max_z_dlas[los_keep]

    keep = (
        (est.snrs > snr_thresh)
        & (est.log_nhis > lnhi_min)
        & (est.log_nhis < lnhi_max)
        & (est.z_dlas > z_min)
        & (est.z_dlas < z_max)
    )
    weights = est.p_dlas[keep] if apply_p_dlas else None
    tot_f_N, _ = np.histogram(10.0 ** est.log_nhis[keep], 10.0**lnhis, weights=weights)

    dX = path_length_flat(min_z, max_z, z_min, z_max)
    dN = 10.0 ** lnhis[1:] - 10.0 ** lnhis[:-1]
    cddf = tot_f_N / dX / dN

    l_cent = 0.5 * (lnhis[:-1] + lnhis[1:])
    xerrs = (10.0**l_cent - 10.0 ** lnhis[:-1], 10.0 ** lnhis[1:] - 10.0**l_cent)
    return l_cent, cddf, xerrs


def line_density_external(
    est: ExternalEstimations,
    z_min: float = 2.0,
    z_max: float = 4.0,
    lnhi_min: float = 20.3,
    bins_per_z: int = 6,
    snr_thresh: float = -2.0,
    apply_p_dlas: bool = False,
):
    """dN/dX(z) from catalog point estimates
    (reference: qso_loader.py:1299-1356, 1448-1496).

    :return: (z bin centers, dNdX, xerrs)
    """
    nbins = max(int((z_max - z_min) * bins_per_z), 1)
    z_bins = np.linspace(z_min, z_max, nbins + 1)

    los_keep = est.all_snrs > snr_thresh
    min_z = est.min_z_dlas[los_keep]
    max_z = est.max_z_dlas[los_keep]

    keep = (est.snrs > snr_thresh) & (est.log_nhis > lnhi_min)
    weights = est.p_dlas[keep] if apply_p_dlas else None
    ndlas, _ = np.histogram(est.z_dlas[keep], z_bins, weights=weights)

    dX = np.array(
        [
            path_length_flat(min_z, max_z, zm, zx)
            for zm, zx in zip(z_bins[:-1], z_bins[1:])
        ]
    )
    ii = dX > 0
    dNdX = ndlas[ii] / dX[ii]
    z_cent = 0.5 * (z_bins[:-1] + z_bins[1:])
    xerrs = (z_cent[ii] - z_bins[:-1][ii], z_bins[1:][ii] - z_cent[ii])
    return z_cent[ii], dNdX, xerrs
