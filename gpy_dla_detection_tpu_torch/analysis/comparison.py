"""Catalog cross-comparison: GP detections vs external truth catalogs.

The essentials of the reference's ``QSOLoader`` comparison machinery
(reference: CDDF_analysis/qso_loader.py:410-968): match sightlines to a
truth catalog (concordance / Noterdaeme / CNN), produce ROC curves,
multi-DLA confusion matrices, and MAP parameter accuracy statistics.

The port's copy of ``gpy_dla_detection_tpu/analysis/comparison.py``, on
the port's ``catalog_tools``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .catalog_tools import multi_dla_confusion, roc_curve


@dataclass
class TruthCatalog:
    """External absorber catalog keyed by sightline id."""

    ids: np.ndarray  # (T,) sightline ids with >= 1 absorber
    z_dlas: np.ndarray  # (T,) object arrays or lists per sightline
    log_nhis: np.ndarray

    @classmethod
    def from_flat(cls, ids, z_dlas, log_nhis):
        """Build from flat per-absorber rows (id may repeat)."""
        ids = np.asarray(ids)
        order = np.argsort(ids, kind="stable")
        ids_s = ids[order]
        z_s = np.asarray(z_dlas)[order]
        n_s = np.asarray(log_nhis)[order]
        uniq, start = np.unique(ids_s, return_index=True)
        z_lists = np.empty(len(uniq), object)
        n_lists = np.empty(len(uniq), object)
        for i, s in enumerate(start):
            e = start[i + 1] if i + 1 < len(start) else len(ids_s)
            z_lists[i] = z_s[s:e]
            n_lists[i] = n_s[s:e]
        return cls(uniq, z_lists, n_lists)


def truth_from_parks_json(filename: str) -> TruthCatalog:
    """Load a Parks-style (CNN) JSON catalog — also the format this
    framework's ``generate_json_catalog`` emits
    (reference: qso_loader.py:969-1054)."""
    import json

    with open(filename) as f:
        records = json.load(f)
    ids, zs, ns = [], [], []
    for rec in records:
        for dla in rec.get("dlas", []):
            ids.append(rec["id"])
            zs.append(dla["z_dla"])
            ns.append(dla.get("log_nhi", dla.get("column_density")))
    return TruthCatalog.from_flat(np.asarray(ids), zs, ns)


def truth_from_concordance(dla_catalog_txt: str) -> TruthCatalog:
    """Load the DR9 concordance plain-text DLA catalog
    (thing_id, z_dla, log_nhi per row; reference: model_priors.py:98-112)."""
    rows = np.atleast_2d(np.loadtxt(dla_catalog_txt))
    return TruthCatalog.from_flat(
        rows[:, 0].astype(np.int64), rows[:, 1], rows[:, 2]
    )


def truth_from_build_catalog(catalog: dict, name: str) -> TruthCatalog:
    """Build from a data.build_catalog dict's per-sightline DLA maps
    (reference: qso_loader.py:410-593 cross-matching)."""
    z_map = catalog["z_dlas"][name]
    n_map = catalog["log_nhis"][name]
    ids = catalog["thing_ids"]
    keep = np.isfinite(z_map)
    return TruthCatalog.from_flat(ids[keep], z_map[keep], n_map[keep])


def match_truth(ids, truth: TruthCatalog, lnhi_min: float = 20.3):
    """Boolean truth flags + per-sightline absorber lists aligned with
    ``ids``; absorbers below ``lnhi_min`` don't count as DLAs."""
    ids = np.asarray(ids)
    has_dla = np.zeros(ids.shape[0], bool)
    counts = np.zeros(ids.shape[0], np.int64)
    z_lists = np.empty(ids.shape[0], object)
    n_lists = np.empty(ids.shape[0], object)
    pos = {tid: i for i, tid in enumerate(truth.ids)}
    for i, tid in enumerate(ids):
        j = pos.get(tid)
        if j is None:
            z_lists[i] = np.array([])
            n_lists[i] = np.array([])
            continue
        keep = np.asarray(truth.log_nhis[j]) >= lnhi_min
        z_lists[i] = np.asarray(truth.z_dlas[j])[keep]
        n_lists[i] = np.asarray(truth.log_nhis[j])[keep]
        counts[i] = keep.sum()
        has_dla[i] = counts[i] > 0
    return has_dla, counts, z_lists, n_lists


def query_least_num_dlas(model_posteriors, p_thresh: float = 0.98,
                         sub_dla: int = 1):
    """Predicted DLA count per sightline by the reference's downward
    scan: starting from the largest-k model, return k as soon as the
    (renormalized) posterior of the current top model exceeds
    ``p_thresh``; else drop that model, renormalize, and continue;
    0 if nothing passes (reference: qso_loader.py:832-858
    downward_model / query_least_num_dlas).

    Vectorized over the catalog: ``model_posteriors`` is (Q, M) with
    columns [null, (sub-DLA...), DLA(1), ..., DLA(tot)].
    """
    mp = np.asarray(model_posteriors, np.float64)
    tot = mp.shape[1] - 1 - sub_dla
    counts = np.zeros(mp.shape[0], np.int64)
    decided = np.zeros(mp.shape[0], bool)
    cur = mp.copy()
    for i in range(tot):
        k = tot - i
        hit = ~decided & (cur[:, -1] > p_thresh)
        counts[hit] = k
        decided |= hit
        cur = cur[:, :-1]
        cur = cur / np.maximum(cur.sum(axis=1, keepdims=True), 1e-300)
    return counts


@dataclass
class ComparisonResult:
    fpr: np.ndarray
    tpr: np.ndarray
    auc: float
    confusion: np.ndarray
    delta_z: np.ndarray
    delta_log_nhi: np.ndarray


def compare_catalogs(
    ids,
    p_dlas,
    map_z_dlas,
    map_log_nhis,
    model_posteriors,
    truth: TruthCatalog,
    lnhi_min: float = 20.3,
    p_thresh: float = 0.9,
    sub_dla: int = 1,
    max_k: int = 4,
    count_mode: str = "least",
    p_thresh_count: float = 0.98,
) -> ComparisonResult:
    """Full comparison: ROC against sightline truth, count confusion,
    and MAP parameter residuals for matched detections
    (reference: qso_loader.py:618-831, 878-968).

    :param count_mode: how the predicted DLA count is derived from the
        model posteriors — "least" (the reference's downward threshold
        scan at ``p_thresh_count``, qso_loader.py:839-858) or "argmax"
        (MAP model index, qso_loader.py:285-302).
    """
    has_dla, counts, z_lists, n_lists = match_truth(ids, truth, lnhi_min)
    fpr, tpr, _, auc = roc_curve(p_dlas, has_dla)

    mp = np.asarray(model_posteriors)
    if count_mode == "least":
        pred_counts = query_least_num_dlas(mp, p_thresh_count, sub_dla)
    elif count_mode == "argmax":
        pred_counts = np.maximum(np.argmax(mp, axis=1) - sub_dla, 0)
    else:
        raise ValueError(f"unknown count_mode {count_mode!r}")
    confusion = multi_dla_confusion(pred_counts, counts, max_k)

    # MAP residuals: nearest-absorber matching for detected sightlines
    delta_z, delta_n = [], []
    p_dlas = np.asarray(p_dlas)
    map_z_dlas = np.asarray(map_z_dlas)
    map_log_nhis = np.asarray(map_log_nhis)
    for i in range(len(ids)):
        if p_dlas[i] < p_thresh or not has_dla[i]:
            continue
        # the MAP arrays store max_k models; a predicted count beyond
        # that (possible when model_posteriors has more absorber models
        # than the stored MAP chains) clamps to the deepest stored one
        k = min(int(pred_counts[i]), map_z_dlas.shape[1])
        if k < 1:
            continue
        for j in range(min(k, map_z_dlas.shape[2])):
            z_map = map_z_dlas[i, k - 1, j]
            if not np.isfinite(z_map) or len(z_lists[i]) == 0:
                continue
            nearest = int(np.argmin(np.abs(z_lists[i] - z_map)))
            delta_z.append(z_map - z_lists[i][nearest])
            delta_n.append(map_log_nhis[i, k - 1, j] - n_lists[i][nearest])

    return ComparisonResult(
        fpr=fpr,
        tpr=tpr,
        auc=auc,
        confusion=confusion,
        delta_z=np.asarray(delta_z),
        delta_log_nhi=np.asarray(delta_n),
    )
