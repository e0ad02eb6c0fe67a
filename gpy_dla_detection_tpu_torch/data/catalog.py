"""Prior catalog: data-driven P(DLA | zQSO) counts.

Rewrite of the reference's ``PriorCatalog`` (reference:
gpy_dla_detection/model_priors.py:12-157) with two design changes:

* explicit boolean filter arguments instead of ``eval``-able strings
  (the reference evaluates ``prior_ind`` with ``eval``,
  model_priors.py:85-86 — a wart called out for removal);
* ``less_ind`` is O(log n) via a sorted-redshift prefix sum instead of
  an O(n) scan per query.

The port's own copy of ``gpy_dla_detection_tpu/data/catalog.py`` (numpy
only), kept equal to it name for name and number for number so that the
port imports nothing of the JAX package.  ``PriorCatalog.from_mat`` reads
the MATLAB ``catalog.mat`` with h5py, imported inside the method: the
port's CLIs import this module on machines without h5py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..params import Parameters


@dataclass
class PriorCatalog:
    """Quasar sightlines with known-DLA flags used for the model prior.

    :param z_qsos: (Q,) redshifts of the prior quasar sample.
    :param dla_ind: (Q,) True where the sightline contains a DLA.
    """

    params: Parameters
    z_qsos: np.ndarray
    dla_ind: np.ndarray
    thing_ids: np.ndarray | None = None
    z_dlas: np.ndarray | None = None
    log_nhis: np.ndarray | None = None

    _z_sorted: np.ndarray = field(init=False, repr=False)
    _dla_cumsum: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        order = np.argsort(self.z_qsos, kind="stable")
        self._z_sorted = np.asarray(self.z_qsos)[order]
        dla_sorted = np.asarray(self.dla_ind, dtype=np.int64)[order]
        self._dla_cumsum = np.concatenate([[0], np.cumsum(dla_sorted)])

    def less_ind(self, z_qso: float) -> tuple[int, int]:
        """(number of DLA sightlines, number of quasars) with
        ``z < z_qso + prior_z_qso_increase``
        (reference: model_priors.py:142-157)."""
        cut = z_qso + self.params.prior_z_qso_increase
        n = int(np.searchsorted(self._z_sorted, cut, side="left"))
        return int(self._dla_cumsum[n]), n

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        params: Parameters,
        z_qsos: np.ndarray,
        dla_ind: np.ndarray,
        **kw,
    ) -> "PriorCatalog":
        return cls(params, np.asarray(z_qsos), np.asarray(dla_ind, bool), **kw)

    @classmethod
    def from_mat(
        cls,
        params: Parameters,
        catalog_file: str,
        los_catalog: str,
        dla_catalog: str,
        use_in_dr9: bool = True,
        require_filter_flags_zero: bool = True,
    ) -> "PriorCatalog":
        """Load the MATLAB ``catalog.mat`` plus the DR9 concordance
        line-of-sight / DLA text catalogs
        (reference: model_priors.py:39-140)."""
        import h5py

        with h5py.File(catalog_file, "r") as catalog:
            in_dr9 = catalog["in_dr9"][0, :].astype(bool)
            z_qsos = catalog["z_qsos"][0, :]
            filter_flags = catalog["filter_flags"][0, :]
            thing_ids = catalog["thing_ids"][0, :].astype(np.int64)

        from .build_catalog import load_dla_catalog_txt

        # the shared loader is single-row-safe (np.atleast_2d)
        thing_ids_dla, z_dlas_cat, log_nhis_cat, thing_ids_los = (
            load_dla_catalog_txt(dla_catalog, los_catalog)
        )

        los_ind = np.isin(thing_ids, thing_ids_los)
        dla_ind = np.isin(thing_ids, thing_ids_dla)

        # Assign each DLA sightline the (z_dla, logNHI) of its FIRST
        # entry in the concordance file.  The reference assigns
        # ``z_dlas[dla_ind] = z_dlas_cat[present]`` (reference:
        # model_priors.py:81-82), which silently assumes the catalog and
        # the concordance list unique thing_ids in the same order —
        # multi-DLA sightlines (duplicate thing_ids) crash or misalign
        # it.  A stable sort keyed on thing_id gives an explicit
        # first-occurrence index map instead.
        order = np.argsort(thing_ids_dla, kind="stable")
        tid_sorted = thing_ids_dla[order]
        is_first = np.concatenate([[True], tid_sorted[1:] != tid_sorted[:-1]])
        uniq_tids = tid_sorted[is_first]
        first_row = order[is_first]  # first file-order row per thing_id

        z_dlas = np.full(dla_ind.shape, np.nan)
        log_nhis = np.full(dla_ind.shape, np.nan)
        pos = np.searchsorted(uniq_tids, thing_ids[dla_ind])
        z_dlas[dla_ind] = z_dlas_cat[first_row[pos]]
        log_nhis[dla_ind] = log_nhis_cat[first_row[pos]]

        keep = los_ind.copy()
        if use_in_dr9:
            keep &= in_dr9
        if require_filter_flags_zero:
            keep &= filter_flags == 0

        thing_ids = thing_ids[keep]
        z_qsos = z_qsos[keep]
        dla_ind = dla_ind[keep]
        z_dlas = z_dlas[keep]
        log_nhis = log_nhis[keep]

        # drop DLAs whose Lya absorption falls below the QSO rest-frame
        # Lyman limit (reference: model_priors.py:117-140)
        with np.errstate(invalid="ignore"):
            below = params.lya_wavelength * (1.0 + z_dlas) < params.lyman_limit * (
                1.0 + z_qsos
            )
        dla_ind = dla_ind & ~(below & dla_ind)

        return cls(
            params,
            z_qsos,
            dla_ind,
            thing_ids=thing_ids,
            z_dlas=z_dlas,
            log_nhis=log_nhis,
        )
