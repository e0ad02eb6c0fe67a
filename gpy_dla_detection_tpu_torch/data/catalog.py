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
port imports nothing of the JAX package. ``PriorCatalog.from_mat`` (HDF5
``.mat`` loading) is not copied: it comes with the port's CLI and
catalog I/O.
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
