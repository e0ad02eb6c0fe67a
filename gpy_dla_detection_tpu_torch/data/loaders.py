"""Loaders for the reference pipeline's trained ``.mat`` (HDF5 v7.3)
artifacts: learned GP models and QMC sample files.

The port's copy of the loaders of ``gpy_dla_detection_tpu/data/loaders.py``
that the CLIs need, reading the same datasets: ``load_learned_model``
returns the learned GP as numpy arrays in the reference container's field
order (:class:`~.synthetic.LearnedArrays`), which
``models.learned.LearnedModel.from_numpy`` moves to a device.  h5py is
imported inside each loader: the CLIs import this module on machines
without it.  The zQSO loader (``load_z_learned_model``) comes with the
port of the zQSO model.
"""

from __future__ import annotations

import numpy as np

from ..params import Parameters
from .samples import DLASamples, SubDLASamples
from .synthetic import LearnedArrays


def load_learned_model(
    filename: str, prev_tau_0: float = 0.0023, prev_beta: float = 3.65
) -> LearnedArrays:
    """Load a trained null-model GP (reference: null_gp.py:395-422)."""
    import h5py

    with h5py.File(filename, "r") as f:
        return LearnedArrays(
            rest_wavelengths=f["rest_wavelengths"][:, 0],
            mu=f["mu"][:, 0],
            M=f["M"][()].T,
            log_omega=f["log_omega"][:, 0],
            log_c_0=np.float64(f["log_c_0"][0, 0]),
            log_tau_0=np.float64(f["log_tau_0"][0, 0]),
            log_beta=np.float64(f["log_beta"][0, 0]),
            prev_tau_0=np.float64(prev_tau_0),
            prev_beta=np.float64(prev_beta),
        )


def load_dla_samples(filename: str, params: Parameters) -> DLASamples:
    """Load the DLA QMC sample set (reference: dla_samples.py:59-93)."""
    import h5py

    with h5py.File(filename, "r") as f:
        log_nhi = f["log_nhi_samples"][:, 0]
        return DLASamples(
            offset_samples=f["offset_samples"][:, 0],
            log_nhi_samples=log_nhi,
            nhi_samples=f["nhi_samples"][:, 0],
            alpha=float(f["alpha"][0, 0]),
            uniform_min_log_nhi=float(f["uniform_min_log_nhi"][0, 0]),
            uniform_max_log_nhi=float(f["uniform_max_log_nhi"][0, 0]),
            fit_min_log_nhi=params.fit_min_log_nhi,
        )


def load_subdla_samples(filename: str, params: Parameters) -> SubDLASamples:
    """Load the subDLA QMC sample set
    (reference: subdla_samples.py:72-113)."""
    import h5py

    with h5py.File(filename, "r") as f:
        return SubDLASamples(
            offset_samples=f["offset_samples"][:, 0],
            log_nhi_samples=f["lls_log_nhi_samples"][:, 0],
            nhi_samples=f["lls_nhi_samples"][:, 0],
            Z_lls=float(f["Z_lls"][0, 0]),
            Z_dla=float(f["Z_dla"][0, 0]),
        )
