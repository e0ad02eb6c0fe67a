"""Loaders for the reference pipeline's trained ``.mat`` (HDF5 v7.3)
artifacts: learned GP models and QMC sample files.

The port's copy of the loaders of ``gpy_dla_detection_tpu/data/loaders.py``
that the CLIs need, reading the same datasets: ``load_learned_model``
returns the learned GP as numpy arrays in the reference container's field
order (:class:`~.synthetic.LearnedArrays`), which
``models.learned.LearnedModel.from_numpy`` moves to a device.  h5py is
imported inside each loader: the CLIs import this module on machines
without it.  ``load_z_learned_model`` returns the port's
``models.zqso.ZLearnedModel`` with numpy fields, and
``save_z_learned_model`` writes one in the reference's layout;
``save_learned_model`` writes a null-model GP (``models.training.
train_model``'s ``LearnedModel`` on any device, or ``LearnedArrays``) in
the layout ``load_learned_model`` and the catalog CLIs' ``--learned-file``
read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.zqso import ZLearnedModel
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


def load_z_learned_model(filename: str) -> ZLearnedModel:
    """Load a trained zQSO GP (reference: zqso_gp.py:293-319)."""
    import h5py

    with h5py.File(filename, "r") as f:
        return ZLearnedModel(
            rest_wavelengths=f["rest_wavelengths"][:, 0],
            mu=f["mu"][:, 0],
            M=f["M"][()].T,
            bluewards_mu=np.float64(f["bluewards_mu"][0, 0]),
            bluewards_sigma=np.float64(f["bluewards_sigma"][0, 0]),
            redwards_mu=np.float64(f["redwards_mu"][0, 0]),
            redwards_sigma=np.float64(f["redwards_sigma"][0, 0]),
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


def _host(x) -> np.ndarray:
    """A field as a host array: tensors (any device) in float64."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x)


def save_learned_model(filename: str, learned) -> None:
    """Write a learned model in the reference's .mat v7.3 layout, so the
    reference Python package can load models trained here."""
    import h5py

    with h5py.File(filename, "w") as f:
        f.create_dataset(
            "rest_wavelengths", data=_host(learned.rest_wavelengths)[:, None]
        )
        f.create_dataset("mu", data=_host(learned.mu)[:, None])
        f.create_dataset("M", data=_host(learned.M).T)
        f.create_dataset("log_omega", data=_host(learned.log_omega)[:, None])
        for name in ["log_c_0", "log_tau_0", "log_beta"]:
            f.create_dataset(name, data=_host(getattr(learned, name)).reshape(1, 1))


def save_z_learned_model(filename: str, learned: ZLearnedModel) -> None:
    """Write a zQSO GP in the reference's .mat v7.3 layout
    (reference: zqso_gp.py:293-319)."""
    import h5py

    with h5py.File(filename, "w") as f:
        f.create_dataset(
            "rest_wavelengths", data=np.asarray(learned.rest_wavelengths)[:, None]
        )
        f.create_dataset("mu", data=np.asarray(learned.mu)[:, None])
        f.create_dataset("M", data=np.asarray(learned.M).T)
        for name in [
            "bluewards_mu",
            "bluewards_sigma",
            "redwards_mu",
            "redwards_sigma",
        ]:
            f.create_dataset(
                name, data=np.asarray(getattr(learned, name)).reshape(1, 1)
            )
