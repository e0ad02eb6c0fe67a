"""Processed-catalog writer: HDF5 output byte-compatible in layout and
variable names with the reference CLI's catalog
(reference: run_bayes_select.py:248-295), so downstream CDDF analysis
tooling works on either pipeline's output.

The port's own copy of ``gpy_dla_detection_tpu/catalog_io.py``: the same
dataset names, shapes and dtypes.  ``results_to_arrays`` needs only numpy;
``write_catalog`` imports h5py inside the function, so the CLIs import
this module on machines without h5py and stop at the arrays there.
"""

from __future__ import annotations

import numpy as np

from .models.pipeline import SpectrumResult
from .params import Parameters


def results_to_arrays(
    results: list[SpectrumResult], params: Parameters, max_dlas: int
):
    """Stack per-spectrum results into the catalog arrays."""
    n = len(results)
    S = params.num_dla_samples
    out = {
        "min_z_dlas": np.array([r.min_z_dla for r in results]),
        "max_z_dlas": np.array([r.max_z_dla for r in results]),
        "log_priors_no_dla": np.array([r.selection.log_priors[0] for r in results]),
        "log_priors_lls": np.array([r.selection.log_priors[1] for r in results]),
        "log_priors_dla": np.stack([r.selection.log_priors[-max_dlas:] for r in results]),
        "log_likelihoods_no_dla": np.array([r.log_evidence_null for r in results]),
        "log_likelihoods_lls": np.array([r.log_evidence_subdla for r in results]),
        "log_likelihoods_dla": np.stack([r.log_evidences_dla for r in results]),
        "log_posteriors_no_dla": np.array(
            [r.selection.log_posteriors[0] for r in results]
        ),
        "log_posteriors_lls": np.array(
            [r.selection.log_posteriors[1] for r in results]
        ),
        "log_posteriors_dla": np.stack(
            [r.selection.log_posteriors[-max_dlas:] for r in results]
        ),
        "MAP_z_dlas": np.stack([r.map_z_dlas for r in results]),
        "MAP_log_nhis": np.stack([r.map_log_nhis for r in results]),
        "model_posteriors": np.stack(
            [r.selection.model_posteriors for r in results]
        ),
        "p_dlas": np.array([r.p_dla for r in results]),
        "p_no_dlas": np.array([r.p_no_dla for r in results]),
    }
    if results[0].sample_log_likelihoods_dla is not None:
        # omitted entirely in catalog-lite runs (dispatch_batch
        # with_sample_lls=False); the reference CLI always writes
        # them (reference: run_bayes_select.py:266-295)
        out["sample_log_likelihoods_dla"] = np.stack(
            [r.sample_log_likelihoods_dla for r in results]
        )
        out["sample_log_likelihoods_lls"] = np.stack(
            [r.sample_log_likelihoods_subdla for r in results]
        )
        out["base_sample_inds"] = np.stack(
            [r.base_sample_inds.T for r in results]
        ).astype(np.int32)
        assert out["sample_log_likelihoods_dla"].shape == (n, S, max_dlas)
    return out


def write_catalog(
    filename: str,
    results: list[SpectrumResult],
    params: Parameters,
    max_dlas: int,
    z_qso_list,
    qso_list,
):
    """Write the processed catalog with the reference's dataset names
    (reference: run_bayes_select.py:248-295)."""
    import h5py

    arrays = results_to_arrays(results, params, max_dlas)
    with h5py.File(filename, "w") as f:
        f.create_dataset("prior_z_qso_increase", data=params.prior_z_qso_increase)
        f.create_dataset("k", data=params.k)
        f.create_dataset(
            "normalization_min_lambda", data=params.normalization_min_lambda
        )
        f.create_dataset(
            "normalization_max_lambda", data=params.normalization_max_lambda
        )
        f.create_dataset("min_z_cut", data=params.min_z_cut)
        f.create_dataset("max_z_cut", data=params.max_z_cut)
        f.create_dataset("num_dla_samples", data=params.num_dla_samples)
        f.create_dataset("num_lines", data=params.num_lines)
        f.create_dataset("num_forest_lines", data=params.num_forest_lines)
        for name, arr in arrays.items():
            f.create_dataset(name, data=arr)
        f.create_dataset("z_qsos", data=np.asarray(z_qso_list, np.float64))
        f.create_dataset(
            "qso_list",
            data=np.asarray(qso_list, h5py.string_dtype(encoding="utf-8")),
        )
