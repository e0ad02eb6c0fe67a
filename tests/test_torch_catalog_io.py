"""The port's catalog I/O (``gpy_dla_detection_tpu_torch/catalog_io.py``)
against the JAX package's, and the port's CLIs without h5py.

* ``results_to_arrays`` of the port's and the JAX package's on the same
  results (a float64 and a float32 batch of the port's, full and
  catalog-lite): the same dataset names, shapes, dtypes and bits;
  ``base_sample_inds`` int32, stored transposed, ``(n, S, max_dlas - 1)``;
  the per-sample datasets omitted when the results carry None;
* ``write_catalog`` of both on those results: the same HDF5 datasets;
* a process where h5py cannot be imported (the card's machine has none)
  imports the port's CLIs, loaders, catalog and catalog I/O, and runs the
  catalog CLI's ``run`` to its arrays.
"""

import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu import catalog_io as J_io
from gpy_dla_detection_tpu_torch import catalog_io as T_io
from gpy_dla_detection_tpu_torch.data.samples import generate_dla_samples, generate_subdla_samples
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu_torch.parallel.batch import (
    device_put_inputs,
    dispatch_batch,
    finalize_batch,
)
from gpy_dla_detection_tpu_torch.params import Parameters

from .test_fits import _write_speclite

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
S = 50
PER_SAMPLE = ("sample_log_likelihoods_dla", "sample_log_likelihoods_lls", "base_sample_inds")


def _results(dtype, max_dlas, with_sample_lls=True):
    params = Parameters(num_dla_samples=S, k=8)
    learned = synthetic_learned_model(params)
    spectra = [synthetic_spectrum(params, learned, z, seed=i, dlas=[(z - 0.3, 21.0)] if i else None)
               for i, z in enumerate((2.9, 3.2, 3.4))]
    dla, sub = generate_dla_samples(params), generate_subdla_samples(params)
    inputs = device_put_inputs(learned, dla, sub, "cpu", dtype)
    out = dispatch_batch(inputs, spectra, params,
                         torch.Generator().manual_seed(3), max_dlas,
                         with_sample_lls=with_sample_lls)
    return params, finalize_batch(out, spectra, sub, synthetic_prior_catalog(params), max_dlas)


@pytest.mark.parametrize("with_sample_lls", [True, False], ids=["full", "lite"])
@pytest.mark.parametrize("dtype, max_dlas", [(torch.float64, 3), (torch.float32, 1),
                                             (torch.float32, 4)])
def test_results_to_arrays_equals_jax(dtype, max_dlas, with_sample_lls):
    params, results = _results(dtype, max_dlas, with_sample_lls)
    got = T_io.results_to_arrays(results, params, max_dlas)
    want = J_io.results_to_arrays(results, params, max_dlas)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    if with_sample_lls:
        assert got["base_sample_inds"].dtype == np.int32
        assert got["base_sample_inds"].shape == (len(results), S, max_dlas - 1)
        assert got["sample_log_likelihoods_dla"].shape == (len(results), S, max_dlas)
        np.testing.assert_array_equal(got["base_sample_inds"][1].T, results[1].base_sample_inds)
    else:
        assert not set(PER_SAMPLE) & set(got)
        assert all(getattr(r, f) is None for r in results for f in (
            "sample_log_likelihoods_dla", "sample_log_likelihoods_subdla", "base_sample_inds"))


@pytest.mark.parametrize("with_sample_lls", [True, False], ids=["full", "lite"])
def test_write_catalog_equals_jax(tmp_path, with_sample_lls):
    params, results = _results(torch.float64, 2, with_sample_lls)
    names, zs = [f"spec-{i}.fits" for i in range(len(results))], [2.9, 3.2, 3.4]
    T_io.write_catalog(str(tmp_path / "t.h5"), results, params, 2, zs, names)
    J_io.write_catalog(str(tmp_path / "j.h5"), results, params, 2, zs, names)
    with h5py.File(tmp_path / "t.h5") as t, h5py.File(tmp_path / "j.h5") as j:
        assert sorted(t) == sorted(j)
        assert ("base_sample_inds" in t) == with_sample_lls
        for name in j:
            a, b = t[name][()], j[name][()]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert [n.decode() for n in t["qso_list"][()]] == names


def test_cli_runs_without_h5py(tmp_path):
    """The card's machine has no h5py: the port's CLIs and what they import
    load without it, and the catalog CLI's ``run`` reaches its arrays."""
    params = Parameters(num_dla_samples=S)
    learned = synthetic_learned_model(params)
    files = []
    for i, z in enumerate((3.0, 3.2)):
        wl, fx, nv, pm = synthetic_observation(params, learned, z, seed=i,
                                               dlas=[(z - 0.3, 21.2)] if i else None)
        files.append(str(tmp_path / f"spec-0007-55555-{i:04d}.fits"))
        _write_speclite(files[-1], fx.astype(np.float32), np.log10(wl).astype(np.float32),
                        (1.0 / nv).astype(np.float32), np.where(pm, 1 << 24, 0).astype(np.int32))
    argv = ["--qso_list", *files, "--z_qso_list", "3.0", "3.2", "--max_dlas", "2",
            "--num-samples", str(S), "--device", "cpu", "--output", str(tmp_path / "c.h5")]
    code = f"""
import sys
sys.modules["h5py"] = None
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
import gpy_dla_detection_tpu_torch.data.loaders, gpy_dla_detection_tpu_torch.data.catalog
import gpy_dla_detection_tpu_torch.data.build_catalog, gpy_dla_detection_tpu_torch.catalog_io
import gpy_dla_detection_tpu_torch.run_find_lls, gpy_dla_detection_tpu_torch.run_civ
from gpy_dla_detection_tpu_torch import run_bayes_select
out = run_bayes_select.run({argv!r})
assert out.arrays["sample_log_likelihoods_dla"].shape == (2, {S}, 2), out.arrays.keys()
assert out.arrays["p_dlas"][1] > 0.5 and out.qso_list == {files!r}
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert not (tmp_path / "c.h5").exists()
