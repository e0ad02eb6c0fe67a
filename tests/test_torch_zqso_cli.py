"""The port's ``run_zqso_estimation`` against the JAX CLI on the CPU.

The same synthetic speclite FITS files (drawn from the CLI's synthetic
fallback model, seed 0 and k = 5) go through
``gpy_dla_detection_tpu.run_zqso_estimation`` (float64 on the CPU) and
its twin ``gpy_dla_detection_tpu_torch.run_zqso_estimation --device cpu``
(float64), HDF5 to HDF5: the same ``qso_list``, and ``z_map`` the same
grid point.  Also: ``--device cuda`` without a card is refused through
``parser.error`` before anything is read, and ``main`` without h5py runs
the scans and fails only at the write.
"""

import os
import sys

import h5py
import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu import run_zqso_estimation as J_zqso
from gpy_dla_detection_tpu_torch import run_zqso_estimation as T_zqso
from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_z_observation
from gpy_dla_detection_tpu_torch.models.zqso import sample_z_qsos

from .test_fits import _write_speclite

torch.set_num_threads(2)

Z_TRUE = (2.5, 3.2, 3.9, 4.4)
NUM_SAMPLES = 300


@pytest.fixture(scope="module")
def fits_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("zqso_fits")
    files = []
    for i, z in enumerate(Z_TRUE):
        _, (wl, fx, nv, pm) = synthetic_z_observation(z, seed=0, obs_seed=200 + i)
        path = str(d / f"spec-0003-55555-{i:04d}.fits")
        _write_speclite(path, fx.astype(np.float32), np.log10(wl).astype(np.float32),
                        (1.0 / nv).astype(np.float32), np.where(pm, 1 << 24, 0).astype(np.int32))
        files.append(path)
    return d, files


def _argv(files, out, *extra):
    return ["--qso_list", *files, "--num-samples", str(NUM_SAMPLES), "--output", str(out),
            *extra]


def test_cli_matches_jax_float64(fits_files, capsys):
    d, files = fits_files
    J_zqso.main(_argv(files, d / "jax.h5"))
    T_zqso.main(_argv(files, d / "torch.h5", "--device", "cpu"))
    out = capsys.readouterr().out
    assert "using a synthetic zQSO model" in out and f"wrote {d / 'torch.h5'}" in out
    with h5py.File(d / "jax.h5") as j, h5py.File(d / "torch.h5") as t:
        assert sorted(t) == sorted(j) == ["qso_list", "z_map"]
        assert list(t["qso_list"][()]) == list(j["qso_list"][()])
        assert [n.decode() for n in t["qso_list"][()]] == files
        z_t, z_j = t["z_map"][()], j["z_map"][()]
    assert z_t.dtype == z_j.dtype == np.float64
    np.testing.assert_array_equal(z_t, z_j)
    assert np.isin(z_t, sample_z_qsos(NUM_SAMPLES)).all()
    np.testing.assert_allclose(z_t, Z_TRUE, atol=0.05)


def test_cli_run_returns_the_arrays(fits_files):
    d, files = fits_files
    out = T_zqso.run(_argv(files[:2], d / "unused.h5", "--device", "cpu"))
    assert out.qso_list == files[:2] and out.output == str(d / "unused.h5")
    assert out.z_map.shape == (2,) and out.seconds > 0
    assert not os.path.exists(d / "unused.h5")


def test_cuda_without_a_card_fails(fits_files, monkeypatch, capsys):
    """``--device cuda`` (the default) without a card exits 2 through
    ``parser.error`` before any spectrum is read; nothing is written."""
    d, files = fits_files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    read = []
    monkeypatch.setattr(T_zqso, "spec_reader", lambda release: read.append(release))
    with pytest.raises(SystemExit) as e:
        T_zqso.main(_argv(files, d / "nocard.h5"))
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    assert read == [] and not os.path.exists(d / "nocard.h5")


def test_main_without_h5py_fails_only_at_the_write(fits_files, monkeypatch, capsys):
    d, files = fits_files
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        T_zqso.main(_argv(files[:1], d / "noh5py.h5", "--device", "cpu"))
    out = capsys.readouterr().out
    assert "z_map = " in out and "spectra/sec" in out
    assert not os.path.exists(d / "noh5py.h5")
