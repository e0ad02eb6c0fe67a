"""The port's ``native`` (the ctypes C++ library, built into
``native/build/``) against the JAX package's ``native`` on the same inputs:
the same source byte for byte, the same flags, so every function returns
the same bits; and against scipy's ``wofz`` and the port's Python
``preprocess``."""

import os

import numpy as np
import pytest

from gpy_dla_detection_tpu import native as JN
from gpy_dla_detection_tpu.params import Parameters as JParameters
from gpy_dla_detection_tpu_torch import native as TN
from gpy_dla_detection_tpu_torch.data.spectrum import preprocess
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.params import Parameters


def test_same_source_flags_and_build_directory():
    with open(TN._SRC, "rb") as a, open(JN._SRC, "rb") as b:
        assert a.read() == b.read()
    TN.load()
    assert os.path.dirname(TN._LIB) == os.path.join(os.path.dirname(TN._SRC), "build")
    assert os.path.exists(TN._LIB)


def test_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises with the compiler's message; nothing falls
    back to the Python route."""
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "_SRC", str(bad))
    monkeypatch.setattr(TN, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "_LIB", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="failed"):
        TN._build()
    assert not os.path.exists(TN._LIB) and os.listdir(tmp_path / "build") == []


def test_faddeeva_bit_for_bit_and_against_scipy():
    from scipy.special import wofz

    x = np.concatenate([np.linspace(-10, 10, 201), np.logspace(1, 4, 101)])
    for y in (4.72e-4, 0.3, 5.0):
        yy = np.full_like(x, y)
        got = TN.faddeeva_real(x, yy)
        assert np.array_equal(got, JN.faddeeva_real(x, yy))
        np.testing.assert_allclose(got, wofz(x + 1j * yy).real, rtol=2e-9)


@pytest.mark.parametrize("broadening", [True, False])
def test_voigt_profiles_bit_for_bit(broadening):
    wl = 2900.0 * 10 ** (1e-4 * np.arange(1200))
    nhi = 10.0 ** np.array([19.0, 20.3, 21.5])
    z = np.array([2.4, 2.55, 3.0])
    for fn in ("voigt_absorption", "voigt_absorption_lls"):
        for lines in (1, 3, 31):
            got = getattr(TN, fn)(wl, nhi, z, num_lines=lines, broadening=broadening)
            want = getattr(JN, fn)(wl, nhi, z, num_lines=lines, broadening=broadening)
            assert np.array_equal(got, want), (fn, lines)
    wl_c = 1548.0 * 3.0 * 10 ** (1e-4 * np.arange(300))
    nciv, z_c, sigma = 10.0 ** np.array([13.5, 14.5]), np.array([1.98, 2.01]), \
        np.array([2.0e6, 4.0e6])
    got = TN.voigt_absorption_civ(wl_c, nciv, z_c, sigma, broadening=broadening)
    assert np.array_equal(got, JN.voigt_absorption_civ(wl_c, nciv, z_c, sigma,
                                                       broadening=broadening))
    with pytest.raises(ValueError, match="one length"):
        TN.voigt_absorption(wl, nhi, z[:2])


@pytest.mark.parametrize("z_qso", [2.6, 3.1, 4.2])
def test_preprocess_bit_for_bit_and_against_python(z_qso):
    params = Parameters()
    learned = synthetic_learned_model(params)
    wl, fx, nv, pm = synthetic_observation(params, learned, z_qso, seed=5,
                                           dlas=[(z_qso - 0.4, 20.9)])
    nat = TN.preprocess_spectrum(wl, fx, nv, pm, z_qso, params)
    ref = JN.preprocess_spectrum(wl, fx, nv, pm, z_qso, JParameters())
    assert nat._fields == ref._fields
    for f in nat._fields:
        a, b = np.asarray(getattr(nat, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    py = preprocess(wl, fx, nv, pm, z_qso, params)
    for f in ("padded_wavelengths", "flux", "noise_variance", "normalization_median",
              "min_z_dla", "max_z_dla"):
        np.testing.assert_allclose(getattr(nat, f), getattr(py, f), rtol=1e-12, err_msg=f)
    assert np.array_equal(nat.mask, py.mask) and float(nat.z_qso) == float(py.z_qso)
