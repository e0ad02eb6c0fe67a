"""The port's ``data/preload`` and ``data/loaders.save_learned_model``
against the JAX package's on the same inputs: ``preload_spectra`` on both
routes (the Python ``preprocess`` and the native library) and on FITS files
through the default reader, ``compute_snrs``, the ``save_preloaded`` /
``load_preloaded`` round trip across the packages, the length-mismatch
error; the learned model written by either package and read by the other,
every dataset equal."""

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from gpy_dla_detection_tpu.data import loaders as JLoad  # noqa: E402
from gpy_dla_detection_tpu.data import preload as JPre  # noqa: E402
from gpy_dla_detection_tpu.models.learned import LearnedModel as JLearned  # noqa: E402
from gpy_dla_detection_tpu.params import Parameters as JParameters  # noqa: E402
from gpy_dla_detection_tpu_torch.data import build_catalog as TB  # noqa: E402
from gpy_dla_detection_tpu_torch.data import loaders as TLoad  # noqa: E402
from gpy_dla_detection_tpu_torch.data import preload as TPre  # noqa: E402
from gpy_dla_detection_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel  # noqa: E402
from gpy_dla_detection_tpu_torch.params import Parameters  # noqa: E402

from .test_fits import _write_speclite  # noqa: E402


def _store(params):
    """A good spectrum, one with a DLA, one unnormalizable (NaN flux in the
    normalization window) and one with too few pixels, as
    ``tests/test_preload.py`` builds them."""
    learned = synthetic_learned_model(params)
    store, zs = {}, []
    store["good"] = synthetic_observation(params, learned, 3.0, seed=1)
    store["dla"] = synthetic_observation(params, learned, 3.3, seed=4, dlas=[(3.0, 21.0)])
    wl, fx, nv, pm = synthetic_observation(params, learned, 3.0, seed=2)
    rest = wl / 4.0
    fx = fx.copy()
    fx[(rest >= params.normalization_min_lambda) & (rest <= params.normalization_max_lambda)] = \
        np.nan
    store["badnorm"] = (wl, fx, nv, pm)
    wl, fx, nv, pm = synthetic_observation(params, learned, 3.0, seed=3)
    pm = np.ones_like(pm)
    rest = wl / 4.0
    pm[(rest >= params.normalization_min_lambda) & (rest <= params.normalization_max_lambda)] = \
        False
    pm[np.where((rest >= params.min_lambda) & (rest <= params.max_lambda))[0][:50]] = False
    store["fewpix"] = (wl, fx, nv, pm)
    return store, ["good", "dla", "badnorm", "fewpix"], [3.0, 3.3, 3.0, 3.0]


def _assert_spectra_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        for f in w._fields:
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("use_native", [False, True])
def test_preload_and_snrs_equal_jax(use_native):
    params = Parameters()
    store, names, zs = _store(params)
    read = store.__getitem__
    spectra, flags = TPre.preload_spectra(names, zs, params, read_spec=read,
                                          use_native=use_native)
    j_spectra, j_flags = JPre.preload_spectra(names, zs, JParameters(), read_spec=read,
                                              use_native=use_native)
    _assert_spectra_equal(spectra, j_spectra)
    assert np.array_equal(flags, j_flags) and flags.dtype == j_flags.dtype
    assert list(flags) == [0, 0, TB.FILTER_NORMALIZATION, TB.FILTER_MIN_PIXELS]
    snrs = TPre.compute_snrs(spectra)
    assert np.array_equal(snrs, JPre.compute_snrs(j_spectra))
    assert snrs[0] > 1.0 and snrs[2] == -1.0 and snrs[3] == -1.0


def test_native_and_python_routes_agree_on_fits_files(tmp_path):
    """FITS files through the port's default reader: the native route
    within rtol 1e-12 of the Python route (tests/test_native.py's bound),
    the same flags, and both equal to the JAX package's."""
    params = Parameters()
    store, names, zs = _store(params)
    paths = []
    for name in names:
        wl, fx, nv, pm = store[name]
        path = str(tmp_path / f"spec-0001-55555-{len(paths):04d}.fits")
        _write_speclite(path, fx.astype(np.float32), np.log10(wl).astype(np.float32),
                        np.where(np.isfinite(nv), 1.0 / nv, 0.0).astype(np.float32),
                        np.where(pm, 1 << 24, 0).astype(np.int32))
        paths.append(path)
    py, f_py = TPre.preload_spectra(paths, zs, params)
    nat, f_nat = TPre.preload_spectra(paths, zs, params, use_native=True)
    assert np.array_equal(f_py, f_nat)
    for a, b in zip(nat, py):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for f in a._fields:
            if f == "mask":
                assert np.array_equal(a.mask, b.mask)
            else:
                np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-12, err_msg=f)
    for use_native, got in ((False, py), (True, nat)):
        _assert_spectra_equal(got, JPre.preload_spectra(paths, zs, JParameters(),
                                                        use_native=use_native)[0])


def test_save_and_load_preloaded_across_packages(tmp_path):
    params = Parameters()
    store, names, zs = _store(params)
    spectra, _ = TPre.preload_spectra(names, zs, params, read_spec=store.__getitem__)
    for writer, reader in ((TPre, JPre), (JPre, TPre), (TPre, TPre)):
        path = str(tmp_path / "preloaded.h5")
        writer.save_preloaded(path, spectra, ids=names)
        batch, kept = reader.load_preloaded(path)
        assert list(kept) == [0, 1]
        assert batch.flux.shape == (2, params.num_pixels_padded)
        for f in batch._fields:
            want = np.stack([np.asarray(getattr(spectra[i], f)) for i in (0, 1)])
            assert np.array_equal(getattr(batch, f), want), f
        with h5py.File(path, "r") as fh:
            assert [s.decode() for s in fh["ids"][()]] == ["good", "dla"]
    with pytest.raises(ValueError, match="nothing to save"):
        TPre.save_preloaded(str(tmp_path / "none.h5"), [None, None])


def test_length_mismatch_raises():
    params = Parameters()
    with pytest.raises(ValueError, match="2 filenames but 1 z_qsos"):
        TPre.preload_spectra(["a", "b"], [3.0], params, read_spec=lambda name: None)


def _assert_files_equal(a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert sorted(fa.keys()) == sorted(fb.keys())
        for name in fa.keys():
            x, y = fa[name][()], fb[name][()]
            assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_learned_model_written_by_either_package_reads_in_the_other(tmp_path):
    """The port writes (from its float64 ``LearnedModel`` and from
    ``LearnedArrays``) and the JAX ``load_learned_model`` reads; the JAX
    package writes and the port reads: every dataset equal, every field."""
    params = Parameters(k=4)
    arrays = synthetic_learned_model(params, seed=3)
    module = LearnedModel.from_numpy(arrays, "cpu", torch.float64)
    j_model = JLearned(*[np.asarray(a) for a in arrays])
    t_path, a_path, j_path = (str(tmp_path / n) for n in ("t.mat", "a.mat", "j.mat"))
    TLoad.save_learned_model(t_path, module)
    TLoad.save_learned_model(a_path, arrays)
    JLoad.save_learned_model(j_path, j_model)
    _assert_files_equal(t_path, j_path)
    _assert_files_equal(a_path, j_path)
    back_j = JLoad.load_learned_model(t_path)
    back_t = TLoad.load_learned_model(j_path)
    for f in arrays._fields:
        assert np.array_equal(np.asarray(getattr(back_j, f)), np.asarray(getattr(arrays, f))), f
        assert np.array_equal(getattr(back_t, f), np.asarray(getattr(arrays, f))), f
    # a float32 model on its device is written as its values in float64
    TLoad.save_learned_model(t_path, LearnedModel.from_numpy(arrays, "cpu", torch.float32))
    with h5py.File(t_path, "r") as f:
        assert f["M"].dtype == np.float64
        assert np.array_equal(f["M"][()].T, np.float32(arrays.M).astype(np.float64))
