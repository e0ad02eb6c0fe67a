"""The port's ``analysis/catalog_tools`` and ``analysis/comparison``
against the JAX package's on the same inputs: the cases of
``tests/test_catalog_tools.py`` and ``tests/test_analysis_extras.py``'s
catalog-tool cases, each function's output equal to the reference's
(files dataset by dataset, with their attributes and the v7.3 userblock),
and the module sources the same code."""

import json
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from gpy_dla_detection_tpu.analysis import catalog_tools as JCT  # noqa: E402
from gpy_dla_detection_tpu.analysis import comparison as JCmp  # noqa: E402
from gpy_dla_detection_tpu_torch.analysis import catalog_tools as TCT  # noqa: E402
from gpy_dla_detection_tpu_torch.analysis import comparison as TCmp  # noqa: E402

from .test_analysis_extras import _consistent_catalog_file  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _h5_equal(a: str, b: str) -> None:
    """Two HDF5 files hold the same datasets, values and attributes."""
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert list(fa.keys()) == list(fb.keys())
        for name in fa.keys():
            x, y = fa[name][()], fb[name][()]
            assert x.dtype == y.dtype and x.shape == y.shape, name
            if x.dtype.kind in "OSU":
                assert list(np.ravel(x)) == list(np.ravel(y)), name
            else:
                assert np.array_equal(x, y, equal_nan=True), name
            assert dict(fa[name].attrs) == dict(fb[name].attrs), name
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read(128) == fb.read(128)


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, list)) and len(want) and isinstance(
            np.asarray(want, dtype=object).ravel()[0], (list, np.ndarray)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray) and want.dtype.kind in "OSU":
        assert got.dtype == want.dtype and list(got) == list(want)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(got, want, equal_nan=True) and got.dtype == want.dtype
    else:
        assert got == want


def test_the_copies_are_the_reference_modules_code():
    """The sources differ only in the docstring's added paragraph: every
    function and constant is the reference's code."""
    import ast

    for name in ("catalog_tools", "comparison"):
        trees = [ast.parse((ROOT / pkg / "analysis" / f"{name}.py").read_text())
                 for pkg in ("gpy_dla_detection_tpu", "gpy_dla_detection_tpu_torch")]
        bodies = [[ast.dump(node) for node in tree.body[1:]] for tree in trees]
        assert bodies[0] == bodies[1], name


@pytest.mark.parametrize("seed", [0, 1])
def test_roc_and_confusion_equal(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(size=500)
    p[:40] = 0.5  # ties
    t = rng.uniform(size=500) < 0.3
    _same(TCT.roc_curve(p, t), JCT.roc_curve(p, t))
    fpr, tpr, thr, auc = TCT.roc_curve(np.array([0.9, 0.8, 0.7, 0.2, 0.1]),
                                       np.array([True, True, True, False, False]))
    assert auc == 1.0
    assert TCT.roc_curve(np.full(10, 0.3), np.arange(10) < 3)[3] == 0.5
    pred, true = rng.integers(0, 5, 50), rng.integers(0, 5, 50)
    _same(TCT.multi_dla_confusion(pred, true, max_k=4), JCT.multi_dla_confusion(pred, true, 4))
    conf = TCT.multi_dla_confusion([0, 1, 2, 1], [0, 1, 2, 2], max_k=3)
    assert conf[0, 0] == 1 and conf[1, 1] == 1 and conf[2, 2] == 1 and conf[2, 1] == 1


def test_json_ascii_and_sub_dla_catalogs_equal(tmp_path):
    rng = np.random.default_rng(2)
    Q = 12
    p = rng.uniform(size=Q)
    map_z = rng.uniform(2.0, 3.0, (Q, 4, 4))
    map_n = rng.uniform(20.0, 22.0, (Q, 4, 4))
    mp = rng.dirichlet(np.full(6, 0.3), size=Q)
    z = rng.uniform(2.5, 3.5, Q)
    ids = np.arange(100, 100 + Q)
    snrs = rng.uniform(1, 10, Q)
    assert TCT.generate_json_catalog(p, map_z, map_n, mp, z, ids) == \
        JCT.generate_json_catalog(p, map_z, map_n, mp, z, ids)
    assert TCT.generate_sub_dla_catalog(mp, z, ids, snrs) == \
        JCT.generate_sub_dla_catalog(mp, z, ids, snrs)
    for fn, args in (("write_json_catalog", (p, map_z, map_n, mp, z, ids)),
                     ("write_sub_dla_catalog", (mp, z, ids, snrs)),
                     ("generate_ascii_catalog", (p, map_z, map_n, z, ids))):
        getattr(TCT, fn)(str(tmp_path / "t.txt"), *args)
        getattr(JCT, fn)(str(tmp_path / "j.txt"), *args)
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes(), fn
    # the reference test's structure
    map_z1 = np.full((2, 2, 2), np.nan)
    map_n1 = np.full((2, 2, 2), np.nan)
    map_z1[0, 0, 0], map_n1[0, 0, 0] = 2.5, 20.8
    cat = TCT.generate_json_catalog(np.array([0.95, 0.1]), map_z1, map_n1,
                                    np.array([[0.02, 0.03, 0.95, 0.0], [0.85, 0.05, 0.1, 0.0]]),
                                    z_qsos=[3.0, 2.5])
    assert cat[0]["num_dlas"] == 1 and cat[0]["dlas"][0]["z_dla"] == 2.5
    assert cat[1]["num_dlas"] == 0 and cat[1]["dlas"] == []
    json.dumps(cat)


def _shards(tmp_path, prefix, n=2):
    """Shard files in the writer's layout: per-spectrum datasets and a
    scalar, posteriors normalized."""
    rng = np.random.default_rng(7)
    paths = []
    for shard in range(n):
        path = str(tmp_path / f"{prefix}{shard}.h5")
        Q = 2 + shard
        mp = rng.dirichlet(np.ones(4), size=Q)
        with h5py.File(path, "w") as f:
            f.create_dataset("p_dlas", data=mp[:, 2:].sum(axis=1))
            f.create_dataset("model_posteriors", data=mp)
            f.create_dataset("MAP_z_dlas", data=rng.uniform(2, 3, (Q, 2, 2)))
            f.create_dataset("qso_list", data=np.array([f"spec-{shard}-{i}" for i in range(Q)],
                                                       dtype=h5py.string_dtype()))
            f.create_dataset("num_dla_samples", data=100)
        paths.append(path)
    return paths


def test_merge_catalogs_gives_equal_files(tmp_path):
    """merge_catalogs on the same shard files writes equal files."""
    paths = _shards(tmp_path, "part")
    assert TCT.merge_catalogs(paths, str(tmp_path / "t.h5")) == 5
    assert JCT.merge_catalogs(paths, str(tmp_path / "j.h5")) == 5
    _h5_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))
    with h5py.File(tmp_path / "t.h5", "r") as f:
        assert f["p_dlas"].shape == (5,) and f["num_dla_samples"][()] == 100
    # a broken normalization is refused by both
    with h5py.File(paths[0], "r+") as f:
        f["model_posteriors"][0, 0] += 0.5
    for mod in (TCT, JCT):
        with pytest.raises(AssertionError, match="normalization"):
            mod.merge_catalogs(paths, str(tmp_path / "x.h5"))


def test_mat73_exports_equal(tmp_path):
    variables = {"a": np.arange(6, dtype=np.float64).reshape(2, 3),
                 "flag": np.array([True, False]), "scalar": np.float64(3.5),
                 "names": np.array(["spec-a", "longer-name"])}
    TCT.write_mat73(str(tmp_path / "t.mat"), variables)
    JCT.write_mat73(str(tmp_path / "j.mat"), variables)
    _h5_equal(str(tmp_path / "t.mat"), str(tmp_path / "j.mat"))
    with open(tmp_path / "t.mat", "rb") as f:
        assert f.read(19) == b"MATLAB 7.3 MAT-file"
    src = str(tmp_path / "processed.h5")
    with h5py.File(src, "w") as f:
        f.create_dataset("p_dlas", data=np.array([0.1, 0.9]))
        f.create_dataset("sample_log_likelihoods_dla", data=np.zeros((2, 10, 1)))
    for small in (True, False):
        TCT.save2mat73(src, str(tmp_path / "t2.mat"), small_file=small)
        JCT.save2mat73(src, str(tmp_path / "j2.mat"), small_file=small)
        _h5_equal(str(tmp_path / "t2.mat"), str(tmp_path / "j2.mat"))


@pytest.mark.parametrize("mat73", [False, True])
def test_occam_and_zwarning_patch_equal(tmp_path, mat73):
    src = str(tmp_path / "merged.h5")
    mp = _consistent_catalog_file(src)
    _same(TCT.occam_model_posteriors(mp, 100.0), JCT.occam_model_posteriors(mp, 100.0))
    flags = np.array([0, 0, 1, 0, 2, 0])
    ext = ".mat" if mat73 else ".h5"
    assert TCT.zwarning_occam_patch(src, flags, str(tmp_path / f"t{ext}"), mat73=mat73) == 4
    assert JCT.zwarning_occam_patch(src, flags, str(tmp_path / f"j{ext}"), mat73=mat73) == 4
    _h5_equal(str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}"))


def test_truth_catalogs_matching_and_comparison_equal(tmp_path):
    rows = dict(ids=[10, 10, 30, 40, 40, 40], z_dlas=[2.5, 3.0, 2.2, 2.1, 2.4, 2.9],
                log_nhis=[20.8, 19.0, 21.5, 20.4, 20.9, 21.2])
    truth_t, truth_j = TCmp.TruthCatalog.from_flat(**rows), JCmp.TruthCatalog.from_flat(**rows)
    _same(tuple(truth_t.__dict__.values()), tuple(truth_j.__dict__.values()))
    ids = [10, 20, 30, 40]
    _same(TCmp.match_truth(ids, truth_t), JCmp.match_truth(ids, truth_j))
    has, counts, _, _ = TCmp.match_truth(ids, truth_t)
    assert list(has) == [True, False, True, True] and list(counts) == [1, 0, 1, 3]

    rng = np.random.default_rng(4)
    mp = rng.dirichlet(np.full(6, 0.2), size=4)
    mp[0] = [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
    p = mp[:, 2:].sum(axis=1)
    map_z = rng.uniform(2.0, 3.0, (4, 4, 4))
    map_n = rng.uniform(20.0, 22.0, (4, 4, 4))
    for mode in ("least", "argmax"):
        got = TCmp.compare_catalogs(ids, p, map_z, map_n, mp, truth_t, count_mode=mode)
        want = JCmp.compare_catalogs(ids, p, map_z, map_n, mp, truth_j, count_mode=mode)
        _same(tuple(got.__dict__.values()), tuple(want.__dict__.values()))
    for thresh in (0.5, 0.9, 0.98):
        _same(TCmp.query_least_num_dlas(mp, thresh), JCmp.query_least_num_dlas(mp, thresh))

    records = [{"id": "42", "z_qso": 3.0, "p_dla": 0.99, "num_dlas": 2,
                "dlas": [{"z_dla": 2.5, "log_nhi": 20.8}, {"z_dla": 2.7, "log_nhi": 21.0}]},
               {"id": "43", "z_qso": 2.5, "p_dla": 0.1, "num_dlas": 0, "dlas": []}]
    (tmp_path / "parks.json").write_text(json.dumps(records))
    (tmp_path / "dla_catalog").write_text("100 2.3 20.5\n100 2.6 21.1\n200 3.0 20.9\n")
    for fn, arg in (("truth_from_parks_json", "parks.json"),
                    ("truth_from_concordance", "dla_catalog")):
        got, want = (getattr(m, fn)(str(tmp_path / arg)) for m in (TCmp, JCmp))
        _same(tuple(got.__dict__.values()), tuple(want.__dict__.values()))
    assert list(TCmp.truth_from_concordance(str(tmp_path / "dla_catalog")).ids) == [100, 200]
    catalog = {"thing_ids": np.array([5, 7, 9]), "z_dlas": {"x": np.array([2.1, np.nan, 3.0])},
               "log_nhis": {"x": np.array([20.5, np.nan, 21.0])}}
    _same(tuple(TCmp.truth_from_build_catalog(catalog, "x").__dict__.values()),
          tuple(JCmp.truth_from_build_catalog(catalog, "x").__dict__.values()))
