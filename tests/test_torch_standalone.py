"""The port stands alone: its copies of the JAX package's numpy modules
give the reference's values, and it names no module of the JAX package
(tests/test_torch_pipeline.py::test_port_runs_without_jax runs it with
both ``jax`` and ``gpy_dla_detection_tpu`` blocked).

The copies are held bit for bit (``array_equal``, ``==``): they are the
same numpy code on the same inputs.  The CLIs' copies (``fits``,
``build_catalog``, ``loaders``, ``PriorCatalog.from_mat``, ``metrics``,
``prefetch``) read files written here: speclite and catalog FITS tables,
and ``.mat`` (HDF5) files written with h5py; ``catalog_io`` is held in
``tests/test_torch_catalog_io.py``.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpy_dla_detection_tpu import constants as JC
from gpy_dla_detection_tpu import params as JP
from gpy_dla_detection_tpu.data import build_catalog as JB
from gpy_dla_detection_tpu.data import catalog as JCat
from gpy_dla_detection_tpu.data import fits as JF
from gpy_dla_detection_tpu.data import loaders as JLoad
from gpy_dla_detection_tpu.data import samples as JS
from gpy_dla_detection_tpu.data import spectrum as JSpec
from gpy_dla_detection_tpu.models import lls as JL
from gpy_dla_detection_tpu.models import selection as JSel
from gpy_dla_detection_tpu.ops import kernel_config as JK
from gpy_dla_detection_tpu.utils import metrics as JMet
from gpy_dla_detection_tpu.utils import prefetch as JPre
from gpy_dla_detection_tpu_torch import constants as TC
from gpy_dla_detection_tpu_torch import params as TP
from gpy_dla_detection_tpu_torch.data import build_catalog as TB
from gpy_dla_detection_tpu_torch.data import catalog as TCat
from gpy_dla_detection_tpu_torch.data import fits as TF
from gpy_dla_detection_tpu_torch.data import loaders as TLoad
from gpy_dla_detection_tpu_torch.data import samples as TS
from gpy_dla_detection_tpu_torch.data import spectrum as TSpec
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.models import lls as TL
from gpy_dla_detection_tpu_torch.models import selection as TSel
from gpy_dla_detection_tpu_torch.ops import kernel_config as TK
from gpy_dla_detection_tpu_torch.utils import metrics as TMet
from gpy_dla_detection_tpu_torch.utils import prefetch as TPre

from .test_fits import _block, _card, _write_speclite

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gpy_dla_detection_tpu_torch"


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    return a == b or (a != a and b != b)


@pytest.mark.parametrize("name", ["Parameters", "CIVParameters", "ZParameters"])
def test_parameters_equal_field_by_field(name):
    jp, tp = getattr(JP, name)(), getattr(TP, name)()
    jf = [f.name for f in dataclasses.fields(jp)]
    assert jf == [f.name for f in dataclasses.fields(tp)]
    for f in jf:
        assert _equal(getattr(jp, f), getattr(tp, f)), f
    # derived quantities go through the same methods
    wl = np.linspace(3600.0, 9000.0, 800)
    assert tp.num_pixels_padded == jp.num_pixels_padded
    assert tp.min_z_dla(wl, 3.1) == jp.min_z_dla(wl, 3.1)
    assert tp.max_z_dla(wl, 3.1) == jp.max_z_dla(wl, 3.1)


def test_constants_equal():
    names = [n for n in dir(JC) if n.isupper()]
    assert names == [n for n in dir(TC) if n.isupper()]
    for n in names:
        assert _equal(getattr(JC, n), getattr(TC, n)), n


def test_profile_storage_constant_equal():
    """The fixed-point scale of int16 profile storage, the port's one copy
    from the reference's ops/kernel_config.py."""
    assert TK.ABS_I16_SCALE == JK.ABS_I16_SCALE


@pytest.mark.parametrize("num_samples", [64, 10000])
def test_samples_bit_for_bit(num_samples):
    jp, tp = JP.Parameters(num_dla_samples=num_samples), TP.Parameters(num_dla_samples=num_samples)
    for gen in ("generate_dla_samples", "generate_subdla_samples"):
        js, ts = getattr(JS, gen)(jp), getattr(TS, gen)(tp)
        assert js._fields == ts._fields
        for f, a, b in zip(js._fields, js, ts):
            assert _equal(a, b), (gen, f)
    x = np.linspace(19.0, 24.0, 101)
    assert np.array_equal(JS.log_nhi_mixture_pdf(x, jp), TS.log_nhi_mixture_pdf(x, tp))
    assert JS._gaussian_fit_integral(20.0, 25.0) == TS._gaussian_fit_integral(20.0, 25.0)
    assert JS.GARNETT_FIT == TS.GARNETT_FIT and JS._FIT_UPPER == TS._FIT_UPPER


@pytest.mark.parametrize("normalize", [True, False])
def test_preprocess_and_stack_equal(normalize):
    params = TP.Parameters()
    learned = synthetic_learned_model(params)
    specs = []
    for seed, z in ((0, 2.9), (1, 3.3)):
        obs = synthetic_observation(params, learned, z, seed=seed, dlas=[(z - 0.3, 21.0)])
        got = TSpec.preprocess(*obs, z, params, normalize=normalize)
        want = JSpec.preprocess(*obs, z, JP.Parameters(), normalize=normalize)
        for f in want._fields:
            assert _equal(getattr(got, f), getattr(want, f)), f
        assert np.array_equal(got.wavelengths, want.wavelengths)
        specs.append((got, want))
    got_b = TSpec.stack([g for g, _ in specs])
    want_b = JSpec.stack([w for _, w in specs])
    for a, b in zip(TSpec.astype(got_b, np.float32), JSpec.astype(want_b, np.float32)):
        assert np.array_equal(a, b)


def test_prior_catalog_and_model_selection_equal():
    rng = np.random.default_rng(3)
    z = rng.uniform(2.0, 4.5, 5000)
    dla = rng.uniform(size=5000) < 0.1
    jcat = JCat.PriorCatalog.from_arrays(JP.Parameters(), z, dla)
    tcat = TCat.PriorCatalog.from_arrays(TP.Parameters(), z, dla)
    sub = TS.generate_subdla_samples(TP.Parameters(num_dla_samples=64))
    for zq in rng.uniform(2.0, 4.5, 20):
        nd, nq = tcat.less_ind(zq)
        assert (nd, nq) == jcat.less_ind(zq)
        assert np.array_equal(TSel.log_priors_k_dlas(nd, nq, 4), JSel.log_priors_k_dlas(nd, nq, 4))
        lp_sub_t = TSel.log_priors_subdla(nd, nq, sub.Z_lls, sub.Z_dla)
        assert np.array_equal(lp_sub_t, JSel.log_priors_subdla(nd, nq, sub.Z_lls, sub.Z_dla))
        args = (
            lp_sub_t, TSel.log_priors_k_dlas(nd, nq, 4), float(rng.normal(-500, 5)),
            rng.normal(-500, 5, 1), rng.normal(-500, 5, 4),
        )
        got, want = TSel.model_selection(*args), JSel.model_selection(*args)
        assert got._fields == want._fields
        for f, a, b in zip(got._fields, got, want):
            assert _equal(np.asarray(a), np.asarray(b)), f


@pytest.mark.parametrize("num_samples", [64, 10000])
def test_lls_copies_bit_for_bit(num_samples):
    """The LLS search's numpy parts: its samples (at the search's full
    10,000), prior density, constants and posteriors."""
    for prior in ("garnett", "uniform"):
        js, ts = JL.generate_lya_samples(num_samples, prior=prior), TL.generate_lya_samples(
            num_samples, prior=prior)
        assert js._fields == ts._fields and TL.LyaSamples._fields == JL.LyaSamples._fields
        for f, a, b in zip(js._fields, js, ts):
            assert _equal(a, b), (prior, f)
    x = np.linspace(17.0, 23.5, 131)
    assert np.array_equal(JL.lya_log_nhi_pdf(x, 17.5, 22.0), TL.lya_log_nhi_pdf(x, 17.5, 22.0))
    assert (JL.BOSS_TAU_0, JL.BOSS_BETA, JL.LYA_FLAT_BELOW) == (
        TL.BOSS_TAU_0, TL.BOSS_BETA, TL.LYA_FLAT_BELOW)
    assert JL.FumagalliTable._fields == TL.FumagalliTable._fields
    evs = np.random.default_rng(num_samples).normal(-500, 3, 4)
    for kw in ({}, {"num_dlas": 300, "num_quasars": 4000}, {"p_lls": 0.2}):
        assert np.array_equal(JL.lls_model_posteriors(-501.0, evs, **kw),
                              TL.lls_model_posteriors(-501.0, evs, **kw))


# the port's scripts that run on the card's machine, which has no JAX
TORCH_SCRIPTS = ("train_fullscale_torch.py", "train_throughput_torch.py",
                 "profile_torch_slice.py", "accuracy_gates_torch.py", "heads_throughput_torch.py",
                 "mcmc_throughput_torch.py", "survey_throughput_torch.py")
# the port's examples, twins of the JAX package's
TORCH_EXAMPLES = ("demo_synthetic_torch.py", "lls_walkthrough_torch.py", "zqso_demo_torch.py",
                  "civ_mcmc_demo_torch.py")
# the in-flight window and the timers, ported from the JAX package's modules
# of the same names
UTILS_MODULES = ("utils/pipeline.py", "utils/timing.py")


# the survey's plumbing and the L-BFGS search, ported from the JAX package's
# modules of the same names (but the search, torch's own)
SURVEY_MODULES = ("native/__init__.py", "data/preload.py", "parallel/distributed.py",
                  "analysis/__init__.py", "analysis/catalog_tools.py", "analysis/comparison.py",
                  "models/linesearch.py")
# the catalog's science stage, ported from the JAX package's modules of the
# same names: the numpy copies (same code) and the ports
SCIENCE_COPIES = ("analysis/cddf.py", "analysis/external.py", "analysis/tables.py",
                  "analysis/paper_plots.py", "data/download.py", "run_analysis.py")
SCIENCE_MODULES = SCIENCE_COPIES + ("analysis/paper_plots_multi.py", "plotting.py")


def _imports_of(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_names_no_module_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "scripts" / name for name in TORCH_SCRIPTS + ("kernel_ablate_torch.py",)] + [
        ROOT / "examples" / name for name in TORCH_EXAMPLES]
    assert {PORT / name for name in SURVEY_MODULES + SCIENCE_MODULES + UTILS_MODULES} <= set(
        files)
    offenders = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _imports_of(f)
        if name == "gpy_dla_detection_tpu" or name.startswith("gpy_dla_detection_tpu.")
        or name == "jax" or name.startswith("jax.")
    ]
    assert offenders == []


def test_int16_storage_runs_without_jax():
    """With ``jax`` and the JAX package blocked, the port runs a float32
    batch with int16 profile storage (the reference's ``i16p`` flag value)
    in its four configurations, each within the reference's int16 bound
    (0.02) of its float32 storage."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
torch.set_num_threads(2)
from gpy_dla_detection_tpu_torch.params import Parameters
from gpy_dla_detection_tpu_torch.data.samples import generate_dla_samples, generate_subdla_samples
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model, synthetic_prior_catalog, synthetic_spectrum)
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
from gpy_dla_detection_tpu_torch.ops.kernel_config import profile_store_dtype
from gpy_dla_detection_tpu_torch.parallel.batch import process_batch
params = Parameters(num_dla_samples=64, k=6, min_lambda=1090.0, num_pixels_padded=512)
learned = synthetic_learned_model(params)
spectra = [synthetic_spectrum(params, learned, 3.0, seed=2, dlas=[(2.8, 21.0)])]
module = LearnedModel.from_numpy(learned, "cpu", torch.float32)
for impl in ("windowed", "windowed_weideman", "exact", "windowed_unfused"):
    evs = [process_batch(module, spectra, generate_dla_samples(params),
               generate_subdla_samples(params), synthetic_prior_catalog(params), params,
               torch.Generator().manual_seed(0), max_dlas=2, voigt_impl=impl,
               abs_dtype=store)[0].log_evidences_dla
           for store in (None, profile_store_dtype("i16p"))]
    assert np.isfinite(evs[1]).all() and np.abs(evs[1] - evs[0]).max() < 0.02, (impl, evs)
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu"))]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


_TFORMS = {np.dtype(">i8"): "K", np.dtype(">i4"): "J", np.dtype(">i2"): "I",
           np.dtype(">f8"): "D", np.dtype(">f4"): "E", np.dtype("u1"): "B"}


def _write_table(path, columns: dict, extname: str = "CATALOG"):
    """One BINTABLE of scalar big-endian columns after an empty primary HDU."""
    n = len(next(iter(columns.values())))
    dtype = [(name, np.asarray(col).dtype.newbyteorder(">") if np.asarray(col).dtype.itemsize > 1
              else np.dtype("u1")) for name, col in columns.items()]
    rec = np.zeros(n, dtype=dtype)
    for name, col in columns.items():
        rec[name] = col
    cards = [_card("XTENSION", "BINTABLE"), _card("BITPIX", 8), _card("NAXIS", 2),
             _card("NAXIS1", rec.dtype.itemsize), _card("NAXIS2", n), _card("PCOUNT", 0),
             _card("GCOUNT", 1), _card("TFIELDS", len(columns))]
    for i, (name, dt) in enumerate(dtype, 1):
        cards += [_card(f"TTYPE{i}", name), _card(f"TFORM{i}", _TFORMS[np.dtype(dt)])]
    data = rec.tobytes()
    with open(path, "wb") as f:
        f.write(_block([_card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0)]))
        f.write(_block(cards + [_card("EXTNAME", extname)]))
        f.write(data + b"\x00" * ((-len(data)) % 2880))


def _assert_tables_equal(got, want):
    assert [t["name"] for t in got] == [t["name"] for t in want]
    for g, w in zip(got, want):
        assert list(g["columns"]) == list(w["columns"])
        for name in w["columns"]:
            a, b = g["columns"][name], w["columns"][name]
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_fits_copy_bit_for_bit(tmp_path):
    """``read_fits_tables``, ``read_spec``, ``read_spec_dr14q``,
    ``spec_reader`` and ``file_loader`` on a speclite file and a catalog
    table; the reader's constants."""
    rng = np.random.default_rng(5)
    n = 700
    path = str(tmp_path / "spec-1234-55555-0001.fits")
    ivar = rng.uniform(0, 10, n).astype(np.float32)
    ivar[::40] = 0.0
    _write_speclite(path, rng.normal(size=n).astype(np.float32),
                    (np.log10(3600.0) + 1e-4 * np.arange(n)).astype(np.float32), ivar,
                    np.where(np.arange(n) % 55 == 0, 1 << 24, 0).astype(np.int32))
    table = str(tmp_path / "table.fits")
    _write_table(table, {"THING_ID": rng.integers(0, 1 << 40, 20), "Z_VI": rng.uniform(2, 5, 20),
                         "PLATE": rng.integers(0, 9000, 20).astype(np.int32),
                         "FLAG": rng.integers(0, 3, 20).astype(np.int16)})
    for f in (path, table):
        _assert_tables_equal(TF.read_fits_tables(f), JF.read_fits_tables(f))
    for release in ("dr12q", "dr14q"):
        assert TF.spec_reader(release).__name__ == JF.spec_reader(release).__name__
        for a, b in zip(TF.spec_reader(release)(path), JF.spec_reader(release)(path)):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    with pytest.raises(ValueError, match="dr12q or dr14q"):
        TF.spec_reader("dr16q")
    assert TF.file_loader(7339, 56000, 12) == JF.file_loader(7339, 56000, 12)
    assert (TF.BLOCK, TF._TFORM_DTYPES) == (JF.BLOCK, JF._TFORM_DTYPES)


def test_build_catalog_copy_bit_for_bit(tmp_path):
    """``build_catalog`` (with and without the ZWARNING filter),
    ``load_dla_catalog_txt``, ``write_catalog_h5`` and ``write_file_list``
    on a DR12Q-like table, a DR9Q table and DLA/LOS text catalogs."""
    rng = np.random.default_rng(9)
    n = 40
    ids = rng.choice(np.arange(1, 10_000), n, replace=False).astype(np.int64)
    dr12 = str(tmp_path / "DR12Q.fits")
    _write_table(dr12, {
        "THING_ID": ids, "RA": rng.uniform(0, 360, n), "DEC": rng.uniform(-10, 60, n),
        "PLATE": np.where(np.arange(n) % 7 == 0, 7339, 5000 + np.arange(n)).astype(np.int32),
        "MJD": rng.integers(55000, 57000, n).astype(np.int32),
        "FIBERID": rng.integers(1, 1000, n).astype(np.int32), "Z_VI": rng.uniform(1.8, 5, n),
        "SNR_SPEC": rng.uniform(0, 20, n), "BAL_FLAG_VI": rng.integers(0, 2, n).astype(np.int16),
        "ZWARNING": rng.choice([0, 16, 4, 20], n).astype(np.int32),
    })
    dr9 = str(tmp_path / "DR9Q.fits")
    _write_table(dr9, {"THING_ID": ids[::3]})
    dla_txt, los_txt = str(tmp_path / "dla.txt"), str(tmp_path / "los.txt")
    dla_rows = np.column_stack([ids[[1, 4, 4, 9]], [2.5, 2.7, 3.1, 2.2], [20.5, 21.0, 20.4, 22.1]])
    np.savetxt(dla_txt, dla_rows)
    np.savetxt(los_txt, ids[: n // 2], fmt="%d")
    for a, b in zip(TB.load_dla_catalog_txt(dla_txt, los_txt),
                    JB.load_dla_catalog_txt(dla_txt, los_txt)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for zwarning in (False, True):
        kw = dict(dr9q_fits=dr9, dla_catalogs={"dr9": (dla_txt, los_txt)},
                  zwarning_filter=zwarning)
        got, want = TB.build_catalog(dr12, **kw), JB.build_catalog(dr12, **kw)
        assert list(got) == list(want)
        for key, w in want.items():
            g = got[key]
            if isinstance(w, dict):
                assert list(g) == list(w)
                assert all(np.array_equal(g[k], w[k], equal_nan=True) for k in w), key
            else:
                assert g.dtype == w.dtype and np.array_equal(g, w), key
    for mod, name in ((TB, "t"), (JB, "j")):
        mod.write_catalog_h5(str(tmp_path / f"{name}.h5"), want)
        assert mod.write_file_list(str(tmp_path / f"{name}.txt"), want) >= 1
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    import h5py

    with h5py.File(tmp_path / "t.h5") as t, h5py.File(tmp_path / "j.h5") as j:
        names = []
        j.visit(names.append)
        for name in names:
            if isinstance(j[name], h5py.Dataset):
                assert np.array_equal(t[name][()], j[name][()], equal_nan=True), name
    assert np.array_equal(TB.V_5_7_2_PLATES, JB.V_5_7_2_PLATES)
    assert [getattr(TB, f) for f in dir(JB) if f.startswith("FILTER_")] == [
        getattr(JB, f) for f in dir(JB) if f.startswith("FILTER_")]


def test_loaders_and_from_mat_copy_bit_for_bit(tmp_path):
    """``load_learned_model`` (the port returns the reference container's
    fields as numpy), ``load_dla_samples``, ``load_subdla_samples`` and
    ``PriorCatalog.from_mat`` on ``.mat`` files written with h5py."""
    import h5py

    params = JP.Parameters(num_dla_samples=64)
    learned = str(tmp_path / "learned.mat")
    JLoad.save_learned_model(learned, synthetic_learned_model(TP.Parameters()))
    got, want = TLoad.load_learned_model(learned), JLoad.load_learned_model(learned)
    assert got._fields == tuple(want._fields)
    for f, a, b in zip(want._fields, got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b), f

    dla, sub = JS.generate_dla_samples(params), JS.generate_subdla_samples(params)
    with h5py.File(tmp_path / "dla.mat", "w") as f:
        for name in ("offset_samples", "log_nhi_samples", "nhi_samples"):
            f.create_dataset(name, data=getattr(dla, name)[:, None])
        for name in ("alpha", "uniform_min_log_nhi", "uniform_max_log_nhi"):
            f.create_dataset(name, data=np.reshape(getattr(dla, name), (1, 1)))
    with h5py.File(tmp_path / "sub.mat", "w") as f:
        f.create_dataset("offset_samples", data=sub.offset_samples[:, None])
        f.create_dataset("lls_log_nhi_samples", data=sub.log_nhi_samples[:, None])
        f.create_dataset("lls_nhi_samples", data=sub.nhi_samples[:, None])
        f.create_dataset("Z_lls", data=np.reshape(sub.Z_lls, (1, 1)))
        f.create_dataset("Z_dla", data=np.reshape(sub.Z_dla, (1, 1)))
    tparams = TP.Parameters(num_dla_samples=64)
    for loader, name in (("load_dla_samples", "dla.mat"), ("load_subdla_samples", "sub.mat")):
        got = getattr(TLoad, loader)(str(tmp_path / name), tparams)
        want = getattr(JLoad, loader)(str(tmp_path / name), params)
        assert got._fields == want._fields
        assert all(_equal(a, b) for a, b in zip(got, want)), loader

    rng = np.random.default_rng(2)
    n = 300
    ids = rng.choice(np.arange(1, 100_000), n, replace=False)
    with h5py.File(tmp_path / "catalog.mat", "w") as f:
        f.create_dataset("in_dr9", data=(rng.uniform(size=(1, n)) < 0.8).astype(np.uint8))
        f.create_dataset("z_qsos", data=rng.uniform(2.0, 5.0, (1, n)))
        f.create_dataset("filter_flags", data=rng.choice([0, 0, 0, 1], (1, n)).astype(np.uint8))
        f.create_dataset("thing_ids", data=ids[None, :].astype(np.float64))
    dla_ids = rng.choice(ids, 40)  # duplicates: multi-DLA sightlines
    np.savetxt(tmp_path / "dla.txt", np.column_stack(
        [dla_ids, rng.uniform(1.8, 4.5, 40), rng.uniform(20.3, 22.0, 40)]))
    np.savetxt(tmp_path / "los.txt", ids[: 2 * n // 3], fmt="%d")
    args = (str(tmp_path / "catalog.mat"), str(tmp_path / "los.txt"), str(tmp_path / "dla.txt"))
    for kw in ({}, {"use_in_dr9": False, "require_filter_flags_zero": False}):
        got = TCat.PriorCatalog.from_mat(TP.Parameters(), *args, **kw)
        want = JCat.PriorCatalog.from_mat(JP.Parameters(), *args, **kw)
        for f in ("z_qsos", "dla_ind", "thing_ids", "z_dlas", "log_nhis"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and _equal(a, b), f
        for zq in rng.uniform(2.0, 5.0, 10):
            assert got.less_ind(zq) == want.less_ind(zq)


def test_metrics_and_prefetch_copies(tmp_path):
    """``RunLogger`` writes the same events (less their clocks) and
    ``read_metrics`` reads them back; ``prefetch_map`` yields in order and
    raises where the reference's does."""
    for mod, name in ((TMet, "t"), (JMet, "j")):
        log = mod.RunLogger(str(tmp_path / f"{name}.jsonl"), run_config={"devices": 1})
        log.batch(index=0, size=4, done=4, total=9, seconds=0.5, span_seconds=1.25)
        log.failure("gone.fits", "FileNotFoundError: gone")
        log.emit("note", value=np.float32(2.5), item=Path("x"))
        log.finish(spectra_processed=4)
        mod.RunLogger(None).emit("ignored")
    strip = lambda events: [{k: v for k, v in e.items() if k not in ("ts", "elapsed_s",
                                                                     "spectra_per_sec")}
                            for e in events]
    got = TMet.read_metrics(str(tmp_path / "t.jsonl"))
    assert strip(got) == strip(JMet.read_metrics(str(tmp_path / "j.jsonl")))
    assert [e["event"] for e in got] == ["run_start", "batch_done", "spectrum_failed", "note",
                                         "run_end"]

    def square(x):
        if x == 7:
            raise KeyError(x)
        return x * x

    for depth in (1, 2, 5):
        assert list(TPre.prefetch_map(square, range(7), depth)) == list(
            JPre.prefetch_map(square, range(7), depth))
        for mod in (TPre, JPre):
            with pytest.raises(KeyError):
                list(mod.prefetch_map(square, range(9), depth))
    with pytest.raises(ValueError, match="depth must be >= 1"):
        list(TPre.prefetch_map(square, range(3), 0))


def test_memo_by_identity_copy():
    """The same hits, rebuilds on a reused id and FIFO eviction."""
    from gpy_dla_detection_tpu.utils import memo as JMemo
    from gpy_dla_detection_tpu_torch.utils import memo as TMemo

    def trace(mod):
        cache, built, out = {}, [], []
        owners = [object() for _ in range(4)]
        for i in (0, 1, 0, 2, 3, 0, 1):
            key = (id(owners[i]), "x")
            out.append(mod.memo_by_identity(cache, key, owners[i],
                                            lambda: built.append(i) or i, max_entries=2))
        impostor = object()
        out.append(mod.memo_by_identity(cache, (id(owners[1]), "x"), impostor,
                                        lambda: built.append("new") or "new", max_entries=2))
        return out, built, len(cache)

    assert trace(TMemo) == trace(JMemo)


def _z_spectra():
    rng = np.random.default_rng(8)
    wl = 3600.0 * 10 ** (1e-4 * np.arange(900))
    flux = rng.normal(1.0, 0.2, 900)
    nv = rng.uniform(0.01, 0.05, 900)
    nv[::97] = np.inf
    nv[5] = np.nan
    flux[11] = np.nan
    pm = rng.uniform(size=900) < 0.05
    return [(wl, flux, nv, pm, 1024), (wl[:0], flux[:0], nv[:0], pm[:0], 64),
            (wl, flux, nv, np.ones(900, bool), 900)]


@pytest.mark.parametrize("case", range(3))
def test_prepare_z_spectrum_bit_for_bit(case):
    from gpy_dla_detection_tpu.models import zqso as JZ
    from gpy_dla_detection_tpu_torch.models import zqso as TZ

    *arrays, n = _z_spectra()[case]
    got, want = TZ.prepare_z_spectrum(*arrays, n), JZ.prepare_z_spectrum(*arrays, n)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="pixels"):
        TZ.prepare_z_spectrum(*_z_spectra()[0][:4], 10)


def _pixel_grids():
    wl = 3600.0 * 10 ** (1e-4 * np.arange(1000))
    dup = wl.copy()
    dup[500] = dup[499]
    return {
        "uniform": wl,
        "padded": np.concatenate([wl, np.full(64, wl[-1])]),
        "drifting": np.linspace(6000.0, 6300.0, 3000),
        "linear": np.linspace(3600, 9000, 1000),
        "duplicate": dup,
        "jittered": wl * (1 + 1e-9 * np.sin(np.arange(1000))),
        "short": wl[:2],
    }


@pytest.mark.parametrize("name", list(_pixel_grids()))
def test_detect_pixel_dlog_equal(name):
    from gpy_dla_detection_tpu.models import zqso as JZ
    from gpy_dla_detection_tpu_torch.models import zqso as TZ

    wl = _pixel_grids()[name]
    got, want = TZ.detect_pixel_dlog(wl), JZ.detect_pixel_dlog(wl)
    assert got == want
    assert (got is None) == (name in ("drifting", "linear", "duplicate", "short"))


@pytest.mark.parametrize("seed, k", [(0, 5), (3, 20)])
def test_zqso_generators_and_flat_resampled_model_bit_for_bit(seed, k):
    """``synthetic_z_learned_model`` and ``synthetic_z_observation``, and
    ``_flat_resampled_model`` on the model as numpy and as float64
    tensors."""
    import torch

    from gpy_dla_detection_tpu.data import synthetic as JSyn
    from gpy_dla_detection_tpu.models import zqso as JZ
    from gpy_dla_detection_tpu_torch.data import synthetic as TSyn
    from gpy_dla_detection_tpu_torch.models import zqso as TZ

    got, want = TSyn.synthetic_z_learned_model(seed, k), JSyn.synthetic_z_learned_model(seed, k)
    assert type(got).__name__ == "ZLearnedModel" and got._fields == want._fields
    assert all(_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype
               for a, b in zip(got, want))
    for kw in ({}, {"obs_seed": 77, "noise": 0.05}):
        (gl, gobs), (wl_, wobs) = (TSyn.synthetic_z_observation(3.3, seed, k=k, **kw),
                                   JSyn.synthetic_z_observation(3.3, seed, k=k, **kw))
        assert all(_equal(a, b) for a, b in zip(gl, wl_))
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(gobs, wobs))
    for learned in (got, got.to("cpu", torch.float64)):
        for args in ((1e-4, 5632), (1e-4, 1000, 2, 2.5, 5.0)):
            a = TZ._flat_resampled_model(learned, *args)
            b = JZ._flat_resampled_model(want, *args)
            assert all(_equal(x, y) for x, y in zip(a, b))
    assert TZ.SCAN_OVERSAMPLE == JZ.SCAN_OVERSAMPLE and TZ.SCAN_WL_BOUNDS == JZ.SCAN_WL_BOUNDS
    assert np.array_equal(TZ.sample_z_qsos(57, 2.2, 5.5), JZ.sample_z_qsos(57, 2.2, 5.5))


def test_z_learned_model_loaders_bit_for_bit(tmp_path):
    """``load_z_learned_model`` and ``save_z_learned_model``: each reads
    what the other package wrote, with the same fields and dtypes."""
    from gpy_dla_detection_tpu.data.synthetic import synthetic_z_learned_model

    want = synthetic_z_learned_model(seed=2, k=7)
    JLoad.save_z_learned_model(str(tmp_path / "j.mat"), want)
    TLoad.save_z_learned_model(str(tmp_path / "t.mat"), TLoad.load_z_learned_model(
        str(tmp_path / "j.mat")))
    for name in ("j.mat", "t.mat"):
        got = TLoad.load_z_learned_model(str(tmp_path / name))
        ref = JLoad.load_z_learned_model(str(tmp_path / name))
        assert type(got).__module__.startswith("gpy_dla_detection_tpu_torch")
        assert got._fields == ref._fields
        for a, b, c in zip(got, ref, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(a, b) and np.array_equal(a, c)


def test_zqso_scan_runs_without_jax():
    """With ``jax`` and the JAX package blocked, the port scans a small
    grid by both scans on the CPU and finds the redshift."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
torch.set_num_threads(2)
from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_z_observation
from gpy_dla_detection_tpu_torch.models.zqso import inference_z_qso_many, prepare_z_spectrum
from gpy_dla_detection_tpu_torch.params import ZParameters
learned, obs = synthetic_z_observation(3.1, seed=0, k=4)
spec = prepare_z_spectrum(*obs, 5632)
model = learned.to("cpu", torch.float64)
for method in ("corr", "exact"):
    (res,), grid = inference_z_qso_many(model, [spec], ZParameters(num_zqso_samples=120),
                                        method=method)
    assert abs(res[0] - 3.1) < 0.05, (method, res)
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu"))]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_training_copies_bit_for_bit():
    """The training module's host copies: the mean-flux lift and
    ``prepare_training_set`` give the reference's arrays bit for bit on the
    same lists, and the parameter fields keep its order."""
    from gpy_dla_detection_tpu.models import training as JTr
    from gpy_dla_detection_tpu_torch.models import training as TTr

    rng = np.random.default_rng(0)
    obs_wl = np.sort(rng.uniform(3600.0, 5800.0, size=512))
    for z, beta, tau_0 in [(3.1, 3.182, 0.00554), (2.4, 3.65, 0.0023)]:
        assert np.array_equal(TTr._mean_flux_suppression_np(obs_wl, beta, tau_0, z, 31),
                              JTr._mean_flux_suppression_np(obs_wl, beta, tau_0, z, 31))
    params = TP.Parameters(k=4)
    learned = synthetic_learned_model(params, seed=5)
    lists = list(zip(*[synthetic_observation(params, learned, z, seed=300 + i,
                                             noise_level=0.05)
                       for i, z in enumerate((2.7, 3.0, 3.3))]))
    lists[2] = list(lists[2])
    lists[2][1] = np.full_like(lists[2][1], np.nan)  # an unusable spectrum: an all-masked row
    zs = [2.7, 3.0, 3.3]
    got = TTr.prepare_training_set(params, *lists, zs)
    want = JTr.prepare_training_set(JP.Parameters(k=4), *lists, zs)
    assert got._fields == want._fields
    for f in want._fields:
        assert _equal(getattr(got, f), getattr(want, f)), f
    assert not got.mask[1].any()
    assert TTr.PARAM_FIELDS == JTr.TrainingParams._fields


def test_training_runs_without_jax():
    """With ``jax`` and the JAX package blocked, the port trains a small
    GP on the CPU in float64 (K3's and its adjoint's twins) and the loss
    falls."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
torch.set_num_threads(2)
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model, synthetic_training_lists)
from gpy_dla_detection_tpu_torch.models.training import prepare_training_set, train_model
from gpy_dla_detection_tpu_torch.params import Parameters
params = Parameters(k=3)
z = np.linspace(2.6, 3.4, 5)
lists = synthetic_training_lists(params, synthetic_learned_model(params, seed=1), z, 40, 0.05)
learned, losses = train_model(params, prepare_training_set(params, *lists, z), 6,
                              device="cpu", dtype=torch.float64)
assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
assert learned.M.dtype == torch.float64
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu"))]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_training_scripts_run_without_jax(tmp_path):
    """With ``jax`` and the JAX package blocked, the port's training
    scripts load, the reference-scale script trains 8 spectra on the CPU
    and writes its artifact, and the throughput twin fits both objectives;
    neither package is imported."""
    code = f"""
import importlib.util, json, os, sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
os.environ.update(TRAIN_Q="8", TRAIN_ITERS="1")
import torch
torch.set_num_threads(2)
mods = {{}}
for name in {TORCH_SCRIPTS[:2]!r}:
    spec = importlib.util.spec_from_file_location(name[:-3], {str(ROOT / "scripts")!r} + "/" + name)
    mods[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mods[name])
out = {str(tmp_path / "train.json")!r}
art = mods["train_fullscale_torch.py"].main(["--device", "cpu", "--num-spectra", "8",
    "--chunks", "2", "--iters", "2", "--gate-n", "0", "--output", out])
assert json.load(open(out))["num_iterations"] == 2 and art["device"] == "cpu"
res = mods["train_throughput_torch.py"].main(["--device", "cpu"])
assert res["Q"] == 8
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu"))]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"


def test_heads_scripts_and_examples_run_without_jax(tmp_path):
    """With ``jax`` and the JAX package blocked, the LLS and CIV heads run
    through the in-flight window and the timers time them, the accuracy
    gates, the three throughput twins and the four examples run on the CPU
    at small sizes (the examples without drawing), and neither package is
    imported."""
    code = f"""
import importlib.util, json, os, sys
class Blocked:  # an import hook: scipy's array-API helpers fail on None in sys.modules
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "gpy_dla_detection_tpu", "matplotlib"):
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, Blocked())
os.environ.update(MCMC_REPS="1", MCMC_STEPS="3")
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
torch.set_num_threads(2)
from gpy_dla_detection_tpu_torch.data.synthetic import synthetic_learned_model, synthetic_spectrum
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel
from gpy_dla_detection_tpu_torch.models.lls import generate_lya_samples, lls_inference_many
from gpy_dla_detection_tpu_torch.ops.faddeeva import voigt_profile
from gpy_dla_detection_tpu_torch.params import Parameters
from gpy_dla_detection_tpu_torch.utils.timing import StageTimer, block_and_time
params = Parameters(num_dla_samples=64, k=6)
arrays = synthetic_learned_model(params)
specs = [synthetic_spectrum(params, arrays, z, seed=i) for i, z in enumerate((2.9, 3.1, 3.3))]
timer = StageTimer()
with timer.stage("lls"):
    out, best = block_and_time(lls_inference_many, LearnedModel.from_numpy(arrays, "cpu",
        torch.float32), specs, generate_lya_samples(64), torch.Generator().manual_seed(0), 2,
        params, batch_size=2, max_in_flight=1, repeats=1, device="cpu")
assert len(out) == 3 and best > 0 and timer.counts["lls"] == 1
assert float(voigt_profile(torch.zeros(1, dtype=torch.float64), 1.0, 0.0)) > 0.39
def load(path):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
scripts = {{n: load({str(ROOT / "scripts")!r} + "/" + n) for n in {TORCH_SCRIPTS[3:]!r}}}
report, ok = scripts["accuracy_gates_torch.py"].main(["--device", "cpu", "--n-zqso", "2",
    "--n-lls", "2", "--n-civ", "2", "--num-samples", "100", "--out", {str(tmp_path / "a.json")!r}])
assert set(report) == {{"card", "zqso", "lls", "civ"}}
rates = scripts["heads_throughput_torch.py"].main(["--device", "cpu", "--count", "2",
                                                  "--num-samples", "100"])
assert set(rates) == {{"lls", "civ", "zqso"}}
assert set(scripts["mcmc_throughput_torch.py"].main(["--device", "cpu"])) == {{"dla", "civ"}}
line = scripts["survey_throughput_torch.py"].main(["--device", "cpu", "--runs", "1", "--spectra",
    "3", "--batch-size", "1", "--inflight", "1", "--out", {str(tmp_path / "survey")!r},
    "--extra=--num-samples 400"])
assert line["spectra"] == 3 and line["p50"] > 0
examples = {str(ROOT / "examples")!r}
load(examples + "/zqso_demo_torch.py").main([{str(tmp_path / "z")!r}, "--device", "cpu",
    "--no-plots", "--num-samples", "300"])
load(examples + "/demo_synthetic_torch.py").main(["--out-dir", {str(tmp_path / "d")!r},
    "--device", "cpu", "--no-plots", "--num-spectra", "2", "--num-samples", "100",
    "--train-iters", "2", "--mcmc-steps", "8"])
load(examples + "/civ_mcmc_demo_torch.py").main([{str(tmp_path / "c")!r}, "--device", "cpu",
    "--no-plots", "--num-samples", "300", "--mcmc-steps", "8"])
load(examples + "/lls_walkthrough_torch.py").main([{str(tmp_path / "l")!r}, "--device", "cpu",
    "--no-plots", "--num-samples", "1000"])
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "gpy_dla_detection_tpu",
                                                        "matplotlib")]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "ok"


def test_survey_plumbing_copies():
    """The native source is the JAX package's byte for byte; the preloader
    and the two analysis modules are its code (the module docstring aside);
    the port's launcher runs the port's CLI."""
    jax_pkg = ROOT / "gpy_dla_detection_tpu"
    assert (PORT / "native" / "voigt_native.cc").read_bytes() == \
        (jax_pkg / "native" / "voigt_native.cc").read_bytes()
    for name in ("data/preload.py", "analysis/catalog_tools.py", "analysis/comparison.py",
                 *SCIENCE_COPIES):
        bodies = [[ast.dump(node) for node in ast.parse((pkg / name).read_text()).body[1:]]
                  for pkg in (jax_pkg, PORT)]
        assert bodies[0] == bodies[1], name
    launcher = (ROOT / "scripts" / "launch_survey_torch.sh").read_text()
    assert "python -m gpy_dla_detection_tpu_torch.run_bayes_select" in launcher
    assert "gpy_dla_detection_tpu_torch.analysis.catalog_tools" in launcher
    assert "gpy_dla_detection_tpu." not in launcher


def test_survey_plumbing_runs_without_jax(tmp_path):
    """With ``jax`` and the JAX package blocked, the port preloads spectra
    both ways (native and Python), writes and reads the preloaded artifact
    and a learned model, shards a work list outside a process group, merges
    two shard catalogs and compares the result with a truth catalog, and
    fits a small problem with its L-BFGS; neither package is imported."""
    code = f"""
import os, sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
import h5py
torch.set_num_threads(2)
from gpy_dla_detection_tpu_torch.analysis.catalog_tools import merge_catalogs
from gpy_dla_detection_tpu_torch.analysis.comparison import TruthCatalog, compare_catalogs
from gpy_dla_detection_tpu_torch.data.loaders import load_learned_model, save_learned_model
from gpy_dla_detection_tpu_torch.data.preload import (
    compute_snrs, load_preloaded, preload_spectra, save_preloaded)
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model, synthetic_observation)
from gpy_dla_detection_tpu_torch.models import training as TT
from gpy_dla_detection_tpu_torch.parallel import distributed
from gpy_dla_detection_tpu_torch.params import Parameters
out = {str(tmp_path)!r}
params = Parameters()
learned = synthetic_learned_model(params)
store = {{i: synthetic_observation(params, learned, z, seed=i) for i, z in enumerate((2.8, 3.2))}}
py, flags = preload_spectra([0, 1], [2.8, 3.2], params, read_spec=store.__getitem__)
nat, flags_n = preload_spectra([0, 1], [2.8, 3.2], params, read_spec=store.__getitem__,
                               use_native=True)
assert not flags.any() and np.array_equal(flags, flags_n)
np.testing.assert_allclose(nat[0].flux, py[0].flux, rtol=1e-12)
assert (compute_snrs(py) > 0).all()
save_preloaded(os.path.join(out, "pre.h5"), py)
batch, kept = load_preloaded(os.path.join(out, "pre.h5"))
assert list(kept) == [0, 1] and np.array_equal(batch.flux[1], py[1].flux)
save_learned_model(os.path.join(out, "learned.mat"), learned)
assert np.array_equal(load_learned_model(os.path.join(out, "learned.mat")).M, learned.M)
distributed.initialize()
assert distributed.host_shard(list(range(5)), 1, 2) == [3, 4]
assert distributed.shard_filename("p.h5") == "p.shard0000.h5"
shards = []
for i in range(2):
    shards.append(os.path.join(out, f"p.shard{{i:04d}}.h5"))
    with h5py.File(shards[-1], "w") as f:
        f.create_dataset("p_dlas", data=np.array([0.95, 0.05]))
        f.create_dataset("model_posteriors", data=np.array([[0.05, 0.0, 0.95], [0.95, 0.0, 0.05]]))
assert merge_catalogs(shards, os.path.join(out, "p.h5")) == 4
res = compare_catalogs([1, 2, 3, 4], np.array([0.95, 0.05, 0.95, 0.05]),
                       np.full((4, 1, 1), 2.5), np.full((4, 1, 1), 21.0),
                       np.array([[0.05, 0.0, 0.95], [0.95, 0.0, 0.05]] * 2),
                       TruthCatalog.from_flat([1, 3], [2.5, 2.5], [21.0, 21.0]), max_k=1)
assert res.auc == 1.0
p0 = TT.TrainingParams.from_numpy((np.ones((3, 1)), np.zeros(3), 0.1, -0.5, 0.2), "cpu",
                                  torch.float64)
def objective(p, *_):
    x = torch.cat([p.M.reshape(-1), p.log_omega, torch.stack([p.log_c_0, p.log_tau_0, p.log_beta])])
    return torch.sum((x - 0.5) ** 2 * torch.arange(1.0, 10.0, dtype=torch.float64))
_, values = TT.fit_lbfgs_stepwise(p0, None, None, None, None, None, Parameters(k=1), 20,
                                  objective=objective)
assert values[-1] < 1e-6 * values[0], values
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu"))]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"


def test_science_stage_runs_without_jax(tmp_path):
    """With ``jax`` and the JAX package blocked, the port computes the
    statistics of a processed catalog at two DLA levels (the four
    statistics, the MAP from the samples, the bootstrap errors), writes its
    three LaTeX tables, and computes the figure curves (the MAP-absorbed
    mean, posterior draws, the mean-flux-suppressed mean) on the CPU in
    float32; neither package is imported, and no matplotlib either."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["gpy_dla_detection_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
torch.set_num_threads(2)
from gpy_dla_detection_tpu_torch import plotting
from gpy_dla_detection_tpu_torch.analysis import tables
from gpy_dla_detection_tpu_torch.analysis.cddf import ProcessedCatalog
from gpy_dla_detection_tpu_torch.data.synthetic import (
    catalog_statistics, synthetic_learned_model, synthetic_processed_catalog, synthetic_spectrum)
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, build_spectrum_model
from gpy_dla_detection_tpu_torch.params import Parameters
stats = catalog_statistics(ProcessedCatalog(**synthetic_processed_catalog(24, 300, 1),
                                            max_k=2), tables)
assert np.isfinite(stats["line_density.dNdX"][:3]).all() and "tabular" in str(stats["tables.omega"])
params = Parameters(num_dla_samples=16)
arrays = synthetic_learned_model(params)
learned = LearnedModel.from_numpy(arrays, "cpu", torch.float32)
model = build_spectrum_model(learned, to_torch(synthetic_spectrum(params, arrays, 3.0, seed=1),
                                               "cpu", torch.float32), params)
mean = plotting.absorbed_mean(model, params, np.array([2.7]), np.array([21.0]))
draws = plotting.sample_prediction_curves(np.full((4, 2, 2), [2.7, 21.0]), model, params, 3)
rest, mu = plotting.mean_flux_curve(learned, 3.0)
assert mean.dtype == draws.dtype == mu.dtype == torch.float32 and draws.shape[0] == 3
assert bool(torch.isfinite(mean).all()) and float(mean.min()) < 0.1 * float(model.mu.max())
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "gpy_dla_detection_tpu", "matplotlib"))]
assert loaded == [], loaded
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"
