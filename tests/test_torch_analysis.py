"""The port's science stage beyond ``cddf`` against the JAX package's on
the same inputs: the cases of ``tests/test_analysis_extras.py`` that
``tests/test_torch_catalog_tools.py`` does not hold (bootstrap
resampling and sample errors, the Parks and Noterdaeme estimators, the
Parks JSON round trip, the sub-DLA catalog, ``multi_roc``, the paper
drivers, the LaTeX loaders, ``map_from_samples``, the mean-flux and
Lyman-series drivers, the Lya demo and the skyline check), and
``run_analysis`` end to end (the copies' sources are held in
``tests/test_torch_standalone.py``).

Tolerances: the numpy copies (``external``, ``tables``, ``paper_plots``,
``cddf``) bit for bit, and their files byte for byte; the figures by the
data they draw (``test_torch_plotting.figure_data``), bit for bit where
the data are the catalog's, within 1e-10 of the largest magnitude where
they are float64 model curves (the port's learned model's buffers in
float64 on the CPU against the reference's numpy fields).
"""

import os

import numpy as np
import pytest
import torch

from gpy_dla_detection_tpu import run_analysis as J_ra
from gpy_dla_detection_tpu.analysis import catalog_tools as JCT
from gpy_dla_detection_tpu.analysis import external as JE
from gpy_dla_detection_tpu.analysis import paper_plots as Jpp
from gpy_dla_detection_tpu.analysis import paper_plots_multi as Jpm
from gpy_dla_detection_tpu.analysis import tables as JT
from gpy_dla_detection_tpu.analysis.comparison import ComparisonResult as JResult
from gpy_dla_detection_tpu.data import synthetic as JS
from gpy_dla_detection_tpu.models.learned import build_spectrum_model as j_build
from gpy_dla_detection_tpu_torch import run_analysis as T_ra
from gpy_dla_detection_tpu_torch.analysis import catalog_tools as TCT
from gpy_dla_detection_tpu_torch.analysis import external as TE
from gpy_dla_detection_tpu_torch.analysis import paper_plots as Tpp
from gpy_dla_detection_tpu_torch.analysis import paper_plots_multi as Tpm
from gpy_dla_detection_tpu_torch.analysis import tables as TT
from gpy_dla_detection_tpu_torch.analysis.comparison import ComparisonResult as TResult
from gpy_dla_detection_tpu_torch.data import synthetic as TS
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch
from gpy_dla_detection_tpu_torch.models.learned import LearnedModel, build_spectrum_model
from gpy_dla_detection_tpu_torch.params import Parameters

from .test_analysis_extras import _toy_parks
from .test_torch_cddf import same, toy_pair
from .test_torch_plotting import assert_same_data, figure_data

torch.set_num_threads(2)

REL_F64 = 1e-10


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


def test_resample_equal():
    """``test_resample_restores_and_preserves_shape`` and
    ``test_resample_preserves_z_distribution``: the same draws, the same
    resampled statistics, and the original restored."""
    jcat, tcat, _ = toy_pair(num_spec=40, S=200, seed=1)
    for cat in (jcat, tcat):
        cat.resample(True, rng=0)
    same(tcat._resample, jcat._resample)
    same(tcat.line_density(2.0, 3.5), jcat.line_density(2.0, 3.5))
    for cat in (jcat, tcat):
        cat.resample(False)
    same(tcat.line_density(2.0, 3.5), jcat.line_density(2.0, 3.5))

    jcat, tcat, _ = toy_pair(num_spec=60, S=100, seed=3)
    for cat in (jcat, tcat):
        cat._z_max = np.linspace(2.5, 5.5, 60)
        cat.resample(True, rng=np.random.default_rng(1), nspec=50)
    same(tcat._resample, jcat._resample)
    same(tcat.omega_dla_cddf(2.5, 5.0), jcat.omega_dla_cddf(2.5, 5.0))


def test_get_sample_errors_equal():
    jcat, tcat, _ = toy_pair(num_spec=40, S=200, seed=4)
    kw = dict(z_min=2.0, z_max=3.5, nsample=6, rng=0)
    same(tcat.get_sample_errors(**kw), jcat.get_sample_errors(**kw))
    assert tcat._resample is None


def _estimations_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for field in want.__dataclass_fields__:
        same(getattr(got, field), getattr(want, field))


def test_parks_estimators_equal():
    """``test_parks_cddf_analytic``, ``test_parks_line_density_analytic``
    and ``test_parks_snr_cut``: the estimations and both statistics."""
    parks = _toy_parks()
    snrs = np.where(np.arange(50) < 5, -5.0, 10.0)
    for kw in (dict(p_thresh=0.98), dict(our_snrs=snrs), dict(p_thresh=0.4, our_snrs=snrs)):
        got = TE.parks_estimations(parks, np.arange(50), **kw)
        want = JE.parks_estimations(parks, np.arange(50), **kw)
        _estimations_equal(got, want)
        for skw in (dict(z_min=2.0, z_max=3.0, lnhi_nbins=6, lnhi_min=20.0, lnhi_max=23.0),
                    dict(z_min=2.0, z_max=3.0, snr_thresh=0.0),
                    dict(z_min=2.0, z_max=3.0, apply_p_dlas=True)):
            same(TE.column_density_function_external(got, **skw),
                 JE.column_density_function_external(want, **skw))
        for lkw in (dict(z_min=2.0, z_max=3.0, bins_per_z=2), dict(snr_thresh=0.0)):
            same(TE.line_density_external(got, **lkw), JE.line_density_external(want, **lkw))
    same(TE.path_length_flat([2.0, 2.2], [3.0, 2.8], 2.1, 2.9),
         JE.path_length_flat([2.0, 2.2], [3.0, 2.8], 2.1, 2.9))
    assert (TE.LYA_A, TE.LYB_A, TE.LYMAN_LIMIT_A) == (JE.LYA_A, JE.LYB_A, JE.LYMAN_LIMIT_A)
    same(TE.make_unique_id([7339, 4000], [56000, 55000], [12, 3]),
         JE.make_unique_id([7339, 4000], [56000, 55000], [12, 3]))


def test_noterdaeme_estimations_equal():
    rows = np.array([[110, 2.7, 20.5], [115, 2.9, 21.0], [999, 2.8, 21.5]])
    args = (rows, np.arange(100, 160), np.arange(100, 160), np.full(60, 3.2))
    got, want = TE.noterdaeme_estimations(*args), JE.noterdaeme_estimations(*args)
    _estimations_equal(got, want)
    same(TE.line_density_external(got, z_min=2.5, z_max=3.1, bins_per_z=1),
         JE.line_density_external(want, z_min=2.5, z_max=3.1, bins_per_z=1))


def test_parks_json_round_trip_and_sub_dla_catalog_equal(tmp_path):
    import json

    mp = np.array([[0.05, 0.05, 0.9, 0.0], [0.9, 0.05, 0.05, 0.0]])
    records = TCT.generate_json_catalog(
        p_dlas=np.array([0.95, 0.02]), map_z_dlas=np.full((2, 2, 2), 2.5),
        map_log_nhis=np.full((2, 2, 2), 20.7), model_posteriors=mp,
        z_qsos=np.array([3.0, 3.1]))
    path = tmp_path / "parks.json"
    path.write_text(json.dumps(records + [{"plate": 7339, "mjd": 56000, "fiber_id": 12,
                                           "z_qso": 3.3, "dlas": [{"z_dla": 2.9,
                                                                   "column_density": 20.4}]}]))
    got, want = TE.load_parks_json(str(path)), JE.load_parks_json(str(path))
    same(got, want)
    assert got["ids"].size == 3 and np.sum(got["dla_confidences"] > 0.9) == 2

    mp = np.array([[0.2, 0.7, 0.1, 0.0], [0.8, 0.1, 0.1, 0.0], [0.1, 0.2, 0.7, 0.0],
                   [0.3, 0.4, 0.2, 0.1]])
    args = (mp, [3.0, 3.1, 3.2, 3.3], [10, 11, 12, 13], [5, 6, 7, 8])
    assert TCT.generate_sub_dla_catalog(*args) == JCT.generate_sub_dla_catalog(*args)


def test_multi_roc_equal():
    counts = np.array([0, 1, 2, 0, 1])
    perfect, anti = np.zeros((5, 6)), np.zeros((5, 6))
    for i, c in enumerate(counts):
        perfect[i, 0 if c == 0 else c + 1] = 1.0
        anti[i, 2 if c == 0 else 0] = 1.0
    noisy = np.random.default_rng(2).dirichlet(np.ones(6), size=40)
    for mp, truth in ((perfect, counts), (anti, counts), (noisy, np.arange(40) % 3)):
        for kw in (dict(sub_dla=1, max_k=4), dict(sub_dla=1, max_k=2)):
            same(Tpm.multi_roc(mp, truth, **kw), Jpm.multi_roc(mp, truth, **kw))
    assert Tpm.multi_roc(perfect, counts)[2] > 0.99 and Tpm.multi_roc(anti, counts)[2] < 0.5


def _recorder(monkeypatch, module):
    """``module.save_figure`` wrapped: what each saved figure draws, under
    its file name."""
    import matplotlib.pyplot as plt

    drawn, real = {}, module.save_figure

    def record(fname, fig=None):
        drawn[os.path.basename(fname)] = figure_data(fig if fig is not None else plt.gcf())
        return real(fname, fig)

    monkeypatch.setattr(module, "save_figure", record)
    return drawn


def _assert_same_figures(got, want, rel=0.0):
    assert sorted(got) == sorted(want)
    for name in want:
        assert_same_data(got[name], want[name], rel)


def test_multi_dla_paper_drivers_equal(tmp_path, monkeypatch):
    """``test_multi_dla_paper_drivers_render``: every driver's figures
    draw the reference's data and its data files are byte for byte."""
    rng = np.random.default_rng(0)
    fields = dict(fpr=np.linspace(0, 1, 10), tpr=np.sqrt(np.linspace(0, 1, 10)), auc=0.8,
                  confusion=np.array([[5, 1, 0], [1, 4, 1], [0, 1, 2]]),
                  delta_z=rng.normal(0, 0.003, 40), delta_log_nhi=rng.normal(0, 0.2, 40))
    counts = np.array([0, 1, 2, 0, 1])
    mp = np.zeros((5, 6))
    for i, c in enumerate(counts):
        mp[i, 0 if c == 0 else c + 1] = 1.0
    jcat, tcat, _ = toy_pair(num_spec=30, S=200)
    figures, returned = {}, {}
    for pm, ext, result, cat, name in ((Jpm, JE, JResult, jcat, "j"),
                                       (Tpm, TE, TResult, tcat, "t")):
        figures[name] = _recorder(monkeypatch, pm)
        sub = str(tmp_path / name)
        res = result(**fields)
        cat.bins_per_z = 2
        est = ext.parks_estimations(_toy_parks(), np.arange(50), p_thresh=0.98)
        pm.do_MAP_comparison(res, sub, label="concordance")
        pm.do_ROC_comparisons({"GP": res, "alt": res}, sub)
        pm.do_confusion(res, sub, label="parks")
        returned[name] = [pm.do_multi_ROC(mp, counts, sub),
                          pm.do_external_CDDF(cat, est, sub, label="parks"),
                          pm.do_external_dNdX(cat, est, sub, label="parks")]
        pm.do_external_snr_check(est, sub, label="parks")
    same(returned["t"], returned["j"])
    _assert_same_figures(figures["t"], figures["j"])
    made = sorted(os.listdir(tmp_path / "t"))
    assert made == sorted(os.listdir(tmp_path / "j")) and len(made) == 11
    for f in ("cddf_parks.txt", "dndx_parks.txt"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


@pytest.fixture(scope="module")
def learned_pair():
    """The synthetic learned model as the reference's fields and as the
    port's float64 buffers on the CPU."""
    params = Parameters(num_dla_samples=16)
    return (params, JS.synthetic_learned_model(params),
            LearnedModel.from_numpy(TS.synthetic_learned_model(params), "cpu", torch.float64))


def test_procedure_and_this_mu_drivers_equal(learned_pair, tmp_path, monkeypatch):
    params, j_learned, t_learned = learned_pair
    obs = TS.synthetic_observation(params, TS.synthetic_learned_model(params), 3.0, seed=0,
                                   dlas=[(2.7, 21.0)])
    from gpy_dla_detection_tpu.data.spectrum import preprocess as j_preprocess

    j_model = j_build(j_learned, j_preprocess(*obs, 3.0, params), params)
    t_model = build_spectrum_model(
        t_learned, to_torch(TS.preprocess(*obs, 3.0, params), "cpu", torch.float64), params)
    figures = {}
    for pm, learned, model, name in ((Jpm, j_learned, j_model, "j"),
                                     (Tpm, t_learned, t_model, "t")):
        figures[name] = _recorder(monkeypatch, pm)
        pm.do_procedure_plots(learned, learned, str(tmp_path / name))
        pm.do_this_mu_examples(
            [model, model], params, map_z_dlas=[np.array([2.7]), np.array([2.7, np.nan])],
            map_log_nhis=[np.array([21.0]), np.array([21.0, np.nan])],
            subdir=str(tmp_path / name), truth_dlas=[{"concordance": [(2.7, 21.0)]}, None])
    _assert_same_figures(figures["t"], figures["j"], REL_F64)
    assert {"mu_omega_changes.pdf", "covariance_matrix.pdf", "this_mu_0.pdf",
            "this_mu_1.pdf"} <= set(os.listdir(tmp_path / "t"))


def test_latex_table_loaders_equal(tmp_path):
    """``test_latex_table_loaders``: the number formats, the data files
    ``do_data_plots`` writes (byte for byte), every table read from them
    and the three direct emitters."""
    for x in (0.0, 3.1e4, 0.5, 2.5e-5, np.nan, 12.0):
        assert TT.format_latex_num(x) == JT.format_latex_num(x)
        for y in (4.2e4, 0.7, np.inf):
            assert TT.format_latex_two_num(x, y) == JT.format_latex_two_num(x, y)
    jcat, tcat, _ = toy_pair(num_spec=30, S=200)
    for pp, cat, name in ((Jpp, jcat, "j"), (Tpp, tcat, "t")):
        cat.bins_per_z = 2
        pp.do_data_plots(cat, str(tmp_path / name))
    for f in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes() or \
            f.endswith(".pdf"), f
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    # a table's label is its file's path
    assert TT.all_tables(t) == JT.all_tables(j).replace(j, t)
    assert TT.all_tables(t).count("\\begin{table*}") >= 3
    for loader, args in (("load_table", ("dndx_all.txt", ("$z$", "dN/dX"), "dndx")),
                         ("load_table", ("omega_dla_all.txt", ("$z$", "omega"), "omega", True)),
                         ("load_cddf_table", ("cddf_all.txt", "CDDF"))):
        got = getattr(TT, loader)(os.path.join(t, args[0]), *args[1:])
        assert got == getattr(JT, loader)(os.path.join(j, args[0]), *args[1:]).replace(j, t)
    cddf, dndx, omega = (tcat.column_density_function(), tcat.line_density(),
                         tcat.omega_dla())
    assert TT.cddf_table(*cddf[:4]) == JT.cddf_table(*cddf[:4])
    assert TT.line_density_table(*dndx[:4]) == JT.line_density_table(*dndx[:4])
    assert TT.omega_table(*omega) == JT.omega_table(*omega)
    mp = np.zeros((3, 1, 1)) + 2.5
    args = ([7, 8, 9], [3.0, 3.1, 3.2], [0.95, 0.2, 0.99], mp, mp + 18.0)
    assert TT.detection_table(*args, max_rows=1) == JT.detection_table(*args, max_rows=1)


def test_map_from_samples_equal():
    """``test_map_from_samples_matches_injected_peak`` in chunks of 7, and
    the two-level catalog at k = 1 and 2 with a failed spectrum."""
    jcat, tcat, (detected, picked, offsets, lnhi) = toy_pair(num_spec=25, S=300)
    got = tcat.map_from_samples(chunk=7)
    same(got, jcat.map_from_samples(chunk=7))
    z_expect = 2.0 + 1.5 * offsets[picked]
    np.testing.assert_array_equal(got[0][detected], z_expect[detected])
    arrays = TS.synthetic_processed_catalog(20, 300, seed=5)
    from gpy_dla_detection_tpu.analysis.cddf import ProcessedCatalog as JCat
    from gpy_dla_detection_tpu_torch.analysis.cddf import ProcessedCatalog as TCat

    for second in (0, 1):
        got = TCat(**arrays, max_k=2).map_from_samples(second, chunk=6)
        same(got, JCat(**arrays, max_k=2).map_from_samples(second, chunk=6))
        assert np.isnan(got[0][-1]) and np.isfinite(got[0][:-1]).all()


def test_meanflux_and_lyseries_drivers_equal(learned_pair, tmp_path, monkeypatch):
    params, j_learned, t_learned = learned_pair
    wl, fx, _, _ = TS.synthetic_observation(params, TS.synthetic_learned_model(params), 3.2,
                                            seed=5)
    figures, mus = {}, {}
    for pm, learned, name in ((Jpm, j_learned, "j"), (Tpm, t_learned, "t")):
        figures[name] = _recorder(monkeypatch, pm)
        pm.do_meanflux_samples(learned, wl, fx, 3.2, str(tmp_path / name), tag="5")
        mus[name] = pm.do_lyman_series_suppression(learned, wl, fx, 3.2, str(tmp_path / name),
                                                   tag="5")
    _assert_same_figures(figures["t"], figures["j"], REL_F64)
    for got, want in zip(mus["t"], mus["j"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=REL_F64 * np.abs(want).max())
    mu31, mu1 = mus["t"]
    rest = TS.synthetic_learned_model(params).rest_wavelengths
    assert np.all(mu31 <= mu1 + 1e-12) and np.any(mu31[rest < 1025.0] < mu1[rest < 1025.0] - 1e-9)
    assert {"meanflux_5.pdf", "test_num_lines_5.pdf"} <= set(os.listdir(tmp_path / "t"))


def test_lya_demo_and_skyline_check_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    observations, z_qsos = [], [2.3, 3.1, 4.2, 3.3]
    for _ in z_qsos:
        wl = 3600.0 * 10 ** (1e-4 * np.arange(3000))
        flux = np.ones_like(wl) + 0.05 * rng.normal(size=wl.size)
        observations.append((wl, flux, np.full_like(wl, 0.01), np.zeros(wl.size, bool)))
    figures, plotted = {}, {}
    for pm, name in ((Jpm, "j"), (Tpm, "t")):
        figures[name] = _recorder(monkeypatch, pm)
        plotted[name] = pm.do_Lya_demo(observations, z_qsos, str(tmp_path / name), zmin=2.0,
                                       zmax=5.0, nbins=3, num_spec_bin=2)
    assert plotted["t"] == plotted["j"] == 4
    _assert_same_figures(figures["t"], figures["j"])

    wl, flux, nv, msk = observations[1]
    flux = flux.copy()
    flux[1200] = -12.0
    observations[1] = (wl, flux, nv, msk)
    map_z = np.full((4, 2), np.nan)
    map_z[1, 0] = wl[1200] / 1215.6701 - 1.0 + 0.002
    map_z[2, 0] = 3.0
    got = Tpm.check_skylines(observations, map_z)
    assert got == Jpm.check_skylines(observations, map_z) == [(1, float(map_z[1, 0]))]


@pytest.fixture(scope="module")
def processed_files(tmp_path_factory):
    """A two-level processed catalog in this framework's layout, its QMC
    sample file and an SNR file."""
    h5py = pytest.importorskip("h5py")
    d = tmp_path_factory.mktemp("analysis")
    arrays = TS.synthetic_processed_catalog(40, 400, seed=3)
    with h5py.File(d / "processed.h5", "w") as f:
        f["min_z_dlas"], f["max_z_dlas"] = arrays["min_z_dlas"], arrays["max_z_dlas"]
        f["sample_log_likelihoods_dla"] = arrays["sample_log_likelihoods"]
        f["log_likelihoods_dla"] = arrays["log_likelihoods_dla"]
        f["model_posteriors"] = arrays["model_posteriors"]
        f["base_sample_inds"] = arrays["base_sample_inds"].astype(np.int32)
    with h5py.File(d / "samples.h5", "w") as f:
        f["offset_samples"] = arrays["offset_samples"][:, None]
        f["log_nhi_samples"] = arrays["log_nhi_samples"][:, None]
    with h5py.File(d / "snrs.h5", "w") as f:
        f["snrs"] = np.random.default_rng(3).uniform(-1.0, 8.0, (1, 40))
    return d


@pytest.mark.parametrize("quick", [False, True])
def test_run_analysis_writes_the_reference_files(processed_files, quick):
    """Both CLIs on one processed file (with ``--compare``, SNRs, both DLA
    levels): the same file names, every ``.txt`` data file and
    ``tables.tex`` byte for byte (the PDFs only exist: their metadata
    differs)."""
    d = processed_files
    outs = {}
    for mod, name in ((J_ra, "j"), (T_ra, "t")):
        # one output directory for both, renamed after each run: a table's
        # label is its data file's path
        out = d / f"figures_{quick}"
        mod.main(["--processed", str(d / "processed.h5"), "--samples", str(d / "samples.h5"),
                  "--snrs", str(d / "snrs.h5"), "--out", str(out), "--max-k", "2",
                  "--bins-per-z", "2", "--tables", str(out / "tables.tex"),
                  "--compare", str(d / "processed.h5"), "--compare-label", "alt"]
                 + (["--quick"] if quick else []))
        outs[name] = out.rename(d / f"{name}_{quick}")
    made = sorted(os.listdir(outs["t"]))
    assert made == sorted(os.listdir(outs["j"]))
    data = [f for f in made if f.endswith((".txt", ".tex"))]
    assert "tables.tex" in data and "omega_dla_all.txt" in data
    assert len(made) > (12 if quick else 30)
    for f in data:
        assert (outs["t"] / f).read_bytes() == (outs["j"] / f).read_bytes(), f
    assert (outs["t"] / "tables.tex").read_text().count("\\begin{table*}") >= 3
