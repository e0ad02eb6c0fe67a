"""The port's ``plotting`` against the JAX package's, by the data the
figures draw: the cases of ``tests/test_plotting.py`` (every plot, the
split and bootstrap plots, the paper-figure drivers), the curve functions
on their own, and the catalog CLI's ``--plot-figures`` against the JAX
CLI's.

Each figure is compared by what it draws (:func:`figure_data`: every
line's x-y data, every collection's offsets, paths and colour values,
images, texts and labels), not only by rendering.  Tolerances:
* arrays that reach the plot unchanged, and every figure of a catalog:
  bit for bit;
* the model curves in float64 (the port's exact Voigt profile, K5's plain
  float64 composition on the CPU, against the JAX package's): within 1e-10
  of the array's largest magnitude, the tolerance of
  ``tests/test_torch_voigt_tail.py``'s float64 profiles;
* the curves in float32 (K5's twin on the CPU): held as that file's
  ``_check`` holds a float32 profile, to JAX float64 as JAX float32 is
  (1.5x its error, or 2e-6) and to JAX float32 within 2e-6 on all but
  1e-3 of the pixels.
The CLI figures are drawn from catalogs whose chained levels use the same
resampling indices (``test_torch_cli._feed_jax_indices``), at float64.
"""

import os
import sys

import jax.numpy as jnp
import matplotlib
import matplotlib.figure
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from gpy_dla_detection_tpu import plotting as JP  # noqa: E402
from gpy_dla_detection_tpu import run_bayes_select as J_rbs  # noqa: E402
from gpy_dla_detection_tpu.analysis import paper_plots as Jpp  # noqa: E402
from gpy_dla_detection_tpu.data import synthetic as JS  # noqa: E402
from gpy_dla_detection_tpu.models import learned as JL  # noqa: E402
from gpy_dla_detection_tpu.ops import optical_depth as JOD  # noqa: E402
from gpy_dla_detection_tpu.ops import voigt as JV  # noqa: E402
from gpy_dla_detection_tpu_torch import plotting as TP  # noqa: E402
from gpy_dla_detection_tpu_torch import run_bayes_select as T_rbs  # noqa: E402
from gpy_dla_detection_tpu_torch.analysis import paper_plots as Tpp  # noqa: E402
from gpy_dla_detection_tpu_torch.data import synthetic as TS  # noqa: E402
from gpy_dla_detection_tpu_torch.data.spectrum import to_torch  # noqa: E402
from gpy_dla_detection_tpu_torch.models.learned import (  # noqa: E402
    LearnedModel,
    build_spectrum_model,
)
from gpy_dla_detection_tpu_torch.ops import _build  # noqa: E402
from gpy_dla_detection_tpu_torch.params import Parameters  # noqa: E402

from .test_torch_cddf import toy_pair  # noqa: E402
from .test_torch_cli import _feed_jax_indices, _write  # noqa: E402

torch.set_num_threads(2)

REL_F64 = 1e-10
TOL_F32 = 2e-6
F32_OUTLIER_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


def figure_data(fig):
    """What a figure draws, axes by axes in drawing order, as (kind,
    value) pairs."""
    out = []
    for ax in fig.axes:
        out += [("line", line.get_xydata()) for line in ax.lines]
        for coll in ax.collections:
            out.append(("offsets", np.asarray(coll.get_offsets(), np.float64)))
            out += [("path", path.vertices) for path in coll.get_paths()]
            if coll.get_array() is not None:
                out.append(("array", np.ma.getdata(coll.get_array())))
        out += [("image", np.ma.getdata(image.get_array())) for image in ax.images]
        out += [("text", text.get_text()) for text in ax.texts]
        out.append(("labels", (ax.get_xlabel(), ax.get_ylabel(), ax.get_title(),
                               ax.get_xscale(), ax.get_yscale())))
    return out


def assert_same_drawing(got, want, rel=0.0):
    """Two figures draw the same data (:func:`assert_same_data`)."""
    assert_same_data(figure_data(got), figure_data(want), rel)


def assert_same_data(g, w, rel=0.0):
    """The same kinds in the same order; texts equal; arrays of equal
    shape, NaN where the other has NaN, and bit for bit (``rel`` 0) or
    within ``rel`` of the array's largest magnitude."""
    assert [k for k, _ in g] == [k for k, _ in w]
    for (kind, a), (_, b) in zip(g, w):
        if kind in ("text", "labels"):
            assert a == b
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, kind
        if rel == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=kind)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=kind)
        scale = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=kind)


def _fig(drawn):
    """A plot function's figure, from what it returns (a figure or axes)."""
    return drawn if isinstance(drawn, matplotlib.figure.Figure) else drawn.figure


@pytest.fixture(scope="module")
def models():
    """One spectrum with a DLA at full width, as the JAX package's float64
    model and the port's float64 model on the CPU; the observation and
    both learned models."""
    params = Parameters(num_dla_samples=80)
    obs = TS.synthetic_observation(params, TS.synthetic_learned_model(params), 3.0, seed=2,
                                   dlas=[(2.7, 21.0)])
    j_learned = JS.synthetic_learned_model(params)
    t_learned = LearnedModel.from_numpy(TS.synthetic_learned_model(params), "cpu", torch.float64)
    spec = TS.preprocess(*obs, 3.0, params)
    from gpy_dla_detection_tpu.data.spectrum import preprocess as j_preprocess

    j_model = JL.build_spectrum_model(j_learned.astype(np.float64),
                                      j_preprocess(*obs, 3.0, params), params)
    t_model = build_spectrum_model(t_learned, to_torch(spec, "cpu", torch.float64), params)
    return params, obs, spec, j_learned, t_learned, j_model, t_model


def test_all_plots_draw_the_reference_data(models):
    """``test_all_plots_render``'s figures with the same inputs: the
    sample-likelihood scatter and MAP-absorbed mean, the corner plot, the
    posterior draws, the CDDF family, ROC and confusion, the annotated
    spectrum, the external overlays and the correlation heatmap."""
    params, (wl, fx, _, _), spec, j_learned, t_learned, j_model, t_model = models
    rng = np.random.default_rng(3)
    S = params.num_dla_samples
    z_s = float(spec.min_z_dla) + (float(spec.max_z_dla) - float(spec.min_z_dla)) * rng.uniform(
        size=S)
    lnhi = rng.uniform(20.0, 22.5, S)
    sll = rng.normal(-500.0, 5.0, (S, 2))
    sll[::7] = np.nan
    map_z = np.array([[2.7, np.nan], [2.7, 2.45]])
    map_n = np.array([[21.0, np.nan], [21.0, 20.5]])

    assert_same_drawing(_fig(TP.plot_raw_spectrum(wl, fx, 3.0)),
                        _fig(JP.plot_raw_spectrum(wl, fx, 3.0)))
    for nth in (0, 1, 2):
        kw = dict(sample_z_dlas=z_s, log_nhi_samples=lnhi, sample_log_likelihoods=sll,
                  map_z_dlas=map_z, map_log_nhis=map_n, nth_dla=nth, title="t", label="l")
        assert_same_drawing(TP.plot_dla_model(t_model, params, **kw),
                            JP.plot_dla_model(j_model, params, **kw), REL_F64)
    chain = rng.normal(size=(50, 8, 2)) + [2.7, 21.0]
    assert_same_drawing(TP.plot_corner(chain, labels=["z", "logNHI"], burn_in=10),
                        JP.plot_corner(chain, labels=["z", "logNHI"], burn_in=10))
    chain2 = np.concatenate([chain, chain[..., ::-1] * [1, 0.1] + [0, -0.3]], axis=-1)
    for ch, k in ((chain, 5), (torch.as_tensor(chain2), 4)):
        assert_same_drawing(
            TP.plot_sample_predictions(ch, t_model, params, n_draws=k, burn_in=3, seed=1),
            JP.plot_sample_predictions(np.asarray(ch), j_model, params, n_draws=k, burn_in=3,
                                       seed=1), REL_F64)

    l_cent = np.linspace(20.4, 22.6, 5)
    cddf = 10.0 ** (-21 - (l_cent - 20.4))
    band = np.stack([cddf * 0.5, cddf * 2], axis=1)
    z_cent = np.array([2.2, 2.6, 3.0])
    dndx = np.array([0.05, 0.06, 0.07])
    dband = np.stack([dndx * 0.7, dndx * 1.3], axis=1)
    from gpy_dla_detection_tpu_torch.analysis.catalog_tools import roc_curve

    fpr, tpr, _, auc = roc_curve(np.array([0.9, 0.2, 0.8, 0.1, 0.7]),
                                 np.array([1, 0, 1, 0, 0], bool))
    truth = {"concordance": [(2.7, 21.0)], "parks": [(2.69, 20.9), (2.9, 20.4)]}
    cases = [
        ("plot_cddf", (l_cent, cddf, band, band, (cddf * 0, cddf * 0)), {}),
        ("plot_line_density", (z_cent, dndx, dband, dband, (z_cent * 0, z_cent * 0)), {}),
        ("plot_omega_dla", (z_cent, dndx * 1e-2, dndx * 1e-3), {}),
        ("plot_roc", (fpr, tpr, auc), {}),
        ("plot_confusion", (np.array([[5, 1], [2, 7]]),), {}),
        ("plot_confusion", (np.array([[5, 1], [2, 7]]),), {"normalize": True}),
        ("plot_cddf_external", (l_cent, cddf, (cddf * 0, cddf * 0)), {}),
        ("plot_cddf_external", (l_cent, cddf, (cddf * 0, cddf * 0)), {"moment": True}),
        ("plot_line_density_external", (z_cent, dndx, (z_cent * 0, z_cent * 0)), {}),
    ]
    for name, args, kw in cases:
        assert_same_drawing(_fig(getattr(TP, name)(*args, **kw)),
                            _fig(getattr(JP, name)(*args, **kw)))
    for map_args in ((map_z[1], map_n[1]), (map_z[0, 1:], map_n[0, 1:]), (None, None)):
        assert_same_drawing(
            _fig(TP.plot_annotated_spectrum(t_model, params, *map_args, truth_dlas=truth)),
            _fig(JP.plot_annotated_spectrum(j_model, params, *map_args, truth_dlas=truth)),
            REL_F64)
    C = TP.build_correlation_matrix(t_learned.M)
    np.testing.assert_array_equal(C, JP.build_correlation_matrix(np.asarray(j_learned.M)))
    np.testing.assert_allclose(np.diag(C), 1.0, rtol=1e-10)
    assert_same_drawing(_fig(TP.plot_model_correlation(t_learned.rest_wavelengths, t_learned.M)),
                        _fig(JP.plot_model_correlation(j_learned.rest_wavelengths, j_learned.M)))


def test_split_and_bootstrap_plots_draw_the_reference_data():
    jcat, tcat, _ = toy_pair(num_spec=30, S=150, seed=7)
    jcat.snrs = tcat.snrs = np.full(30, 5.0)
    cases = [
        ("plot_cddf_by_z", dict(z_edges=(2.0, 2.8, 3.5), lnhi_nbins=6)),
        ("plot_cddf_by_snr", dict(snr_threshs=(-2.0, 2.0), z_min=2.0, z_max=3.5, lnhi_nbins=6)),
        ("plot_dndx_sample_errors", dict(z_min=2.0, z_max=3.5, nsample=3)),
        ("plot_omega_sample_errors", dict(z_min=2.0, z_max=3.5, nsample=3)),
    ]
    for name, kw in cases:
        assert_same_drawing(_fig(getattr(TP, name)(tcat, **kw)),
                            _fig(getattr(JP, name)(jcat, **kw)))
    assert tcat.snr_thresh == -2.0 and tcat._resample is None


def test_paper_plot_drivers_write_the_reference_files(tmp_path):
    """``make_all_plots`` and ``do_compare_plots`` on the toy catalog: the
    same figure files, the data tables byte for byte, the catalog's state
    restored."""
    made = {}
    jcat, tcat, _ = toy_pair(num_spec=30, S=200)
    jcat2, tcat2, _ = toy_pair(num_spec=30, S=200, seed=1)
    for mod, cat, other, name in ((Jpp, jcat, jcat2, "j"), (Tpp, tcat, tcat2, "t")):
        cat.bins_per_z = other.bins_per_z = 2
        before = (cat.snr_thresh, cat.lowzcut, cat.max_k, cat.p_thresh_sample,
                  cat.p_thresh_spec, cat.condition)
        sub = tmp_path / name
        mod.make_all_plots(cat, str(sub))
        assert before == (cat.snr_thresh, cat.lowzcut, cat.max_k, cat.p_thresh_sample,
                          cat.p_thresh_spec, cat.condition)
        mod.do_compare_plots(cat, other, str(sub), label="alt")
        made[name] = sorted(os.listdir(sub))
    assert made["t"] == made["j"] and "omega_alt.pdf" in made["t"]
    txt = [f for f in made["t"] if f.endswith(".txt")]
    assert {"cddf_all.txt", "cddf_z34.txt", "dndx_all.txt", "omega_dla_all.txt"} <= set(txt)
    for f in txt:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def _check_f32(got32, jax32, f64):
    err_port = np.abs(got32.astype(np.float64) - f64).max()
    err_jax = np.abs(jax32.astype(np.float64) - f64).max()
    assert err_port <= 1.5 * max(err_jax, TOL_F32), (err_port, err_jax)
    assert np.mean(np.abs(got32 - jax32) > TOL_F32) <= F32_OUTLIER_SHARE


def test_curve_functions_match_jax(models):
    """``absorbed_mean``, ``sample_prediction_curves`` and
    ``mean_flux_curve`` in float64 against the JAX package's composition
    within 1e-10, and in float32 (K5's twin) at the float32 bound; the
    twin's launches are not counted (nothing launched on the CPU)."""
    params, obs, spec, j_learned, t_learned, j_model, t_model = models
    z = np.array([2.7, 2.45, 2.9])
    lnhi = np.array([21.0, 20.5, 20.3])
    # Module.to casts in place: the float32 model is a model of its own
    t_learned32 = LearnedModel.from_numpy(TS.synthetic_learned_model(params), "cpu",
                                          torch.float32)
    t32 = build_spectrum_model(t_learned32, to_torch(spec, "cpu", torch.float32), params)

    def jax_absorbed(model, dtype):
        wl = np.asarray(model.padded_wavelengths, dtype)
        a = np.asarray(JV.voigt_absorption(jnp.asarray(wl), jnp.asarray((10.0**lnhi).astype(dtype)),
                                           jnp.asarray(z.astype(dtype)), params.num_lines,
                                           impl="exact"))
        return np.asarray(model.mu, dtype) * np.prod(a, axis=0)

    _build.reset_launch_counts()
    got = TP.absorbed_mean(t_model, params, z, lnhi).numpy()
    want = jax_absorbed(j_model, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_F64 * np.abs(want).max())
    got32 = TP.absorbed_mean(t32, params, torch.as_tensor(z), lnhi)
    assert got32.dtype == torch.float32
    _check_f32(got32.numpy(), jax_absorbed(t32, np.float32), want)
    assert torch.equal(TP.absorbed_mean(t_model, params, z[:0], lnhi[:0]), t_model.mu)

    chain = np.random.default_rng(4).normal(size=(30, 6, 2)) * [0.05, 0.3] + [2.7, 21.0]
    curves = TP.sample_prediction_curves(chain, t_model, params, n_draws=16, burn_in=5, seed=3)
    idx = np.random.default_rng(3).integers(0, 25 * 6, size=16)
    draws = chain[5:].reshape(-1, 2)[idx]
    a64 = np.asarray(JV.voigt_absorption(jnp.asarray(np.asarray(j_model.padded_wavelengths)),
                                         jnp.asarray(10.0 ** draws[:, 1]), jnp.asarray(draws[:, 0]),
                                         params.num_lines, impl="exact"))
    want = np.asarray(j_model.mu) * a64
    assert curves.shape == want.shape
    np.testing.assert_allclose(curves.numpy(), want, rtol=0, atol=REL_F64 * np.abs(want).max())
    curves32 = TP.sample_prediction_curves(chain, t32, params, n_draws=16, burn_in=5, seed=3)
    wl32 = np.asarray(t32.padded_wavelengths)
    a32 = np.asarray(JV.voigt_absorption(jnp.asarray(wl32), jnp.asarray(10.0 ** draws[:, 1].astype(
        np.float32)), jnp.asarray(draws[:, 0].astype(np.float32)), params.num_lines, impl="exact"))
    _check_f32(curves32.numpy(), np.asarray(t32.mu) * a32, want)

    for num_lines, suppressed in ((31, True), (1, True), (31, False)):
        rest, mu = TP.mean_flux_curve(t_learned, 3.2, suppressed, num_lines)
        j_rest, j_mu = JP.plot_mean_flux(j_learned, obs[0], obs[1], 3.2, suppressed, num_lines)
        np.testing.assert_array_equal(rest.numpy(), j_rest)
        np.testing.assert_allclose(mu.numpy(), j_mu, rtol=0, atol=REL_F64 * np.abs(j_mu).max())
        rest32, mu32 = TP.mean_flux_curve(t_learned32, 3.2, suppressed, num_lines)
        assert mu32.dtype == torch.float32
        j32 = np.asarray(j_learned.mu, np.float32)
        if suppressed:
            j32 = j32 * np.asarray(JOD.mean_flux_suppression(
                jnp.asarray(np.asarray(j_learned.rest_wavelengths, np.float32) * np.float32(4.2)),
                np.float32(np.exp(j_learned.log_beta)), np.float32(np.exp(j_learned.log_tau_0)),
                3.2, num_lines))
        _check_f32(mu32.numpy(), j32, j_mu)
    assert sum(_build.launch_counts.values()) == 0


@pytest.fixture(scope="module")
def figure_spectra(tmp_path_factory):
    d = tmp_path_factory.mktemp("figures")
    params = Parameters(num_dla_samples=60)
    learned = TS.synthetic_learned_model(params)
    zs = (2.9, 3.15, 3.3)
    files = [_write(d / f"spec-0001-55555-{i:04d}.fits", *TS.synthetic_observation(
        params, learned, z, seed=i, dlas=[(z - 0.3, 21.2)] if i % 2 else None))
        for i, z in enumerate(zs)]
    return d, files, [str(z) for z in zs]


def _catalog_argv(files, zs, out):
    return ["--qso_list", *files, "--z_qso_list", *zs, "--max_dlas", "2", "--num-samples", "60",
            "--batch-size", "2", "--dtype", "float64", "--plot-figures", "--output", str(out)]


def _recording(monkeypatch, module):
    """``module.plot_dla_model`` wrapped: the figures it draws, each as
    :func:`figure_data`."""
    figures = []
    real = module.plot_dla_model

    def record(*a, **k):
        fig = real(*a, **k)
        figures.append(figure_data(fig))
        return fig

    monkeypatch.setattr(module, "plot_dla_model", record)
    return figures


@pytest.fixture(scope="module")
def jax_figures(figure_spectra):
    """The JAX CLI's float64 catalog with ``--plot-figures``, and what its
    figures draw."""
    d, files, zs = figure_spectra
    out = d / "jax.h5"
    with pytest.MonkeyPatch.context() as mp:
        figures = _recording(mp, JP)
        J_rbs.main(_catalog_argv(files, zs, out))
    return out, figures


@pytest.mark.parametrize("checkpoint", [False, True])
def test_plot_figures_cli_matches_jax(figure_spectra, jax_figures, monkeypatch, checkpoint):
    """``--plot-figures`` on ``--device cpu --dtype float64`` (and resumed
    from its part files): one PNG a spectrum under the same names, and
    every figure's data within 1e-10 of the JAX CLI's float64 figure's."""
    d, files, zs = figure_spectra
    jax_out, want = jax_figures
    got = _recording(monkeypatch, TP)
    _feed_jax_indices(monkeypatch, jax_out)
    out = d / f"torch_{checkpoint}.h5"
    extra = ["--device", "cpu"] + (["--checkpoint"] if checkpoint else [])
    T_rbs.main(_catalog_argv(files, zs, out) + extra)
    if checkpoint:  # again, every batch from its part file
        del got[:]
        T_rbs.main(_catalog_argv(files, zs, out) + extra)
    assert len(got) == len(want) == len(files)
    for g, w in zip(got, want):
        assert_same_data(g, w, REL_F64)
    names = sorted(os.listdir(f"{out}_figures"))
    assert names == sorted(os.listdir(f"{jax_out}_figures")) == [
        os.path.basename(f).replace(".fits", ".png") for f in files]


def test_plot_figures_stops_before_any_spectrum_without_matplotlib(figure_spectra, monkeypatch,
                                                                  capsys):
    """Where matplotlib does not import, ``--plot-figures`` stops at its
    argument parsing with a clear message: no device chosen, no metrics
    sidecar, no spectrum read."""
    d, files, zs = figure_spectra
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    read = []
    monkeypatch.setattr(T_rbs, "spec_reader", lambda release: read.append(release))
    out = d / "nompl.h5"
    with pytest.raises(SystemExit) as e:
        T_rbs.run(["--qso_list", *files, "--z_qso_list", *zs, "--plot-figures",
                   "--device", "cpu", "--output", str(out)])
    assert e.value.code == 2
    assert "--plot-figures draws with matplotlib" in capsys.readouterr().err
    assert read == [] and not os.path.exists(f"{out}.metrics.jsonl")
