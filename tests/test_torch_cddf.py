"""The port's ``analysis/cddf`` against the JAX package's on the same
inputs: every case of ``tests/test_cddf.py`` (the Poisson-binomial
machinery, intervals, the path-length integrand, the toy catalog's
statistics, the CDDF-summed Omega_DLA, noisy-pixel filtering and both
file layouts of ``from_file``), and the golden fixture of the science
stage.

Tolerances: the copy is the reference's numpy and scipy code, so on the
same inputs in one process every output is held bit for bit
(``array_equal``, NaN where the reference has NaN).  The golden fixture
(``tests/data/torch_golden_analysis.npz``, the JAX package's float64
statistics written by ``scripts/make_torch_golden.py analysis``) is held
within rtol 1e-10, the tolerance ``chip_smoke.py`` holds the card's
machine to, where numpy and scipy may be other versions.
"""

from pathlib import Path

import numpy as np
import pytest

from gpy_dla_detection_tpu.analysis import cddf as JC
from gpy_dla_detection_tpu.analysis import tables as JT
from gpy_dla_detection_tpu_torch.analysis import cddf as TC
from gpy_dla_detection_tpu_torch.analysis import tables as TT
from gpy_dla_detection_tpu_torch.data.synthetic import (
    catalog_statistics,
    synthetic_processed_catalog,
)

from . import test_cddf

GOLDEN = Path(__file__).resolve().parent / "data" / "torch_golden_analysis.npz"
GOLDEN_RTOL = 1e-10


def same(got, want):
    """Bit for bit, recursively through tuples, lists and dicts."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            same(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (got, want)
        assert np.array_equal(got, want, equal_nan=want.dtype.kind in "fc"), (got, want)
    else:
        assert got == want or (got != got and want != want), (got, want)


def toy_pair(num_spec=40, S=500, seed=0):
    """The JAX and the port's ``ProcessedCatalog`` on the arrays of
    ``tests/test_cddf.py::_toy_catalog`` (its construction run once, its
    constructor call recorded), and the toy's truth."""
    calls = []
    real = test_cddf.ProcessedCatalog
    test_cddf.ProcessedCatalog = lambda *a, **k: calls.append((a, k))
    try:
        _, *truth = test_cddf._toy_catalog(num_spec=num_spec, S=S, seed=seed)
    finally:
        test_cddf.ProcessedCatalog = real
    (args, kw), = calls
    return JC.ProcessedCatalog(*args, **kw), TC.ProcessedCatalog(*args, **kw), truth


def test_poisson_binomial_equal():
    rng = np.random.default_rng(0)
    ragged = [rng.uniform(0.3, 0.95, size=7), rng.uniform(0.25, 0.8, size=4)]
    for pp in (ragged, [np.full(12, 0.4)], [rng.uniform(size=301)], [np.array([0.7])], []):
        same(TC.poisson_binomial_pdf(pp), JC.poisson_binomial_pdf(pp))
    from scipy.stats import binom

    np.testing.assert_allclose(TC.poisson_binomial_pdf([np.full(12, 0.4)]),
                               binom.pmf(np.arange(13), 12, 0.4), atol=1e-10)


def test_interval_and_confidence_equal():
    pdf = np.array([0.05, 0.1, 0.2, 0.3, 0.2, 0.1, 0.05])
    cdf = np.cumsum(pdf)
    for level in [0.0, 0.68, 0.95, 1 - 1e-4]:
        for offset in (0, 3):
            same(TC.interval(cdf, level, offset=offset), JC.interval(cdf, level, offset=offset))
    same(TC.interval(np.ones(1), 0.68, offset=2), JC.interval(np.ones(1), 0.68, offset=2))
    same(TC.pdf_confidence(pdf, 2), JC.pdf_confidence(pdf, 2))


def test_path_length_integrand_and_cosmology_equal():
    zs = np.linspace(0.0, 6.0, 13)
    same(TC.path_length_integrand(zs), JC.path_length_integrand(zs))
    same(TC.hubble_by_h0(zs, 0.3), JC.hubble_by_h0(zs, 0.3))
    assert (TC.rho_crit(0.7), TC.OMEGA_M) == (JC.rho_crit(0.7), JC.OMEGA_M)


@pytest.mark.parametrize("pmean", [0.0, 2.5, 40.0])
def test_combine_with_poisson_equal(pmean):
    pdf = TC.poisson_binomial_pdf([np.array([0.9, 0.8, 0.6])])
    got, want = TC.combine_with_poisson(pdf, pmean), JC.combine_with_poisson(pdf, pmean)
    same(got, want)
    assert 0.99 < got[0].sum() < 1.01 and got[1] >= 0


def test_catalog_statistics_equal():
    """``test_catalog_statistics_sane``'s toy catalog: the intervals, the
    line density, the CDDF, the path length, the moment histogram and
    Omega_DLA are the reference's."""
    jcat, tcat, _ = toy_pair()
    kw = dict(q_bins=np.array([2.0, 3.5]), lred=2.0, ured=3.5, lnhi_min=20.3)
    same(tcat.confidence_intervals(**kw), jcat.confidence_intervals(**kw))
    same(tcat.line_density(2.0, 3.5), jcat.line_density(2.0, 3.5))
    kw = dict(lnhi_nbins=10, lnhi_min=20.3, lnhi_max=23.0)
    same(tcat.column_density_function(2.0, 3.5, **kw),
         jcat.column_density_function(2.0, 3.5, **kw))
    same(tcat.path_length(2.0, 3.5), jcat.path_length(2.0, 3.5))
    kw = dict(q_bins=np.linspace(2.0, 3.5, 4), lred=2.0, ured=3.5, moment=True)
    same(tcat.z_nhi_histogram(**kw), jcat.z_nhi_histogram(**kw))
    same(tcat.omega_dla(2.0, 3.5), jcat.omega_dla(2.0, 3.5))
    for attr in ("model_posteriors", "p_dla", "p_no_dla", "base_sample_inds"):
        same(getattr(tcat, attr), getattr(jcat, attr))


def test_omega_dla_cddf_equal():
    jcat, tcat, _ = toy_pair(num_spec=30, S=300, seed=2)
    same(tcat.omega_dla_cddf(2.0, 3.5), jcat.omega_dla_cddf(2.0, 3.5))
    tcat.lowzcut = jcat.lowzcut = True
    same(tcat.omega_dla_cddf(2.0, 3.5, lnhi_nbins=12), jcat.omega_dla_cddf(2.0, 3.5, lnhi_nbins=12))


def test_path_length_noisy_pixel_filtering_equal():
    jcat, tcat, _ = toy_pair(num_spec=4, S=50, seed=5)
    P = 100
    pn = [np.where(np.arange(P) < P // 2, 0.01, 1.0) for _ in range(4)]
    pn[1] = np.full(P, 0.01)  # a spectrum the filter leaves whole
    for cat in (jcat, tcat):
        cat.pixel_noise, cat.noise_thresh, cat.filter_noisy_pixels = pn, 0.25, True
    same(tcat.path_length(2.0, 3.5), jcat.path_length(2.0, 3.5))
    same(tcat.path_length(2.2, 3.0), jcat.path_length(2.2, 3.0))
    same(tcat.line_density(2.0, 3.5), jcat.line_density(2.0, 3.5))


def test_from_file_both_layouts_equal(tmp_path):
    """``test_from_file_reference_matlab_layout``'s two files: the port
    loads the same arrays as the reference from each."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    Q, S, K = 7, 40, 3
    min_z, max_z = np.full(Q, 2.0), np.full(Q, 3.5)
    sll = rng.normal(-50.0, 5.0, (Q, S, K))
    lld = rng.normal(-40.0, 3.0, (Q, K))
    mp = rng.uniform(0.01, 1.0, (Q, 2 + K))
    mp /= mp.sum(axis=1, keepdims=True)
    base0 = rng.integers(0, S, (Q, S, K - 1)).astype(np.int64)
    sample_file = str(tmp_path / "samples.h5")
    with h5py.File(sample_file, "w") as f:
        f["offset_samples"] = rng.uniform(size=S)[:, None]
        f["log_nhi_samples"] = rng.uniform(20.0, 22.5, size=S)[:, None]
    snrs_file = str(tmp_path / "snrs.h5")
    with h5py.File(snrs_file, "w") as f:
        f["snrs"] = rng.uniform(0, 10, Q)[None]
    native, matlab = str(tmp_path / "native.h5"), str(tmp_path / "matlab.h5")
    with h5py.File(native, "w") as f:
        f["min_z_dlas"], f["max_z_dlas"] = min_z, max_z
        f["sample_log_likelihoods_dla"] = sll
        f["log_likelihoods_dla"] = lld
        f["model_posteriors"] = mp
        f["base_sample_inds"] = base0
    with h5py.File(matlab, "w") as f:
        f["min_z_dlas"], f["max_z_dlas"] = min_z[None, :], max_z[None, :]
        f["sample_log_likelihoods_dla"] = sll.T
        f["log_likelihoods_dla"] = lld.T
        f["model_posteriors"] = mp.T
        f["base_sample_inds"] = base0.T + 1
    fields = ("_z_min", "_z_max", "sample_log_likelihoods", "log_likelihoods_dla",
              "base_sample_inds", "z_offsets", "lnhi_vals", "snrs", "model_posteriors", "p_dla")
    for path in (native, matlab):
        got = TC.ProcessedCatalog.from_file(path, sample_file, snrs_file, max_k=K)
        want = JC.ProcessedCatalog.from_file(path, sample_file, snrs_file, max_k=K)
        for name in fields:
            same(getattr(got, name), getattr(want, name))
        for spec in range(Q):
            for second in range(K):
                same(got.sample_params(spec, second), want.sample_params(spec, second))
        np.testing.assert_array_equal(got.base_sample_inds, base0)
    with pytest.raises(ValueError, match="sample_file required"):
        TC.ProcessedCatalog.from_file(native)


def _check_golden(stats, golden):
    for key, value in stats.items():
        want = golden[key]
        assert value.shape == want.shape, key
        if want.dtype.kind in "US":
            assert str(value) == str(want), key
            continue
        np.testing.assert_array_equal(np.isnan(value), np.isnan(want), err_msg=key)
        np.testing.assert_allclose(value, want, rtol=GOLDEN_RTOL, atol=0, err_msg=key)


def test_golden_statistics_regenerated_from_the_seed():
    """The fixture's catalog regenerated from its seed (its likelihood
    checksum equal), both packages' statistics at max_k = 2 bit for bit
    each other and within rtol 1e-10 of the stored JAX float64 ones."""
    golden = np.load(GOLDEN)
    arrays = synthetic_processed_catalog(int(golden["num_spec"]), int(golden["num_samples"]),
                                         int(golden["seed"]))
    assert np.nansum(arrays["sample_log_likelihoods"]) == golden["likelihood_checksum"]
    got = catalog_statistics(TC.ProcessedCatalog(**arrays, max_k=2), TT)
    want = catalog_statistics(JC.ProcessedCatalog(**arrays, max_k=2), JT)
    same(got, want)
    assert sorted(got) == sorted(k for k in golden.files if "." in k)
    _check_golden(got, golden)
    # the statistics see the catalog's structure: NaN where no path was
    # searched, a NaN MAP for the failed spectrum, both DLA levels found
    assert np.isnan(got["sample_errors.dndx_sample"][-1])
    assert np.isnan(got["map_k1.z"][-1]) and np.isfinite(got["map_k1.z"][:-1]).all()
    assert (got["line_density.dNdX"][:4] > 0).all()
