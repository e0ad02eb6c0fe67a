"""The port stands alone: its copies of the JAX package's numpy modules
give the reference's values, and it names no module of the JAX package
(tests/test_torch_pipeline.py::test_port_runs_without_jax runs it with
both ``jax`` and ``gpy_dla_detection_tpu`` blocked).

The copies are held bit for bit (``array_equal``, ``==``): they are the
same numpy code on the same inputs.
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
from gpy_dla_detection_tpu.data import catalog as JCat
from gpy_dla_detection_tpu.data import samples as JS
from gpy_dla_detection_tpu.data import spectrum as JSpec
from gpy_dla_detection_tpu.models import lls as JL
from gpy_dla_detection_tpu.models import selection as JSel
from gpy_dla_detection_tpu.ops import kernel_config as JK
from gpy_dla_detection_tpu_torch import constants as TC
from gpy_dla_detection_tpu_torch import params as TP
from gpy_dla_detection_tpu_torch.data import catalog as TCat
from gpy_dla_detection_tpu_torch.data import samples as TS
from gpy_dla_detection_tpu_torch.data import spectrum as TSpec
from gpy_dla_detection_tpu_torch.data.synthetic import (
    synthetic_learned_model,
    synthetic_observation,
)
from gpy_dla_detection_tpu_torch.models import lls as TL
from gpy_dla_detection_tpu_torch.models import selection as TSel
from gpy_dla_detection_tpu_torch.ops import kernel_config as TK

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


def _imports_of(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_names_no_module_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "scripts" / "kernel_ablate_torch.py"]
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
