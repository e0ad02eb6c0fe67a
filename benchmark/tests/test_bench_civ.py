"""The ``civ.window`` cell's parts: its generator's checksums at a fixed seed,
its counts by hand at S = 10,000 and P = 774, the layout resolving every
part by name, its new readers on a made-up stretch, and the imports of its
reference, generator and ``drivers/civ.py``."""

import json

import numpy as np
import pytest

from harness import counts, counts_civ, gen, gen_civ, layout, spans
from harness.result import Readings
from harness.trace import Record, Trace

SEED = 2**31 + 12345
S, P, N, K = 10_000, 774, 768, 20


@pytest.fixture(scope="module")
def cell():
    return layout.find_cell("civ.window")


def test_the_layout_finds_every_part(cell):
    assert cell.workload["config"] == "civ" and cell.workload["chips"] == 1
    assert cell.config["num_civ_samples"] == S and cell.config["num_pixels_padded"] == N
    assert cell.traffic["driver"] == "civ"
    assert layout.load_driver(cell.traffic).__name__ == "drivers.civ"
    assert [m["name"] for m in cell.end_to_end] == ["spectra_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == ["civ_profile_roofline_pct", "dispatch_ms_per_spectrum.civ",
                     "plain_device_ms_per_spectrum.civ", "launches_per_spectrum.civ",
                     "device_idle_pct.civ", "k2_roofline_pct.civ", "mfu_pct.civ",
                     "k3_roofline_pct.civ", "finalize_ms_per_spectrum.civ",
                     "p95_latency_ms.civ"]
    for name in names:
        assert callable(layout.load_metric(name).read), name
    # the posterior is a function of the two evidences and is only logged (no
    # limit lies between the program's and the TF32 control's readings)
    assert set(cell.traffic["limits"]) == {"evidence_rms", "ll_rms"}


def test_generator_checksums(cell):
    cfg, traffic = cell.config, cell.traffic
    learned = gen_civ.civ_learned_model(cfg, gen.rng_for(SEED, 1))
    assert learned.mu.shape == (487,)
    assert float(learned.M.sum()) == pytest.approx(2.958215307463613, rel=1e-12)
    assert float(np.abs(learned.M).sum()) == pytest.approx(152.60675548731888, rel=1e-12)
    assert float(learned.mu.sum()) == pytest.approx(545.4572130256747, rel=1e-12)
    samples = gen_civ.civ_samples(cfg)
    assert float(samples.log_nciv_samples.sum()) == pytest.approx(136896.0895473251, rel=1e-12)
    assert float(samples.sigma_samples.sum()) == pytest.approx(44991043584.0, rel=1e-12)
    pool, doublets = gen_civ.civ_pool(cfg, traffic, learned, SEED)
    assert len(pool) == 64 and sum(d is not None for d in doublets) == 32
    spec = pool[5]
    assert float(spec.flux.sum()) == pytest.approx(796.47626188137, rel=1e-10)
    assert int(spec.mask.sum()) == 732 and spec.padded_wavelengths.shape == (P,)
    assert (float(spec.min_z_dla), float(spec.max_z_dla)) == pytest.approx(
        (1.7087836261665976, 2.188405775556754), rel=1e-12)
    assert doublets[5][0] == pytest.approx(1.7815005326870406, rel=1e-12)


def test_counts_by_hand():
    # the (S, P - 6) float32 absorption: 4 x 10,000 x 768 bytes
    assert counts_civ.civ_profile_bytes(S, P) == 30_720_000.0
    assert counts_civ.civ_profile_least_s(S, P) == pytest.approx(30.72e6 / 3.35e12, rel=1e-12)
    # K2 at N = 768: 2 S N (210 + 20) products at 3xTF32 (165 TFLOP/s)
    k2 = 2.0 * S * N * 230 / (495e12 / 3)
    assert counts.k2_least_s(S, N, K, 0) == pytest.approx(k2, rel=1e-12)
    # K3: its bytes, 4 S (210 + 20 + 3)
    k3 = 4.0 * S * 233 / 3.35e12
    assert counts.k3_least_s(S, K) == pytest.approx(k3, rel=1e-12)
    assert counts_civ.civ_step_least_s(S, P, N, K) == pytest.approx(
        30.72e6 / 3.35e12 + k2 + k3, rel=1e-12)
    assert 1e6 * counts_civ.civ_step_least_s(S, P, N, K) == pytest.approx(33.37, abs=0.01)


K5 = "void tail_kernel<Source, float>(Source, float const*, float const*, int, int, float*)"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::AUFunctor<float>>"
K2 = "void (anonymous namespace)::logmvn_cap_kernel<32, 16, float>(float const*)"
MAIN = 101


def made_up():
    """A 100 us stretch of one spectrum: the profile's elementwise work and
    K5 under ``gpy.civ_profile``, K2 under ``gpy.civ_likelihood``."""
    program = [spans.Span("gpy.civ_dispatch", MAIN, -1, 0.0, 100.0),
               spans.Span("gpy.civ_profile", MAIN, 0, 5.0, 40.0),
               spans.Span("gpy.civ_likelihood", MAIN, 0, 40.0, 90.0)]
    records = [(Record(ELEM, 10.0, 50.0), 6.0), (Record(K5, 50.0, 60.0), 30.0),
               (Record(K2, 60.0, 80.0), 45.0)]
    trace = Trace([r for r, _ in records], [], 0.0, 100.0)
    return spans.ProgramTrace(trace, program, {r: spans.Launch(MAIN, at) for r, at in records})


def test_profile_roofline_by_hand():
    pt = made_up()
    read = layout.load_metric("civ_profile_roofline_pct").read
    least = 4e-6  # s, one profile's
    got = read(Readings(pt.trace, 1, {"program_trace": pt, "civ_profile_least_s": least}))
    # one K5 record: one profile's least over the profile's 40 + 10 us
    assert got == pytest.approx(100.0 * least / 50e-6)
    assert read(Readings(pt.trace, 1, {})) is None


@pytest.mark.parametrize("name, key, value, want", [
    ("dispatch_ms_per_spectrum.civ", "dispatch_s_per_spectrum", 0.0025, 2.5),
    ("finalize_ms_per_spectrum.civ", "finalize_s_per_spectrum", 0.0001, 0.1),
    ("p95_latency_ms.civ", "p95_latency_ms", 290.5, 290.5),
])
def test_host_readers(name, key, value, want):
    read = layout.load_metric(name).read
    assert read(Readings(None, 1, {key: value})) == pytest.approx(want)
    assert read(Readings(None, 1, {})) is None


def test_device_time_is_put_down_by_span():
    from drivers import civ

    got = civ.device_s_by_span(made_up())
    assert got == pytest.approx({"gpy.civ_profile": 50e-6, "gpy.civ_likelihood": 20e-6})


def test_the_reference_sets_tf32_off_and_imports_nothing_of_the_program():
    import ast

    path = layout.BENCH_DIR / "reference" / "civ.py"
    text = path.read_text()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in text
    assert "torch.backends.cudnn.allow_tf32 = False" in text
    for f in (path, layout.BENCH_DIR / "drivers" / "civ.py",
              layout.BENCH_DIR / "harness" / "gen_civ.py"):
        names = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"jax", "jaxlib", "flax", "gpy_dla_detection_tpu"}, f
        if f == path:
            assert "gpy_dla_detection_tpu_torch" not in names


def test_the_config_holds_civ_parameters():
    from gpy_dla_detection_tpu_torch.params import CIVParameters

    cfg = json.loads((layout.BENCH_DIR / "configs" / "civ.json").read_text())
    want = CIVParameters()
    for key, value in cfg.items():
        if key in CIVParameters.__dataclass_fields__:
            assert getattr(want, key) == value, key
    assert len(cfg["source"]) <= 200 and cfg["reduced"] == []


def test_the_civ_entry_is_a_configuration_of_its_own():
    bench = json.loads((layout.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    entries = {c["name"]: c for c in bench["configs"]}
    civ = entries.pop("civ")
    cfg = json.loads((layout.BENCH_DIR / "configs" / "civ.json").read_text())
    assert civ["source"] == cfg["source"] and civ["reduced"] == cfg["reduced"]
    assert 1 <= len(civ["source"]) <= 200 and "\n" not in civ["source"]
    for other in entries.values():
        assert (other["source"], other["reduced"]) != (civ["source"], civ["reduced"]), other["name"]
