"""The harness finds every part of a cell by name, refuses what it does not
know, and refuses to measure without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from harness import layout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return layout.load_spec()


def test_spec_keys_names_and_units(spec):
    assert set(spec) == KEYS["top"]
    for group, kind in (("configs", "config"), ("workloads", "workload"),
                        ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        for entry in spec[group]:
            assert set(entry) - {"workloads"} == KEYS[kind], entry["name"]
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    names = [e["name"] for g in ("end_to_end", "per_layer") for e in spec[g]]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_cell_finds_its_parts(spec):
    for w in spec["workloads"]:
        cell = layout.find_cell(w["name"], spec)
        assert cell.config["name"] == w["config"]
        assert cell.workload["chips"] == 1
        driver = layout.load_driver(cell.traffic)
        assert callable(driver.run) and callable(driver.calibrate)
        assert {m["name"].split(".")[0] for m in cell.end_to_end} >= {"setup_s", "spectra_per_s"}
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert callable(layout.load_metric(m["name"]).read)
        assert cell.traffic["limits"]


def test_metrics_name_their_cells(spec):
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= cells, m["name"]


def test_unknown_names_are_refused(spec):
    with pytest.raises(KeyError):
        layout.find_cell("no.such.cell", spec)
    with pytest.raises(KeyError):
        layout.load_metric("no_such_metric")
    with pytest.raises(KeyError):
        layout.load_driver({"driver": "no_such_driver"})
    bad = dict(spec, workloads=[dict(spec["workloads"][0], config="no_such_config")])
    with pytest.raises(KeyError):
        layout.find_cell(bad["workloads"][0]["name"], bad)


def test_a_tagged_metric_takes_its_quantitys_reader():
    """``<quantity>.<tag>`` without a file of its own reads as ``<quantity>``."""
    assert layout.load_metric("device_idle_pct.zqso").__file__ == \
        layout.load_metric("device_idle_pct").__file__
    with pytest.raises(KeyError):
        layout.load_metric("no_such_metric.zqso")


def test_paths_and_command(spec):
    assert spec["paths"] == ["benchmark"]
    assert spec["command"][1].startswith("benchmark/")
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/")
        assert (layout.ROOT / c["file"]).is_file()


def test_run_refuses_without_a_card():
    """With no CUDA card the run exits with 2 and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(layout.BENCH_DIR / "run.py"), "--workload",
                           "catalog.window", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, env=env,
                          cwd=layout.ROOT, timeout=300)
    assert proc.returncode == 2
    assert '"correct"' not in proc.stdout
    assert "CUDA" in proc.stderr


def test_run_refuses_an_unknown_workload():
    proc = subprocess.run([sys.executable, str(layout.BENCH_DIR / "run.py"), "--workload",
                           "no.such.cell", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=layout.ROOT, timeout=300)
    assert proc.returncode == 2 and not proc.stdout.strip()
