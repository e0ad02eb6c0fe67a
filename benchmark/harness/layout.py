"""Where the benchmark finds each of its parts, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its traffic
mix.  The configuration is ``configs/<config>.json``; the traffic is
``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``;
each per-layer metric is ``metrics/<name>.py``, a module with ``read(trace)``,
or, where a metric ``<quantity>.<tag>`` (one cell's own) has no file of its
own, the reader of ``<quantity>``.
A later change adds a configuration, a traffic mix or a metric as files of
its own and entries in ``BENCHMARK.json``, and edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    workload: dict  # the BENCHMARK.json entry
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise KeyError(f"{what}: no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics; an
    unknown name raises ``KeyError``."""
    spec = load_spec(root) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {name!r} names an unknown config {w['config']!r}")
    config = _json(root / configs[w["config"]]["file"], f"config {w['config']!r}")
    traffic = _json(root / "benchmark" / "traffic" / f"{w['traffic']}.json",
                    f"traffic {w['traffic']!r}")
    return Cell(name, w, config, traffic,
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])


def load_driver(traffic: dict):
    """The module ``drivers/<traffic['driver']>.py``."""
    name = traffic.get("driver")
    if not name or not (BENCH_DIR / "drivers" / f"{name}.py").is_file():
        raise KeyError(f"traffic names an unknown driver {name!r}")
    return importlib.import_module(f"drivers.{name}")


def load_metric(name: str):
    """The reader ``metrics/<name>.py`` of a per-layer metric, else that of
    the name before its first dot."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise KeyError(f"no reader for metric {name!r} (metrics/{name}.py)")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
