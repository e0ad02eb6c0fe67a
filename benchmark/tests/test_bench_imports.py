"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast

from harness import layout

FORBIDDEN = {"jax", "jaxlib", "flax", "gpy_dla_detection_tpu"}
PROGRAM = "gpy_dla_detection_tpu_torch"


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = sorted(layout.BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not (set(imported(f)) & FORBIDDEN), f


def test_the_reference_takes_nothing_of_the_program():
    for f in sorted((layout.BENCH_DIR / "reference").rglob("*.py")):
        names = set(imported(f))
        assert PROGRAM not in names and not (names & FORBIDDEN), f
        assert not names & {"harness", "drivers", "metrics"}, f


def test_the_top_level_name_is_compared_whole():
    import run

    assert "gpy_dla_detection_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "gpy_dla_detection_tpu" in run.FORBIDDEN
