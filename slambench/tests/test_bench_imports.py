"""Import guard: nothing under `slambench/` imports JAX or the JAX package,
and nothing under `slambench/reference/` imports the program either (its
relative imports stay inside it).  Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
REFERENCE = HERE / "reference"
FORBIDDEN = {"jax", "jaxlib", "flax", "intensity_slam_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.level, node.module or ""


def _top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    bad = [m for level, m in _imports(path) if level == 0 and _top(m) in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted(REFERENCE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    depth = len(path.relative_to(REFERENCE).parts) - 1     # packages above it inside
    for level, m in _imports(path):
        if level == 0:
            assert _top(m) not in FORBIDDEN | {"intensity_slam_tpu_torch", "slambench"}, m
        else:
            assert level <= depth + 1, f"{path.name} reaches outside the reference: {m}"


def test_guard_sees_the_harness():
    names = {str(p.relative_to(HERE)) for p in FILES}
    for f in ("run.py", "spec.py", "check.py", "trace.py", "work.py", "scans.py",
              "kinds/islog_stream.py",
              "reference/islam/pipeline/fused.py"):
        assert f in names


def test_a_run_leaves_no_forbidden_module_loaded():
    import sys

    from slambench import run
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN))
    assert "intensity_slam_tpu_torch" not in run.FORBIDDEN
