"""Import guard: the PyTorch port and chip_smoke.py import nothing of JAX
and nothing of the JAX package (not even its JAX-free modules)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "intensity_slam_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_nn_tune.py"]
FORBIDDEN = ("jax", "jaxlib", "intensity_slam_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_guard_sees_the_package():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py") in FILES
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("ops/curvature.py", "ops/ground.py", "pipeline/geometric.py",
                "pipeline/slam.py", "utils/index.py", "interop.py",
                "ops/grid_hash.py", "pipeline/mapping.py", "pipeline/fused.py",
                "pipeline/system.py", "runtime/spill.py"):
        assert f"intensity_slam_tpu_torch/{mod}" in names
