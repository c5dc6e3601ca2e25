"""Import guard: the PyTorch port (its distributed back-end and the worker
that `parallel.multiproc.launch` spawns included) and chip_smoke.py import
nothing of JAX and nothing of the JAX package (not even its JAX-free
modules), and no
module of the port opens a path under `native/build/`, the JAX package's
build directory of the native runtime (the port builds its own copy into
`intensity_slam_tpu_torch/_build/`)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ("torch_nn_tune", "torch_refine_draws", "torch_replay", "torch_bag2islog",
         "torch_visualize", "torch_os0_eval", "torch_loop_eval", "torch_refine_eval",
         "torch_soak", "torch_capacity_sensitivity", "torch_bench_full", "torch_stream_probe",
         "torch_slope_probe", "torch_profile_stages", "torch_multiproc_product",
         "torch_scaling_bench", "torch_scaling_projection", "torch_scaling_multisession")
FILES = sorted((ROOT / "intensity_slam_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py"] + [
    ROOT / "tools" / f"{name}.py" for name in TOOLS]
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
    assert "bench_torch.py" in names
    for name in TOOLS:
        assert f"tools/{name}.py" in names and (ROOT / "tools" / f"{name}.py").exists()
    for mod in ("ops/curvature.py", "ops/ground.py", "pipeline/geometric.py",
                "pipeline/slam.py", "utils/index.py", "interop.py",
                "ops/grid_hash.py", "pipeline/mapping.py", "pipeline/fused.py",
                "pipeline/system.py", "runtime/spill.py", "io/synthetic.py",
                "runtime/stream.py", "runtime/native.py", "runtime/scanlog.py",
                "utils/checkpoint.py", "pipeline/geometric_slam.py",
                "pipeline/laser_mapping.py", "parallel/multiproc.py",
                "parallel/dist_ba.py", "parallel/ba_builder.py", "parallel/dist_pgo.py",
                "parallel/dist_backend.py", "parallel/live_demo.py", "utils/device.py"):
        assert f"intensity_slam_tpu_torch/{mod}" in names


def _path_literals(tree):
    """String constants that are not docstrings, and the constant arguments
    of each `os.path.join(...)` call joined by "/"."""
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    for n in ast.walk(tree):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
            yield n.value
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"):
            yield "/".join(a.value for a in n.args
                           if isinstance(a, ast.Constant) and isinstance(a.value, str))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_under_the_reference_build(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [s for s in _path_literals(tree) if "native/build" in s]
    assert not bad, f"{path.name} names {bad}"
