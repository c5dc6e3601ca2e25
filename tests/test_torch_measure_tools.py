"""The port's measurement tools (`tools/torch_{bench_full,stream_probe,
slope_probe,profile_stages}.py`) driven in-process on the CPU
(`--device cpu --small`, small_test_config) over a few frames each, with
their outputs under `tmp_path`.

- Each writes the JAX tool's keys, with `platform` replaced by `device`
  (or `device` added): those of the reference's committed
  `RESULTS_full_bench.json` and `RESULTS_stream_probe.json`, and the key
  names that `tools/slope_probe.py:78-104` writes (no file of it is
  committed), plus `max_ms` per class.
- The stream probe's three modes (pose writer on, off, a bare `fused_step`
  loop) end with equal keyframe counts and bit-equal final positions, and
  the streaming and preloaded passes of `torch_bench_full` take the same
  keyframes (each tool exits 1 otherwise).
- `torch_profile_stages` times the JAX tool's ten stages in its order,
  counts `projection`'s operand bytes as a count by hand from the shapes
  does, and writes "not measured" in every device column on the CPU.
- Each tool's default `--out` starts with `RESULTS_torch_`; each tool's
  default device is the card, and without one it raises.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import torch_bench_full  # noqa: E402
import torch_profile_stages  # noqa: E402
import torch_slope_probe  # noqa: E402
import torch_stream_probe  # noqa: E402

from intensity_slam_tpu_torch import config  # noqa: E402

torch.set_num_threads(1)
CPU = ["--device", "cpu", "--small"]
TOOLS = {"bench_full": torch_bench_full, "stream_probe": torch_stream_probe,
         "slope_probe": torch_slope_probe, "profile_stages": torch_profile_stages}

# tools/slope_probe.py:78-104
SLOPE_KEYS = {"frames", "wall_s_sync", "note", "classes", "chunks"}
SLOPE_CLASS_KEYS = {"count", "mean_ms", "p50_ms", "p95_ms", "total_s", "share_pct"}
SLOPE_CHUNK_KEYS = {"frames", "num_kf_end", "scans_per_sec_sync", "verifies", "accepts"}
# tools/profile_stages.py:130-183, in order
STAGES = ["FULL slam_step", "projection", "odometry_step", "curvature features",
          "geometric_delta (solve)", "ground RANSAC", "mapping_step",
          "backend_step (keyframe)", "fused_step (non-keyframe)",
          "fused_step (kf-gate frame)"]
DEVICE_COLUMNS = ("device_us", "kernels", "busy_share", "bound_us", "bound_by", "bound_share",
                  "top_kernel", "top_kernel_us")


def _read(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reference_keys(name: str) -> set:
    return set(_read(ROOT / name))


def test_bench_full_keys(tmp_path, capsys):
    out = tmp_path / "full.json"
    assert torch_bench_full.main(CPU + ["--frames", "4", "--out", str(out)]) == 0
    res = _read(out)
    assert set(res) == _reference_keys("RESULTS_full_bench.json") - {"platform"} | {"device"}
    assert res["frames"] == 4 and res["device"] == "cpu"
    assert res["streaming_keyframes"] >= 1 and res["frontend_scans_per_sec"] > 0
    n = 32 * 256
    assert res["wire_bytes_per_frame"] == (n + 1) * 4
    assert res["float_bytes_per_frame"] == (n + 1) * 16
    capsys.readouterr()


def test_stream_probe_modes_end_equal(tmp_path, monkeypatch, capsys):
    seen = {}
    check = torch_stream_probe.check_modes

    def recording(ends):
        seen.update(ends)
        return check(ends)

    monkeypatch.setattr(torch_stream_probe, "check_modes", recording)
    out = tmp_path / "probe.json"
    assert torch_stream_probe.main(CPU + ["--frames", "4", "--out", str(out)]) == 0
    res = _read(out)
    assert set(res) == _reference_keys("RESULTS_stream_probe.json") | {"device"}
    assert res["frames"] == 4
    assert set(seen) == {"writer-on", "writer-off", "bare-loop"}
    (kf, t), = {(kf, t.tobytes()) for kf, t in seen.values()}
    assert kf >= 1 and np.isfinite(np.frombuffer(t, np.float32)).all()
    capsys.readouterr()


def test_stream_probe_check_sees_a_different_end():
    t = np.zeros(3, np.float32)
    assert not torch_stream_probe.check_modes({"a": (2, t), "b": (2, t.copy())})
    assert len(torch_stream_probe.check_modes({"a": (2, t), "b": (3, t)})) == 1
    assert len(torch_stream_probe.check_modes({"a": (2, t), "b": (2, t + 1e-7)})) == 1


def test_slope_probe_keys_and_classes(tmp_path, capsys):
    out = tmp_path / "slope.json"
    assert torch_slope_probe.main(CPU + ["--frames", "5", "--out", str(out)]) == 0
    res = _read(out)
    assert set(res) == SLOPE_KEYS | {"device"}
    assert res["classes"] and all(set(c) == SLOPE_CLASS_KEYS | {"max_ms"}
                                  for c in res["classes"].values())
    assert set(res["classes"]) <= {"plain", "kf", "verify", "accept"}
    assert sum(c["count"] for c in res["classes"].values()) == 4
    assert all(c["max_ms"] >= c["p95_ms"] for c in res["classes"].values())
    assert [set(c) for c in res["chunks"]] == [SLOPE_CHUNK_KEYS]
    assert res["chunks"][0]["frames"] == "1-4"
    capsys.readouterr()


def test_profile_stages_rows(tmp_path, capsys):
    out = tmp_path / "profile.json"
    assert torch_profile_stages.main(CPU + ["--reps", "1", "--out", str(out)]) == 0
    res = _read(out)
    rows = res["rows"]
    assert [r["stage"] for r in rows] == STAGES
    sc = config.small_test_config().sensor
    n = sc.image_height * sc.image_width
    # in: xyz (n, 3) f32, intensity (n,) f32; out: intensity, range (n,) f32,
    # xyz (n, 3) f32, valid (n,) bool
    assert rows[1]["operand_bytes"] == n * (12 + 4) + n * (4 + 4 + 12 + 1)
    for r in rows:
        assert r["host_ms"] > 0 and r["operand_bytes"] > 0 and r["flops"] >= 0
        assert all(r[c] == "not measured" for c in DEVICE_COLUMNS), r
        assert r["repeat_outputs_differing"] == 0, r
    assert res["device"] == "cpu" and res["peaks"] == "not measured"
    printed = capsys.readouterr().out
    assert "keyframe-branch probe: is_keyframe=" in printed
    assert printed.count("| cpu |") == len(STAGES)


def test_profile_stage_refuses_an_input_changed_in_place(capsys):
    prof = torch_profile_stages.Profiler(torch.device("cpu"), reps=2)
    x = torch.zeros(4)
    prof.stage("pure", lambda a: a + 1, x)
    assert prof.rows[-1]["repeat_outputs_differing"] == 0
    with pytest.raises(RuntimeError, match="changes its inputs in place"):
        prof.stage("drifting", lambda a: a.add_(1).clone(), x)
    # an output that differs between calls on unchanged inputs is counted
    draws = iter([0.0, 1.0, 2.0, 3.0])
    prof.stage("noisy", lambda a: a + next(draws), torch.zeros(2))
    assert prof.rows[-1]["repeat_outputs_differing"] == 1
    assert prof.rows[-1]["repeat_max_abs_diff"] == 2.0
    capsys.readouterr()


def test_operand_bytes_walks_the_trees():
    from intensity_slam_tpu_torch.utils.se3 import Pose

    tree = (Pose(torch.zeros(5, 4), torch.zeros(5, 3)), [torch.zeros(2, dtype=torch.bool)],
            {"k": torch.zeros(3, dtype=torch.int64)}, 0.5, None)
    assert torch_profile_stages.operand_bytes(tree) == 5 * 16 + 5 * 12 + 2 + 24


@pytest.mark.parametrize("name", list(TOOLS))
def test_default_out_is_the_port_s(name):
    assert os.path.basename(TOOLS[name].OUT).startswith("RESULTS_torch_")


@pytest.mark.parametrize("name", list(TOOLS))
def test_default_device_is_the_card(name):
    """Each tool checks the device before it renders or writes."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TOOLS[name].main([])
