"""The port's user-facing and accuracy tools (`tools/torch_*.py`,
`bench_torch.py`; `torch_bag2islog.py` through its command line only)
driven in-process on the CPU (`--device cpu`) at
small_test_config over a few frames each, with their outputs under
`tmp_path`.

- Each writes the JAX tool's keys: those of the reference's committed
  result files (`RESULTS_{benchmark,os064,refine,soak,loops}.json`), with
  `platform` replaced by `device`, and `device` added.
- `torch_replay --npz` against the JAX tool on the same file is
  tests/test_torch_replay_npz.py's.
- `torch_loop_eval._evaluate` equals the reference's `_evaluate` on a fixed
  synthetic run (loops right and wrong, opportunities, cooldown coverage).
- Each tool's default `--out` starts with `RESULTS_torch_`, so no default
  names a result file of the JAX package; `torch_visualize`'s default
  directory lies in the checkout.  Each tool's default device is the card:
  without one it raises.
"""

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
import torch_bag2islog  # noqa: E402
import torch_capacity_sensitivity  # noqa: E402
import torch_loop_eval  # noqa: E402
import torch_os0_eval  # noqa: E402
import torch_refine_eval  # noqa: E402
import torch_replay  # noqa: E402
import torch_soak  # noqa: E402
import torch_visualize  # noqa: E402

torch.set_num_threads(1)
CPU = ["--device", "cpu", "--small"]


def _reference_keys(name: str) -> set:
    with open(ROOT / name) as f:
        return set(json.load(f))


def _read(path) -> dict:
    with open(path) as f:
        return json.load(f)


def test_replay_pipelines_on_the_cpu(tmp_path, capsys):
    for pipeline in ("slam", "odometry"):
        assert torch_replay.main(CPU + ["--frames", "4", "--pipeline", pipeline,
                                        "--check-ate", "--ate-bound", "5.0"]) == 0
        assert "PASS: ATE within bound" in capsys.readouterr().out
    out = tmp_path / "bench.json"
    assert torch_replay.main(CPU + ["--benchmark", "--frames", "4", "--noise",
                                    "--out", str(out)]) == 0
    res = _read(out)
    assert set(res) == _reference_keys("RESULTS_benchmark.json") - {"platform"} | {"device"}
    assert res["frames"] == 4 and res["sequence"] == "circuit"
    assert res["sensor_model"]["noise"] and res["device"] == "cpu"


def test_bench_torch_prints_bench_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "FRAMES", 6)
    monkeypatch.setattr(bench_torch, "FRONTEND_FRAMES", 3)
    assert bench_torch.main(["--device", "cpu", "--small"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "front_end_scans_per_sec",
                        "front_end_vs_baseline", "keyframes", "loop_closures", "compile_s",
                        "device"}
    assert res["value"] > 0 and res["keyframes"] >= 1 and res["device"] == "cpu"


def test_visualize_writes_the_pngs(tmp_path, capsys):
    assert torch_visualize.main(CPU + ["--frames", "5", "--out", str(tmp_path)]) == 0
    made = set(os.listdir(tmp_path))
    assert {"trajectory.png", "map.png", "range_0000.png"} <= made
    assert any(m.startswith("matches_") for m in made), made
    capsys.readouterr()


def test_os0_eval_keys(tmp_path, capsys):
    out = tmp_path / "os0.json"
    assert torch_os0_eval.main(CPU + ["--frames", "5", "--out", str(out)]) == 0
    res = _read(out)
    assert set(res) == _reference_keys("RESULTS_os064.json") | {"device"}
    assert res["frames"] == 5 and res["ate_m"] < 1.0
    capsys.readouterr()


def test_loop_eval_keys(tmp_path, capsys):
    out = tmp_path / "loops.json"
    assert torch_loop_eval.main(CPU + ["--seeds", "1", "--worlds", "aliased", "--channels",
                                       "bow", "--frames", "4", "--cache-dir",
                                       str(tmp_path / "cache"), "--out", str(out)]) == 0
    res, ref = _read(out), _read(ROOT / "RESULTS_loops.json")
    assert set(res) == set(ref) | {"device"}
    ch = res["worlds"]["aliased"]["channels"]
    assert set(ch) == {"bow"} and res["worlds"]["aliased"]["frames"] == 4
    ref_ch = ref["worlds"]["aliased"]["channels"]["bow"]
    assert set(ch["bow"]["aggregate"]) == set(ref_ch["aggregate"])
    assert set(ch["bow"]["runs"][0]) == set(ref_ch["runs"][0])
    assert len(os.listdir(tmp_path / "cache")) == 1      # rendered once, cached
    capsys.readouterr()


def test_loop_eval_evaluate_equals_the_reference():
    """Both `_evaluate`s on one fixed run: 12 keyframes on three laps of a
    circle, loops right and wrong and one that names a keyframe past the
    store, a search gap and a cooldown of 2 keyframes."""
    import dataclasses

    import loop_eval
    from intensity_slam_tpu import config

    cfg = config.small_test_config()
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, min_loop_search_gap=2,
                                               loop_cooldown_kf=2))
    rng = np.random.RandomState(5)
    gt = np.concatenate([np.stack([np.cos(a), np.sin(a), 0 * a], -1) * 6.0
                         for a in [np.linspace(0, 2 * np.pi, 40, endpoint=False)] * 3])
    live = gt + rng.randn(*gt.shape).astype(np.float32) * 0.3
    traj = gt + rng.randn(*gt.shape).astype(np.float32) * 0.1
    kf_time = np.arange(0, 120, 10) * 0.1 + rng.rand(12) * 0.04
    # keyframe k sits at frame 10 k, a quarter lap on: k and k + 4 coincide
    loops = [(8, 0, 0.05), (9, 1, 0.1), (10, 3, 0.02), (11, 7, 0.2), (12, 0, 0.1)]
    fake = types.SimpleNamespace(
        bstate=types.SimpleNamespace(num_kf=np.int32(12), kf_time=kf_time),
        loops=loops, trajectory=lambda: traj)
    j = loop_eval._evaluate(fake, gt, live, cfg)
    t = torch_loop_eval._evaluate(fake, gt, live, cfg)
    assert t == j
    assert 0 < j["correct_loops"] < j["accepted_loops"] and j["opportunity_keyframes"] > 0


def test_refine_eval_variants(tmp_path, capsys):
    out = tmp_path / "refine.json"
    assert torch_refine_eval.main(CPU + ["--frames", "3", "--out", str(out)]) == 0
    res, ref = _read(out), _read(ROOT / "RESULTS_refine.json")
    assert set(res) == set(ref) | {"device"}
    assert set(res["variants"]) == set(ref["variants"]) | {"refine_every_8kf_mesh"}
    for name, r in res["variants"].items():
        assert set(r) == set(ref["variants"]["baseline_no_refine"]), name
    capsys.readouterr()


def test_soak_keys_and_checks(tmp_path, monkeypatch, capsys):
    out = tmp_path / "soak.json"
    monkeypatch.setattr(torch_soak, "LAP", 5)
    monkeypatch.setattr(torch_soak, "CHUNK", 4)
    assert torch_soak.main(CPU + ["--frames", "10", "--out", str(out)]) == 0
    res = _read(out)
    assert set(res) == _reference_keys("RESULTS_soak.json") - {"residual_note"} | {"device"}
    assert res["trajectory_frames_exported"] == 10 and len(res["chunks"]) == 2
    capsys.readouterr()


def test_bag2islog_main_on_the_cpu(tmp_path, capsys):
    """The converter's command line (its bytes against the JAX tool's are
    tests/test_torch_bag2islog.py's)."""
    from test_bag2islog import H, N, W, _make_bag

    rng = np.random.RandomState(3)
    frames = [(1.0 + 0.1 * k, rng.randn(N, 3).astype(np.float32),
               rng.rand(N).astype(np.float32)) for k in range(2)]
    _make_bag(tmp_path / "in.bag", frames)
    out = tmp_path / "out.islog"
    assert torch_bag2islog.main([str(tmp_path / "in.bag"), str(out), "--height", str(H),
                                 "--width", str(W), "--device", "cpu"]) == 0
    assert "wrote 2 frames" in capsys.readouterr().out and out.stat().st_size > 0


def test_capacity_sensitivity_prints_each_draw(monkeypatch, capsys):
    monkeypatch.setattr(torch_capacity_sensitivity, "FRAMES", 4)
    monkeypatch.setattr(torch_capacity_sensitivity, "SCENES", ((0.5, 0.0),))
    monkeypatch.setattr(torch_capacity_sensitivity, "DRAWS", 1)
    assert torch_capacity_sensitivity.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu" and len(lines) == 2
    assert lines[1].startswith("speed 0.5 yaw 0.0 draw 0: trajectory moved ")


TOOLS = {"replay": torch_replay, "os0_eval": torch_os0_eval,
         "loop_eval": torch_loop_eval, "refine_eval": torch_refine_eval, "soak": torch_soak}


@pytest.mark.parametrize("name", list(TOOLS))
def test_default_out_is_the_port_s(name):
    assert os.path.basename(TOOLS[name].OUT).startswith("RESULTS_torch_")


def test_visualize_default_out_is_in_the_checkout():
    assert Path(torch_visualize.OUT).resolve() == ROOT / "viz_torch"


@pytest.mark.parametrize("main", [torch_replay.main, bench_torch.main, torch_visualize.main,
                                  torch_os0_eval.main, torch_loop_eval.main,
                                  torch_refine_eval.main, torch_soak.main,
                                  lambda argv: torch_bag2islog.main(["in.bag", "out.islog"]),
                                  torch_capacity_sensitivity.main],
                         ids=["replay", "bench", "visualize", "os0_eval", "loop_eval",
                              "refine_eval", "soak", "bag2islog", "capacity_sensitivity"])
def test_default_device_is_the_card(main):
    """Each tool checks the device before it renders, reads or writes."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main([])
