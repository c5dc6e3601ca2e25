"""`tools/torch_replay.py --npz` against the JAX tool `tools/replay.py
--npz` on the same JAX-rendered file (12 frames of the corridor with a
yaw, small_test_config, `--pipeline system`): the same skips, keyframes
and loops; the ATE within 0.1 m (the tolerance of
tests/test_torch_fused.py; the two tools draw their ground-RANSAC samples
from different generators).  Both run in-process on the CPU.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import torch_replay  # noqa: E402

torch.set_num_threads(1)


def _read(path) -> dict:
    with open(path) as f:
        return json.load(f)


def test_replay_npz_matches_the_reference_tool(tmp_path, monkeypatch, capsys):
    """The same JAX-rendered corridor (12 frames with a yaw) through the
    JAX tool and the port's, `--pipeline system`."""
    import jax

    from intensity_slam_tpu import config
    from intensity_slam_tpu.io import synthetic as JSyn
    from intensity_slam_tpu.utils import se3 as J3
    import replay

    cfg = config.small_test_config()
    poses = JSyn.corridor_trajectory(12, speed=0.35, yaw_rate=0.02)
    xyz, inten = jax.jit(lambda q, t: JSyn.render_sequence(
        J3.Pose(q, t), JSyn.corridor_world(), cfg.sensor))(poses.q, poses.t)
    p0 = J3.inverse(J3.Pose(poses.q[0], poses.t[0]))
    gt_t = jax.vmap(lambda q, t: J3.compose(p0, J3.Pose(q, t)).t)(poses.q, poses.t)
    npz = tmp_path / "seq.npz"
    np.savez(npz, xyz=np.asarray(xyz), intensity=np.asarray(inten),
             times=np.arange(12, dtype=np.float32) * 0.1, gt_t=np.asarray(gt_t))
    args = ["--npz", str(npz), "--small", "--pipeline", "system"]
    monkeypatch.setattr(sys, "argv", ["replay.py", *args, "--out", str(tmp_path / "j.json")])
    assert replay.main() == 0
    assert torch_replay.main(args + ["--device", "cpu", "--out", str(tmp_path / "t.json")]) == 0
    capsys.readouterr()
    j, t = _read(tmp_path / "j.json"), _read(tmp_path / "t.json")
    assert set(t) == set(j) - {"platform"} | {"device"}
    for key in ("frames", "skip_frames", "keyframes", "loop_closures", "loops"):
        assert t[key] == j[key], key
    assert t["keyframes"] >= 3
    for key in ("ate_rmse_m", "ate_odometry_m", "end_error_m"):
        assert abs(t[key] - j[key]) < 0.1, (key, t[key], j[key])
