"""The port's `StreamingRunner` (`intensity_slam_tpu_torch/runtime/
stream.py`) against the JAX package's, on the CPU, over the same 10-frame
scan log at small_test_config (a JAX-rendered corridor with a yaw, written
once; each package opens it through its own library copy).

Each runner is driven in wire mode (uint16 range/intensity words, xyz
rebuilt from the beam-direction table) and in float mode.  The reference's
ground-RANSAC draws are collected along its key chain in `on_frame` and
handed to the port as `ground_u`.

Exact: the decoded wire inputs (bit for bit), the stats (frames,
keyframes, skips, loops, dropped pose writes), the loop list, the TUM
rows' timestamps.  Within 0.1 m: the TUM positions and `trajectory()`, the
tolerance of tests/test_torch_fused.py for its reason (last-bit
differences of the blurred intensity flip a few near-tie descriptor bits;
each moves one frame's solve by a centimetre or two).
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic as JSyn
from intensity_slam_tpu.runtime import ScanLog as JScanLog
from intensity_slam_tpu.runtime import StreamingRunner as JRunner
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.pipeline import fused as TF
from intensity_slam_tpu_torch.runtime import ScanLog, ScanLogWriter
from intensity_slam_tpu_torch.runtime import stream as TS

torch.set_num_threads(1)
FRAMES = 10
MODES = ("wire", "float")


def _render(cfg, frames, speed=0.3, yaw_rate=0.02):
    poses = JSyn.corridor_trajectory(frames, speed=speed, yaw_rate=yaw_rate)
    xyz, inten = jax.jit(lambda q, t: JSyn.render_sequence(
        J3.Pose(q, t), JSyn.corridor_world(), cfg.sensor))(poses.q, poses.t)
    return np.asarray(xyz), np.asarray(inten)


def _write(path, cfg, xyz, inten, base=0.0):
    with ScanLogWriter(str(path), cfg.sensor.image_height, cfg.sensor.image_width) as w:
        for k in range(xyz.shape[0]):
            w.append(base + 0.1 * k, xyz[k], inten[k])


def _tum(path):
    rows = [r.split() for r in path.read_text().splitlines()]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:4]] for r in rows])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    cfg = config.small_test_config()
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    xyz, inten = _render(cfg, FRAMES)
    log_path = d / "seq.islog"
    _write(log_path, cfg, xyz, inten)
    out = {"cfg": cfg, "tcfg": tcfg, "log": log_path, "dir": d}
    for mode in MODES:
        wire = mode == "wire"
        jr = JRunner(cfg, traj_path=str(d / f"j_{mode}.tum"), wire_compress=wire)
        draws = []

        def collect(_idx, _info, jr=jr, draws=draws):
            _, sub = jax.random.split(jr.state.slam.rng)
            draws.append(np.asarray(jax.random.uniform(sub, (cfg.ground.ransac_iters, 3))))

        collect(None, None)                       # the first frame's draws
        with JScanLog(str(log_path)) as log:
            jstats = jr.run(log, on_frame=collect)
        ground_u = np.stack(draws[:FRAMES])
        tr = TS.StreamingRunner(tcfg, traj_path=str(d / f"t_{mode}.tum"),
                                wire_compress=wire, device="cpu")
        with ScanLog(str(log_path)) as log:
            tstats = tr.run(log, ground_u=ground_u)
        out[mode] = dict(jr=jr, tr=tr, jstats=jstats, tstats=tstats, ground_u=ground_u,
                         jtum=_tum(d / f"j_{mode}.tum"), ttum=_tum(d / f"t_{mode}.tum"))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_stats_and_loops_equal(runs, mode):
    r = runs[mode]
    assert r["tstats"] == r["jstats"]
    assert r["tstats"]["frames"] == FRAMES and r["tstats"]["keyframes"] >= 2
    assert r["tstats"]["dropped_pose_writes"] == 0
    assert r["tr"].loops == r["jr"].loops


@pytest.mark.parametrize("mode", MODES)
def test_tum_rows_and_trajectory(runs, mode):
    r = runs[mode]
    (jts, jpos), (tts, tpos) = r["jtum"], r["ttum"]
    assert len(tts) == FRAMES and tts == jts
    np.testing.assert_allclose(tpos, jpos, atol=0.1)
    jt, tt = r["jr"].trajectory(), r["tr"].trajectory()
    assert tt.shape == jt.shape == (FRAMES, 3)
    np.testing.assert_allclose(tt, jt, atol=0.1)
    assert tt[-1, 0] > 1.5                       # the corridor was traversed


def test_wire_decode_bit_equal(runs):
    """On the same packed frame the port's decoded xyz, intensity and
    timestamp equal the reference's wire arithmetic bit for bit."""
    from intensity_slam_tpu.runtime.stream import _WIRE_MAX_RANGE

    tr = runs["wire"]["tr"]
    dirs = tr._dirs.numpy()
    ref = jax.jit(lambda p, d: (
        (p[0, 0].astype(jnp.float32) * 65536.0 + p[0, 1].astype(jnp.float32)) * 1e-3,
        (p[1:, 0].astype(jnp.float32) * (_WIRE_MAX_RANGE / 65535.0))[:, None] * d,
        p[1:, 1].astype(jnp.float32)))
    with ScanLog(str(runs["log"])) as log:
        frames = list(log.stream_wire(0, FRAMES, depth=2))
    for wf in frames[::3]:
        jts, jxyz, jint = (np.asarray(a) for a in ref(jnp.asarray(wf.packed), jnp.asarray(dirs)))
        xyz, inten, ts = TS.wire_decode(torch.from_numpy(wf.packed.view(np.int16)), tr._dirs)
        assert xyz.numpy().tobytes() == jxyz.tobytes()
        assert inten.numpy().tobytes() == jint.tobytes()
        assert ts.numpy().tobytes() == jts.tobytes()
    # the direction table equals the reference's
    from intensity_slam_tpu.runtime.stream import _build_dir_lut as jlut
    with JScanLog(str(runs["log"])) as log:
        np.testing.assert_array_equal(jlut(log), dirs)


def test_run_preloaded_matches_run_and_reset(runs):
    r = runs["wire"]
    tr = TS.StreamingRunner(runs["tcfg"], device="cpu")
    with ScanLog(str(runs["log"])) as log:
        s_pre = tr.run_preloaded(log, ground_u=r["ground_u"])
        assert s_pre == r["tstats"]
        np.testing.assert_array_equal(tr.trajectory(), r["tr"].trajectory())
        tr.reset()
        assert tr.num_frames == 0 and int(tr.state.log.count) == 0
        assert int(tr.state.backend.num_kf) == 0
        s_again = tr.run(log, ground_u=lambda idx: r["ground_u"][idx])
    assert s_again == s_pre
    np.testing.assert_array_equal(tr.trajectory(), r["tr"].trajectory())


def test_subrange_and_corrected_export(runs):
    """`run(start, end)` drives frames [start, end) only (ground_u indexed
    by the run's frames), and the corrected TUM export has one row per
    frame."""
    r = runs["float"]
    tr = TS.StreamingRunner(runs["tcfg"], wire_compress=False, device="cpu")
    seen = []
    with ScanLog(str(runs["log"])) as log:
        s = tr.run(log, start=2, end=6, ground_u=r["ground_u"][:4],
                   on_frame=lambda idx, info: seen.append(idx))
    assert seen == [2, 3, 4, 5] and s["frames"] == 4
    path = runs["dir"] / "corrected.tum"
    tr.write_corrected_trajectory(str(path), timestamps=[0.2, 0.3, 0.4, 0.5])
    ts, pos = _tum(path)
    assert [float(v) for v in ts] == [0.2, 0.3, 0.4, 0.5]
    np.testing.assert_allclose(pos, tr.trajectory(), atol=1e-5)


def test_streaming_epoch_timestamps(runs, tmp_path):
    """UNIX-epoch stamps neither crash the packer nor corrupt the 0.3 s
    keyframe gate: on-device time is run-relative, the TUM stream keeps the
    absolute float64 stamps."""
    cfg, tcfg = runs["cfg"], runs["tcfg"]
    frames = 8
    xyz, inten = _render(cfg, frames, yaw_rate=0.0)
    base = 1.755e9
    log_path, traj_path = tmp_path / "epoch.islog", tmp_path / "epoch.tum"
    _write(log_path, cfg, xyz, inten, base=base)
    tr = TS.StreamingRunner(tcfg, traj_path=str(traj_path), device="cpu")
    with ScanLog(str(log_path)) as log:
        stats = tr.run(log)
    assert stats["frames"] == frames
    assert stats["keyframes"] >= 2      # a poisoned time gate gives exactly 1
    ts, _ = _tum(traj_path)
    assert len(ts) == frames
    np.testing.assert_allclose([float(v) for v in ts],
                               [base + 0.1 * k for k in range(frames)], atol=5e-4)


def test_drop_oldest_leaves_no_slot_pinned(runs, tmp_path, monkeypatch):
    """A writer slower than the dispatch loop: the channel drops the oldest
    records, the slot table stays bounded by twice the capacity while the
    run lasts, and nothing is left in it after the run."""

    class SlowWriter(TS.TrajectoryWriter):
        def append(self, *a):
            time.sleep(0.02)
            super().append(*a)

    monkeypatch.setattr(TS, "TrajectoryWriter", SlowWriter)
    cap = 2
    tr = TS.StreamingRunner(runs["tcfg"], traj_path=str(tmp_path / "slow.tum"),
                            queue_capacity=cap, device="cpu")
    th = tr._open_writer()
    assert isinstance(th, threading.Thread)
    most = 0
    for idx in range(60):
        info = TF.FrameInfo(*([torch.zeros(())] * 9), pose_t=torch.tensor([idx, 0.0, 0.0]))
        tr._record_pose(idx, 0.1 * idx, info)
        most = max(most, len(tr._slots))
    tr._close_writer(th)
    dropped = tr._chan.dropped      # the end-of-stream marker may drop one more
    assert dropped > 0 and most <= 2 * cap + 1
    assert tr._slots == {}
    ts, pos = _tum(tmp_path / "slow.tum")
    assert len(ts) == 60 - dropped
    assert pos[-1, 0] == 59.0                    # the newest frame is written
