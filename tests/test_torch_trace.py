"""The span recorder (`intensity_slam_tpu_torch/utils/spans.py`) and the
per-layer metrics that read it (`slambench/metrics/`), on the CPU at
small_test_config shapes; no JAX.

One module fixture streams five frames through `StreamingRunner` (wire
mode) from a scan log: the sensor at A, B, A (every frame a keyframe, the
third a loop to the first, accepted: loop search, cooldown and the
ScanContext exclusion cut to one keyframe), then at A with its intensity
flat (the intensity solve skips: the fallback), then at A again.  So the
fallback, keyframe, verify, accept and rebuild regions run, each where the
flags say.

- Device spans are present exactly where the flags read after the frame
  say their region ran; `frame`, `front`, `back`, `mapping` and `log` in
  every frame.
- A frame's spans share its identifier (run, log index) and nest inside
  their parents; self times are >= 0 and add up to the frame (device) and
  to the dispatch (host).
- A frame's device start is stamped inside its upload (the prologue: the
  upload, decode and input copies, and the launch, before `front`'s start,
  the graph's first node), and its device work `busy` runs from there to
  its last stamp.
- The device idle between frames, summed by host phase, adds up to the
  frames' idle, the prologue's phases among them.
- The ring keeps the newest `capacity` frames.
- A `metrics.device_trace` trace of two more frames holds the `stream.*`
  and `graph.*` phases by name.
- Every reader of the eight `program_span` metrics gives a number on the
  recorded run, and None where the window holds no frame.

On the card (`-m cuda`): stamps rise through the frame, an untaken If body
leaves its slots absent, and a replayed frame reads the host once.
"""

import dataclasses
import json
import os
import time

import pytest
import torch

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.pipeline import frame_graph
from intensity_slam_tpu_torch.runtime import ScanLog, ScanLogWriter
from intensity_slam_tpu_torch.runtime import stream
from intensity_slam_tpu_torch.utils import metrics, spans
from intensity_slam_tpu_torch.utils.se3 import Pose
from slambench import spec

torch.set_num_threads(1)
PLACES = (0, 1, 0, 0, 0)        # A, B, A, A, A
FLAT = 3                        # the frame whose intensity is flat
READERS = ("frame.device_ms_p50", "frame.idle_ms_p50", "device.idle_share",
           "frontend.device_ms_p50", "mapping.device_ms_p50", "mapping.solve_device_ms_p50",
           "keyframe.device_ms_p50", "pgo.device_ms_p50")


def _cfg():
    cfg = config.small_test_config()
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, min_loop_search_gap=1, loop_cooldown_kf=0, sc_num_exclude_recent=1))


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    cfg = _cfg()
    base = synthetic.corridor_trajectory(2, speed=0.4, device="cpu")
    at = torch.tensor(PLACES)
    xyz, inten = synthetic.render_sequence(Pose(base.q[at], base.t[at]),
                                           synthetic.corridor_world(device="cpu"), cfg.sensor)
    inten[FLAT] = 1.0
    path = str(tmp_path_factory.mktemp("trace") / "seq.islog")
    with ScanLogWriter(path, cfg.sensor.image_height, cfg.sensor.image_width) as w:
        for k in range(len(PLACES)):
            w.append(0.5 * k, xyz[k].numpy(), inten[k].numpy())
    rec = spans.Recorder()
    saved, spans.recorder = spans.recorder, rec
    try:
        runner = stream.StreamingRunner(cfg, device="cpu")
        seen = []

        def on_frame(idx, info):
            seen.append(dict(k=idx, t=time.perf_counter(), flags=dict(runner.graph.last_flags)))
        t0 = time.perf_counter()
        with ScanLog(path) as log:
            runner.run(log, on_frame=on_frame)
            frames = rec.frames()
            trace_dir = str(tmp_path_factory.mktemp("profile"))
            runner.reset()
            with metrics.device_trace(trace_dir, device="cpu"):
                runner.run(log, end=2)
    finally:
        spans.recorder = saved
    with open(os.path.join(trace_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    return dict(rec=rec, frames=frames, seen=seen, t0=t0, names=names)


def test_device_spans_where_the_flags_say(recorded):
    frames, seen = recorded["frames"], recorded["seen"]
    assert [f.index for f in frames] == [s["k"] for s in seen] == list(range(len(PLACES)))
    ran = {r for s in seen for r, v in s["flags"].items() if v}
    assert {"fallback", "keyframe", "verify", "accept", "rebuild"} <= ran, seen
    for f, s in zip(frames, seen):
        for region in frame_graph.FrameGraph.REGIONS:
            assert (region in f.device) == bool(s["flags"][region]), (f.index, region, s)
        assert {"frame", "front", "back", "mapping", "log"} <= set(f.device), f.index


def test_spans_share_the_frame_and_nest(recorded):
    rec, frames = recorded["rec"], recorded["frames"]
    assert len({f.run for f in frames}) == 1
    for f in frames:
        mine = rec.spans([f])
        assert {s.frame for s in mine} == {(f.run, f.index)}
        by = {(s.clock, s.name): s for s in mine}
        for s in mine:
            assert s.start <= s.end, s
            if s.parent is not None:
                p = by[(s.clock, s.parent)]
                assert p.start <= s.start and s.end <= p.end, (s, p)
        assert {"stream.upload", "stream.decode", "graph.inputs", "graph.launch",
                "graph.read", "graph.unpack", "stream.spill", "stream.pose",
                "stream.caller"} <= set(f.host), f.index
        # the device work lies inside the dispatch, on one clock
        assert f.host["dispatch"][0] <= f.device["frame"][0] <= f.device["frame"][1] \
            <= f.host["graph.read"][1]


def test_self_times_add_up_to_the_frame(recorded):
    for f in recorded["frames"]:
        own = spans.Recorder.self_times(f)
        assert all(v >= 0 for v in own.values()), own
        dev = sum(v for n, v in own.items() if n in f.device)
        host = sum(v for n, v in own.items() if n in f.host)
        assert dev == f.device["frame"][1] - f.device["frame"][0]
        assert host == f.host["dispatch"][1] - f.host["dispatch"][0]


def test_frame_starts_in_its_upload(recorded):
    for f in recorded["frames"]:
        up, front, frame = f.host["stream.upload"], f.device["front"], f.device["frame"]
        assert up[0] <= frame[0] <= up[1] <= f.host["stream.decode"][0], f
        assert f.host["graph.launch"][0] <= front[0] <= f.host["graph.launch"][1], f
        assert f.busy == (front[0], frame[1])
        assert f.busy_ms == pytest.approx((frame[1] - front[0]) * 1e-6)


def test_idle_by_phase_adds_up_to_the_gaps(recorded):
    rec, frames = recorded["rec"], recorded["frames"]
    assert frames[0].idle is None and all(f.idle > 0 for f in frames[1:])
    for p, f in zip(frames, frames[1:]):
        assert f.idle == f.device["front"][0] - p.device["frame"][1]
    by = rec.idle_by_phase(frames)
    assert sum(by.values()) == sum(f.idle for f in frames[1:])
    # after a frame's last stamp: its read, hand-offs and the caller; then
    # the next frame's prologue up to its graph's first node
    assert {"graph.read", "stream.caller", "stream.upload", "stream.decode",
            "graph.inputs", "graph.launch"} <= set(by), by


def test_trace_names_the_phases(recorded):
    names = recorded["names"]
    assert {"stream.upload", "stream.decode", "graph.inputs", "graph.launch",
            "graph.read", "graph.unpack", "stream.spill", "stream.pose"} <= names


def test_ring_keeps_the_newest_frames():
    rec = spans.Recorder(capacity=4)
    rec.begin_run()
    for k in range(10):
        assert rec.begin_frame(100 + k)
        assert not rec.begin_frame()          # one open frame a thread
        with rec.span("graph.launch"):
            pass
        rec.end_frame()
    frames = rec.frames()
    assert [f.index for f in frames] == [106, 107, 108, 109]
    assert [f.ordinal for f in frames] == [6, 7, 8, 9]
    assert all("graph.launch" in f.host and not f.device for f in frames)
    with pytest.raises(IndexError):
        spans.stamp(torch.zeros(spans.SLOTS, dtype=torch.int64), spans.SLOTS)
    with pytest.raises(ValueError):
        spans.stamp(torch.zeros(spans.SLOTS), 0)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_recorded_run(recorded, monkeypatch, name):
    read = spec.load_module(os.path.join(spec.ROOT, "slambench", "metrics", f"{name}.py"),
                            "test_reader_" + name.replace(".", "_")).read
    monkeypatch.setattr(spans, "recorder", recorded["rec"])
    seen = recorded["seen"]
    run = dict(t0=recorded["t0"], frames=seen)
    value = read(run)
    assert isinstance(value, float) and value > 0, (name, value)
    if name == "device.idle_share":
        assert value < 100
    # a window that holds no frame
    assert read(dict(t0=seen[-1]["t"] + 1.0, frames=[dict(t=seen[-1]["t"] + 2.0)])) is None


# ---- on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_stamps_rise_and_untaken_regions_stay_absent(monkeypatch):
    """Replayed frames of a straight corridor drive (no fallback, keyframes
    every few frames): the stamps of each frame rise in program order, the
    If regions the flags say were not taken read absent, and each replayed
    frame makes one host read (the flags' `tolist`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stamp kernel runs only on the card")
    cfg = config.small_test_config()
    dev = torch.device("cuda")
    poses = synthetic.corridor_trajectory(8, speed=0.1, device=dev)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(device=dev),
                                           cfg.sensor)
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "recorder", rec)
    fg = frame_graph.FrameGraph(cfg, dev, seed=3)
    reads = []
    tolist = torch.Tensor.tolist

    def counted(t):
        reads.append(tuple(t.shape))
        return tolist(t)
    flags = []
    for k in range(len(xyz)):
        if k == 2:
            monkeypatch.setattr(torch.Tensor, "tolist", counted)
        fg.step(xyz[k], inten[k], 0.1 * k)
        flags.append(dict(fg.last_flags))
    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    assert reads == [(len(fg.FLAGS) + spans.SLOTS,)] * (len(xyz) - 2)
    assert fg.replays["frame"] == len(xyz) - 1
    frames = rec.frames()
    assert len(frames) == len(xyz)
    cal = rec.calibration[torch.cuda.current_device()]
    assert cal["error_ns"] > 0
    order = ("front", "fallback", "back", "keyframe", "log")
    for f, fl in zip(frames[1:], flags[1:]):
        for region in frame_graph.FrameGraph.REGIONS:
            assert (region in f.device) == bool(fl[region]), (f.index, region)
        assert f.busy[0] == f.device["front"][0] > f.device["frame"][0], f
        starts = [f.device["frame"][0]] + [f.device[r][0] for r in order if r in f.device]
        ends = [f.device[r][1] for r in order if r in f.device] + [f.device["frame"][1]]
        assert starts == sorted(starts) and ends == sorted(ends), f
        assert f.device["back"][0] <= f.device["mapping"][0] <= f.device["mapping"][1] \
            <= f.device["back"][1]
    assert any(not fl["keyframe"] for fl in flags[1:])
