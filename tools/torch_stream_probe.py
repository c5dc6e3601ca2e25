#!/usr/bin/env python
"""Where the streaming stack's time goes: the counterpart of
`tools/stream_probe.py` for the PyTorch/CUDA port.

    python tools/torch_stream_probe.py [--frames 256] [--device cuda]
                                       [--out RESULTS_torch_stream_probe.json]

Three modes over the same circuit scan log (os0_64_config), each timed on
its second, warm pass from a pristine state:

  writer-on    `StreamingRunner.run_preloaded` with the pose writer (the
               shipped path: a per-frame pose handle to the writer thread)
  writer-off   the same with `traj_path=None`
  bare-loop    `fused_step` dispatched in a plain loop over the packed wire
               log, uploaded to the device once and decoded by the runner's
               own `wire_decode` (the ceiling of the streaming stack)

The reference suspected its pose writer of one device fetch per frame over
the TPU's transport.  The port's writer makes no such fetch on the dispatch
thread: the dispatch thread queues a non-blocking copy of the position into
pinned memory and records an event, and the writer thread waits on that
event on its own thread.  What the writer costs here is that copy, the
event and the hand-off.

All three modes run the same step on the same decoded inputs, so they must
end with the same keyframe count and the same final position (bit for bit);
the tool exits 1 when they do not, so that a faster mode cannot be a
different one.  Writes the JAX tool's keys plus `device` (the card's name
and power limit).  `--small` (small_test_config) rehearses the tool on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_stream_probe.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.ops import projection  # noqa: E402
from intensity_slam_tpu_torch.pipeline import fused  # noqa: E402
from intensity_slam_tpu_torch.runtime import ScanLog, ScanLogWriter  # noqa: E402
from intensity_slam_tpu_torch.runtime.stream import (  # noqa: E402
    _WIRE_MAX_RANGE, StreamingRunner, _build_dir_lut, wire_decode)
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import se3  # noqa: E402

RENDER_CHUNK = 32


def write_circuit_log(path: str, frames: int, cfg, dev) -> None:
    """The circuit at 0.4 m a frame, rendered on `dev` in chunks, into a
    scan log at 10 Hz."""
    world = synthetic.circuit_world(device=dev)
    poses = synthetic.circuit_trajectory(frames, speed=0.4, device=dev)
    with ScanLogWriter(path, cfg.sensor.image_height, cfg.sensor.image_width) as w:
        for s in range(0, frames, RENDER_CHUNK):
            chunk = se3.Pose(poses.q[s:s + RENDER_CHUNK], poses.t[s:s + RENDER_CHUNK])
            xyz, inten = synthetic.render_sequence(chunk, world, cfg.sensor)
            xyz, inten = xyz.cpu().numpy(), inten.cpu().numpy()
            for k in range(xyz.shape[0]):
                w.append(0.1 * (s + k), xyz[k], inten[k])


def _end(st: fused.FusedState) -> tuple[int, np.ndarray]:
    """(keyframes, the last logged position) of a fused state."""
    last = (int(st.log.count) - 1) % st.log.t.shape[0]
    return int(st.backend.num_kf), st.log.t[last].cpu().numpy()


def preloaded_pass(cfg, path: str, dev, traj_path) -> tuple[float, tuple]:
    """Seconds of the warm `run_preloaded` pass, and its (keyframes, final
    position)."""
    runner = StreamingRunner(cfg, traj_path=traj_path, device=dev)
    with ScanLog(path) as log:
        runner.run_preloaded(log)                 # warm
        runner.reset()
        devices.synchronize(dev)
        t0 = time.perf_counter()
        runner.run_preloaded(log)
        devices.synchronize(dev)
        dt = time.perf_counter() - t0
    return dt, _end(runner.state)


def bare_pass(cfg, path: str, frames: int, dev) -> tuple[float, tuple]:
    """Seconds of a plain `fused_step` loop over the device-resident wire
    log (after one warm step from a fresh state), and its end."""
    with ScanLog(path) as log:
        dirs = torch.from_numpy(_build_dir_lut(log)).to(dev)
        packed = [wf.packed for wf in log.stream_wire(0, frames, 4, _WIRE_MAX_RANGE)]
    dev_log = torch.from_numpy(np.stack(packed).view(np.int16)).to(dev)
    mask = projection.detection_mask(cfg.sensor, device=dev)

    def step(st, j):
        xyz, inten, ts = wire_decode(dev_log[j], dirs)
        return fused.fused_step(st, xyz, inten, ts, mask, cfg)

    step(fused.init_state(cfg, device=dev), 0)    # warm
    st = fused.init_state(cfg, device=dev)
    devices.synchronize(dev)
    t0 = time.perf_counter()
    for j in range(frames):
        st, _ = step(st, j)
    devices.synchronize(dev)
    dt = time.perf_counter() - t0
    return dt, _end(st)


def check_modes(ends: dict) -> list[str]:
    """The modes' disagreements: keyframe counts, final positions."""
    ref_name, (ref_kf, ref_t) = next(iter(ends.items()))
    bad = []
    for name, (kf, t) in ends.items():
        if kf != ref_kf or not np.array_equal(t, ref_t):
            bad.append(f"{name}: {kf} keyframes, final position {t.tolist()} against "
                       f"{ref_name}'s {ref_kf}, {ref_t.tolist()}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.os0_64_config()
    frames = args.frames
    res = {"frames": frames}
    ends = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "probe.islog")
        write_circuit_log(path, frames, cfg, dev)
        dt_on, ends["writer-on"] = preloaded_pass(cfg, path, dev, os.path.join(td, "t.tum"))
        res["preloaded_writer_on_sps"] = round(frames / dt_on, 1)
        dt_off, ends["writer-off"] = preloaded_pass(cfg, path, dev, None)
        res["preloaded_writer_off_sps"] = round(frames / dt_off, 1)
        dt_bare, ends["bare-loop"] = bare_pass(cfg, path, frames, dev)
        res["bare_dispatch_sps"] = round(frames / dt_bare, 1)

    res["writer_cost_pct"] = round(
        100.0 * (res["preloaded_writer_off_sps"] - res["preloaded_writer_on_sps"])
        / res["preloaded_writer_off_sps"], 1)
    res["stack_overhead_vs_bare_pct"] = round(
        100.0 * (res["bare_dispatch_sps"] - res["preloaded_writer_off_sps"])
        / res["bare_dispatch_sps"], 1)
    res["device"] = devices.describe(dev)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    print(f"results -> {args.out}")
    for name, (kf, t) in ends.items():
        print(f"  {name}: {kf} keyframes, final position {t.tolist()}")
    bad = check_modes(ends)
    for line in bad:
        print(f"FAIL: {line}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
