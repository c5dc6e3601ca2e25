#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port: full-system SLAM throughput on one
card.

    python3 bench_torch.py [--device cuda] [--small]

Prints ONE JSON line with `bench.py`'s keys (`metric`, `value`, `unit`,
`vs_baseline`, `front_end_scans_per_sec`, `front_end_vs_baseline`,
`keyframes`, `loop_closures`, `compile_s`) plus `device`, the card's name
and power limit.  The baseline is the reference system's real-time claim,
the sensor's 10 Hz, so `vs_baseline` is (scans/s) / 10.

- `front_end_scans_per_sec`: `slam_step` over the 64-frame corridor
  (`bench.py:34-59`).
- `value`: `SlamSystem.process` over the 420-frame circuit with its
  textureless span, loop closure, PGO and live feedback on
  (`bench.py:62-105`), rendered on the card before the timed loop (about
  440 MB on the device at full width).  `process` runs each frame through
  `pipeline.frame_graph.FrameGraph`: on the card, CUDA graphs replayed over
  a state updated in place (the reference's jitted, donating step).
- `compile_s` keeps `bench.py`'s key but holds the circuit's first frame's
  time: first-use set-up (CUDA context, the kernels' build on a cold
  checkout, library handles), one eager frame and the capture of the graphs
  its branches take (the counterpart of XLA's compile of the first call).

Both measurements use `os0_64_config()`; `--small` (small_test_config)
rehearses the script on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.ops import projection  # noqa: E402
from intensity_slam_tpu_torch.pipeline import slam  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402

FRONTEND_FRAMES = 64   # the corridor of bench.py:34-59
FRAMES = 420           # the circuit of bench.py:62-105


def bench_frontend(cfg, dev, frames: int) -> float:
    """scans/s of `slam_step` over the corridor, after the first frame."""
    world = synthetic.corridor_world(device=dev)
    poses = synthetic.corridor_trajectory(frames, speed=0.35, yaw_rate=0.005, device=dev)
    xyz, inten = synthetic.render_sequence(poses, world, cfg.sensor)
    mask = projection.detection_mask(cfg.sensor, device=dev)
    times = [k * cfg.sensor.scan_period for k in range(frames)]
    state = slam.init_state(cfg, device=dev)
    state, _ = slam.slam_step(state, xyz[0], inten[0], times[0], mask, cfg)
    devices.synchronize(dev)
    t0 = time.perf_counter()
    for k in range(1, frames):
        state, _ = slam.slam_step(state, xyz[k], inten[k], times[k], mask, cfg)
    devices.synchronize(dev)
    return (frames - 1) / (time.perf_counter() - t0)


def bench_full_system(cfg, dev, frames: int) -> dict:
    """`SlamSystem.process` over the circuit: the first frame timed on its
    own, then the rest with one wait for the card at the end."""
    poses = synthetic.circuit_trajectory(frames, speed=0.4, device=dev)
    xyz, inten = synthetic.render_sequence(poses, synthetic.circuit_world(device=dev),
                                           cfg.sensor)
    sys_ = SlamSystem(cfg, device=dev)
    devices.synchronize(dev)
    t0 = time.perf_counter()
    sys_.process(xyz[0], inten[0], 0.0)
    devices.synchronize(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(1, frames):
        sys_.process(xyz[k], inten[k], 0.1 * k)
    devices.synchronize(dev)
    dt = time.perf_counter() - t0
    return {
        "full_system_scans_per_sec": (frames - 1) / dt,
        "full_system_frames": frames,
        "full_system_keyframes": sys_.num_keyframes,
        "full_system_loops": len(sys_.loops),
        "compile_s": first_s,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--small", action="store_true", help="small test shapes")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.os0_64_config()
    sps_front = bench_frontend(cfg, dev, FRONTEND_FRAMES)
    full = bench_full_system(cfg, dev, FRAMES)
    sps_full = full["full_system_scans_per_sec"]
    print(json.dumps({
        "metric": "slam_scans_per_sec_full_system",
        "value": round(sps_full, 2),
        "unit": "scans/s (SlamSystem.process incl. loop closure + PGO, "
                f"{cfg.sensor.image_height}x{cfg.sensor.image_width}, circuit world)",
        "vs_baseline": round(sps_full / 10.0, 2),
        "front_end_scans_per_sec": round(sps_front, 2),
        "front_end_vs_baseline": round(sps_front / 10.0, 2),
        "keyframes": full["full_system_keyframes"],
        "loop_closures": full["full_system_loops"],
        "compile_s": round(full["compile_s"], 1),
        "device": devices.describe(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
