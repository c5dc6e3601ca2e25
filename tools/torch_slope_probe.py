#!/usr/bin/env python
"""Time every frame by its class over a multi-lap circuit: the counterpart
of `tools/slope_probe.py` for the PyTorch/CUDA port.

    python tools/torch_slope_probe.py [--frames 2400] [--device cuda]
                                      [--out RESULTS_torch_slope.json]

Every frame goes through `SlamSystem.process` (os0_64_config) and is timed
on its own, from a synchronized start to a synchronized end, and sorted by
its `FrameInfo` into one class:

  plain     no keyframe work (front end and scan-to-map only)
  kf        a keyframe, no loop candidate verified
  verify    a candidate verified (ICP and gates) and rejected
  accept    a loop accepted (ICP, PCM, the dense PGO, the map rebuild)

The rows give each class's count, mean, median, 95th percentile and
maximum (a process's first accepted loop pays a cold start-up on the card,
which shows as the accept class's maximum), its total and its share of the
wall time, and per 600-frame chunk the rate and the verifications and
accepts.  The synchronization per frame makes the wall time an upper
bound.  The scans are rendered on the device in chunks before the timed
loop (about 2.5 GB at 2400 full-width frames).

Writes the JAX tool's keys plus `device` (the card's name and power limit)
and `max_ms` per class.  `--small` (small_test_config) rehearses the tool
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_slope.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import se3  # noqa: E402

CHUNK = 600          # frames per chunk row
RENDER_CHUNK = 64    # frames rendered per call
CLASSES = ("plain", "kf", "verify", "accept")


def render_circuit(frames: int, cfg, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The circuit at 0.4 m a frame, rendered on `dev` chunk by chunk into
    one (F, H*W, 3) and one (F, H*W) tensor."""
    world = synthetic.circuit_world(device=dev)
    poses = synthetic.circuit_trajectory(frames, speed=0.4, device=dev)
    n = cfg.sensor.image_height * cfg.sensor.image_width
    xyz = torch.empty((frames, n, 3), dtype=torch.float32, device=dev)
    inten = torch.empty((frames, n), dtype=torch.float32, device=dev)
    for s in range(0, frames, RENDER_CHUNK):
        e = min(s + RENDER_CHUNK, frames)
        xyz[s:e], inten[s:e] = synthetic.render_sequence(
            se3.Pose(poses.q[s:e], poses.t[s:e]), world, cfg.sensor)
    return xyz, inten


def frame_class(info) -> tuple[str, int]:
    """(class, keyframes after the frame) of a frame's `FrameInfo`."""
    is_kf, accepted, fitness, num_kf = torch.stack([
        info.is_keyframe.float(), info.loop_found.float(), info.icp_fitness.float(),
        info.num_kf.float()]).tolist()
    cls = ("accept" if accepted else "verify" if np.isfinite(fitness)
           else "kf" if is_kf else "plain")
    return cls, int(num_kf)


def summarize(rows: list, frames: int, wall: float) -> dict:
    """The JAX tool's record of (class, ms, keyframes) rows."""
    res = {"frames": frames, "wall_s_sync": round(wall, 1),
           "note": "per-frame synchronize: wall here is an UPPER bound (the "
                   "probe stops the host from running ahead of the device)",
           "classes": {}, "chunks": []}
    for cls in CLASSES:
        ts = np.array([m for c, m, _ in rows if c == cls])
        if len(ts) == 0:
            continue
        res["classes"][cls] = {
            "count": int(len(ts)),
            "mean_ms": round(float(ts.mean()), 2),
            "p50_ms": round(float(np.percentile(ts, 50)), 2),
            "p95_ms": round(float(np.percentile(ts, 95)), 2),
            "max_ms": round(float(ts.max()), 2),
            "total_s": round(float(ts.sum()) / 1e3, 1),
            "share_pct": round(100 * float(ts.sum()) / (wall * 1e3), 1),
        }
    for s in range(0, len(rows), CHUNK):
        seg = rows[s:s + CHUNK]
        tot = sum(m for _, m, _ in seg) / 1e3
        res["chunks"].append({
            "frames": f"{s + 1}-{s + len(seg)}",
            "num_kf_end": seg[-1][2],
            "scans_per_sec_sync": round(len(seg) / tot, 1),
            "verifies": sum(1 for c, _, _ in seg if c == "verify"),
            "accepts": sum(1 for c, _, _ in seg if c == "accept"),
        })
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2400)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.os0_64_config()
    frames = args.frames
    xyz, inten = render_circuit(frames, cfg, dev)

    sys_ = SlamSystem(cfg, device=dev)
    sys_.process(xyz[0], inten[0], 0.0)
    devices.synchronize(dev)

    rows = []      # (class, ms, keyframes)
    t_run0 = time.perf_counter()
    for k in range(1, frames):
        t0 = time.perf_counter()
        info = sys_.process(xyz[k], inten[k], 0.1 * k)
        devices.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        cls, num_kf = frame_class(info)
        rows.append((cls, ms, num_kf))
    wall = time.perf_counter() - t_run0

    res = summarize(rows, frames, wall)
    res["device"] = devices.describe(dev)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
