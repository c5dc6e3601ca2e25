#!/usr/bin/env python
"""Long-run soak of the PyTorch/CUDA port: the counterpart of
`tools/soak.py`.

    python tools/torch_soak.py [--frames 9000] [--device cuda]
                               [--out RESULTS_torch_soak.json]

Drives os0_64_config past BOTH capacity limits in one run: more than
2 x max_keyframes (1024) keyframes and more than log_capacity (8192)
frames, so that keyframe-store compaction, the loop-edge ring wrap, map
eviction, the frame-log wrap and the host spill all fire mid-run.  Then it
checks that the frame rate stays bounded (no chunk slower than 40 % of the
median) and that the exported trajectory covers every frame.

The workload is the circuit world replayed lap after lap: one lap (390
frames) is rendered once on the device, and the same frames stream in with
continuing timestamps (9000 frames = ~23 laps, ~3.6 km).  Ground truth
tiles the lap.  Writes the JAX tool's keys plus `device` (the card's name
and power limit); `compile_s` keeps its key and holds the first frame's
time (the port compiles nothing).  `--small` (small_test_config)
rehearses the tool on the CPU.
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
OUT = os.path.join(ROOT, "RESULTS_torch_soak.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import se3  # noqa: E402

SCAN_DT = 0.1
LAP = 390      # one closed lap: 4 legs at 0.4 m/frame + 4 smooth quarter turns
CHUNK = 500    # frames per throughput sample


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=9000)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.os0_64_config()

    poses = synthetic.circuit_trajectory(LAP + 1, speed=0.4, device=dev)
    # the lap must end where it starts for the frames to be reused
    gap = float(torch.linalg.norm(poses.t[LAP] - poses.t[0]))
    print(f"lap closure gap: {gap:.2f} m (frame reuse valid below ~2 m)")
    lap = se3.Pose(poses.q[:LAP], poses.t[:LAP])
    xyz, inten = synthetic.render_sequence(
        lap, synthetic.circuit_world(device=dev), cfg.sensor)
    lap_gt = synthetic.relative_positions(lap).cpu().numpy()
    gt_t = np.tile(lap_gt, (args.frames // LAP + 1, 1))[: args.frames]

    sys_ = SlamSystem(cfg, device=dev)
    t0 = time.perf_counter()
    info = sys_.process(xyz[0], inten[0], 0.0)
    devices.synchronize(dev)
    first_s = time.perf_counter() - t0

    chunk_stats = []
    t0 = tc = time.perf_counter()
    for k in range(1, args.frames):
        info = sys_.process(xyz[k % LAP], inten[k % LAP], SCAN_DT * k)
        if k % CHUNK == 0:
            n_kf = int(info.num_kf)          # one wait per chunk
            now = time.perf_counter()
            chunk_stats.append({"frame": k,
                                "scans_per_sec": round(CHUNK / (now - tc), 1),
                                "keyframes": n_kf})
            print(f"frame {k:5d}: {chunk_stats[-1]['scans_per_sec']:7.1f} "
                  f"scans/s  kf={n_kf}", flush=True)
            tc = now
    devices.synchronize(dev)
    total_s = time.perf_counter() - t0

    traj = sys_.trajectory()                 # spill + live window
    n = len(traj)
    bad = ~np.isfinite(traj).all(axis=-1)
    if bad.any():
        idx = np.where(bad)[0]
        print(f"NONFINITE trajectory rows: {int(bad.sum())} (first {idx[0]}, last "
              f"{idx[-1]}; spilled frames cover [0, {sys_._spiller.spilled}))")
    err = np.linalg.norm(traj - gt_t[:n], axis=-1)
    rates = [c["scans_per_sec"] for c in chunk_stats]
    res = {
        "frames": args.frames,
        "laps": round(args.frames / LAP, 1),
        "distance_m": round(args.frames * 0.4, 0),
        "compile_s": round(first_s, 1),
        "total_s": round(total_s, 1),
        "scans_per_sec_overall": round((args.frames - 1) / total_s, 1),
        "scans_per_sec_chunks_min": min(rates) if rates else None,
        "scans_per_sec_chunks_max": max(rates) if rates else None,
        "keyframes_final": sys_.num_keyframes,
        "max_keyframes": cfg.loop.max_keyframes,
        "log_capacity": cfg.log_capacity,
        "log_count": int(sys_.state.log.count),
        "loops_accepted": len(sys_.loops),
        "trajectory_frames_exported": n,
        "spilled_frames": sys_._spiller.spilled,
        "ate_m": round(float(np.sqrt(np.mean(err ** 2))), 3),
        "max_err_m": round(float(err.max()), 3),
        "end_err_m": round(float(err[-1]), 3),
        "device": devices.describe(dev),
        "chunks": chunk_stats,
    }
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "chunks"}, indent=1))
    print(f"results -> {args.out}")
    if rates and min(rates) <= 0.4 * float(np.median(rates)):
        print(f"FAIL: frame rate collapsed: min {min(rates)} vs median "
              f"{float(np.median(rates))}")
        return 1
    if n != args.frames:
        print(f"FAIL: the whole-run export has {n} of {args.frames} frames")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
