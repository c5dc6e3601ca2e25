#!/usr/bin/env python
"""The circuit benchmark on the OS0-64-exact beam table (+-45 deg vertical
FOV, the sensor of the reference's demo recording) through the port's
`SlamSystem`: the PyTorch/CUDA counterpart of `tools/os0_eval.py`.

    python tools/torch_os0_eval.py [--frames 420] [--device cuda]
                                   [--out RESULTS_torch_os064.json]

Writes the JAX tool's keys plus `device` (the card's name and power limit)
to `--out`.  `wall_s_incl_compile` keeps its key; the port compiles
nothing, so it is the wall time of all frames, first-use set-up included.
`--small` (small_test_config) exists to rehearse the tool on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_os064.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402

SCAN_DT = 0.1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    frames = args.frames
    cfg = config.small_test_config() if args.small else config.os0_64_config()
    poses = synthetic.circuit_trajectory(frames, speed=0.4, device=dev)
    xyz, inten = synthetic.render_sequence(
        poses, synthetic.circuit_world(device=dev), cfg.sensor)
    gt_t = synthetic.relative_positions(poses).cpu().numpy()

    sys_ = SlamSystem(cfg, device=dev)
    t0 = time.perf_counter()
    for k in range(frames):
        sys_.process(xyz[k], inten[k], SCAN_DT * k)
    traj = sys_.trajectory()
    dt = time.perf_counter() - t0
    err = np.linalg.norm(traj - gt_t[: len(traj)], axis=-1)
    res = {
        "sensor": ("OS0-64-exact (+-45 deg vertical FOV)" if not args.small
                   else "small_test_config"),
        "world": "circuit",
        "frames": frames,
        "keyframes": sys_.num_keyframes,
        "loops": len(sys_.loops),
        "ate_m": round(float(np.sqrt(np.mean(err ** 2))), 4),
        "max_err_m": round(float(err.max()), 4),
        "end_err_m": round(float(err[-1]), 4),
        "wall_s_incl_compile": round(dt, 1),
        "device": devices.describe(dev),
    }
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
