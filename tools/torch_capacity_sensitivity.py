#!/usr/bin/env python
"""How far one float32 rounding step of the input moves the port's
trajectory at the configuration of tests/test_torch_capacity.py
(small_test_config, `max_keyframes` 8, 256-point keyframe clouds, every
loop channel off, a keyframe nearly every frame, `log_capacity` 12).

    python tools/torch_capacity_sensitivity.py [--device cuda]

For each scene (`speed`, `yaw_rate` of `corridor_trajectory` in the corridor
world, per frame; 24 frames, as the tests) it runs `SlamSystem` once on the
rendered scans, then once for each of two draws with every input coordinate
scaled by 1 + u, u uniform in +-2e-7, and prints, per draw, the largest
change of `trajectory()` and of `odom_trajectory()` and the frame where the
trajectory moved most.  Two
packages that round differently part by about as much on the same scans,
which is why the capacity tests hold `trajectory()` on one carried state
and not across two runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402

FRAMES = 24
SCENES = ((0.5, 0.0), (0.5, 0.01), (0.35, 0.02))   # the straight corridor, two curves
DRAWS = 2


def capacity_config() -> config.SlamConfig:
    """tests/test_torch_capacity.py's `wrap_compact` configuration."""
    base = config.small_test_config()
    lc = dataclasses.replace(base.loop, max_keyframes=8, keyframe_cloud_size=256,
                             use_scancontext=False, use_bow_loop=False,
                             use_radius_search=False)
    od = dataclasses.replace(base.odometry, keyframe_time_interval=0.05,
                             keyframe_distance_interval=0.05)
    return base.replace(loop=lc, odometry=od, log_capacity=12)


def run(cfg, xyz, inten, dev):
    sys_ = SlamSystem(cfg, device=dev)
    for k in range(xyz.shape[0]):
        sys_.process(xyz[k], inten[k], 0.1 * k)
    return sys_.trajectory(), sys_.odom_trajectory()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = capacity_config()
    world = synthetic.corridor_world(device=dev)
    print(f"device: {devices.describe(dev)}")
    for speed, yaw in SCENES:
        poses = synthetic.corridor_trajectory(FRAMES, speed=speed, yaw_rate=yaw, device=dev)
        xyz, inten = synthetic.render_sequence(poses, world, cfg.sensor)
        traj, odom = run(cfg, xyz, inten, dev)
        for d in range(DRAWS):
            gen = torch.Generator(device=dev).manual_seed(d)
            u = (torch.rand(xyz.shape, generator=gen, device=dev) * 2 - 1) * 2e-7
            t2, o2 = run(cfg, xyz * (1 + u), inten, dev)
            dt = np.abs(t2 - traj).max(axis=1)
            print(f"speed {speed} yaw {yaw} draw {d}: trajectory moved {dt.max():.4f} m "
                  f"(frame {int(dt.argmax())}), odometry {np.abs(o2 - odom).max():.5f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
