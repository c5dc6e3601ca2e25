"""Deterministic LIVE system for the distributed back-end's checks.

PyTorch counterpart of `intensity_slam_tpu/parallel/live_demo.py`: a small
but real `SlamSystem` run (corridor world, straight trajectory, keyframes,
pose graph and keyframe store filled by the fused step), used by the
multi-process check (`parallel.multiproc`).  Every process that calls this
with the same arguments on the same kind of device computes the same state,
which is what lets the ranks treat their copies as one replicated state.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import config
from ..io import synthetic
from ..pipeline.system import SlamSystem
from ..utils import se3
from ..utils.se3 import Pose


def live_config(n_scale: int = 8) -> config.SlamConfig:
    """The check's live config: small sensor, keyframe capacity scaled to
    the mesh size, online refine enabled."""
    live_cfg = config.small_test_config()
    return live_cfg.replace(
        loop=dataclasses.replace(
            live_cfg.loop, max_keyframes=8 * n_scale,
            keyframe_cloud_size=256, sc_num_exclude_recent=4,
            min_loop_search_gap=4,
        ),
        odometry=dataclasses.replace(
            live_cfg.odometry, keyframe_time_interval=0.15),
        parallel=dataclasses.replace(
            live_cfg.parallel, refine_every_kf=4, ba_gn_iters=2,
            ba_cg_iters=8),
        log_capacity=128,
    )


def build_live_system(cfg: config.SlamConfig, frames: int = 12, mesh=None,
                      device="cuda") -> SlamSystem:
    """Run `frames` corridor frames, 0.4 m apart along +x, through the fused
    step on `device`; returns the live system."""
    device = torch.device(device)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    step = Pose(ident, torch.tensor([0.4, 0.0, 0.0], device=device))
    pose = Pose(ident, torch.tensor([0.0, 0.0, 0.8], device=device))
    qs, ts = [], []
    for _ in range(frames):
        qs.append(pose.q)
        ts.append(pose.t)
        pose = se3.compose(pose, step)
    xyz, inten = synthetic.render_sequence(
        Pose(torch.stack(qs), torch.stack(ts)),
        synthetic.corridor_world(device=device), cfg.sensor)
    system = SlamSystem(cfg, mesh=mesh, device=device)
    for k in range(frames):
        system.process(xyz[k], inten[k], 0.1 * k)
    return system
