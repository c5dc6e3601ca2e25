#!/usr/bin/env python
"""The distributed refine's effect on the product trajectory, through the
PyTorch/CUDA port: the counterpart of `tools/refine_eval.py`.

    python tools/torch_refine_eval.py [--frames 420] [--device cuda]
                                      [--out RESULTS_torch_refine.json]

Runs the circuit benchmark (SlamConfig() defaults, as the JAX tool) with the
online refine off and on (every 8 keyframes), with BA pose write-back off
and on, and once more with the refine over a mesh: a one-rank process group
(NCCL on the card, gloo on the CPU), as `chip_smoke.py`'s refine phase runs
it.  A run with the refine on ends with one more `refine()`.  Writes the
corrected-export ATE, end error, loops, keyframes and wall time of each
variant, plus `device` (the card's name and power limit).  `--small`
(small_test_config) exists to rehearse the tool on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import sys
import time

import numpy as np
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_refine.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.parallel import multiproc  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402

SCAN_DT = 0.1


@contextlib.contextmanager
def one_rank_mesh(dev):
    """A process group of this process alone, on `dev` (NCCL on a card,
    gloo on the CPU), for the length of the block."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    mesh = multiproc.initialize(0, 1, f"127.0.0.1:{port}", backend, timeout_s=300)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def run(cfg, xyz, inten, gt_t: np.ndarray, frames: int, dev, mesh=None) -> dict:
    sys_ = SlamSystem(cfg, device=dev, mesh=mesh)
    t0 = time.perf_counter()
    for k in range(frames):
        sys_.process(xyz[k], inten[k], SCAN_DT * k)
    # one final refine at the end of the run when enabled (the batch counterpart
    # of updatePoses; the online trigger already ran every refine_every_kf)
    if cfg.parallel.refine_every_kf > 0:
        sys_.refine()
    traj = sys_.trajectory()
    dt = time.perf_counter() - t0
    err = np.linalg.norm(traj - gt_t[: len(traj)], axis=-1)
    return {
        "ate_m": round(float(np.sqrt(np.mean(err ** 2))), 4),
        "end_err_m": round(float(err[-1]), 4),
        "loops": len(sys_.loops),
        "keyframes": sys_.num_keyframes,
        "wall_s": round(dt, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    frames = args.frames
    base = config.small_test_config() if args.small else config.SlamConfig()
    poses = synthetic.circuit_trajectory(frames, speed=0.4, device=dev)
    xyz, inten = synthetic.render_sequence(
        poses, synthetic.circuit_world(device=dev), base.sensor)
    gt_t = synthetic.relative_positions(poses).cpu().numpy()

    refine8 = base.replace(parallel=dataclasses.replace(base.parallel, refine_every_kf=8))
    variants = {
        "baseline_no_refine": (base, False),
        "refine_every_8kf": (refine8, False),
        "refine_every_8kf_ba_writeback": (base.replace(parallel=dataclasses.replace(
            base.parallel, refine_every_kf=8, ba_pose_writeback=True)), False),
        "refine_every_8kf_mesh": (refine8, True),
    }
    results = {"frames": frames, "world": "circuit",
               "device": devices.describe(dev), "variants": {}}
    for name, (cfg, on_mesh) in variants.items():
        if on_mesh:
            with one_rank_mesh(dev) as mesh:
                r = run(cfg, xyz, inten, gt_t, frames, dev, mesh=mesh)
        else:
            r = run(cfg, xyz, inten, gt_t, frames, dev)
        results["variants"][name] = r
        print(f"{name:32s} ate={r['ate_m']:.4f} end={r['end_err_m']:.4f} "
              f"loops={r['loops']} ({r['wall_s']}s)", flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
