#!/usr/bin/env python
"""How the PyTorch port's online refine moves the ATE, draw by draw.

The scenario of tests/test_dist_backend.py::test_online_refine_improves_live_trajectory
and of `chip_smoke.py`'s refine phase, part c (whose config and trajectory
it takes): the small config in the deferred-solve mode, the 88-frame
out-and-back with sensor noise, one `SlamSystem.refine` after the run.  For each `--seeds` value the port's
renderer draws the noise (and the ground-RANSAC draws) from that seed; with
`--scans FILE.npz ...` the port runs on scans and draws the JAX package
rendered instead (`tools/refine_draws_reference.py --save`).  Prints the
keyframes, the loops and the ATE before and after the refine.

    python tools/torch_refine_draws.py --seeds 0 1 2 3 4 5 6 --device cpu
    python tools/torch_refine_draws.py --scans DIR/refine_scans_key3.npz --device cpu

The port runs on the card unless `--device cpu` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import loop_trajectory, small_refine_config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402


def run(label: str, xyz, inten, ground_u, gt: np.ndarray, device) -> float:
    """One run and its refine; returns ATE after / ATE before."""
    system = SlamSystem(small_refine_config(), device=device)
    for k in range(xyz.shape[0]):
        system.process(xyz[k].to(device), inten[k].to(device), 0.1 * k,
                       ground_u=ground_u[k].to(device))
    ate = lambda e: float(np.sqrt(np.mean(np.sum((e - gt[:len(e)]) ** 2, -1))))
    before = ate(system.trajectory())
    system.refine()
    after = ate(system.trajectory())
    print(f"port {label}: keyframes {system.num_keyframes}, loops "
          f"{[(a, b) for a, b, _ in system.loops]}, ATE {before:.4f} -> {after:.4f} m "
          f"(x{after / before:.3f})", flush=True)
    return after / before


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--scans", type=str, nargs="*", default=[])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    cfg = small_refine_config()
    traj = loop_trajectory(n_out=40, n_turn=6)
    gt = (traj.t - traj.t[0]).numpy()
    noise = synthetic.SensorNoise(range_sigma=0.04, intensity_speckle=0.15, dropout_rate=0.03)
    for seed in args.seeds:
        xyz, inten = synthetic.render_sequence(
            traj, synthetic.corridor_world(device="cpu"), cfg.sensor, noise=noise,
            gen=torch.Generator().manual_seed(seed))
        gu = torch.rand((xyz.shape[0], cfg.ground.ransac_iters, 3),
                        generator=torch.Generator().manual_seed(seed))
        run(f"seed {seed}", xyz, inten, gu, gt, args.device)
    for path in args.scans:
        with np.load(path) as f:
            run(os.path.basename(path), torch.from_numpy(f["xyz"]), torch.from_numpy(f["inten"]),
                torch.from_numpy(f["ground_u"]), f["gt"], args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
