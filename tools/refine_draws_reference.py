#!/usr/bin/env python
"""How the JAX package's online refine moves the ATE, noise key by noise key.

tests/test_dist_backend.py::test_online_refine_improves_live_trajectory
asserts ATE after `SlamSystem.refine` < 0.9 x ATE before on its one noise
key (3).  This script runs that test's scenario (config, 88-frame
out-and-back, sensor noise) for each key given and prints the keyframes,
the loops and the ATE before and after the refine.  With `--save DIR` it
also writes each key's rendered scans and ground-RANSAC draws to
`DIR/refine_scans_key{K}.npz`, which `tools/torch_refine_draws.py --scans`
feeds to the PyTorch port.  CPU only:

    JAX_PLATFORMS=cpu python tools/refine_draws_reference.py --keys 0 1 2 3 4 [--save DIR]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from intensity_slam_tpu import config  # noqa: E402
from intensity_slam_tpu.io import synthetic  # noqa: E402
from intensity_slam_tpu.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu.utils import se3  # noqa: E402


def scenario_config() -> config.SlamConfig:
    base = config.small_test_config()
    return base.replace(
        loop=dataclasses.replace(base.loop, sc_num_exclude_recent=4, min_loop_search_gap=4,
                                 max_keyframes=64, keyframe_cloud_size=1024, online_pgo=False,
                                 loop_drift_rate=0.08, loop_drift_rot_rate=0.01),
        odometry=dataclasses.replace(base.odometry, keyframe_time_interval=0.15))


def loop_trajectory(n_out=40, n_turn=6, speed=0.4) -> se3.Pose:
    ident = jnp.array([1.0, 0, 0, 0])
    fwd = se3.Pose(ident, jnp.array([speed, 0, 0]))
    turn = se3.Pose(se3.so3_exp(jnp.array([0.0, 0.0, np.pi / n_turn])),
                    jnp.array([speed * 0.5, 0, 0]))
    pose = se3.Pose(ident, jnp.array([0.0, 0.0, 0.8]))
    qs, ts = [], []
    for step, n in ((fwd, n_out), (turn, n_turn), (fwd, n_out + 2)):
        for _ in range(n):
            qs.append(pose.q)
            ts.append(pose.t)
            pose = se3.compose(pose, step)
    return se3.Pose(jnp.stack(qs), jnp.stack(ts))


def run(key: int, save: str | None) -> None:
    cfg = scenario_config()
    poses = loop_trajectory()
    noise = synthetic.SensorNoise(range_sigma=0.04, intensity_speckle=0.15, dropout_rate=0.03)
    xyz, inten = jax.jit(lambda q, t: synthetic.render_sequence(
        se3.Pose(q, t), synthetic.corridor_world(), cfg.sensor, noise=noise,
        key=jax.random.PRNGKey(key)))(poses.q, poses.t)
    system = SlamSystem(cfg)
    draws = []
    for k in range(xyz.shape[0]):
        _, sub = jax.random.split(system.state.slam.rng)
        draws.append(np.asarray(jax.random.uniform(sub, (cfg.ground.ransac_iters, 3))))
        system.process(xyz[k], inten[k], k * 0.1)
    gt = np.asarray(poses.t - poses.t[0])      # the first pose has no rotation
    ate = lambda e: float(np.sqrt(np.mean(np.sum((e - gt[:len(e)]) ** 2, -1))))
    before = ate(system.trajectory())
    system.refine()
    after = ate(system.trajectory())
    print(f"reference key {key}: keyframes {system.num_keyframes}, loops "
          f"{[(a, b) for a, b, _ in system.loops]}, ATE {before:.4f} -> {after:.4f} m "
          f"(x{after / before:.3f})", flush=True)
    if save:
        os.makedirs(save, exist_ok=True)
        np.savez(os.path.join(save, f"refine_scans_key{key}.npz"), xyz=np.asarray(xyz),
                 inten=np.asarray(inten), ground_u=np.stack(draws), gt=gt)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--save", type=str, default=None)
    args = ap.parse_args()
    for key in args.keys:
        run(key, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
