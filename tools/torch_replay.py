#!/usr/bin/env python
"""Replay CLI of the PyTorch/CUDA port: run the SLAM pipeline over a
synthetic or recorded sequence.

Usage:
  python tools/torch_replay.py --frames 40 [--check-ate] [--speed 0.35]
                               [--yaw-rate 0.005] [--small] [--npz path.npz]
                               [--device cuda]

With --npz, loads a recorded log: arrays `xyz` (T, H*W, 3), `intensity`
(T, H*W), `times` (T,), optional `gt_t` (T, 3) for ATE.  Otherwise renders a
synthetic corridor sequence with known ground truth on the device.

--benchmark runs the circuit world through the full `SlamSystem` and writes
the results JSON (`RESULTS_torch_benchmark.json` unless --out says
otherwise).  Its noise draws come from a `torch.Generator` seeded with
1000 + s for the 32-frame chunk starting at frame s: the same seeds as the
JAX tool's `jax.random.PRNGKey(1000 + s)`, but torch cannot reproduce
`jax.random`'s draws, so a noisy render differs from the JAX tool's.  The
renders differ without noise too: the texture hashes sin(large argument),
which differs in the last bit between the two libraries.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.pipeline import odometry, slam  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import se3  # noqa: E402

OUT = "RESULTS_torch_benchmark.json"   # --benchmark's results
CHUNK = 64        # frames between two waits for the card in the system replay
RENDER_CHUNK = 32


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--speed", type=float, default=0.35)
    ap.add_argument("--yaw-rate", type=float, default=0.005)
    ap.add_argument("--check-ate", action="store_true")
    ap.add_argument("--ate-bound", type=float, default=0.6)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--npz", type=str, default=None)
    ap.add_argument("--benchmark", action="store_true",
                    help="multi-loop circuit world with a 12 m textureless "
                         "span, full SlamSystem, JSON results via --out")
    ap.add_argument("--out", type=str, default=None,
                    help="write the results JSON to this path "
                         "(--benchmark: RESULTS_torch_benchmark.json)")
    ap.add_argument("--no-textureless", action="store_true",
                    help="benchmark world without the degenerate span")
    ap.add_argument("--noise", action="store_true",
                    help="stochastic sensor model (io.synthetic.SensorNoise)")
    ap.add_argument("--dynamic", action="store_true",
                    help="add moving objects to the benchmark world")
    ap.add_argument("--distort", action="store_true",
                    help="render per-column firing poses (motion distortion)")
    ap.add_argument("--undistort", action="store_true",
                    help="enable the constant-velocity undistortion path")
    ap.add_argument("--pipeline", choices=["system", "slam", "odometry"],
                    default="slam",
                    help="system = full SLAM + loop closure + PGO; "
                         "slam/odometry = the per-frame step replayed")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def load_sequence(args, cfg, dev):
    """(xyz (T, N, 3), intensity (T, N), times (T,), gt_t (T, 3) or None),
    all on `dev`."""
    sc = cfg.sensor
    if args.npz:
        data = np.load(args.npz)
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return (put(data["xyz"]), put(data["intensity"]), put(data["times"]),
                put(data["gt_t"]) if "gt_t" in data else None)
    if args.benchmark:
        world = synthetic.circuit_world(textureless=not args.no_textureless,
                                        dynamic=args.dynamic, device=dev)
        poses = synthetic.circuit_trajectory(args.frames, speed=0.4, device=dev)
        noise = synthetic.DEFAULT_NOISE if args.noise else None
        xs, its = [], []
        for s in range(0, args.frames, RENDER_CHUNK):
            chunk = se3.Pose(poses.q[s:s + RENDER_CHUNK], poses.t[s:s + RENDER_CHUNK])
            n = chunk.q.shape[0]
            gen = torch.Generator(device=dev).manual_seed(1000 + s)
            times = sc.scan_period * (s + torch.arange(n, dtype=torch.float32, device=dev))
            x, i = synthetic.render_sequence(chunk, world, sc, distort=args.distort,
                                             noise=noise, gen=gen, times=times)
            xs.append(x)
            its.append(i)
        xyz, inten = torch.cat(xs), torch.cat(its)
    else:
        world = synthetic.corridor_world(device=dev)
        poses = synthetic.corridor_trajectory(args.frames, speed=args.speed,
                                              yaw_rate=args.yaw_rate, device=dev)
        xyz, inten = synthetic.render_sequence(poses, world, sc)
    times = torch.arange(args.frames, dtype=torch.float32, device=dev) * sc.scan_period
    return xyz, inten, times, synthetic.relative_positions(poses)


def _ate(est: np.ndarray, gt: np.ndarray | None):
    if gt is None:
        return None
    n = min(len(est), len(gt))
    d = est[:n] - gt[:n]
    return float(np.sqrt(np.mean(np.sum(d * d, -1))))


def run_system(args, cfg, dev, xyz, inten, times, gt_t) -> tuple[np.ndarray, dict]:
    """The full `SlamSystem` over the sequence: the first frame timed on
    its own, then one wait for the card per CHUNK frames."""
    T = xyz.shape[0]
    sys_ = SlamSystem(cfg, device=dev)
    times_host = times.cpu().numpy().astype(np.float64)
    t_c0 = time.perf_counter()
    sys_.process(xyz[0], inten[0], float(times_host[0]))
    devices.synchronize(dev)
    first_s = time.perf_counter() - t_c0
    chunk_times = []
    t0 = tc = time.perf_counter()
    for k in range(1, T):
        sys_.process(xyz[k], inten[k], float(times_host[k]))
        if k % CHUNK == 0:
            devices.synchronize(dev)
            now = time.perf_counter()
            chunk_times.append((k, now - tc))
            tc = now
    devices.synchronize(dev)
    dt = time.perf_counter() - t0
    est = sys_.trajectory()
    loops = sys_.loops
    print(f"frames: {T}  time: {dt:.2f}s ({(T - 1) / dt:.1f} scans/s; "
          f"first frame {first_s:.1f}s)")
    print(f"skips: {sys_.num_skips}  keyframes: {sys_.num_keyframes}  loops: {loops}")
    print(f"final pose t: {est[-1].astype(np.float64).round(3).tolist()}")
    gt = gt_t.cpu().numpy() if gt_t is not None else None
    steady = chunk_times[len(chunk_times) // 4:]
    results = {
        "sequence": "circuit" if args.benchmark else (args.npz or "corridor"),
        "sensor_model": {
            "noise": bool(args.noise),
            "dynamic_objects": bool(args.dynamic),
            "motion_distortion": bool(args.distort),
            "undistort_enabled": bool(args.undistort),
        },
        "frames": T,
        "path_length_m": (float(np.linalg.norm(np.diff(gt, axis=0), axis=-1).sum())
                          if gt is not None else None),
        "ate_odometry_m": _ate(sys_.odom_trajectory(), gt),
        "ate_mapped_live_m": _ate(np.asarray([t for _, t in sys_.frame_poses]), gt),
        "ate_rmse_m": _ate(est, gt),
        "end_error_m": (float(np.linalg.norm(est[-1] - gt[-1]))
                        if gt is not None else None),
        "skip_frames": sys_.num_skips,
        "skip_rate": sys_.num_skips / T,
        "keyframes": sys_.num_keyframes,
        "loop_closures": len(loops),
        "loops": [[int(a), int(b), float(f)] for a, b, f in loops],
        # the first frame's time (the JAX tool's compile + first frame; the
        # port compiles nothing, so this is first-use set-up and one frame)
        "compile_plus_first_frame_s": first_s,
        "scans_per_sec_post_compile": (T - 1) / dt,
        "scans_per_sec_steady": (sum(CHUNK for _ in steady)
                                 / max(sum(t for _, t in steady), 1e-9)),
        "chunk_scans_per_sec": [[k, CHUNK / t] for k, t in chunk_times],
        "device": devices.describe(dev),
    }
    return est, results


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.SlamConfig()
    if args.undistort:
        cfg = cfg.replace(sensor=dataclasses.replace(cfg.sensor, undistort=True))
    if args.benchmark:
        if args.frames == 40:   # the default is too short for the circuit
            args.frames = 420
        args.pipeline = "system"
    xyz, inten, times, gt_t = load_sequence(args, cfg, dev)
    T = xyz.shape[0]
    if args.pipeline == "system":
        est, results = run_system(args, cfg, dev, xyz, inten, times, gt_t)
        if args.out or args.benchmark:
            out_path = args.out or OUT
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
            print(f"results -> {out_path}")
        est_t = torch.from_numpy(est).to(dev)
    else:
        runner = slam.run_sequence if args.pipeline == "slam" else odometry.run_sequence
        t0 = time.perf_counter()
        outs = runner(xyz, inten, times, cfg)
        devices.synchronize(dev)
        dt = time.perf_counter() - t0
        skips = outs.skip.cpu().numpy().astype(int)
        print(f"frames: {T}  time: {dt:.2f}s ({T / dt:.1f} scans/s incl. first-use set-up)")
        print(f"skips: {skips.sum()} ({skips.tolist()[:20]}...)")
        print(f"keyframes: {int(outs.is_keyframe.sum())}")
        print(f"matches/frame (median): {int(np.median(outs.num_good.cpu().numpy()[1:]))}")
        print(f"final pose t: {outs.pose.t[-1].double().cpu().numpy().round(3).tolist()}")
        est_t = outs.pose.t
    if gt_t is not None:
        ate = float(odometry.ate_rmse(est_t, gt_t))
        end = float(torch.linalg.norm(est_t[-1] - gt_t[-1]))
        print(f"ATE RMSE: {ate:.4f} m   end error: {end:.4f} m")
        if args.check_ate and ate > args.ate_bound:
            print(f"FAIL: ATE {ate:.4f} > bound {args.ate_bound}")
            return 1
        if args.check_ate:
            print(f"PASS: ATE within bound {args.ate_bound}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
