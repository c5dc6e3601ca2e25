#!/usr/bin/env python
"""Projected N-card scaling of the distributed pose-graph solve: the
counterpart of `tools/scaling_projection.py` for the PyTorch/CUDA port.

    python tools/torch_scaling_projection.py [--reps 10] [--device cuda]
                                             [--out RESULTS_torch_scaling_projection.json]

Measured single-card solves and the collective's byte count, combined in an
explicit model:

  t_N = t_shardable / N + t_replicated + t_comm(N)
  t_comm(N) = 2 * bytes_per_solve * (N - 1) / N / link_bw   (ring all-reduce)

`dist_pgo.optimize_shmap` shares the loop edges out over the ranks.  The
shardable work is the loop-edge Jacobians and their normal equations,
measured as t(E = 128 loop edges) - t(E = 0) at K = 1024 nodes (the
product graph); the replicated work is what every rank repeats (the odometry
chain, the dense Cholesky solves, the pose update), measured as t(E = 0).
Each `posegraph.optimize` call is synchronized, `--reps` calls after a warm
one.  The collective is one all-reduce of the (6K, 6K) loop normal
equations and the (6K,) right-hand side per Gauss-Newton iteration:
GN * (36 K^2 + 6 K) * 4 bytes a solve.

Links (published figures): NVLink 4 between the cards of one H100 host, 900
GB/s all to all, i.e. 450 GB/s each way (`projection_ici`, the reference's
key for its in-pod links), and one InfiniBand NDR port of 400 Gb/s, 50
GB/s, per host between hosts (`projection_dcn_hosts`).  The keys are the
reference's, so the two files compare; `assumptions` names the links.
Writes the JAX tool's keys with `platform` replaced by `device` (the card's
name and power limit).  `--small` (small_test_config, 64 nodes, 8 loop
edges) rehearses the tool on the CPU.
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
OUT = os.path.join(ROOT, "RESULTS_torch_scaling_projection.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.pipeline import posegraph  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import se3  # noqa: E402
from intensity_slam_tpu_torch.utils.se3 import Pose  # noqa: E402

NVLINK_BW = 450e9   # B/s each way per card: NVLink 4, 900 GB/s all to all (H100 SXM)
IB_BW = 50e9        # B/s per host: one InfiniBand NDR port, 400 Gb/s


def _graph(K: int, E: int, lc: config.LoopConfig, dev, seed: int = 0) -> posegraph.PoseGraph:
    """K nodes 0.4 m apart along x, E loop edges from the second half to
    the first quarter (measured exactly), at least 8 loop slots."""
    rng = np.random.default_rng(seed)
    g = posegraph.empty(K, max(E, 8), device=dev)
    pose = Pose.identity(device=dev)
    step = Pose(torch.tensor([1.0, 0, 0, 0], device=dev), torch.tensor([0.4, 0.0, 0.0], device=dev))
    for k in range(K):
        if k > 0:
            pose = se3.compose(pose, step)
        g = posegraph.add_node(g, pose)
    fitness = torch.tensor(0.05, device=dev)
    for _ in range(E):
        i = int(rng.integers(K // 2, K))
        j = int(rng.integers(0, K // 4))
        Ti = Pose(g.poses.q[i], g.poses.t[i])
        Tj = Pose(g.poses.q[j], g.poses.t[j])
        rel = se3.compose(se3.inverse(Ti), Tj)
        g = posegraph.add_loop(g, torch.tensor(i, dtype=torch.int32, device=dev),
                               torch.tensor(j, dtype=torch.int32, device=dev), rel, fitness, lc)
    return g


def collective_bytes_per_solve(K: int, gn_iters: int) -> int:
    """One all-reduce of the (6K, 6K) + (6K,) float32 loop normal equations
    per Gauss-Newton iteration."""
    return gn_iters * (36 * K * K + 6 * K) * 4


def summary(t_full, t_zero, t_shardable, K, E, bytes_per_iter, ici4, dcn4, dev) -> str:
    """What the measurement says, from its own numbers."""
    where = "card" if dev.type == "cuda" else "CPU"
    if t_full <= t_zero:
        head = (f"Measured on one {where}: the solve with {E} loop edges ({t_full:.3f} s at "
                f"K = {K}) took no longer than with none ({t_zero:.3f} s), so the loop-edge "
                f"work that sharding splits is below the run-to-run spread: the whole solve "
                f"is replicated work and more devices cannot shorten it.")
    else:
        head = (f"Measured on one {where}: the loop-edge work that shards is "
                f"{100 * t_shardable / t_full:.0f} % of a {t_full:.3f} s solve at K = {K}, "
                f"E = {E}; the replicated part ({t_zero:.3f} s) bounds the speedup at "
                f"{t_full / t_zero:.2f}x.")
    return (f"{head} Each GN iteration all-reduces {bytes_per_iter / 1e6:.0f} MB: over NVLink "
            f"the model gives {ici4['speedup']}x on 4 cards ({ici4['t_comm_s']} s of "
            f"communication), over one 400 Gb/s port per host {dcn4['speedup']}x on 4 hosts "
            f"({dcn4['t_comm_s']} s). A model from one device's times, not a multi-card "
            f"measurement.")


def _time_solve(g, lc, gn_iters: int, reps: int, dev) -> float:
    """Seconds per `posegraph.optimize`, each call synchronized, after a
    warm one."""
    solve = lambda: posegraph.optimize(
        g, gn_iters=gn_iters, cg_iters=64, odo_noise=lc.odom_noise,
        prior_noise=lc.prior_noise, loop_cauchy_c=lc.loop_cauchy_c,
        drift_rate=lc.loop_drift_rate, drift_rot_rate=lc.loop_drift_rot_rate)
    solve()
    devices.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        solve()
        devices.synchronize(dev)
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.SlamConfig()
    lc = cfg.loop
    K = lc.max_keyframes          # the product graph (1024)
    E = 8 if args.small else 128  # a loop-rich session
    GN = lc.pgo_gn_iters

    t_full = _time_solve(_graph(K, E, lc, dev), lc, GN, args.reps, dev)
    t_zero = _time_solve(_graph(K, 0, lc, dev), lc, GN, args.reps, dev)
    t_shardable = max(t_full - t_zero, 1e-5)   # loop-edge Jacobians + their normal equations
    t_replicated = t_zero                      # odometry chain, dense solves, update
    bytes_per_solve = collective_bytes_per_solve(K, GN)

    def project(n, bw):
        t_comm = 2.0 * bytes_per_solve * (n - 1) / n / bw
        t_n = t_shardable / n + t_replicated + t_comm
        return {
            "chips": n,
            "t_projected_s": round(t_n, 4),
            "t_comm_s": round(t_comm, 4),
            "speedup": round(t_full / t_n, 3),
            "efficiency_vs_ideal": round(t_full / t_n / n, 3),
            "shardable_fraction": round(t_shardable / t_full, 3),
        }

    amdahl = t_full / t_replicated
    ici = [project(n, NVLINK_BW) for n in (2, 4, 8)]
    dcn = [project(n, IB_BW) for n in (2, 4)]
    res = {
        "what": "projected N-card scaling of the distributed PGO solve (dense "
                "relative-coordinate GN, loop edges sharded, one all-reduce of the "
                "(6K,6K) normal equations per GN iteration)",
        "graph": {"K": K, "loop_edges": E, "gn_iters": GN},
        "measured_single_chip": {
            "device": devices.describe(dev),
            "t_solve_s": round(t_full, 4),
            "t_with_zero_loop_edges_s": round(t_zero, 4),
            "t_shardable_s": round(t_shardable, 4),
            "t_replicated_s": round(t_replicated, 4),
        },
        "collective_bytes_per_solve": bytes_per_solve,
        "assumptions": {
            "ici_bw_Bps": NVLINK_BW,
            "ici_link": "NVLink 4 between the cards of one H100 SXM host: 900 GB/s all "
                        "to all, 450 GB/s each way",
            "dcn_bw_Bps": IB_BW,
            "dcn_link": "InfiniBand NDR between hosts: one 400 Gb/s port, 50 GB/s per host",
            "allreduce_model": "ring: 2*bytes*(N-1)/N / bw",
        },
        "projection_ici": ici,
        "projection_dcn_hosts": dcn,
        "amdahl_speedup_limit": round(amdahl, 2),
        "honest_summary": summary(t_full, t_zero, t_shardable, K, E, bytes_per_solve // GN,
                                  ici[1], dcn[1], dev),
    }
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
