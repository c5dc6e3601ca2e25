#!/usr/bin/env python
"""Scaling measurements of the distributed bundle adjustment: the
counterpart of `tools/scaling_bench.py` for the PyTorch/CUDA port.

    python tools/torch_scaling_bench.py [--device cuda] [--devices 1 N]
                                        [--out RESULTS_torch_scaling_bench.json]

Three sections, each saying what it shows:

1. weak scaling / partition overhead (n ranks, `--device cpu` gloo ranks on
   this host, one process and one thread per rank; NCCL ranks, one per
   card, on cuda): the problem grows with n (fixed observations per rank),
   and `ba_solve` sharded over the n ranks (`dist_ba.shard_problem`) is
   timed against the same whole problem solved unsharded by rank 0 alone.
   The sharded poses must lie within 1e-3 m of the unsharded ones.
2. collective count: the `all_reduce` calls of one sharded `ba_solve`,
   counted by a wrapper this tool installs over `dist_ba.all_reduce` in its
   worker; every timed solve must make the same count, and the count should
   be flat in n (the reference counted all-reduce ops in the compiled HLO).
3. solve time against problem size on one device: `ba_solve` at K = 32,
   64, 128 and 256 poses (65 536 to 524 288 observations).

Sections 1 and 2 run when `--devices` names more than one rank (then with
n = 1 as the reference does); `--devices 1` on the card gives section 3
only.  The problems are drawn from `np.random.default_rng(seed)` with the
reference's shapes and distributions (`jax.random` cannot be reproduced).
Writes the JAX tool's keys with `platform` replaced by `device` (the
card's name and power limit).  `--small` shrinks every problem to rehearse
the tool on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_scaling_bench.json")

from intensity_slam_tpu_torch.parallel import dist_ba, multiproc  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import se3  # noqa: E402
from intensity_slam_tpu_torch.utils.se3 import Pose  # noqa: E402

GN_ITERS, CG_ITERS = 3, 8
TOL_M = 1e-3
SIZES = (32, 64, 128, 256)          # section 3: poses, 2048 observations each
SMALL_SIZES = (4, 8)


def make_problem(K=64, L=4096, obs_per_pose=2048, seed=0, device="cpu") -> dist_ba.BAProblem:
    """K poses 0.5 m apart along x, L landmarks uniform in [-10, 40)^3,
    `obs_per_pose` observations a pose of uniformly drawn landmarks with
    1 cm noise; poses and landmarks start 5 cm off, pose 0 fixed."""
    rng = np.random.default_rng(seed)
    gt_t = np.stack([np.arange(K) * 0.5, np.zeros(K), np.zeros(K)], -1).astype(np.float32)
    gt_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (K, 1))
    lms = rng.uniform(-10, 40, (L, 3)).astype(np.float32)
    op = np.repeat(np.arange(K, dtype=np.int32), obs_per_pose)
    ol = rng.integers(0, L, K * obs_per_pose).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=device)
    q_op = t(gt_q[op])
    z = se3.quat_rotate(se3.quat_conj(q_op), t(lms[ol] - gt_t[op]))
    z = z + t(rng.normal(size=z.shape).astype(np.float32)) * 0.01
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dist_ba.BAProblem(
        poses=Pose(t(gt_q), t(gt_t + 0.05)), landmarks=t(lms + 0.05),
        obs_pose=t(op), obs_lm=t(ol), obs_z=z,
        obs_w=torch.ones(op.shape[0], device=device), fixed_poses=t(fixed))


def _time(fn, reps: int, dev) -> float:
    """ms per call of `reps` calls after a warm one, synchronized at the
    end."""
    fn()
    devices.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    devices.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _solve(prob, mesh=None) -> torch.Tensor:
    return dist_ba.ba_solve(prob, gn_iters=GN_ITERS, cg_iters=CG_ITERS, mesh=mesh).poses.t


def worker(pid: int, nproc: int, coordinator: str, out_path: str, timeout_s: float,
           device: str, obs_per_device: int, poses_per_device: int, reps: int) -> None:
    """One of n ranks: rank 0 times the whole problem unsharded, then every
    rank times the sharded solve while counting its all_reduce calls."""
    import torch.distributed as dist

    if device == "cuda":
        dev, backend = torch.device("cuda", pid), "nccl"
        torch.cuda.set_device(dev)
    else:
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(1)
    mesh = multiproc.initialize(pid, nproc, coordinator, backend, timeout_s)
    try:
        K = poses_per_device * nproc
        opp = obs_per_device // poses_per_device
        prob = make_problem(K=K, L=64 * K, obs_per_pose=opp, device=dev)
        if pid == 0:
            t_single = _time(lambda: _solve(prob), reps, dev)
            whole = _solve(prob).cpu().numpy()
        dist.barrier()

        counts = []
        inner = dist_ba.all_reduce

        def counting(x, mesh_):
            counts[-1] += 1
            return inner(x, mesh_)

        sprob = dist_ba.shard_problem(prob, mesh)

        def sharded():
            counts.append(0)
            return _solve(sprob, mesh)

        dist_ba.all_reduce = counting
        try:
            t_shard = _time(sharded, reps, dev)
            got = sharded().cpu().numpy()
        finally:
            dist_ba.all_reduce = inner
        if len(set(counts)) != 1:
            raise RuntimeError(f"all_reduce calls differ between solves: {counts}")
        if pid == 0:
            err = float(np.abs(got - whole).max())
            if not err < TOL_M:
                raise RuntimeError(f"sharded poses {err} m off the unsharded ones")
            with open(out_path, "w") as f:
                json.dump({"total_poses": K, "total_obs": K * opp,
                           "ms_unsharded_same_problem": round(t_single, 2),
                           "ms_sharded": round(t_shard, 2),
                           "max_abs_dt_sharded_vs_unsharded_m": err,
                           "ba_all_reduce_ops": counts[0]}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="rank counts (default: 1 and the cards on cuda, 1 2 on the cpu)")
    ap.add_argument("--obs-per-device", type=int, default=None)
    ap.add_argument("--poses-per-device", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="small problems")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--procs", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    args = ap.parse_args(argv)
    opd = args.obs_per_device or (2048 if args.small else 65536)
    ppd = args.poses_per_device or (8 if args.small else 32)
    if args.worker is not None:
        worker(args.worker, args.procs, args.coordinator, args.out, args.timeout,
               args.device, opd, ppd, args.reps)
        return 0
    dev = devices.resolve(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    counts = sorted(set(args.devices or ([1, cards] if dev.type == "cuda" else [1, 2])))
    if dev.type == "cuda" and max(counts) > cards:
        raise RuntimeError(f"{max(counts)} NCCL ranks asked for, {cards} cards: one rank "
                           "is one card")
    results = {"device": devices.describe(dev), "virtual_mesh": dev.type == "cpu",
               "sections": {}}

    # ---- 1-2. weak scaling / partition overhead, collective count --------
    if max(counts) > 1:
        weak, coll = {}, {}
        for n in counts:
            if n == 1:
                prev = torch.get_num_threads()
                torch.set_num_threads(1)           # as each rank runs
                try:
                    prob = make_problem(K=ppd, L=64 * ppd, obs_per_pose=opd // ppd, device=dev)
                    t_single = _time(lambda: _solve(prob), args.reps, dev)
                finally:
                    torch.set_num_threads(prev)
                rec = {"total_poses": ppd, "total_obs": opd,
                       "ms_unsharded_same_problem": round(t_single, 2),
                       "ms_sharded": round(t_single, 2)}
            else:
                with tempfile.TemporaryDirectory() as td:
                    path = os.path.join(td, "rank0.json")
                    rc = multiproc.launch(
                        n, path, args.timeout, retries=0, module=os.path.abspath(__file__),
                        args=["--device", dev.type, "--obs-per-device", opd,
                              "--poses-per-device", ppd, "--reps", args.reps])
                    if rc != 0:
                        print(f"FAIL: the {n}-rank run exited {rc}")
                        return rc
                    with open(path) as f:
                        rec = json.load(f)
                coll[str(n)] = {
                    "ba_all_reduce_ops": rec.pop("ba_all_reduce_ops"),
                    "pgo_all_reduce_design": "1 all-reduce of the (6K,6K) loop normal "
                                             "equations, the rhs and the loop cost per GN "
                                             "iteration, 1 of the candidates' loop costs "
                                             "(dist_pgo.optimize_shmap)",
                }
            rec["partition_overhead_pct"] = round(
                100.0 * (rec["ms_sharded"] - rec["ms_unsharded_same_problem"])
                / max(rec["ms_unsharded_same_problem"], 1e-9), 1)
            weak[str(n)] = rec
            print(f"{n} rank(s): {json.dumps(rec)}", flush=True)
        results["sections"]["weak_scaling_partition_overhead"] = {
            "shows": "partition + collective overhead at fixed work per rank: the "
                     "sharded solve over n ranks against rank 0 alone on the whole "
                     "problem" + (" (ranks are single-threaded processes sharing this "
                                  "host's cores)" if dev.type == "cpu" else ""),
            "does_not_show": "multi-card speedup unless each rank holds a card of its own",
            "per_devices": weak,
        }
        results["sections"]["collective_count"] = {
            "shows": "all_reduce calls of one sharded BA solve, counted at run time: "
                     "flat in n validates the fixed number of collectives per CG "
                     "application",
            "per_devices": coll,
        }

    # ---- 3. one device: solve time against problem size ------------------
    sizes = {}
    opp = 256 if args.small else 2048
    for K in (SMALL_SIZES if args.small else SIZES):
        prob = make_problem(K=K, L=64 * K, obs_per_pose=opp, device=dev)
        ms = _time(lambda: _solve(prob), args.reps, dev)
        sizes[str(K)] = {"observations": K * opp, "ms_per_solve": round(ms, 2)}
        print(f"K={K}: {K * opp} observations, {ms:.2f} ms per solve", flush=True)
    results["sections"]["single_device_solve_vs_size"] = {
        "shows": f"BA solve wall time on one {dev.type} device against problem size "
                 "(what a multi-card projection multiplies out from)",
        "per_poses": sizes,
    }
    print(json.dumps(results, indent=1))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
