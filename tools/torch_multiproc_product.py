#!/usr/bin/env python
"""The distributed back-end at product scale over processes: the
counterpart of `tools/multiproc_product.py` for the PyTorch/CUDA port.

    python tools/torch_multiproc_product.py [--device cuda] [--procs N]
                                            [--out RESULTS_torch_multiproc_product.json]

Every rank builds the same product-scale `BackendState` from the same
numpy draws (`synth_product_state`: default `SlamConfig` shapes, 1024
keyframes on a drifted multi-lap circuit, 200 loop edges at true revisits,
feature payloads that share landmarks along the chain), then

1. the dense `posegraph.optimize` on each rank (the reference solve), and
   `dist_pgo.optimize_shmap` with the loop edges shared out over the ranks
   (one all-reduce of the loop normal equations per Gauss-Newton
   iteration): poses within 1e-3 m of the dense solve;
2. `dist_backend.shard_backend_state` + `refine` (the sharded keyframe
   store, the PGO and the Schur BA) against `refine` with `mesh=None` on
   the same rank: poses within 1e-3 m.

One rank is one device: `--device cuda` opens one NCCL rank per card
(`--procs` defaults to the number of cards, one on one card, and more
ranks than cards raise), `--device cpu` the reference's two gloo
processes on this host.  The ranks are spawned by
`parallel.multiproc.launch`, which kills them all if one fails or the time
limit passes.  Rank 0 writes the reference's record (`MULTIPROC_r05.json`'s
keys) plus `device` (the card's name and power limit, or "cpu");
`local_devices_per_process` is 1.  `--small` runs a 192-keyframe state (a
lap and a quarter of the 156-node lap, so that 102 loop edges close) at
small_test_config widths on the CPU.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_multiproc_product.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.parallel import dist_backend, dist_pgo, multiproc  # noqa: E402
from intensity_slam_tpu_torch.pipeline import loop as loop_mod  # noqa: E402
from intensity_slam_tpu_torch.pipeline import posegraph  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils.se3 import Pose  # noqa: E402

N_LOOPS = 200
TOL_M = 1e-3


def product_config(small: bool) -> config.SlamConfig:
    """Default `SlamConfig` (the product's shapes), or small_test_config
    widths with 192 keyframes and 256 features (each keyframe observes 256
    landmarks)."""
    if not small:
        return config.SlamConfig()
    cfg = config.small_test_config()
    return cfg.replace(feature=dataclasses.replace(cfg.feature, num_features=256),
                       loop=dataclasses.replace(cfg.loop, max_keyframes=192))


def _quat_mul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _quat_conj(a):
    return a * np.array([1.0, -1, -1, -1])


def _quat_rot(q, v):
    u = q[..., 1:]
    uxv = np.cross(u, v)
    return v + 2 * q[..., :1] * uxv + 2 * np.cross(u, uxv)


def ground_truth(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(q, t) float64 of the circuit at keyframe spacing (1.2 m)."""
    gt = synthetic.circuit_trajectory(n, speed=1.2, device="cpu")
    return gt.q.numpy().astype(np.float64), gt.t.numpy().astype(np.float64)


def synth_product_state(cfg: config.SlamConfig, device="cuda") -> loop_mod.BackendState:
    """The reference's product-scale state from the same draws of
    `np.random.default_rng(7)`, in the same order: K chain nodes on a
    multi-lap circuit with a slowly varying planar drift, N_LOOPS loop edges
    at true revisits (indices more than 60 apart, within 2 m; true relative
    poses plus 2 cm noise), and landmark-consistent feature payloads (8 new
    landmarks a keyframe, keyframe k observing those born in [k-31, k]), so
    that the BA's track builder finds multi-frame tracks.  Descriptor words
    are uint32 bits carried as int32."""
    rng = np.random.default_rng(7)
    lc = cfg.loop
    K, P = lc.max_keyframes, lc.keyframe_cloud_size
    F = cfg.feature.num_features
    Pg = cfg.mapping.max_query_points
    Pc = cfg.mapping.max_query_points // 2
    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)

    gt_q, gt_t = ground_truth(K)
    path = np.cumsum(np.r_[0.0, np.linalg.norm(np.diff(gt_t, axis=0), axis=1)])
    drift = np.stack([
        0.004 * path * np.sin(path / 60.0),
        0.004 * path * np.cos(path / 90.0),
        0.001 * path * np.sin(path / 45.0),
    ], axis=1)
    est_t = gt_t + drift
    est_q = gt_q

    state = loop_mod.init_state(cfg, device=dev)
    g = state.graph
    # odometry measurements from the drifted chain; graph poses the chain
    prev_q = np.vstack([est_q[:1], est_q[:-1]])
    prev_t = np.vstack([est_t[:1], est_t[:-1]])
    rel_q = _quat_mul(_quat_conj(prev_q), est_q)
    rel_t = _quat_rot(_quat_conj(prev_q), est_t - prev_t)
    rel_q[0] = [1, 0, 0, 0]
    rel_t[0] = 0
    g = g._replace(
        poses=Pose(f32(est_q), f32(est_t)),
        node_valid=torch.ones((K,), dtype=torch.bool, device=dev),
        num_nodes=i32(K),
        odo_rel=Pose(f32(rel_q), f32(rel_t)),
        last_raw=Pose(f32(est_q[-1]), f32(est_t[-1])),
    )

    # loop edges at true revisits, measured from the true relative poses
    d = np.linalg.norm(gt_t[None, :, :] - gt_t[:, None, :], axis=-1)
    ii, jj = np.where((d < 2.0) & (np.abs(
        np.arange(K)[None, :] - np.arange(K)[:, None]) > 60))
    keep = ii > jj
    ii, jj = ii[keep], jj[keep]
    sel = rng.choice(len(ii), size=min(N_LOOPS, len(ii)), replace=False)
    L = g.loop_valid.shape[0]
    li = np.zeros(L, np.int32)
    lj = np.zeros(L, np.int32)
    lq = np.zeros((L, 4), np.float32)
    lq[:, 0] = 1
    lt = np.zeros((L, 3), np.float32)
    lsi = np.zeros((L, 6), np.float32)
    lval = np.zeros(L, bool)
    for s_idx, e in enumerate(sel[:L]):
        a, b = int(ii[e]), int(jj[e])
        zq = _quat_mul(_quat_conj(gt_q[a]), gt_q[b])
        zt = _quat_rot(_quat_conj(gt_q[a]), gt_t[b] - gt_t[a])
        zt = zt + rng.normal(0, 0.02, 3)
        li[s_idx], lj[s_idx] = a, b
        lq[s_idx], lt[s_idx] = zq, zt
        lsi[s_idx] = 1.0 / np.sqrt(0.01)
        lval[s_idx] = True
    g = g._replace(
        loop_i=torch.as_tensor(li, device=dev), loop_j=torch.as_tensor(lj, device=dev),
        loop_rel=Pose(f32(lq), f32(lt)), loop_sqrt_info=f32(lsi),
        loop_valid=torch.as_tensor(lval, device=dev), num_loops=i32(int(lval.sum())),
    )

    # keyframe payloads: landmark-consistent features
    G = K * 8
    lm_desc = rng.integers(0, 2**32, size=(G, 8), dtype=np.uint32)
    lm_world = gt_t[np.minimum(np.arange(G) // 8, K - 1)] + rng.normal(0, 5.0, (G, 3))
    feat_desc = np.zeros((K, F, 8), np.uint32)
    feat_xyz = np.zeros((K, F, 3), np.float32)
    feat_valid = np.zeros((K, F), bool)
    obs_per = 256
    for k in range(K):
        ids = np.arange(max(0, (k - 31) * 8), (k + 1) * 8)[:obs_per]
        n = len(ids)
        feat_desc[k, :n] = lm_desc[ids]
        # sensor-frame observation of the landmark from the true pose
        rel = lm_world[ids] - gt_t[k]
        feat_xyz[k, :n] = _quat_rot(_quat_conj(gt_q[k])[None, :], rel) \
            + rng.normal(0, 0.02, (n, 3))
        feat_valid[k, :n] = True

    clouds = rng.uniform(-20, 20, (K, P, 3)).astype(np.float32)
    cloud_int = rng.uniform(0, 255, (K, P)).astype(np.float32)
    kf_ground = rng.uniform(-20, 20, (K, Pg, 3)).astype(np.float32)
    kf_corner = rng.uniform(-20, 20, (K, Pc, 3)).astype(np.float32)
    ones = lambda *shape: torch.ones(shape, dtype=torch.bool, device=dev)
    return state._replace(
        graph=g,
        kf_cloud=f32(clouds), kf_cloud_mask=ones(K, P), kf_cloud_int=f32(cloud_int),
        kf_time=f32(0.4 * np.arange(K, dtype=np.float32)),
        num_kf=i32(K),
        kf_feat_desc=torch.as_tensor(feat_desc.view(np.int32), device=dev),
        kf_feat_xyz=f32(feat_xyz),
        kf_feat_valid=torch.as_tensor(feat_valid, device=dev),
        kf_raw=Pose(f32(est_q), f32(est_t)),
        kf_ground=f32(kf_ground), kf_ground_mask=ones(K, Pg),
        kf_corner=f32(kf_corner), kf_corner_mask=ones(K, Pc),
        free_count=i32(0),
    )


def _ate(t: np.ndarray, gt_t: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((t - gt_t) ** 2, -1))))


def worker(pid: int, nproc: int, coordinator: str, out_path: str | None,
           timeout_s: float, device: str, small: bool) -> None:
    """One rank: build the state, solve dense, across the ranks, refine."""
    import torch.distributed as dist

    if device == "cuda":
        dev = torch.device("cuda", pid)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device("cpu")
        backend = "gloo"
        torch.set_num_threads(1 if small else max(1, (os.cpu_count() or 1) // nproc))
    mesh = multiproc.initialize(pid, nproc, coordinator, backend, timeout_s)
    sync = lambda: devices.synchronize(dev)
    try:
        t_start = time.perf_counter()
        probe = multiproc.all_reduce(torch.tensor([float(pid)], device=dev), mesh)
        if float(probe) != nproc * (nproc - 1) / 2:
            raise RuntimeError(f"all_reduce gave {float(probe)}")
        print(f"[worker {pid}] {nproc} {backend} ranks, one device each ({dev})", flush=True)

        cfg = product_config(small)
        lc = cfg.loop
        t0 = time.perf_counter()
        bstate = synth_product_state(cfg, dev)
        sync()
        n_kf = int(bstate.num_kf)
        n_loops = int(bstate.graph.loop_valid.sum())
        t_build = time.perf_counter() - t0
        print(f"[worker {pid}] product state: {n_kf} keyframes, {n_loops} loop edges "
              f"({t_build:.1f}s)", flush=True)
        dist.barrier()

        kw = dict(gn_iters=lc.pgo_gn_iters, odo_noise=lc.odom_noise,
                  prior_noise=lc.prior_noise, loop_cauchy_c=lc.loop_cauchy_c,
                  drift_rate=lc.loop_drift_rate, drift_rot_rate=lc.loop_drift_rot_rate)
        # the dense single-rank solve (the reference), timed
        t0 = time.perf_counter()
        ref_t = posegraph.optimize(bstate.graph, **kw).poses.t[:n_kf].cpu().numpy()
        t_ref = time.perf_counter() - t0
        _, gt_t = ground_truth(n_kf)
        ate_before = _ate(bstate.graph.poses.t[:n_kf].cpu().numpy(), gt_t)
        ate_after = _ate(ref_t, gt_t)
        print(f"[worker {pid}] dense reference: {t_ref:.1f}s, ATE {ate_before:.3f} -> "
              f"{ate_after:.3f} m", flush=True)
        dist.barrier()

        # the loop edges shared out over the ranks
        t0 = time.perf_counter()
        mp_t = multiproc.fetch_replicated(
            dist_pgo.optimize_shmap(bstate.graph, mesh, **kw).poses.t)[:n_kf]
        t_pgo = time.perf_counter() - t0
        pgo_err = float(np.abs(mp_t - ref_t).max())
        print(f"[worker {pid}] dist PGO: max |dt| = {pgo_err:.2e} ({t_pgo:.1f}s)", flush=True)
        if not pgo_err < TOL_M:
            raise RuntimeError(f"PGO mismatch: {pgo_err} m")

        # the sharded store's refine against the single-rank refine
        dist.barrier()
        t0 = time.perf_counter()
        rres = dist_backend.refine(dist_backend.shard_backend_state(bstate, mesh), cfg,
                                   mesh=mesh)
        mp_poses = multiproc.fetch_replicated(rres.state.graph.poses.t)[:n_kf]
        ba_ci, ba_cf = float(rres.ba_initial_cost), float(rres.ba_final_cost)
        n_obs = int(rres.num_obs)
        t_refine = time.perf_counter() - t0
        t0 = time.perf_counter()
        lo_poses = dist_backend.refine(bstate, cfg, mesh=None).state.graph.poses.t[:n_kf]
        lo_poses = lo_poses.cpu().numpy()
        t_refine_local = time.perf_counter() - t0
        refine_err = float(np.abs(mp_poses - lo_poses).max())
        print(f"[worker {pid}] dist refine: {n_obs} BA obs, cost {ba_ci:.4f} -> {ba_cf:.4f}, "
              f"max |dt| vs local = {refine_err:.2e} ({t_refine:.1f}s vs local "
              f"{t_refine_local:.1f}s)", flush=True)
        if not refine_err < TOL_M:
            raise RuntimeError(f"refine mismatch: {refine_err} m")

        if pid == 0 and out_path:
            with open(out_path, "w") as f:
                json.dump({
                    "scale": ("small (192 keyframes, small_test_config widths)" if small
                              else "PRODUCT (default SlamConfig)"),
                    "processes": nproc,
                    "local_devices_per_process": 1,
                    "global_devices": nproc,
                    "collective_backend": ("nccl, one rank per card" if backend == "nccl"
                                           else "gloo (localhost)"),
                    "graph_nodes": n_kf,
                    "loop_edges": n_loops,
                    "ba_observations": n_obs,
                    "pgo_max_abs_dt_vs_dense_reference_m": pgo_err,
                    "refine_max_abs_dt_vs_single_process_m": refine_err,
                    "pgo_ate_before_m": round(ate_before, 3),
                    "pgo_ate_after_m": round(ate_after, 3),
                    "ba_cost_initial": ba_ci,
                    "ba_cost_final": ba_cf,
                    "build_s": round(t_build, 1),
                    "dense_reference_s": round(t_ref, 1),
                    "dist_pgo_s": round(t_pgo, 1),
                    "dist_refine_s": round(t_refine, 1),
                    "single_process_refine_s": round(t_refine_local, 1),
                    "note": ("wall-clocks of one rank per card, each call synchronized; "
                             "the first dense solve includes the process's first-use "
                             "set-up on the card" if backend == "nccl" else
                             "wall-clocks of processes sharing this host's CPU cores over "
                             "localhost gloo: correctness evidence, not a performance claim"),
                    "ok": True,
                    "device": devices.describe(dev),
                }, f, indent=1)
            print(f"[worker 0] wrote {out_path}", flush=True)
        dist.barrier()
        print(f"[worker {pid}] total {time.perf_counter() - t_start:.1f}s", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=None,
                    help="ranks (default: the cards on cuda, 2 on the cpu)")
    ap.add_argument("--small", action="store_true", help="a 192-keyframe state")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.procs, args.coordinator, args.out, args.timeout,
               args.device, args.small)
        return 0
    dev = devices.resolve(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    procs = args.procs or (cards if dev.type == "cuda" else 2)
    if dev.type == "cuda" and procs > cards:
        raise RuntimeError(f"{procs} NCCL ranks asked for, {cards} cards: one rank is one card")
    rc = multiproc.launch(procs, args.out, args.timeout, retries=0,
                          module=os.path.abspath(__file__),
                          args=["--device", dev.type] + (["--small"] if args.small else []))
    if rc == 0 and args.out:
        with open(args.out) as f:
            print(json.dumps(json.load(f), indent=1))
    print(f"multiproc product {'OK' if rc == 0 else f'FAILED rc={rc}'}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
