#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`intensity_slam_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. build: compile the CUDA nearest-neighbour kernel (`csrc/nn.cu`) from the
   checkout and print nvcc's register/shared-memory report and build time;
2. kernel: hold the kernel against its plain PyTorch version at the ICP
   shapes (P = 2048 sources, M = 6144 targets) on three input sets — random
   clouds with duplicated targets and a partial mask, an all-masked target
   with a ragged P, and real keyframe clouds from `voxel_downsample` of
   rendered scans — indices and distances must be identical; then time the
   kernel, the plain version and `torch.cdist(...).min(1)` (a yardstick the
   port never calls) with CUDA events;
3. small: the slice at small_test_config on the CPU and on the card from the
   same scans — the same keyframes, skips and loop decisions;
4. slice: the slice at full width — SlamConfig() defaults (64x1024 scans,
   1024 features, 2048-point keyframe clouds, 1024 keyframes, so each PGO
   solve is the dense 6144-dim one) with only the two recency exclusions
   shortened for a 38-frame sequence — over the out-and-back of
   tests/test_loop_closure.py rendered on the card.  The kernel must
   launch on this path (33 launches per ICP verification).

The slice is the composition of `intensity_slam_tpu/pipeline/fused.py:159-168`
minus scan-to-map: intensity odometry every frame, `loop.backend_step` on
every keyframe with the integrated odometry pose as the mapping pose.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile

builds the kernel and profiles the full-width slice instead: host-clock
time per stage (each stage synchronized), then a `torch.profiler` trace of
the whole sequence with the device's busy share and its top kernels.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.ops import pallas_nn, projection, voxel
from intensity_slam_tpu_torch.pipeline import loop, odometry
from intensity_slam_tpu_torch.utils import se3

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
NN_FLOPS_PER_PAIR = 8          # 3 subtracts, 3 multiplies, 2 adds
P_ICP, M_ICP = 2048, 6144      # keyframe_cloud_size, (2*submap_window+1)*2048


class SmokeFailure(RuntimeError):
    """A phase of the smoke run failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def loop_trajectory(n_out=14, n_turn=8, speed=0.4) -> se3.Pose:
    """tests/test_loop_closure.py:18-36: forward along +x, U-turn, back."""
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    pose = se3.Pose(ident, torch.tensor([0.0, 0.0, 0.8]))
    fwd = se3.Pose(ident, torch.tensor([speed, 0.0, 0.0]))
    turn = se3.Pose(se3.so3_exp(torch.tensor([0.0, 0.0, math.pi / n_turn])),
                    torch.tensor([speed * 0.5, 0.0, 0.0]))
    qs, ts = [], []
    for step, n in ((fwd, n_out), (turn, n_turn), (fwd, n_out + 2)):
        for _ in range(n):
            qs.append(pose.q)
            ts.append(pose.t)
            pose = se3.compose(pose, step)
    return se3.Pose(torch.stack(qs), torch.stack(ts))


def slice_config(base: config.SlamConfig) -> config.SlamConfig:
    """The recency exclusions shortened for a 38-frame sequence, as
    tests/test_loop_closure.py:41-49 sets them."""
    return base.replace(loop=dataclasses.replace(
        base.loop, sc_num_exclude_recent=4, min_loop_search_gap=4))


def _sync_untracked(device):
    """A synchronize for timing that the sync counter does not see."""
    if device.type == "cuda":
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(mode)


def run_slice(cfg, xyz, inten, device, count_syncs=False) -> dict:
    """Odometry on every frame, the keyframe back-end on every keyframe.
    The driver reads one device value per frame (the keyframe flag it
    branches on); every other output is read after the sequence."""
    device = torch.device(device)
    mask = projection.detection_mask(cfg.sensor, device=device)
    odo = odometry.init_state(cfg, device=device)
    back = loop.init_state(cfg, device=device)
    frames, kfs, t_odo, t_back = [], [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(xyz.shape[0]):
                _sync_untracked(device)
                t0 = time.perf_counter()
                scan = projection.project_organized(xyz[k], inten[k], cfg.sensor)
                odo, out = odometry.odometry_step(odo, scan, k * 0.1, mask, cfg)
                is_kf = bool(out.is_keyframe)
                _sync_untracked(device)
                t_odo.append(time.perf_counter() - t0)
                frames.append((out.skip, is_kf))
                if not is_kf:
                    continue
                f = out.features
                t0 = time.perf_counter()
                valid = torch.sqrt(torch.sum(xyz[k] * xyz[k], -1)) >= cfg.sensor.min_range
                back, bout = loop.backend_step(
                    back, xyz[k], valid, f.desc, f.valid & f.xyz_valid, out.pose,
                    k * 0.1, cfg, feat_xyz=f.xyz, scan_int=inten[k])
                _sync_untracked(device)
                t_back.append(time.perf_counter() - t0)
                kfs.append((k, bout))
        finally:
            if count_syncs:
                torch.cuda.set_sync_debug_mode(0)
    sync_sites = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))
    frames = [(bool(skip), is_kf) for skip, is_kf in frames]
    kfs = [dict(kf=i, frame=k, candidate=bool(b.sc_found),
                accepted=bool(b.loop_found), loop_idx=int(b.loop_idx),
                fitness=float(b.icp_fitness)) for i, (k, b) in enumerate(kfs)]
    return dict(frames=frames, kfs=kfs, back=back, t_odo=t_odo, t_back=t_back,
                syncs=sum(sync_sites.values()), sync_sites=sync_sites)


def time_cuda(fn, reps=50, warmup=5) -> float:
    """Median ms of single calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def nn_bound_ms(P: int, M: int, m_valid: int) -> tuple[float, str]:
    """Least time for the NN function on this card: the larger of the
    operations (8 FP32 per (source, valid target) pair) over the FP32 peak
    and the bytes (inputs read once, outputs written once) over HBM rate."""
    t_ops = NN_FLOPS_PER_PAIR * P * m_valid / PEAK_FP32_FLOPS
    t_bytes = (P * 12 + M * 12 + M * 1 + P * 4 + P * 4) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_sets(dev, cfg) -> dict:
    g = torch.Generator().manual_seed(0)
    sets = {}
    # 1. duplicated targets on an integer grid, sources on half-integers:
    #    many exact distance ties; 80 % of the targets valid
    base = torch.randint(-6, 7, (M_ICP // 3, 3), generator=g).float()
    tgt = torch.cat([base, base, base])
    src = torch.randint(-6, 7, (P_ICP, 3), generator=g).float() + 0.5
    mask = torch.rand(M_ICP, generator=g) < 0.8
    sets["ties_partial_mask"] = (src, tgt, mask)
    # 2. every target masked, ragged source count
    sets["all_masked_ragged"] = (torch.randn(P_ICP - 3, 3, generator=g) * 5,
                                 torch.randn(M_ICP, 3, generator=g) * 5,
                                 torch.zeros(M_ICP, dtype=torch.bool))
    # 3. real keyframe clouds: voxel_downsample of rendered scans
    traj = loop_trajectory()
    world = synthetic.corridor_world(device=dev)
    clouds = []
    for i in (0, 4, 8, 12):
        xyz, _ = synthetic.render_scan(se3.Pose(traj.q[i].to(dev), traj.t[i].to(dev)),
                                       world, cfg.sensor)
        valid = torch.sqrt(torch.sum(xyz * xyz, -1)) >= cfg.sensor.min_range
        clouds.append(voxel.voxel_downsample(xyz, valid, cfg.loop.voxel_size * 2.0,
                                             P_ICP))
    src = clouds[0][0]
    tgt = torch.cat([c[0] for c in clouds[1:]])
    tmask = torch.cat([c[1] for c in clouds[1:]])
    sets["keyframe_clouds"] = (src, tgt, tmask)
    return {k: tuple(t.to(dev).contiguous() for t in v) for k, v in sets.items()}


def kernel_phase(dev, cfg) -> dict:
    sets = kernel_sets(dev, cfg)
    max_err = 0.0
    for name, (src, tgt, mask) in sets.items():
        ki, kd = pallas_nn.nearest_neighbor(src, tgt, mask)
        pi, pd = pallas_nn.nearest_neighbor_plain(src, tgt, mask)
        torch.cuda.synchronize()
        n_idx = int((ki != pi).sum())
        err = float((kd - pd).abs().max())
        print(f"kernel set {name}: P={src.shape[0]} M={tgt.shape[0]} "
              f"valid_targets={int(mask.sum())} index_mismatches={n_idx} "
              f"max_abs_dist_err={err}")
        if n_idx or not torch.equal(kd, pd):
            raise SmokeFailure(f"nn kernel disagrees with its plain version on {name}")
        if name == "all_masked_ragged":
            check(bool((ki == 0).all()) and bool((kd == 1e30).all()),
                  "all-masked targets must give index 0 and distance 1e30")
        max_err = max(max_err, err)
    src, tgt, mask = sets["keyframe_clouds"]
    tgt_valid = tgt[mask].contiguous()
    ms = time_cuda(lambda: pallas_nn.nearest_neighbor(src, tgt, mask))
    plain_ms = time_cuda(lambda: pallas_nn.nearest_neighbor_plain(src, tgt, mask))
    lib_ms = time_cuda(lambda: torch.cdist(src, tgt_valid).min(dim=1))
    bound, bound_by = nn_bound_ms(src.shape[0], tgt.shape[0], int(mask.sum()))
    print(f"kernel timing (keyframe_clouds, P={src.shape[0]} M={tgt.shape[0]}): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({bound_by})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=bound_by)


def decisions(r: dict):
    return (list(r["frames"]),
            [(k["frame"], k["candidate"], k["accepted"], k["loop_idx"]) for k in r["kfs"]])


def small_phase(dev) -> None:
    """The slice at small_test_config, CPU (plain versions) vs the card."""
    cfg = slice_config(config.small_test_config())
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, max_keyframes=64,
                                               keyframe_cloud_size=512))
    xyz, inten = synthetic.render_sequence(loop_trajectory(),
                                           synthetic.corridor_world(device="cpu"),
                                           cfg.sensor)
    ref = run_slice(cfg, xyz, inten, "cpu")
    got = run_slice(cfg, xyz.to(dev), inten.to(dev), dev)
    same = decisions(ref) == decisions(got)
    pr, pg = ref["back"].graph.poses.t, got["back"].graph.poses.t.cpu()
    dpose = float((pr - pg).abs().max())
    n_loops = sum(k["accepted"] for k in got["kfs"])
    print(f"small slice: keyframes {len(got['kfs'])} (cpu {len(ref['kfs'])}), "
          f"accepted loops {n_loops}, same decisions {same}, "
          f"max |graph t| diff vs cpu {dpose:.3g} m")
    if not same or dpose > 0.1 or n_loops < 1:
        raise SmokeFailure("small slice on the card disagrees with the CPU run")


def slice_phase(dev) -> dict:
    cfg = slice_config(config.SlamConfig())
    traj = loop_trajectory()
    world = synthetic.corridor_world(device=dev)
    xyz, inten = synthetic.render_sequence(
        se3.Pose(traj.q.to(dev), traj.t.to(dev)), world, cfg.sensor)
    check(xyz.shape == (38, cfg.sensor.num_points, 3), f"rendered {tuple(xyz.shape)}")
    # warm-up: one whole run (library loads, solver and autodiff set-up)
    run_slice(cfg, xyz, inten, dev)
    pallas_nn.nearest_neighbor.launches = 0
    r = run_slice(cfg, xyz, inten, dev)
    launches = pallas_nn.nearest_neighbor.launches
    # the same path again with every host sync counted (the sync debug
    # mode's warnings slow the host, so this run is not timed)
    pallas_nn.nearest_neighbor.launches = 0
    rs = run_slice(cfg, xyz, inten, dev, count_syncs=True)
    check(pallas_nn.nearest_neighbor.launches == launches,
          "second run launched the kernel another number of times")
    check(decisions(rs) == decisions(r), "second run took other decisions")
    r["syncs"], r["sync_sites"] = rs["syncs"], rs["sync_sites"]
    back = r["back"]
    n = int(back.graph.num_nodes)
    poses = torch.cat([back.graph.poses.q[:n], back.graph.poses.t[:n]], -1)
    skips = sum(f[0] for f in r["frames"])
    cands = [k for k in r["kfs"] if k["candidate"]]
    acc = [k for k in r["kfs"] if k["accepted"]]
    print(f"slice (full width): frames {len(r['frames'])}, keyframes {len(r['kfs'])}, "
          f"skips {skips}")
    for k in cands:
        print(f"  candidate: keyframe {k['kf']} (frame {k['frame']}) -> keyframe "
              f"{k['loop_idx']}, icp fitness {k['fitness']:.6g}, "
              f"{'accepted' if k['accepted'] else 'rejected'}")
    print(f"  candidates {len(cands)}, accepted loops {len(acc)}, "
          f"num_loops {int(back.graph.num_loops)}, nn kernel launches {launches}")
    print(f"  median ms per odometry_step {1e3 * statistics.median(r['t_odo']):.3f}, "
          f"per backend_step {1e3 * statistics.median(r['t_back']):.3f} "
          f"(max {1e3 * max(r['t_back']):.3f}, the accepted-loop keyframe)")
    print(f"  host syncs {r['syncs']} in {len(r['frames'])} frames = "
          f"{r['syncs'] / len(r['frames']):.2f} per frame; by call site:")
    for site, count in r["sync_sites"].most_common(12):
        print(f"    {count:5d}  {site}")
    print("  (the JAX package on the CPU, on its own renders: 10 keyframes, "
          "1 skip, loop keyframe 7 -> 2 accepted)")
    check(bool(torch.isfinite(poses).all()), "non-finite graph pose")
    check(n == len(r["kfs"]), "graph nodes != keyframes")
    check(launches >= 33, f"nn kernel launched {launches} times on the slice")
    check(all(k["fitness"] < cfg.loop.icp_fitness_score for k in acc),
          "an accepted loop above the fitness gate")
    return dict(launches=launches)


def _stage_timers(stage: dict) -> list:
    """Wrap the slice's hot callees with synchronized host timers; returns
    the (module, name, original) list to restore."""
    targets = [(odometry.F, "extract"), (odometry.F, "match_retry"),
               (odometry.solver, "solve_pose"), (loop, "voxel_downsample"),
               (loop.scancontext, "detect_loop"), (loop.bow, "detect_loop"),
               (loop.icp, "icp_align"), (loop.posegraph, "consistent_loop_mask"),
               (loop.posegraph, "optimize"), (loop.posegraph, "_edge_jacobians"),
               (loop.posegraph, "_loop_jacobians"),
               (loop.posegraph, "_dense_update_multi"),
               (loop.posegraph, "_frozen_cost")]
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)
        label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            stage[_label].append(time.perf_counter() - t0)
            return out

        setattr(mod, name, timed)
        saved.append((mod, name, fn))
    return saved


def profile_phase(dev) -> None:
    cfg = slice_config(config.SlamConfig())
    traj = loop_trajectory()
    xyz, inten = synthetic.render_sequence(
        se3.Pose(traj.q.to(dev), traj.t.to(dev)),
        synthetic.corridor_world(device=dev), cfg.sensor)
    run_slice(cfg, xyz, inten, dev)               # warm-up, as in slice_phase
    stage = collections.defaultdict(list)
    saved = _stage_timers(stage)
    try:
        r = run_slice(cfg, xyz, inten, dev)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(f"stage times, full-width slice ({len(r['frames'])} frames, "
          f"{len(r['kfs'])} keyframes; each stage synchronized):")
    print(f"  {'stage':34s} {'calls':>5s} {'median ms':>10s} {'max ms':>10s} {'total ms':>10s}")
    rows = [("odometry_step", r["t_odo"]), ("backend_step", r["t_back"])]
    rows += sorted(stage.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in rows:
        print(f"  {name:34s} {len(ts):5d} {1e3 * statistics.median(ts):10.3f} "
              f"{1e3 * max(ts):10.3f} {1e3 * sum(ts):10.3f}")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(cfg, xyz, inten, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    dur = [e.time_range.elapsed_us() for e in events]
    busy_us = sum(dur)
    by_name = collections.Counter()
    count = collections.Counter()
    for e, us in zip(events, dur):
        by_name[e.name] += us
        count[e.name] += 1
    print(f"profiled slice: wall {wall * 1e3:.1f} ms, device kernels {len(events)} "
          f"({len(events) / len(r['frames']):.0f} per frame), device busy "
          f"{busy_us / 1e3:.1f} ms = {100 * busy_us / 1e3 / (wall * 1e3):.1f} % of wall")
    print("  top device kernels by total time:")
    for name, us in by_name.most_common(15):
        print(f"    {us / 1e3:9.3f} ms  {count[name]:6d} x  {name[:90]}")
    print("  top host operations by self CPU time:")
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:15]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(gpu_name_and_power())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = pallas_nn.build(verbose=True)
    print(f"nn kernel build: {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "smem" in line.lower() or "error" in line.lower():
            print("  nvcc:", line.strip())
    if "--profile" in sys.argv[1:]:
        profile_phase(dev)
        return 0
    cfg = slice_config(config.SlamConfig())
    kern = kernel_phase(dev, cfg)
    small_phase(dev)
    sl = slice_phase(dev)
    record = {"kernels": [{
        "name": "nn_kernel",
        "route": "cuda",
        "source": "intensity_slam_tpu_torch/csrc/nn.cu",
        "replaces": "intensity_slam_tpu/ops/pallas_nn.py:103",
        "launches": sl["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "passed": True,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
