#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`intensity_slam_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. build: compile the CUDA nearest-neighbour kernels (`csrc/nn.cu`) from the
   checkout and print nvcc's register/shared-memory report and build time;
2. kernel: hold both kernels (`pack_kernel`, `nn_packed_kernel`) against
   their plain PyTorch versions at the ICP shapes (P = 2048 sources,
   M = 6144 targets) on three input sets — random clouds with duplicated
   targets and a partial mask, an all-masked target with a ragged P, and
   real keyframe clouds from `voxel_downsample` of rendered scans — through
   the unpacked entry (pack + search) and the packed one (pack once, search
   on fresh sources): packs, indices and distances must be identical.  Then
   time, with CUDA events: the search, 33 back-to-back searches on fresh
   sources, the pack, an empty kernel through the same ctypes route (the
   launch floor), the plain versions and `torch.cdist(...).min(1)` (a
   yardstick the port never calls); and the search's device-side duration
   with `torch.profiler`;
3. grid: the voxel grid-hash map at full width (32768 sets x 4 ways x 8
   slots): one rendered frame, downsampled at the ground and at the corner
   voxel size, and one 2 097 152-point rebuild batch (the first of the two
   clouds at 1024 keyframe poses)
   are inserted on the CPU and on the card, then the frame's cloud is
   inserted into the rebuilt map; `way_keys`, `valid`, `num_points` must be
   equal and `pts` bit-equal, and `knn` (8 and 27 cells) must select the same
   points at bit-equal distances.  Then times by CUDA events and device
   kernels per call of `knn`, `insert` and `evict_far`;
4. small: `SlamSystem` at small_test_config on the CPU and on the card from
   the same scans: the same keyframes, skips and loop decisions;
5. fallback: `slam_step` at full width (SlamConfig() defaults) over an
   8-frame corridor rendered on the card with the intensity set to a
   constant, so that the intensity stream skips every frame and the
   geometric fallback carries the pose: every frame must skip, the end
   position must lie within 0.35 m of the rendered trajectory, ground must
   be ok, and the same sequence at small_test_config must take the same
   decisions on the CPU and on the card;
6. slice: the main path at full width, `SlamSystem(cfg).process(...)` per
   frame, with SlamConfig() defaults (64x1024 scans, 1024 features,
   2048-point keyframe clouds, 1024 keyframes, so each PGO solve is the
   dense 6144-dim one, two voxel maps of 131 073 cells) and only the two
   recency exclusions shortened for a 38-frame sequence, over the
   out-and-back of tests/test_loop_closure.py rendered on the card.  Both
   kernels must launch on this path (1 pack and 33 searches per ICP
   verification).  Checked: at least 8 keyframes, one accepted loop from the
   return leg to the start, at least 16 plane residuals on every frame after
   the first, the ground map growing on every frame and changed by the
   rebuild at the accepted loop only, a finite 38-row `trajectory()` whose
   end lies within 0.5 m of the rendered end.

Every frame runs `fused.fused_step`: `slam_step` (intensity odometry,
curvature features, geometric fallback on a skipped frame, mux, ground
RANSAC, scan-to-map), on a keyframe `loop.keyframe_core` with the
scan-to-map pose, at an accepted loop the correction feedback and the map
rebuild, and the ring-log append.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --phase kernel|grid|small|fallback|slice

builds the kernels and runs that one phase alone (no result lines).

    python3 chip_smoke.py --profile

builds the kernels and profiles the full-width slice instead: host-clock
time per stage (each stage synchronized), then a `torch.profiler` trace of
the whole sequence with the device's busy share and its top kernels.
"""

from __future__ import annotations

import collections
import contextlib
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
from intensity_slam_tpu_torch.ops import grid_hash, pallas_nn, projection, voxel
from intensity_slam_tpu_torch.pipeline import loop, mapping, odometry, slam
from intensity_slam_tpu_torch.pipeline.system import SlamSystem
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


@contextlib.contextmanager
def sync_counter(enabled: bool):
    """Count host syncs by call site for the length of the block (CUDA's
    sync debug mode warns on each one); yields a Counter filled on exit."""
    sites = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if enabled:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            if enabled:
                torch.cuda.set_sync_debug_mode(0)
    sites.update(f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message))


@contextlib.contextmanager
def captured(mod, name: str, keep):
    """Record `keep(result)` of every call of `mod.name` for the length of
    the block; yields the list."""
    fn = getattr(mod, name)
    kept = []

    def recording(*a, **k):
        out = fn(*a, **k)
        kept.append(keep(out))
        return out

    setattr(mod, name, recording)
    try:
        yield kept
    finally:
        setattr(mod, name, fn)


def run_slam(cfg, xyz, inten, device, count_syncs=False) -> dict:
    """`slam_step` over a sequence.  The step reads one device value set per
    frame (skip, has_prev and the keyframe flag, together) besides its
    solvers' own reads; every other output is read after the sequence."""
    device = torch.device(device)
    mask = projection.detection_mask(cfg.sensor, device=device)
    st = slam.init_state(cfg, seed=0, device=device)
    outs, t_step = [], []
    with sync_counter(count_syncs) as sync_sites:
        for k in range(xyz.shape[0]):
            _sync_untracked(device)
            t0 = time.perf_counter()
            st, out = slam.slam_step(st, xyz[k], inten[k], k * 0.1, mask, cfg)
            _sync_untracked(device)
            t_step.append(time.perf_counter() - t0)
            outs.append(out)
    return dict(
        frames=[(o.host.skip, o.host.is_keyframe) for o in outs],
        ground_ok=[bool(o.ground_ok) for o in outs],
        t=torch.stack([o.odom_pose.t for o in outs]).cpu(),
        q=torch.stack([o.odom_pose.q for o in outs]).cpu(),
        map_t=torch.stack([o.pose.t for o in outs]).cpu(),
        plane=[int(o.num_plane_residuals) for o in outs],
        t_step=t_step, syncs=sum(sync_sites.values()), sync_sites=sync_sites)


def run_system(cfg, xyz, inten, device, count_syncs=False) -> dict:
    """The main path: `SlamSystem.process` on every frame.  Nothing is read
    from the device inside the loop beyond what the step reads itself; the
    per-frame scalars are fetched after the sequence."""
    device = torch.device(device)
    system = SlamSystem(cfg, seed=0, device=device)
    infos, t_step, after = [], [], []
    keep = lambda r: (r[1].num_plane_residuals, r[1].map_points)
    with captured(slam.mapping, "mapping_step", keep) as mapped, \
            sync_counter(count_syncs) as sync_sites:
        for k in range(xyz.shape[0]):
            _sync_untracked(device)
            t0 = time.perf_counter()
            infos.append(system.process(xyz[k], inten[k], k * 0.1))
            _sync_untracked(device)
            t_step.append(time.perf_counter() - t0)
            after.append(system.state.slam.mapping.ground_map.num_points)
    frames = [(bool(i.skip), bool(i.is_keyframe)) for i in infos]
    kfs = [dict(kf=int(i.num_kf) - 1, frame=k,
                candidate=math.isfinite(float(i.icp_fitness)),
                accepted=bool(i.loop_found), loop_idx=int(i.loop_idx),
                fitness=float(i.icp_fitness))
           for k, i in enumerate(infos) if frames[k][1]]
    return dict(
        system=system, frames=frames, kfs=kfs, t_step=t_step,
        plane=[int(p) for p, _ in mapped],
        map_points=[int(m) for _, m in mapped],       # after the frame's insert
        map_points_after=[int(a) for a in after],     # after the frame's rebuild
        traj=system.trajectory(),
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


def pack_bound_ms(M: int, m_valid: int) -> tuple[float, str]:
    """Least time for the packing: targets and mask read once, the packed
    rows and the count written once, over the HBM rate (its operations, one
    compare and one add per target, are far below that)."""
    t_bytes = (M * 12 + M * 1 + M * 16 + 4) / PEAK_BYTES_PER_S
    t_ops = 2 * M / PEAK_FP32_FLOPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def time_cuda_batch(fn, n: int, reps=20, warmup=3) -> float:
    """Median ms per call of `n` back-to-back calls, CUDA events around
    each batch."""
    return time_cuda(lambda: [fn(i) for i in range(n)], reps=reps,
                     warmup=warmup) / n


def kernel_device_us(fn, name: str, n: int = 33) -> float:
    """Median device-side duration in microseconds of the kernel `name`
    over `n` calls of `fn`, from a `torch.profiler` trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type.name == "CUDA" and name in e.name]
    check(len(durs) >= n, f"the profiler saw {len(durs)} launches of {name}")
    return statistics.median(durs)


def kernel_phase(dev, cfg) -> dict:
    """Both kernels against their plain versions on three input sets,
    through the unpacked entry (pack + search) and the packed one (pack
    once, search on fresh sources), then their times."""
    sets = kernel_sets(dev, cfg)
    max_err = 0.0
    for name, (src, tgt, mask) in sets.items():
        pi, pd = pallas_nn.nearest_neighbor_plain(src, tgt, mask)
        ui, ud = pallas_nn.nearest_neighbor(src, tgt, mask)
        packed = pallas_nn.pack_targets(tgt, mask)
        plain_pack = pallas_nn.pack_targets_plain(tgt, mask)
        ki, kd = pallas_nn.nearest_neighbor_packed(src, packed)
        # a second search on the same pack, on other sources
        src2 = (src * 0.5 + 0.25).contiguous()
        ki2, kd2 = pallas_nn.nearest_neighbor_packed(src2, packed)
        pi2, pd2 = pallas_nn.nearest_neighbor_plain(src2, tgt, mask)
        qi, qd = pallas_nn.nearest_neighbor_packed_plain(src, plain_pack)
        torch.cuda.synchronize()
        pack_same = (torch.equal(packed.count, plain_pack.count)
                     and torch.equal(packed.data.view(torch.int32),
                                     plain_pack.data.view(torch.int32)))
        n_idx = int((ki != pi).sum()) + int((ui != pi).sum()) + int((ki2 != pi2).sum())
        err = max(float((kd - pd).abs().max()), float((ud - pd).abs().max()),
                  float((kd2 - pd2).abs().max()))
        print(f"kernel set {name}: P={src.shape[0]} M={tgt.shape[0]} "
              f"valid_targets={int(mask.sum())} pack_identical={pack_same} "
              f"index_mismatches={n_idx} max_abs_dist_err={err}")
        check(pack_same, f"pack kernel disagrees with its plain version on {name}")
        same = (torch.equal(kd, pd) and torch.equal(ud, pd) and torch.equal(kd2, pd2)
                and torch.equal(qi, pi) and torch.equal(qd, pd))
        if n_idx or not same:
            raise SmokeFailure(f"nn kernel disagrees with its plain version on {name}")
        if name == "all_masked_ragged":
            check(bool((ki == 0).all()) and bool((kd == 1e30).all()),
                  "all-masked targets must give index 0 and distance 1e30")
        max_err = max(max_err, err)
    src, tgt, mask = sets["keyframe_clouds"]
    m_valid = int(mask.sum())
    tgt_valid = tgt[mask].contiguous()
    packed = pallas_nn.pack_targets(tgt, mask)
    plain_pack = pallas_nn.pack_targets_plain(tgt, mask)
    fresh = [(src + 0.01 * i).contiguous() for i in range(33)]
    floor_ms = time_cuda(lambda: pallas_nn.empty_launch(dev))
    ms = time_cuda(lambda: pallas_nn.nearest_neighbor_packed(src, packed))
    unpacked_ms = time_cuda(lambda: pallas_nn.nearest_neighbor(src, tgt, mask))
    pack_ms = time_cuda(lambda: pallas_nn.pack_targets(tgt, mask))
    batch_ms = time_cuda_batch(
        lambda i: pallas_nn.nearest_neighbor_packed(fresh[i], packed), 33)
    floor_batch_ms = time_cuda_batch(lambda i: pallas_nn.empty_launch(dev), 33)
    plain_ms = time_cuda(lambda: pallas_nn.nearest_neighbor_plain(src, tgt, mask))
    packed_plain_ms = time_cuda(
        lambda: pallas_nn.nearest_neighbor_packed_plain(src, plain_pack))
    pack_plain_ms = time_cuda(lambda: pallas_nn.pack_targets_plain(tgt, mask))
    lib_ms = time_cuda(lambda: torch.cdist(src, tgt_valid).min(dim=1))
    device_us = kernel_device_us(
        lambda: pallas_nn.nearest_neighbor_packed(src, packed), "nn_packed_kernel")
    pack_device_us = kernel_device_us(
        lambda: pallas_nn.pack_targets(tgt, mask), "pack_kernel")
    bound, bound_by = nn_bound_ms(src.shape[0], tgt.shape[0], m_valid)
    pbound, pbound_by = pack_bound_ms(tgt.shape[0], m_valid)
    print(f"kernel timing (keyframe_clouds, P={src.shape[0]} M={tgt.shape[0]}, "
          f"{m_valid} valid; CUDA events, median of single calls):")
    print(f"  nn_packed_kernel {ms:.4f} ms (33 back-to-back launches on fresh "
          f"sources: {batch_ms:.4f} ms each), unpacked entry (pack + search) "
          f"{unpacked_ms:.4f} ms, plain {plain_ms:.4f} ms, packed plain "
          f"{packed_plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({bound_by}); device-side duration "
          f"{device_us:.2f} us (torch.profiler, median of 33)")
    print(f"  pack_kernel {pack_ms:.4f} ms (device-side {pack_device_us:.2f} us), plain (stable argsort) "
          f"{pack_plain_ms:.4f} ms, bound {pbound:.6f} ms ({pbound_by})")
    print(f"  launch floor: an empty kernel through the same ctypes route "
          f"{floor_ms:.4f} ms (33 back to back: {floor_batch_ms:.4f} ms each)")
    return dict(
        nn=dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=bound_by, batch_ms=batch_ms,
                device_ms=device_us / 1e3, floor_ms=floor_ms),
        pack=dict(max_abs_err=0.0, ms=pack_ms, plain_ms=pack_plain_ms,
                  library_ms=None, bound_ms=pbound, bound_by=pbound_by,
                  device_ms=pack_device_us / 1e3, floor_ms=floor_ms))


def reset_launches() -> None:
    pallas_nn.pack_targets.launches = 0
    pallas_nn.nearest_neighbor_packed.launches = 0


def read_launches() -> dict:
    return dict(nn=pallas_nn.nearest_neighbor_packed.launches,
                pack=pallas_nn.pack_targets.launches)


def decisions(r: dict):
    return (list(r["frames"]),
            [(k["frame"], k["candidate"], k["accepted"], k["loop_idx"]) for k in r["kfs"]])


def device_kernels(fn) -> int:
    """Device kernels (and copies) that one call of `fn` launches, from a
    `torch.profiler` trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    count = 0
    for _ in range(3):          # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        count = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
        if count:
            break
    return count


def _same_map(a: grid_hash.VoxelHashMap, b: grid_hash.VoxelHashMap) -> bool:
    """CPU map `a` against card map `b`: discrete fields equal, points
    bit-equal."""
    b = grid_hash.VoxelHashMap(*(t.cpu() for t in b))
    return (torch.equal(a.way_keys, b.way_keys) and torch.equal(a.valid, b.valid)
            and torch.equal(a.num_points, b.num_points)
            and torch.equal(a.pts.view(torch.int32), b.pts.view(torch.int32)))


def _same_knn(mc, md, queries, cell: float, k: int) -> bool:
    ok = True
    for nb in (8, 27):
        cs, csq, cv = grid_hash.knn(mc, queries.cpu(), cell, k=k, neighborhood=nb)
        ds, dsq, dv = grid_hash.knn(md, queries, cell, k=k, neighborhood=nb)
        ok = ok and (torch.equal(cv, dv.cpu())
                     and torch.equal(csq.view(torch.int32), dsq.cpu().view(torch.int32))
                     and torch.equal(cs.view(torch.int32), ds.cpu().view(torch.int32)))
    return ok


def grid_phase(dev) -> None:
    """The voxel grid-hash map at full width, CPU against the card."""
    cfg = config.SlamConfig()
    mc = cfg.mapping
    S = mc.map_capacity // (4 * 8)
    K = cfg.loop.max_keyframes
    traj = loop_trajectory()
    xyz, _ = synthetic.render_scan(
        se3.Pose(traj.q[0].to(dev), traj.t[0].to(dev)),
        synthetic.corridor_world(device=dev), cfg.sensor)
    valid = torch.sqrt(torch.sum(xyz * xyz, -1)) >= cfg.sensor.min_range
    g, gm = voxel.voxel_downsample(xyz, valid, mc.ground_voxel, mc.max_query_points)
    c, cm = voxel.voxel_downsample(xyz, valid, mc.corner_voxel,
                                   mc.max_query_points // 2)
    # the rebuild batch: the frame's cloud at K keyframe poses, 0.3 m apart
    # along +x with a slow yaw, as `rebuild_maps` flattens them
    kk = torch.arange(K, device=dev, dtype=torch.float32)
    zero = torch.zeros_like(kk)
    poses = se3.Pose(se3.so3_exp(torch.stack([zero, zero, 0.002 * kk], -1)),
                     torch.stack([0.3 * kk, zero, zero], -1))
    batch = se3.transform_points(poses, g.expand(K, -1, -1)).reshape(-1, 3)
    bmask = gm.expand(K, -1).reshape(-1)
    gcell, ccell = 2.0 * mc.ground_voxel, 2.0 * mc.corner_voxel
    cases = [("frame ground cloud", g, gm, gcell), ("frame corner cloud", c, cm, ccell),
             ("rebuild batch", batch, bmask, gcell)]
    maps = {}
    for name, pts, mask, cell in cases:
        t0 = time.perf_counter()
        m_cpu = grid_hash.insert(grid_hash.empty(S, 4, device="cpu"),
                                 pts.cpu(), mask.cpu(), cell)
        t_cpu = time.perf_counter() - t0
        m_dev = grid_hash.insert(grid_hash.empty(S, 4, device=dev), pts, mask, cell)
        same = _same_map(m_cpu, m_dev)
        q = pts[:: max(1, pts.shape[0] // 2048)][:2048] + 0.05
        same_knn = _same_knn(m_cpu, m_dev, q, cell, mc.knn)
        print(f"grid {name}: {pts.shape[0]} points ({int(mask.sum())} masked in), map "
              f"points {int(m_dev.num_points)}, ways claimed "
              f"{int((m_dev.way_keys >= 0).sum())} of {S * 4}, equal to the CPU's "
              f"{same}, knn (8 and 27 cells) equal {same_knn}; the CPU insert took "
              f"{t_cpu:.2f} s")
        check(same, f"grid-hash insert of the {name} differs between CPU and card")
        check(same_knn, f"grid-hash knn after the {name} differs between CPU and card")
        maps[name] = (m_cpu, m_dev)
    # an insert into an OCCUPIED map: the frame's cloud, moved, into the
    # rebuilt map (the occupant comparison and the hit path)
    m_cpu, m_dev = maps["rebuild batch"]
    moved = g + torch.tensor([0.37, 1.9, 0.02], device=dev)
    n_cpu = grid_hash.insert(m_cpu, moved.cpu(), gm.cpu(), gcell)
    n_dev = grid_hash.insert(m_dev, moved, gm, gcell)
    same = _same_map(n_cpu, n_dev) and _same_knn(n_cpu, n_dev, moved, gcell, mc.knn)
    radius = 0.15 * K              # half of the batch's extent along +x
    e_cpu = grid_hash.evict_far(n_cpu, torch.zeros(3), radius)
    e_dev = grid_hash.evict_far(n_dev, torch.zeros(3, device=dev), radius)
    same_evict = _same_map(e_cpu, e_dev)
    print(f"grid insert into the rebuilt map: added "
          f"{int(n_dev.num_points) - int(m_dev.num_points)} points, equal to the CPU's "
          f"{same}; evict_far beyond {radius:.1f} m keeps {int(e_dev.num_points)} of "
          f"{int(n_dev.num_points)} points and {int((e_dev.way_keys >= 0).sum())} "
          f"ways, equal {same_evict}")
    check(same, "insert into an occupied map differs between CPU and card")
    check(same_evict, "evict_far differs between CPU and card")
    check(int(e_dev.num_points) < int(n_dev.num_points), "evict_far evicted nothing")

    q_world = moved
    over = n_dev.num_points > 0
    calls = [
        (f"knn ({moved.shape[0]} queries, 8 cells, k={mc.knn})", 50,
         lambda: grid_hash.knn(n_dev, q_world, gcell, k=mc.knn, neighborhood=8)),
        (f"knn ({moved.shape[0]} queries, 27 cells, k={mc.knn})", 50,
         lambda: grid_hash.knn(n_dev, q_world, gcell, k=mc.knn, neighborhood=27)),
        (f"insert ({moved.shape[0]}-point frame cloud)", 50,
         lambda: grid_hash.insert(m_dev, moved, gm, gcell)),
        (f"insert ({batch.shape[0]}-point rebuild batch)", 5,
         lambda: grid_hash.insert(grid_hash.empty(S, 4, device=dev), batch, bmask, gcell)),
        ("evict_far (conditional pass)", 50,
         lambda: grid_hash.evict_far(n_dev, q_world[0], mc.map_keep_radius, when=over)),
    ]
    print("grid timing (CUDA events, median of single calls; device kernels per "
          "call from torch.profiler):")
    for name, reps, fn in calls:
        ms = time_cuda(fn, reps=reps, warmup=2)
        print(f"  {name}: {ms:.3f} ms, {device_kernels(fn)} device kernels")


def small_phase(dev) -> None:
    """`SlamSystem` at small_test_config, CPU (plain versions) vs the card."""
    cfg = slice_config(config.small_test_config())
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, max_keyframes=64,
                                               keyframe_cloud_size=512))
    xyz, inten = synthetic.render_sequence(loop_trajectory(),
                                           synthetic.corridor_world(device="cpu"),
                                           cfg.sensor)
    ref = run_system(cfg, xyz, inten, "cpu")
    got = run_system(cfg, xyz.to(dev), inten.to(dev), dev)
    same = decisions(ref) == decisions(got)
    pr = ref["system"].state.backend.graph.poses.t
    pg = got["system"].state.backend.graph.poses.t.cpu()
    dpose = float((pr - pg).abs().max())
    dtraj = float(abs(ref["traj"] - got["traj"]).max())
    n_loops = sum(k["accepted"] for k in got["kfs"])
    print(f"small system: keyframes {len(got['kfs'])} (cpu {len(ref['kfs'])}), "
          f"accepted loops {n_loops}, same decisions {same}, "
          f"max |graph t| diff vs cpu {dpose:.3g} m, max |trajectory| diff "
          f"{dtraj:.3g} m, ground map points {got['map_points_after'][-1]} "
          f"(cpu {ref['map_points_after'][-1]})")
    if not same or dpose > 0.1 or dtraj > 0.1 or n_loops < 1:
        raise SmokeFailure("small system on the card disagrees with the CPU run")


def state_bytes(system) -> tuple[int, int]:
    """Bytes held by the two voxel maps and by the keyframe store."""
    size = lambda t: t.numel() * t.element_size()
    m = system.state.slam.mapping
    maps = sum(size(t) for vm in (m.ground_map, m.corner_map) for t in vm)
    b = system.state.backend
    store = sum(size(getattr(b, f)) for f in b._fields
                if f.startswith("kf_") and isinstance(getattr(b, f), torch.Tensor))
    return maps, store


def slice_phase(dev) -> dict:
    cfg = slice_config(config.SlamConfig())
    traj = loop_trajectory()
    world = synthetic.corridor_world(device=dev)
    xyz, inten = synthetic.render_sequence(
        se3.Pose(traj.q.to(dev), traj.t.to(dev)), world, cfg.sensor)
    n = xyz.shape[0]
    check(xyz.shape == (38, cfg.sensor.num_points, 3), f"rendered {tuple(xyz.shape)}")
    # warm-up: one whole run (library loads, solver and autodiff set-up)
    run_system(cfg, xyz, inten, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r = run_system(cfg, xyz, inten, dev)
    launches = read_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # the same path with each stage synchronized and timed
    with stage_timers(SYSTEM_STAGES) as stage:
        rt = run_system(cfg, xyz, inten, dev)
    # and with every host sync counted (the sync debug mode's warnings slow
    # the host, so this run is not timed)
    reset_launches()
    rs = run_system(cfg, xyz, inten, dev, count_syncs=True)
    check(read_launches() == launches,
          "second run launched the kernel another number of times")
    check(decisions(rs) == decisions(r) == decisions(rt),
          "a repeated run took other decisions")
    system = r["system"]
    back = system.state.backend
    nk = int(back.graph.num_nodes)
    poses = torch.cat([back.graph.poses.q[:nk], back.graph.poses.t[:nk]], -1)
    skips = [k for k, f in enumerate(r["frames"]) if f[0]]
    cands = [k for k in r["kfs"] if k["candidate"]]
    acc = [k for k in r["kfs"] if k["accepted"]]
    kf_frames = {k["frame"] for k in r["kfs"]}
    t_kf = [t for k, t in enumerate(r["t_step"]) if k in kf_frames]
    t_other = [t for k, t in enumerate(r["t_step"]) if k not in kf_frames]
    gt_end = traj.t[-1] - traj.t[0]            # the first pose has no rotation
    end_err = float(torch.linalg.norm(torch.from_numpy(r["traj"][-1]) - gt_end))
    maps_b, store_b = state_bytes(system)
    print(f"slice (full width, SlamSystem.process): frames {n}, keyframes "
          f"{len(r['kfs'])}, skips {len(skips)} at frames {skips} (frame 0 has no "
          f"previous frame, so it takes no fallback solve), skips in the log "
          f"{system.num_skips}")
    for k in cands:
        print(f"  candidate: keyframe {k['kf']} (frame {k['frame']}) -> keyframe "
              f"{k['loop_idx']}, icp fitness {k['fitness']:.6g}, "
              f"{'accepted' if k['accepted'] else 'rejected'}")
    print(f"  candidates {len(cands)}, accepted loops {len(acc)}, loop table "
          f"{[(a, b) for a, b, _ in system.loops]}, nn kernel launches "
          f"{launches['nn']}, pack kernel launches {launches['pack']}")
    print(f"  plane residuals per frame {r['plane']}")
    print(f"  ground map points after each frame's insert {r['map_points']}")
    print(f"  trajectory: {r['traj'].shape[0]} rows, end {r['traj'][-1].round(3).tolist()} "
          f"against the rendered {[round(float(v), 3) for v in gt_end]}, error "
          f"{end_err:.4f} m; the merged odometry alone ends at "
          f"{system.odom_trajectory()[-1].round(3).tolist()}")
    print(f"  median ms per process {1e3 * statistics.median(r['t_step']):.3f} "
          f"(non-keyframes {1e3 * statistics.median(t_other):.3f}, keyframes "
          f"{1e3 * statistics.median(t_kf):.3f}, max {1e3 * max(r['t_step']):.3f} at "
          f"frame {r['t_step'].index(max(r['t_step']))}); peak device memory "
          f"{peak_mb:.0f} MiB; the maps hold {maps_b} bytes, the keyframe store "
          f"{store_b} bytes")
    print("  each stage synchronized (a separate run; stages nest):")
    print_stage_rows([("process", rt["t_step"])]
                     + sorted(stage.items(), key=lambda kv: -sum(kv[1])))
    print(f"  host syncs {rs['syncs']} in {n} frames = {rs['syncs'] / n:.2f} per "
          f"frame; by call site:")
    print_sync_sites(rs["sync_sites"])
    check(bool(torch.isfinite(poses).all()), "non-finite graph pose")
    check(nk == len(r["kfs"]) >= 8, f"{len(r['kfs'])} keyframes, {nk} graph nodes")
    check(len(acc) == 1 and acc[0]["kf"] - acc[0]["loop_idx"] >= 4,
          f"accepted loops: {acc}")
    check(acc[0]["frame"] > 14 + 8 and acc[0]["loop_idx"] <= 4,
          "the loop does not join the return leg to the start")
    check(launches["nn"] >= 33, f"nn kernel launched {launches['nn']} times on the slice")
    check(launches["pack"] >= 1, "pack kernel was not launched on the slice")
    check(all(k["fitness"] < cfg.loop.icp_fitness_score for k in acc),
          "an accepted loop above the fitness gate")
    check(all(p >= 16 for p in r["plane"][1:]),
          f"fewer than 16 plane residuals on a frame: {r['plane']}")
    loop_frame = acc[0]["frame"]
    grown, rebuilt = r["map_points"], r["map_points_after"]
    check(all(grown[k] >= rebuilt[k - 1] for k in range(1, n)) and grown[0] > 0,
          "the ground map shrank on an insert")
    check(all((grown[k] != rebuilt[k]) == (k == loop_frame) for k in range(n)),
          "the ground map was rebuilt on another frame than the accepted loop's")
    check(r["traj"].shape == (n, 3) and bool(torch.isfinite(
        torch.from_numpy(r["traj"])).all()), "trajectory is not 38 finite rows")
    check(end_err < 0.5, f"trajectory ends {end_err:.3f} m from the rendered end")
    return dict(launches=launches)


SLAM_STAGES = [(slam.odometry, "odometry_step"),
               (slam.curvature, "extract_features"),
               (slam.geometric, "geometric_delta"),
               (slam.ground, "extract_ground"),
               (slam.mapping, "mapping_step")]
MAP_STAGES = [(mapping.grid_hash, "knn"), (mapping.grid_hash, "insert"),
              (mapping.grid_hash, "evict_far"), (mapping, "voxel_downsample"),
              (mapping, "_fit_planes"), (mapping, "fit_lines"),
              (mapping, "rebuild_maps")]
SYSTEM_STAGES = SLAM_STAGES + MAP_STAGES + [
    (slam, "slam_step"), (loop, "keyframe_core"), (loop, "write_slot"),
    (odometry.F, "extract"), (odometry.F, "match_retry"),
    (odometry.solver, "solve_pose"), (loop, "voxel_downsample"),
    (loop.scancontext, "detect_loop"), (loop.bow, "detect_loop"),
    (loop.icp, "icp_align"), (loop.posegraph, "consistent_loop_mask"),
    (loop.posegraph, "optimize"), (loop.posegraph, "_edge_jacobians"),
    (loop.posegraph, "_loop_jacobians"),
    (loop.posegraph, "_dense_update_multi"),
    (loop.posegraph, "_frozen_cost")]


@contextlib.contextmanager
def stage_timers(targets):
    """Wrap the named callees with synchronized host timers for the length
    of the block; yields {label: [seconds per call]}."""
    stage = collections.defaultdict(list)
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)
        label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

        def timed(*a, _fn=fn, _label=label, **k):
            _sync_untracked(torch.device("cuda"))
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            _sync_untracked(torch.device("cuda"))
            stage[_label].append(time.perf_counter() - t0)
            return out

        setattr(mod, name, timed)
        saved.append((mod, name, fn))
    try:
        yield stage
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def print_stage_rows(rows) -> None:
    print(f"  {'stage':34s} {'calls':>5s} {'median ms':>10s} {'max ms':>10s} {'total ms':>10s}")
    for name, ts in rows:
        print(f"  {name:34s} {len(ts):5d} {1e3 * statistics.median(ts):10.3f} "
              f"{1e3 * max(ts):10.3f} {1e3 * sum(ts):10.3f}")


def print_sync_sites(sites: collections.Counter) -> None:
    for site, count in sites.most_common():
        print(f"    {count:5d}  {site}")


def forward_trajectory(n: int, speed: float = 0.3) -> se3.Pose:
    """`n` poses along +x at 0.8 m height, `speed` metres apart."""
    q = torch.tensor([1.0, 0.0, 0.0, 0.0]).expand(n, 4).clone()
    t = torch.zeros(n, 3)
    t[:, 0] = speed * torch.arange(n)
    t[:, 2] = 0.8
    return se3.Pose(q, t)


def fallback_phase(dev) -> None:
    """The geometric fallback at full width: constant intensity makes every
    frame skip, so `geometric_delta` carries the pose."""
    n = 8
    traj = forward_trajectory(n)
    # the same sequence at small_test_config, CPU vs card
    scfg = config.small_test_config()
    sx, si = synthetic.render_sequence(traj, synthetic.corridor_world(device="cpu"),
                                       scfg.sensor)
    si = torch.full_like(si, 100.0)
    ref = run_slam(scfg, sx, si, "cpu")
    got = run_slam(scfg, sx.to(dev), si.to(dev), dev)
    same = (ref["frames"], ref["ground_ok"]) == (got["frames"], got["ground_ok"])
    dpos = float((ref["t"] - got["t"]).abs().max())
    print(f"small fallback: skips {sum(f[0] for f in got['frames'])}/{n}, ground ok "
          f"{sum(got['ground_ok'])}/{n}, same decisions as the CPU {same}, "
          f"max |t| diff vs cpu {dpos:.3g} m")
    check(same, "small fallback run on the card took other decisions than the CPU")
    check(all(f[0] for f in got["frames"]), "small fallback: a frame did not skip")
    check(dpos < 0.05, "small fallback: card pose differs from the CPU's")

    cfg = config.SlamConfig()
    xyz, inten = synthetic.render_sequence(
        se3.Pose(traj.q.to(dev), traj.t.to(dev)),
        synthetic.corridor_world(device=dev), cfg.sensor)
    inten = torch.full_like(inten, 100.0)
    check(xyz.shape == (n, cfg.sensor.num_points, 3), f"rendered {tuple(xyz.shape)}")
    run_slam(cfg, xyz, inten, dev)                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    r = run_slam(cfg, xyz, inten, dev)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    with stage_timers(SLAM_STAGES) as stage:
        run_slam(cfg, xyz, inten, dev)
    rs = run_slam(cfg, xyz, inten, dev, count_syncs=True)
    check(rs["frames"] == r["frames"], "fallback: second run took other decisions")
    gt = traj.t - traj.t[0]
    end_err = float(torch.sqrt(torch.sum((r["t"][-1] - gt[-1]) ** 2)))
    step_err = float(torch.sqrt(torch.sum((r["t"] - gt) ** 2, -1)).max())
    map_err = float(torch.sqrt(torch.sum((r["map_t"][-1] - gt[-1]) ** 2)))
    print(f"fallback (full width, {n} frames, constant intensity): skips "
          f"{sum(f[0] for f in r['frames'])}/{n}, ground ok {sum(r['ground_ok'])}/{n}, "
          f"end position error of the odometry {end_err:.4f} m (largest over the "
          f"frames {step_err:.4f} m), of the scan-to-map pose {map_err:.4f} m, plane "
          f"residuals {r['plane']}, peak device memory {peak_mb:.0f} MiB")
    print(f"  median ms per slam_step {1e3 * statistics.median(r['t_step']):.3f} "
          f"(frames 1..{n - 1}, which run the fallback solve: "
          f"{1e3 * statistics.median(r['t_step'][1:]):.3f}); each stage synchronized:")
    print_stage_rows(sorted(stage.items(), key=lambda kv: -sum(kv[1])))
    print(f"  host syncs {rs['syncs']} in {n} frames = {rs['syncs'] / n:.2f} per "
          f"frame; by call site:")
    print_sync_sites(rs["sync_sites"])
    check(all(f[0] for f in r["frames"]), "fallback: a frame did not skip")
    check(all(r["ground_ok"]), "fallback: ground extraction failed on a frame")
    check(bool(torch.isfinite(r["t"]).all() and torch.isfinite(r["q"]).all()),
          "fallback: non-finite pose")
    check(end_err < 0.35, f"fallback lost track: end position error {end_err:.3f} m")
    check(map_err < 0.35, f"fallback: scan-to-map pose ends {map_err:.3f} m off")
    check(bool(torch.isfinite(r["map_t"]).all()), "fallback: non-finite map pose")


def profile_phase(dev) -> None:
    cfg = slice_config(config.SlamConfig())
    traj = loop_trajectory()
    xyz, inten = synthetic.render_sequence(
        se3.Pose(traj.q.to(dev), traj.t.to(dev)),
        synthetic.corridor_world(device=dev), cfg.sensor)
    run_system(cfg, xyz, inten, dev)              # warm-up, as in slice_phase
    with stage_timers(SYSTEM_STAGES) as stage:
        r = run_system(cfg, xyz, inten, dev)
    print(f"stage times, full-width slice ({len(r['frames'])} frames, "
          f"{len(r['kfs'])} keyframes; each stage synchronized, stages nest):")
    print_stage_rows([("process", r["t_step"])]
                     + sorted(stage.items(), key=lambda kv: -sum(kv[1])))

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_system(cfg, xyz, inten, dev)
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


KERNELS = (
    ("nn", "nn_packed_kernel"),
    ("pack", "pack_kernel"),
)


def kernel_records(kern: dict, launches: dict) -> dict:
    return {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "intensity_slam_tpu_torch/csrc/nn.cu",
        "replaces": "intensity_slam_tpu/ops/pallas_nn.py:103",
        "launches": launches[key],
        **kern[key],
        "passed": True,
    } for key, name in KERNELS]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    only = args[args.index("--phase") + 1] if "--phase" in args else None
    dev = torch.device("cuda", 0)
    print(gpu_name_and_power())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = pallas_nn.build(verbose=True)
    print(f"nn kernels build: {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if ("registers" in line or "smem" in line.lower() or "error" in line.lower()
                or "Compiling entry" in line):
            print("  nvcc:", line.strip())
    if "--profile" in args:
        profile_phase(dev)
        return 0
    cfg = slice_config(config.SlamConfig())
    if only is not None:
        # one phase alone (after the build): prints that phase's lines only
        phases = {"kernel": lambda: kernel_phase(dev, cfg),
                  "grid": lambda: grid_phase(dev),
                  "small": lambda: small_phase(dev),
                  "fallback": lambda: fallback_phase(dev),
                  "slice": lambda: slice_phase(dev)}
        phases[only]()
        return 0
    kern = kernel_phase(dev, cfg)
    grid_phase(dev)
    small_phase(dev)
    fallback_phase(dev)
    sl = slice_phase(dev)
    print(json.dumps(kernel_records(kern, sl["launches"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
