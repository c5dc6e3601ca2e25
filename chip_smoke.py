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
   end lies within 0.5 m of the rendered end;
7. stream-small: `StreamingRunner` at small_test_config over a 12-frame
   corridor scan log (the same ground-RANSAC draws handed to every run):
   the CPU and the card take the same keyframes, skips and loops, `run` and
   `run_preloaded` give the same stats on the card, the wire decode is
   bit-equal between CPU and card, and the dispatch thread's host syncs
   equal, call site by call site, those of `fused_step` (through
   `SlamSystem.process`) on the same decoded frames;
8. checkpoint: `SlamSystem.save` after 6 of 12 frames at small_test_config,
   `load` into a fresh system and continue: on the card against the
   uninterrupted card run, and from a file the CPU wrote against the
   uninterrupted CPU run; the same decisions, log ids and skips;
9. geoslam: `geometric_slam.run_sequence` (A-LOAM odometry + laser
   mapping on unorganized scans) at full width over a 16-frame corridor
   rendered on the card and permuted per frame: ATE and end error under a
   quarter of the motion (tests/test_geometric_slam.py's bound), ms per step;
10. stream: bench.py's 420-frame circuit (os0_64_config, circuit_world with
   its textureless span, circuit_trajectory at 0.4 m a frame) rendered on
   the card into a ~440 MB scan log in a temporary directory (deleted at
   the end) and run once through `StreamingRunner(...).run(log)` in wire
   mode.  Checked: 420 frames, an accepted loop from the second lap to the
   first, 420 live TUM rows, no dropped pose write, a finite 420-row
   `trajectory()` within 1.5 m ATE RMSE of the rendered poses, both kernels
   launched, and no host sync of the dispatch thread outside `fused_step`'s
   modules.  Printed: keyframes, skips, loops, ms per frame, scans/s, the
   syncs by call site, peak memory, kernel launches;
11. refine: the distributed back-end (`parallel/`) at full width, on the
   circuit's keyframe store left by the stream phase (K = 1024 keyframe
   slots x F = 1024 features: 1 048 576 BA observation and landmark slots, a
   6144-dim dense PGO): (a) `dist_backend.refine` with `mesh=None` and over
   a one-rank NCCL process group on the card (`shard_backend_state` first),
   poses within 1e-3 m of each other, the BA's median landmark within 1e-3 m
   (`LANDMARK_MEDIAN_TOL_M`) and its final cost within 1e-3 relative, the BA
   cost not raised, BA observations found, no kernel launched inside
   `refine`; printed: the refined trajectory's ATE beside the online one,
   host ms per stage and for the whole `refine`, peak memory, host syncs by
   call site; (b) the slice's out-and-back at full width in the
   deferred-solve mode (`online_pgo=False`) through `SlamSystem(cfg,
   mesh=...)` with `refine_every_kf` = 4, so that `process` itself refines
   once, then one explicit `refine()`: a finite adopted trajectory, ATE
   before and after; (c) tests/test_dist_backend.py's online-refine test
   (small config, sensor noise, 88 frames) on the CPU and on the card: the
   same keyframes and loop decisions, the card's refine of its store within
   1e-3 m of the CPU's refine of a copy (the BA's median landmark within
   2e-2 m, its final cost within 1e-3 relative), the end error after the
   refine under 1 m on both, and on the (deterministic) CPU run the refine
   cutting the ATE below 0.9 of what it was; the card's ATE before and after
   is printed. Kernel launches are counted over (b) and over (c)'s card run,
   each from 0. The NCCL group is destroyed at the end;
12. tools: the user-facing and accuracy tools at full width, called
   in-process: the README's quick start `tools/torch_replay.py --frames 40
   --check-ate` (the `slam` pipeline) and the same 40 frames through
   `--pipeline odometry`, both within their ATE bound, skips and keyframes
   printed; `tools/torch_bag2islog.py`'s `convert` of a bag of three
   full-width scans, read back through `ScanLog` bit-equal;
   `tools/torch_loop_eval.py`'s `run_one` on the aliased corridor
   (os0_64_config, every loop channel, sensor noise seed 0, 320 frames),
   which must close at least one correct loop (its precision printed).
   Kernel launches are counted over the whole phase (`tools`);
13. measure: the measurement and scale-out tools at full width, each
   through its `main(argv)` on the card with its JSON in a temporary
   directory: `torch_bench_full --frames 32` (front end, back end,
   `StreamingRunner.run` and `run_preloaded` apart; the streaming and the
   preloaded keyframes must be equal), `torch_stream_probe --frames 32`
   (writer on, writer off and a bare `fused_step` loop must end with equal
   keyframes and equal final positions; 32 frames, cut from 64 to keep the
   phase under 150 s), `torch_slope_probe --frames 48`
   (the frame classes must sum to 47), `torch_profile_stages --reps 5`
   (every one of the ten stages must show device time and a kernel count),
   `torch_scaling_bench --devices 1` (BA solve time against size),
   `torch_scaling_projection --reps 2` and `torch_multiproc_product` (one
   NCCL rank, product scale: 1024 nodes and 200 loop edges, the PGO and
   the refine within 1e-3 m of the dense and the local solves, the ATE
   lowered).  Times are printed, not held.  Kernel launches are counted
   over the whole phase (`measure`): at this depth no tool reaches a loop
   candidate (a 32-frame corridor, the circuit's first lap), so the NN
   kernels launch 0 times there; the kernel phase holds them and the slice,
   stream, refine and tools paths launch them;
14. multisession: the batched step (`slam.slam_step_batched`) at full
   width (os0_64_config, 64x1024): B = 8 circuit streams of 24 frames,
   stream b starting at frame b of one 31-frame render, stream 3 at
   constant intensity (its intensity odometry skips every frame, so the
   geometric fallback's sub-batch runs on the card).  Every session is held
   against an unbatched `slam_step` run of its stream with the same draws
   (its generator's seed): `skip`, `is_keyframe`, `num_good`, `ground_ok`
   and the host flags equal on every frame, the odometry pose within 1e-4
   m and the scan-to-map pose within 0.1 m (the largest differences
   printed).  The batch sums some products in another order than one
   session does (a batched matrix product, reduction or factorization
   against a single one), and the scan-to-map solve amplifies a rounding
   difference as it does an input's (ROADMAP C.7: one float32 rounding
   step of the input moves it 0.16-0.40 m over a longer run).  Then 8 copies of stream 0 from
   one seed against one (B = 1) and against the unbatched step, 6 frames:
   host syncs by call site equal at B = 1, at B = 8 and unbatched at every
   site but the solver's loop test, and there one a loop test (a batched
   solve tests as long as its slowest session; rounding decides a solve's
   last iterations, so the counts of iterations may differ between the
   three); the device kernels of the sixth step printed by name, B = 8
   against B = 1, and held under 1.5 times B = 1's (a loop over the
   sessions would launch 8 times as many).  Printed, not
   held: ms per step and total scans/s at B = 1 and 8, peak memory.  Then
   `tools/torch_scaling_multisession.py --batches 1,8 --frames 12 --warm 4`.
   Kernel launches are counted over the B = 8 run (`multisession`): the
   step reaches no loop candidate, so the NN kernels launch 0 times.

Every frame runs `fused.fused_step`: `slam_step` (intensity odometry,
curvature features, geometric fallback on a skipped frame, mux, ground
RANSAC, scan-to-map), on a keyframe `loop.keyframe_core` with the
scan-to-map pose, at an accepted loop the correction feedback and the map
rebuild, and the ring-log append.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --phase NAME

with NAME one of kernel, grid, small, fallback, slice, stream-small,
checkpoint, geoslam, stream, refine, tools, measure, multisession

builds the kernels and runs that one phase alone (no result lines; refine
runs the stream phase first, for its keyframe store).

    python3 chip_smoke.py --profile

builds the kernels and profiles the full-width slice instead: host-clock
time per stage (each stage synchronized), then a `torch.profiler` trace of
the whole sequence with the device's busy share and its top kernels.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import bz2
import importlib
import json
import math
import os
import shutil
import socket
import statistics
import struct
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.ops import grid_hash, pallas_nn, projection, solver, voxel
from intensity_slam_tpu_torch.parallel import ba_builder, dist_ba, dist_backend, multiproc
from intensity_slam_tpu_torch.pipeline import (fused, geometric_slam, loop, mapping,
                                               odometry, slam)
from intensity_slam_tpu_torch.pipeline.system import SlamSystem
from intensity_slam_tpu_torch.runtime import ScanLog, ScanLogWriter, stream
from intensity_slam_tpu_torch.utils import device as devices
from intensity_slam_tpu_torch.utils import se3

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = devices.H100_SXM
NN_FLOPS_PER_PAIR = 8          # 3 subtracts, 3 multiplies, 2 adds
P_ICP, M_ICP = 2048, 6144      # keyframe_cloud_size, (2*submap_window+1)*2048


class SmokeFailure(RuntimeError):
    """A phase of the smoke run failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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


# host syncs by call site for the length of a block (a Counter)
sync_counter = devices.count_syncs


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


def kernel_device_us(fn, name: str, n: int = 33, traces: int = 3) -> float:
    """Median device-side duration in microseconds of the kernel `name`
    over `n` calls of `fn`, from a `torch.profiler` trace that saw all `n`
    launches.  CUPTI now and then drops a launch from a trace (32 of 33
    seen), so up to `traces` traces are taken."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type.name == "CUDA" and name in e.name]
        if len(durs) >= n:
            return statistics.median(durs)
        seen.append(len(durs))
    raise SmokeFailure(f"the profiler saw {seen} launches of {name} in {traces} traces of {n}")


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


# ---- slice 5: the streaming runtime, checkpoints, the A-LOAM path ---------

CIRCUIT_FRAMES = 420           # bench.py:62-105, tools/replay.py --benchmark
RUNTIME_FILES = ("stream.py", "scanlog.py", "channel.py", "traj.py", "spill.py",
                 "system.py", "fused.py", os.path.basename(__file__))


def write_log(path: str, poses: se3.Pose, world, cfg, ground_truth=True) -> None:
    """Render each pose with the port's renderer on the poses' device, one
    frame at a time, into a scan log 0.1 s apart (with the rendered poses
    as ground truth)."""
    sc = cfg.sensor
    with ScanLogWriter(path, sc.image_height, sc.image_width,
                       ground_truth=ground_truth) as w:
        for k in range(poses.q.shape[0]):
            pose = se3.Pose(poses.q[k], poses.t[k])
            xyz, inten = synthetic.render_scan(pose, world, sc,
                                               frame_time=k * sc.scan_period)
            w.append(0.1 * k, xyz.cpu().numpy(), inten.cpu().numpy(),
                     pose.q.cpu().numpy(), pose.t.cpu().numpy())


def run_stream(runner, log, count_syncs=False, preloaded=False, **kw) -> dict:
    """`runner.run(log, ...)` (or `run_preloaded` with `preloaded=True`),
    with the host clock read and the sync counts copied as each frame's
    dispatch ends (`on_frame`), so that the counts cover the dispatch loop
    and not the stats read after it.  Nothing is read from the device in
    the loop; the frames' scalars are read after the run."""
    stamps, infos, at_last = [], [], collections.Counter()

    with sync_counter(count_syncs) as sites:
        def on_frame(idx, info):
            stamps.append(time.perf_counter())
            infos.append(info)
            at_last.clear()
            at_last.update(sites)

        t0 = time.perf_counter()
        go = runner.run_preloaded if preloaded else runner.run
        stats = go(log, on_frame=on_frame, **kw)
        wall = time.perf_counter() - t0
    t_frame = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    frames = [(bool(i.skip), bool(i.is_keyframe)) for i in infos]
    kfs = [dict(kf=int(i.num_kf) - 1, frame=k,
                candidate=math.isfinite(float(i.icp_fitness)),
                accepted=bool(i.loop_found), loop_idx=int(i.loop_idx),
                fitness=float(i.icp_fitness))
           for k, i in enumerate(infos) if frames[k][1]]
    return dict(stats=stats, frames=frames, kfs=kfs, t_frame=t_frame, wall=wall,
                sync_sites=at_last, all_sync_sites=sites)


def dispatch_sites(sites: collections.Counter) -> collections.Counter:
    """The sync sites of the caller's (dispatch) thread."""
    return collections.Counter({k: v for k, v in sites.items() if not k.startswith("[")})


def stream_phase(dev) -> dict:
    """bench.py's 420-frame circuit at full width through
    `StreamingRunner.run` in wire mode, from a scan log the port rendered on
    the card."""
    cfg = config.os0_64_config()
    n = CIRCUIT_FRAMES
    traj = synthetic.circuit_trajectory(n, speed=0.4, device=dev)
    world = synthetic.circuit_world(device=dev)
    tmp = tempfile.mkdtemp(prefix="islam_circuit.")
    try:
        path, tum = os.path.join(tmp, "circuit.islog"), os.path.join(tmp, "live.tum")
        t0 = time.perf_counter()
        write_log(path, traj, world, cfg)
        t_write = time.perf_counter() - t0
        with ScanLog(path) as log:
            print(f"stream: rendered and wrote the {n}-frame circuit "
                  f"({len(world.box_centers)} boxes, {len(world.flat_centers)} "
                  f"textureless zone) on the card in {t_write:.1f} s, "
                  f"{os.path.getsize(path)} bytes")
            # warm-up: the first 12 frames through a runner of their own
            stream.StreamingRunner(cfg, device=dev).run(log, end=12)
            runner = stream.StreamingRunner(cfg, traj_path=tum, device=dev)
            _sync_untracked(dev)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            r = run_stream(runner, log, count_syncs=True)
            launches = read_launches()
            peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            gt = torch.from_numpy(np.stack([log[k].gt_t for k in range(n)]))
            overhead = runner_against_process(cfg, log, dev, tmp)
        with open(tum) as f:
            tum_rows = [line.split() for line in f if line.strip()]
        est = torch.from_numpy(runner.trajectory())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gt = gt - gt[0]                              # the first pose has no rotation
    odo = runner.state.log.ot[:n].cpu()
    ate = lambda e: float(torch.sqrt(torch.mean(torch.sum((e - gt) ** 2, -1))))
    stats, kfs = r["stats"], r["kfs"]
    kf_frame = {k["kf"]: k["frame"] for k in kfs}
    acc = [k for k in kfs if k["accepted"]]
    cands = [k for k in kfs if k["candidate"]]
    d0 = torch.linalg.norm(gt[:, :2], dim=-1)
    lap = next((k for k in range(100, n) if d0[k] < 1.0), n)   # back at the start
    last_to_first = [a for a in acc if a["frame"] >= lap
                     and kf_frame.get(a["loop_idx"], n) < 100]
    kf_frames = set(kf_frame.values())
    t_kf = [t for k, t in enumerate(r["t_frame"]) if k in kf_frames]
    t_other = [t for k, t in enumerate(r["t_frame"]) if k not in kf_frames]
    disp = dispatch_sites(r["sync_sites"])
    others = {k: v for k, v in r["sync_sites"].items() if k.startswith("[")}
    in_runtime = {k: v for k, v in disp.items() if k.split(":")[0] in RUNTIME_FILES}
    print(f"stream (full width, os0_64_config, StreamingRunner.run, wire mode): "
          f"stats {stats}; keyframes {len(kfs)}, skips at frames "
          f"{[k for k, f in enumerate(r['frames']) if f[0]]}, accepted loops {len(acc)}")
    for k in cands:
        print(f"  candidate: keyframe {k['kf']} (frame {k['frame']}) -> keyframe "
              f"{k['loop_idx']} (frame {kf_frame.get(k['loop_idx'])}), icp fitness "
              f"{k['fitness']:.6g}, {'accepted' if k['accepted'] else 'rejected'}, "
              f"{1e3 * r['t_frame'][k['frame']]:.3f} ms")
    print(f"  loop table {runner.loops}; the second lap starts at frame {lap}; "
          f"nn kernel launches {launches['nn']}, pack kernel launches {launches['pack']}")
    print(f"  trajectory(): {tuple(est.shape)} rows, ATE RMSE {ate(est):.4f} m against "
          f"the rendered poses (the merged odometry alone {ate(odo):.4f} m), end "
          f"error {float(torch.linalg.norm(est[-1] - gt[-1])):.4f} m; live TUM rows "
          f"{len(tum_rows)}, dropped pose writes {stats['dropped_pose_writes']}")
    print(f"  ms per frame (host clock between frame dispatches): median "
          f"{1e3 * statistics.median(r['t_frame']):.3f}, non-keyframes "
          f"{1e3 * statistics.median(t_other):.3f}, keyframes "
          f"{1e3 * statistics.median(t_kf):.3f}, max {1e3 * max(r['t_frame']):.3f} at "
          f"frame {r['t_frame'].index(max(r['t_frame']))}; loop frames "
          f"{[(a['frame'], round(1e3 * r['t_frame'][a['frame']], 3)) for a in acc]}")
    print(f"  end to end {n / r['wall']:.3f} scans/s ({r['wall']:.2f} s for {n} frames, "
          f"sync counter on); upload slot waits {runner.upload_waits}; peak device "
          f"memory {peak_mb:.0f} MiB; {devices.describe('cuda')}")
    print(f"  the runner against SlamSystem.process on the circuit's first 40 frames "
          f"(median ms per frame after the first, in run order): "
          f"{[(k, round(v, 3)) for k, v in overhead]}")
    print(f"  dispatch-thread host syncs {sum(disp.values())} in {n} frames = "
          f"{sum(disp.values()) / n:.2f} per frame; by call site:")
    print_sync_sites(disp)
    print(f"  syncs on other threads: {dict(others)}")
    check(stats["frames"] == n, f"stream ran {stats['frames']} frames")
    check(len(tum_rows) == n, f"the live TUM file has {len(tum_rows)} rows")
    check(stats["dropped_pose_writes"] == 0, "pose writes were dropped")
    check(est.shape == (n, 3) and bool(torch.isfinite(est).all()),
          "trajectory() is not 420 finite rows")
    check(len(last_to_first) >= 1, f"no accepted loop from the second lap to the "
          f"first: {[(a['frame'], a['loop_idx']) for a in acc]}")
    check(launches["nn"] >= 1 and launches["pack"] >= 1,
          f"the stream run did not launch both kernels: {launches}")
    check(not in_runtime, f"the dispatch thread synced outside fused_step: {in_runtime}")
    check(ate(est) < 1.5, f"ATE RMSE {ate(est):.3f} m over the circuit")
    return dict(launches=launches, runner=runner, gt=gt, cfg=cfg, ate=ate(est))


def runner_against_process(cfg, log, dev, tmp, frames=40) -> list:
    """The runner's cost per frame: `StreamingRunner.run` over the log's
    first `frames` frames against `SlamSystem.process` on the same frames
    decoded beforehand, in the order runner, process, process, runner.
    Median host ms per frame after the first (no per-frame synchronize in
    either; the step's own syncs keep the host in step with the card)."""
    words = [torch.from_numpy(wf.packed.view(np.int16))
             for wf in log.stream_wire(0, frames, 2, 120.0)]
    out = []
    for kind in ("runner", "process", "process", "runner"):
        if kind == "runner":
            runner = stream.StreamingRunner(cfg, traj_path=os.path.join(tmp, "ab.tum"),
                                            device=dev)
            t = run_stream(runner, log, end=frames)["t_frame"]
        else:
            system = SlamSystem(cfg, device=dev)
            dirs = torch.from_numpy(stream._build_dir_lut(log)).to(dev)
            decoded = [stream.wire_decode(w.to(dev), dirs) for w in words]
            _sync_untracked(dev)
            t = []
            for xyz, inten, ts in decoded:
                t0 = time.perf_counter()
                system.process(xyz, inten, ts)
                t.append(time.perf_counter() - t0)
            del decoded
        _sync_untracked(dev)
        out.append((kind, 1e3 * statistics.median(t[1:])))
    return out


def stream_small_phase(dev) -> None:
    """`StreamingRunner` at small_test_config on a 12-frame corridor log:
    CPU against card, `run` against `run_preloaded`, the wire decode, and
    the dispatch thread's syncs against `fused_step`'s on the same frames."""
    cfg = config.small_test_config()
    n = 12
    traj = synthetic.corridor_trajectory(n, speed=0.35, yaw_rate=0.02, device="cpu")
    gu = torch.rand((n, cfg.ground.ransac_iters, 3),
                    generator=torch.Generator().manual_seed(0))
    gu_dev = gu.to(dev)
    tmp = tempfile.mkdtemp(prefix="islam_small.")
    try:
        path = os.path.join(tmp, "corridor.islog")
        write_log(path, traj, synthetic.corridor_world(device="cpu"), cfg)
        with ScanLog(path) as log:
            runs = {}
            for name, device, kw in (("cpu", "cpu", {}), ("card", dev, {}),
                                     ("card_preloaded", dev, {"preloaded": True})):
                runner = stream.StreamingRunner(
                    cfg, traj_path=os.path.join(tmp, f"{name}.tum"), device=device)
                runs[name] = (runner, run_stream(runner, log, ground_u=gu_dev
                                                 if device != "cpu" else gu, **kw))
            counted = stream.StreamingRunner(cfg, traj_path=os.path.join(tmp, "n.tum"),
                                             device=dev)
            rc = run_stream(counted, log, count_syncs=True, ground_u=gu_dev)
            words = [torch.from_numpy(wf.packed.view(np.int16))
                     for wf in log.stream_wire(0, n, 2, 120.0)]
            raw = np.stack([wf.packed for wf in log.stream_wire(0, n, 2, 120.0)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cpu_r, card_r = runs["cpu"][1], runs["card"][1]
    (cpu, _), (card, _), (pre, pre_r) = runs["cpu"], runs["card"], runs["card_preloaded"]
    decide = lambda rr: (rr["stats"], rr["frames"],
                         [(k["frame"], k["accepted"], k["loop_idx"]) for k in rr["kfs"]])
    same_dev = decide(cpu_r) == decide(card_r) and cpu.loops == card.loops
    same_pre = decide(pre_r) == decide(card_r) and pre.loops == card.loops
    dtraj = float(np.abs(cpu.trajectory() - card.trajectory()).max())
    dpre = float(np.abs(pre.trajectory() - card.trajectory()).max())
    # the wire decode: the same words on the CPU and on the card
    bit_equal = True
    for w in words:
        a = stream.wire_decode(w, cpu._dirs)
        b = stream.wire_decode(w.to(dev), card._dirs)
        bit_equal &= all(x.numpy().tobytes() == y.cpu().numpy().tobytes()
                         for x, y in zip(a, b))
    # torch's uint16 on the card (the port widens int16 words instead)
    try:
        u16 = torch.from_numpy(raw).to(dev).to(torch.int32)
        u16_note = (f"supported, equal to the int16 route "
                    f"{torch.equal(u16, torch.stack(words).to(dev).to(torch.int32) & 0xFFFF)}")
    except (RuntimeError, TypeError) as e:
        u16_note = f"not supported ({type(e).__name__}: {str(e).splitlines()[0][:80]})"
    # fused_step on the same decoded frames, through SlamSystem.process
    system = SlamSystem(cfg, device=dev)
    decoded = [stream.wire_decode(w.to(dev), card._dirs) for w in words]
    _sync_untracked(dev)
    t_direct = []
    with sync_counter(True) as direct:
        for k, (xyz, inten, ts) in enumerate(decoded):
            t0 = time.perf_counter()
            system.process(xyz, inten, ts, ground_u=gu_dev[k])
            t_direct.append(time.perf_counter() - t0)
    disp = dispatch_sites(rc["sync_sites"])
    print(f"stream small: CPU {cpu_r['stats']}, card {card_r['stats']}, same "
          f"keyframes, skips and loops {same_dev} (max |trajectory| diff "
          f"{dtraj:.3g} m); run_preloaded on the card {pre_r['stats']}, same as run "
          f"{same_pre} (max |trajectory| diff {dpre:.3g} m)")
    print(f"  wire decode CPU = card bit for bit {bit_equal}; uint16 tensor to the "
          f"card and widened there: {u16_note}")
    print(f"  dispatch-thread syncs {sum(disp.values())} against fused_step's "
          f"{sum(direct.values())} on the same frames; equal by call site "
          f"{disp == direct}; other threads "
          f"{ {k: v for k, v in rc['sync_sites'].items() if k.startswith('[')} }")
    print(f"  median ms per frame after the first, host clock, both with the sync "
          f"counter on: the runner {1e3 * statistics.median(rc['t_frame'][1:]):.3f} "
          f"(log read, upload, decode, step, pose writer), SlamSystem.process on "
          f"the decoded frames {1e3 * statistics.median(t_direct[1:]):.3f}")
    check(same_dev, "stream small: the card took other decisions than the CPU")
    check(same_pre, "stream small: run_preloaded differs from run on the card")
    check(bit_equal, "stream small: the wire decode differs between CPU and card")
    check(disp == direct, f"stream small: the dispatch thread's syncs {dict(disp)} are "
          f"not fused_step's {dict(direct)}")
    # scan-to-map amplifies CPU/card rounding at this config (ROADMAP §C, the
    # plane fit's conditioning: 0.064 m in the small phase, 0.112 m here)
    check(dtraj < 0.25, f"stream small: CPU and card trajectories {dtraj:.3f} m apart")


def checkpoint_phase(dev) -> None:
    """`SlamSystem.save` after 6 of 12 frames, `load` into a fresh system,
    continue: on the card against the uninterrupted card run (the ground
    RANSAC drawing from the restored generator), and from a file the CPU
    wrote against the uninterrupted CPU run (the same draws handed to both)."""
    cfg = config.small_test_config()
    n, cut = 12, 6
    traj = synthetic.corridor_trajectory(n, speed=0.35, yaw_rate=0.02, device="cpu")
    xyz, inten = synthetic.render_sequence(traj, synthetic.corridor_world(device="cpu"),
                                           cfg.sensor)
    gu = torch.rand((n, cfg.ground.ransac_iters, 3),
                    generator=torch.Generator().manual_seed(1))

    def drive(system, frames, draws):
        d = system.device
        return [system.process(xyz[k].to(d), inten[k].to(d), 0.1 * k,
                               ground_u=None if draws is None else draws[k].to(d))
                for k in frames]

    def flags(infos):
        return [(bool(i.skip), bool(i.is_keyframe), int(i.num_kf), bool(i.loop_found))
                for i in infos]

    def log_of(system):
        lg = system.state.log
        return (lg.kf.cpu(), lg.skip.cpu(), int(lg.count), int(lg.num_skips)), lg.t.cpu()

    tmp = tempfile.mkdtemp(prefix="islam_ckpt.")
    results = []
    try:
        for name, first, then, draws in (("card -> card", dev, dev, None),
                                         ("cpu -> card", "cpu", dev, gu)):
            ref = SlamSystem(cfg, device=first)
            drive(ref, range(cut), draws)
            prefix = os.path.join(tmp, name.split()[0])
            ref.save(prefix)
            want = flags(drive(ref, range(cut, n), draws))
            resumed = SlamSystem(cfg, device=then)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                resumed.load(prefix)
            got = flags(drive(resumed, range(cut, n), draws))
            (d_ref, t_ref), (d_got, t_got) = log_of(ref), log_of(resumed)
            same_log = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                           for a, b in zip(d_ref, d_got))
            dt = float((t_ref - t_got).abs().max())
            dtraj = float(np.abs(ref.trajectory() - resumed.trajectory()).max())
            print(f"checkpoint {name}: resumed at frame {cut} of {n}; same decisions "
                  f"{got == want} (keyframes {want[-1][2]}), same log ids and skips "
                  f"{same_log}, max |log t| diff {dt:.3g} m, max |trajectory| diff "
                  f"{dtraj:.3g} m; load warnings {len(caught)}")
            results.append((name, got == want and same_log, dt))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, same, dt in results:
        check(same, f"checkpoint {name}: the resumed run took other decisions")
        check(dt < 0.1, f"checkpoint {name}: the resumed log is {dt:.3f} m off")


def geoslam_phase(dev) -> None:
    """`geometric_slam.run_sequence` at full width (SlamConfig() defaults,
    64x1024) over a 16-frame corridor rendered on the card and permuted per
    frame (tests/test_geometric_slam.py:25-45), held to that test's bound."""
    cfg = config.SlamConfig()
    T = 16
    traj = synthetic.corridor_trajectory(T, speed=0.3, yaw_rate=0.01, device=dev)
    xyz, inten = synthetic.render_sequence(traj, synthetic.corridor_world(device=dev),
                                           cfg.sensor)
    g = torch.Generator(device=dev).manual_seed(0)
    perms = torch.stack([torch.randperm(xyz.shape[1], generator=g, device=dev)
                         for _ in range(T)])
    xyz_u = torch.gather(xyz, 1, perms[..., None].expand(-1, -1, 3))
    inten_u = torch.gather(inten, 1, perms)
    gt = (traj.t - traj.t[0]).cpu()             # the first pose has no rotation
    with sync_counter(True) as sites:           # also the warm-up
        geometric_slam.run_sequence(xyz_u, inten_u, cfg)
    _sync_untracked(dev)
    t0 = time.perf_counter()
    outs = geometric_slam.run_sequence(xyz_u, inten_u, cfg)
    _sync_untracked(dev)
    wall = time.perf_counter() - t0
    with stage_timers([(geometric_slam, "geo_slam_step"),
                       (geometric_slam.geometric, "geometric_delta"),
                       (geometric_slam.laser_mapping, "laser_mapping_step"),
                       (geometric_slam.curvature, "extract_features")]) as stage:
        geometric_slam.run_sequence(xyz_u, inten_u, cfg)
    est = outs.pose.t.cpu()
    odo = outs.odom_pose.t.cpu()
    err = torch.linalg.norm(est - gt, dim=-1)
    ate = float(torch.sqrt(torch.mean(err ** 2)))
    motion = float(torch.linalg.norm(gt[-1] - gt[0]))
    surf = [int(v) for v in outs.num_surf_residuals]
    print(f"geoslam (full width, {T} unorganized frames): ATE {ate:.4f} m, end error "
          f"{float(err[-1]):.4f} m, odometry end error "
          f"{float(torch.linalg.norm(odo[-1] - gt[-1])):.4f} m, over {motion:.2f} m of "
          f"motion (bound: 0.25 x motion = {0.25 * motion:.3f} m); converged "
          f"{[bool(c) for c in outs.converged]}; surf residuals {surf}; corner "
          f"residuals {[int(v) for v in outs.num_corner_residuals]}")
    print(f"  ms per geo_slam_step {1e3 * wall / T:.3f} (run_sequence, unsynchronized); "
          f"host syncs {sum(sites.values()) / T:.2f} per step; each stage synchronized:")
    print_stage_rows(sorted(stage.items(), key=lambda kv: -sum(kv[1])))
    print_sync_sites(sites)
    check(bool(torch.isfinite(est).all()), "geoslam: non-finite pose")
    check(surf[-1] > 10, "geoslam: the mapping back-end did not engage")
    check(motion > 2.0 and ate < 0.25 * motion, f"geoslam: ATE {ate:.3f} m")
    check(float(err[-1]) < 0.25 * motion, f"geoslam: end error {float(err[-1]):.3f} m")


# ---- slice 6: the distributed back-end (parallel/) and SlamSystem.refine ---

REFINE_STAGES = [(dist_backend.posegraph, "consistent_loop_mask"),
                 (dist_backend.posegraph, "optimize"),
                 (dist_backend.dist_pgo, "optimize_shmap"),
                 (dist_backend.ba_builder, "build_problem"),
                 (dist_backend.dist_ba, "ba_solve")]


@contextlib.contextmanager
def nccl_mesh(dev):
    """A one-rank NCCL process group on the card (the port's mesh of one
    device) for the length of the block."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(dev)
    mesh = multiproc.initialize(0, 1, f"127.0.0.1:{port}", "nccl", timeout_s=120)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def ate_of(est, gt: torch.Tensor) -> float:
    """ATE RMSE of positions `est` against `gt` over their common frames."""
    n = min(len(est), len(gt))
    d = torch.as_tensor(est[:n]).cpu() - gt[:n]
    return float(torch.sqrt(torch.mean(torch.sum(d * d, -1))))


def timed(dev, fn):
    """(result, host seconds) of `fn()`, synchronized at both ends."""
    _sync_untracked(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync_untracked(dev)
    return out, time.perf_counter() - t0


def small_refine_config() -> config.SlamConfig:
    """tests/test_dist_backend.py::test_online_refine_improves_live_trajectory's
    config: the deferred-solve mode with 1024-point keyframe clouds and a
    widened drift envelope."""
    base = config.small_test_config()
    return base.replace(
        loop=dataclasses.replace(base.loop, sc_num_exclude_recent=4, min_loop_search_gap=4,
                                 max_keyframes=64, keyframe_cloud_size=1024, online_pgo=False,
                                 loop_drift_rate=0.08, loop_drift_rot_rate=0.01),
        odometry=dataclasses.replace(base.odometry, keyframe_time_interval=0.15))


def refine_phase(dev, circuit: dict) -> dict:
    """`dist_backend.refine` at full width on the circuit's keyframe store
    (no mesh, then over a one-rank NCCL group), the online trigger through
    `SlamSystem(cfg, mesh=...)`, and the reference's online-refine test at
    the small config on the CPU and on the card."""
    cfg, runner, gt = circuit["cfg"], circuit["runner"], circuit["gt"]
    state = runner.state
    bstate = state.backend
    n_kf = int(bstate.num_kf)
    K, F = bstate.kf_feat_valid.shape
    reset_launches()
    with nccl_mesh(dev) as mesh:
        # (a) the circuit's store: stages timed, whole refine timed, syncs
        _sync_untracked(dev)
        torch.cuda.reset_peak_memory_stats()
        held_mb = torch.cuda.memory_allocated() / 2 ** 20
        with stage_timers(REFINE_STAGES) as stage:
            res, t_staged = timed(dev, lambda: dist_backend.refine(bstate, cfg))
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        inside = read_launches()
        res, t_refine = timed(dev, lambda: dist_backend.refine(bstate, cfg))
        with sync_counter(True) as sites:
            dist_backend.refine(bstate, cfg)
        sharded, t_shard = timed(dev, lambda: dist_backend.shard_backend_state(bstate, mesh))
        res_m, t_mesh = timed(dev, lambda: dist_backend.refine(sharded, cfg, mesh=mesh))
        res_m, t_mesh2 = timed(dev, lambda: dist_backend.refine(sharded, cfg, mesh=mesh))
        with sync_counter(True) as mesh_sites:
            dist_backend.refine(sharded, cfg, mesh=mesh)
        pose = lambda r: r.state.graph.poses.t[:n_kf]
        dpose = float((pose(res_m) - pose(res)).abs().max())
        dlm, dlm_med, dcost = ba_agreement(res_m, res)
        adopted = fused.adopt_graph(state, res.state.graph.poses, cfg)
        est = fused.trajectory(adopted, cfg)[1][:CIRCUIT_FRAMES]
        costs = [float(c) for c in (res.ba_initial_cost, res.ba_final_cost,
                                    res_m.ba_initial_cost, res_m.ba_final_cost)]
        n_obs, n_obs_m = int(res.num_obs), int(res_m.num_obs)
        print(f"refine (a) (full width: K={K} keyframe slots x F={F} features = "
              f"{K * F} BA observation and landmark slots, the circuit's store: {n_kf} "
              f"keyframes, loops {runner.loops}): {n_obs} BA observations, "
              f"{int(res.landmark_valid.sum())} landmarks, BA cost {costs[0]:.6g} -> "
              f"{costs[1]:.6g}; over a one-rank NCCL group {n_obs_m} observations, cost "
              f"{costs[2]:.6g} -> {costs[3]:.6g}, max |pose t| diff against mesh=None "
              f"{dpose:.3g} m, |landmark| diff max {dlm:.3g} m, median {dlm_med:.3g} m, BA "
              f"final cost rel diff "
              f"{dcost:.3g}; refined trajectory ATE {ate_of(est, gt):.4f} m against the "
              f"rendered poses (online {circuit['ate']:.4f} m); {devices.describe('cuda')}")
        print(f"  host ms: refine {1e3 * t_refine:.3f} (mesh=None), {1e3 * t_mesh:.3f} "
              f"then {1e3 * t_mesh2:.3f} (NCCL group; the first call sets up the "
              f"communicator), shard_backend_state {1e3 * t_shard:.3f}; peak device "
              f"memory {peak_mb:.0f} MiB ({held_mb:.0f} MiB held before the refine); "
              f"kernel launches inside refine {inside}")
        print(f"  each stage synchronized (refine {1e3 * t_staged:.3f} ms in this run):")
        print_stage_rows(sorted(stage.items(), key=lambda kv: -sum(kv[1])))
        print(f"  host syncs of one refine {sum(sites.values())} (mesh=None), "
              f"{sum(mesh_sites.values())} (NCCL group); by call site (mesh=None, then "
              f"the group):")
        print_sync_sites(sites)
        print_sync_sites(mesh_sites)
        check(dpose < 1e-3, f"refine over the NCCL group is {dpose:.3g} m off mesh=None")
        check(dlm_med < LANDMARK_MEDIAN_TOL_M and dcost < 1e-3,
              f"BA over the NCCL group: landmarks {dlm_med:.3g} m (median), final cost "
              f"{dcost:.3g} (relative) off mesh=None")
        check(costs[1] <= costs[0] and costs[3] <= costs[2], f"BA cost rose: {costs}")
        check(n_obs > 0 and n_obs == n_obs_m, f"BA observations {n_obs}, {n_obs_m}")
        check(bool(torch.isfinite(pose(res_m)).all()), "non-finite refined pose")
        check(est.shape == (CIRCUIT_FRAMES, 3) and bool(torch.isfinite(est).all()),
              "the refined circuit trajectory is not finite")
        check(inside == dict(nn=0, pack=0), f"refine launched kernels: {inside}")
        del adopted, sharded, res, res_m
        online = online_refine_run(dev, mesh)
        small = small_refine_runs(dev, mesh)
    return dict(online=online, small=small)


# The BA's landmarks rest on float32 sums whose order differs between runs
# (atomic `index_add_` on the card), between one rank and none, and between
# card and CPU.  On the circuit's store two such solves agree on the final
# cost to ~1e-6 and on the median landmark to ~1e-5 m, while the farthest
# landmarks, which follow the poses along weakly observed directions, move
# by millimetres: the median is held, the largest difference printed.  On
# (c)'s noisy small store the order alone moves the median landmark by
# millimetres (part c prints this spread, the CPU's BA against itself with
# its observations permuted, beside the BA's own landmark step), hence the
# looser bound there.  A BA that fails to move the landmarks is off by its
# whole step, and its final cost by more than 1e-3.
LANDMARK_MEDIAN_TOL_M = 1e-3           # (a): one-rank group against mesh=None
LANDMARK_MEDIAN_TOL_CPU_M = 2e-2       # (c): the card against the CPU


def ba_order_spread(state, cfg) -> tuple[float, float]:
    """(median |landmark| difference in m between the BA of `state`'s
    problem and the BA of the same problem with its observations permuted,
    median |landmark| step of that BA from its initial landmarks)."""
    pc = cfg.parallel
    prob = ba_builder.build_problem(state, cfg)
    perm = torch.randperm(prob.obs_w.shape[0], generator=torch.Generator().manual_seed(0))
    perm = perm.to(prob.obs_w.device)
    shuffled = prob._replace(**{f: getattr(prob, f)[perm]
                                for f in ("obs_pose", "obs_lm", "obs_z", "obs_w")})
    a, b = (dist_ba.ba_solve(p, gn_iters=pc.ba_gn_iters, cg_iters=pc.ba_cg_iters)
            for p in (prob, shuffled))
    valid = dist_ba._segment_sum(prob.obs_w, prob.obs_lm.long(), prob.landmarks.shape[0]) >= 2.0
    med = lambda d: float(d[valid].abs().amax(-1).median())
    return med(a.landmarks - b.landmarks), med(a.landmarks - prob.landmarks)


def ba_agreement(a, b) -> tuple[float, float, float]:
    """(max and median |landmark| difference in m over the valid landmarks,
    relative difference of the BA final costs) between two
    `RefineResult`s; inf when they keep different landmarks."""
    if not torch.equal(a.landmark_valid.cpu(), b.landmark_valid.cpu()):
        return math.inf, math.inf, math.inf
    va = a.landmark_valid.cpu()
    d = (a.landmarks.cpu()[va] - b.landmarks.cpu()[va]).abs().amax(-1)
    fa, fb = float(a.ba_final_cost), float(b.ba_final_cost)
    return float(d.max()), float(d.median()), abs(fa - fb) / max(abs(fb), 1e-30)


def online_refine_run(dev, mesh) -> dict:
    """(b) The slice's out-and-back at full width in the deferred-solve mode
    through `SlamSystem(cfg, mesh=mesh)` with `refine_every_kf` = 4, so that
    `process` refines at frame 32; then one explicit `refine()`."""
    cfg = slice_config(config.SlamConfig())
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, online_pgo=False),
                      parallel=dataclasses.replace(cfg.parallel, refine_every_kf=4))
    traj = loop_trajectory()
    xyz, inten = synthetic.render_sequence(
        se3.Pose(traj.q.to(dev), traj.t.to(dev)), synthetic.corridor_world(device=dev),
        cfg.sensor)
    gt = traj.t - traj.t[0]
    system = SlamSystem(cfg, device=dev, mesh=mesh)
    keep = lambda r: (float(r.ba_initial_cost), float(r.ba_final_cost), int(r.num_obs))
    reset_launches()
    with captured(dist_backend, "refine", keep) as auto:
        infos = [system.process(xyz[k], inten[k], k * 0.1) for k in range(xyz.shape[0])]
    before = system.trajectory()
    _, t_refine = timed(dev, system.refine)
    launches = read_launches()
    after = system.trajectory()
    acc = [(int(i.num_kf) - 1, int(i.loop_idx)) for i in infos if bool(i.loop_found)]
    print(f"refine (b) (full width, the slice's out-and-back with online_pgo=False "
          f"through SlamSystem(cfg, mesh=<one-rank NCCL group>), refine_every_kf=4): "
          f"keyframes {system.num_keyframes}, accepted loops {acc}, refines inside "
          f"process {len(auto)} (BA cost, cost, observations: {auto}); trajectory ATE "
          f"{ate_of(before, gt):.4f} m before the explicit refine, "
          f"{ate_of(after, gt):.4f} m after it ({1e3 * t_refine:.3f} ms, adoption "
          f"included); kernel launches {launches}")
    check(len(auto) == 1, f"process refined {len(auto)} times in 38 frames")
    check(after.shape == (38, 3) and bool(np.isfinite(after).all()),
          "the refined, adopted trajectory is not finite")
    return dict(before=ate_of(before, gt), after=ate_of(after, gt), launches=launches)


def small_refine_runs(dev, mesh) -> dict:
    """(c) tests/test_dist_backend.py::test_online_refine_improves_live_trajectory
    at its config and sensor noise (the scans rendered once on the CPU, the
    ground-RANSAC draws handed to both runs), on the CPU (no mesh) and on the
    card (the NCCL group).  Checked: the same keyframes and loop decisions;
    the card's refine of its own store against the CPU's refine of a copy
    (poses within 1e-3 m); the reference's bound on the end error after the
    refine (1 m) on both; and on the CPU, whose run is deterministic, the
    reference's gain (ATE after the refine below 0.9 of before).  That gain
    depends on the noise draw in the reference too (its test's key 3 gives
    0.82; its keys 0, 1, 2 and 4 give 1.04 to 1.46), and the card's run,
    whose trajectory parts from the CPU's over 88 noisy frames, is a draw of
    its own: its ratio is printed, not held (ROADMAP.md, section C)."""
    cfg = small_refine_config()
    traj = loop_trajectory(n_out=40, n_turn=6)
    noise = synthetic.SensorNoise(range_sigma=0.04, intensity_speckle=0.15,
                                  dropout_rate=0.03)
    xyz, inten = synthetic.render_sequence(
        traj, synthetic.corridor_world(device="cpu"), cfg.sensor, noise=noise,
        gen=torch.Generator().manual_seed(4))
    T = xyz.shape[0]
    gu = torch.rand((T, cfg.ground.ransac_iters, 3), generator=torch.Generator().manual_seed(4))
    gt = traj.t - traj.t[0]
    out = {}
    for name, device, m in (("cpu", torch.device("cpu"), None), ("card", dev, mesh)):
        system = SlamSystem(cfg, device=device, mesh=m)
        reset_launches()
        infos, t0 = [], time.perf_counter()
        for k in range(T):
            infos.append(system.process(xyz[k].to(device), inten[k].to(device), 0.1 * k,
                                        ground_u=gu[k].to(device)))
        t_run = time.perf_counter() - t0
        flags = [(bool(i.skip), bool(i.is_keyframe), int(i.num_kf), bool(i.loop_found),
                  int(i.loop_idx)) for i in infos]
        n_kf = system.num_keyframes
        if m is not None:       # this store's refine on the card and on the CPU
            store = system.state.backend
            on_card = dist_backend.refine(dist_backend.shard_backend_state(store, m), cfg,
                                          mesh=m)
            on_cpu = dist_backend.refine(multiproc.tree_map(lambda a: a.cpu(), store), cfg)
            drefine = float((on_card.state.graph.poses.t[:n_kf].cpu()
                             - on_cpu.state.graph.poses.t[:n_kf]).abs().max())
            dlm, dlm_med, dcost = ba_agreement(on_card, on_cpu)
            spread, step = ba_order_spread(on_cpu.state, cfg)
        before = system.trajectory()
        system.refine()
        launches = read_launches()
        after = system.trajectory()
        out[name] = dict(flags=flags, loops=[(a, b) for a, b, _ in system.loops],
                         before=ate_of(before, gt), after=ate_of(after, gt),
                         end=float(np.linalg.norm(after[-1] - gt[T - 1].numpy())), s=t_run,
                         launches=launches)
    c, g = out["cpu"], out["card"]
    same = c["flags"] == g["flags"] and c["loops"] == g["loops"]
    print(f"refine (c) (small config, {T} noisy frames, refine after the run): "
          f"keyframes {g['flags'][-1][2]}, loops {g['loops']}, same decisions on the CPU "
          f"and the card {same}; ATE before -> after refine: CPU {c['before']:.4f} -> "
          f"{c['after']:.4f} m (x{c['after'] / c['before']:.3f}), card {g['before']:.4f} "
          f"-> {g['after']:.4f} m (x{g['after'] / g['before']:.3f}); end error after "
          f"refine CPU {c['end']:.4f} m, card {g['end']:.4f} m; the card's store refined "
          f"on the card and on the CPU: max |pose t| diff {drefine:.3g} m, |landmark| diff "
          f"max {dlm:.3g} m, median {dlm_med:.3g} m, BA final cost rel diff {dcost:.3g} (the "
          f"CPU's BA against itself with its observations permuted: median {spread:.3g} m; "
          f"median landmark step of the BA {step:.3g} m); "
          f"host s for the {T} "
          f"frames: CPU {c['s']:.1f}, card {g['s']:.1f}; the card run's kernel launches "
          f"{g['launches']}")
    check(same, "refine (c): the card took other decisions than the CPU")
    check(drefine < 1e-3, f"refine (c): card and CPU refines {drefine:.3g} m apart")
    check(dlm_med < LANDMARK_MEDIAN_TOL_CPU_M and dcost < 1e-3,
          f"refine (c): the card's BA is {dlm_med:.3g} m (median landmark) and {dcost:.3g} "
          f"(final cost, relative) off the CPU's")
    check(c["after"] < 0.9 * c["before"],
          f"refine (c) on the CPU: ATE {c['before']:.4f} -> {c['after']:.4f} m")
    for name, r in out.items():
        check(np.isfinite(r["after"]) and r["end"] < 1.0,
              f"refine (c) on the {name}: end error {r['end']:.4f} m after the refine")
    return dict(launches=g["launches"], ate={k: (v["before"], v["after"]) for k, v in out.items()})


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


TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
QUICK_START_FRAMES = 40        # README: tools/torch_replay.py --frames 40 --check-ate
ALIASED_FRAMES = 320           # the aliased corridor's first loops close by here
BAG_TOPIC = b"/os_cloud_node/points"


def _bag_record(fields: dict, payload: bytes) -> bytes:
    """One rosbag 2.0 record: its header fields, then its payload."""
    hdr = b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k + b"=" + v
                   for k, v in fields.items())
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(payload)) + payload)


def synthetic_bag(path: str, frames, height: int, width: int) -> None:
    """A rosbag 2.0 file of organized sensor_msgs/PointCloud2 scans (x, y,
    z, intensity as float32) on BAG_TOPIC, in one bz2 chunk."""
    conn = struct.pack("<I", 0)
    fields = b"".join(struct.pack("<I", len(n)) + n + struct.pack("<IBI", off, 7, 1)
                      for n, off in ((b"x", 0), (b"y", 4), (b"z", 8), (b"intensity", 12)))
    chunk = _bag_record({b"op": b"\x07", b"conn": conn, b"topic": BAG_TOPIC},
                        _bag_record({b"topic": BAG_TOPIC,
                                     b"type": b"sensor_msgs/PointCloud2"}, b"")[4:-4])
    for ts, xyz, inten in frames:
        sec, nsec = int(ts), int(round((ts - int(ts)) * 1e9))
        data = np.concatenate([xyz, inten[:, None]], 1).astype(np.float32).tobytes()
        msg = (struct.pack("<III", 0, sec, nsec) + struct.pack("<I", 2) + b"os"
               + struct.pack("<II", height, width) + struct.pack("<I", 4) + fields
               + b"\x00" + struct.pack("<II", 16, 16 * width)
               + struct.pack("<I", len(data)) + data + b"\x01")
        chunk += _bag_record({b"op": b"\x02", b"conn": conn,
                              b"time": struct.pack("<II", sec, nsec)}, msg)
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_bag_record({b"op": b"\x05", b"compression": b"bz2",
                             b"size": struct.pack("<I", len(chunk))}, bz2.compress(chunk)))


def tools_phase(dev) -> dict:
    """The user-facing and accuracy tools at full width on the card: the
    README's quick start (`tools/torch_replay.py --frames 40 --check-ate`,
    the `slam` pipeline) and the same 40 frames through `--pipeline
    odometry`; `torch_bag2islog.convert` of a bag of three full-width scans,
    read back through `ScanLog`; `torch_loop_eval.run_one` on the aliased
    corridor (os0_64_config, every channel, sensor noise seed 0), which
    must close a correct loop.  Kernel launches are counted over the whole
    phase."""
    sys.path.insert(0, TOOLS_DIR)
    import torch_bag2islog
    import torch_loop_eval
    import torch_replay

    t_phase = time.perf_counter()
    reset_launches()
    for pipeline in ("slam", "odometry"):
        print(f"tools: torch_replay.py --frames {QUICK_START_FRAMES} --check-ate "
              f"--pipeline {pipeline}")
        rc = torch_replay.main(["--frames", str(QUICK_START_FRAMES), "--check-ate",
                                "--pipeline", pipeline, "--device", str(dev)])
        check(rc == 0, f"torch_replay --pipeline {pipeline} failed its ATE check")

    cfg = config.os0_64_config()
    sc = cfg.sensor
    poses = synthetic.corridor_trajectory(3, speed=0.35, device=dev)
    world = synthetic.corridor_world(device=dev)
    frames = []
    for k in range(3):
        xyz, inten = synthetic.render_scan(se3.Pose(poses.q[k], poses.t[k]), world, sc)
        frames.append((12.5 + 0.1 * k, xyz.cpu().numpy(), inten.cpu().numpy()))
    tmp = tempfile.mkdtemp(prefix="islam_bag.")
    try:
        bag, out = os.path.join(tmp, "in.bag"), os.path.join(tmp, "out.islog")
        synthetic_bag(bag, frames, sc.image_height, sc.image_width)
        n = torch_bag2islog.convert(bag, out, BAG_TOPIC.decode(), sc.image_height,
                                    sc.image_width)
        with ScanLog(out) as log:
            same = [abs(log[k].timestamp - ts) < 1e-6
                    and np.array_equal(log[k].xyz, xyz)
                    and np.array_equal(log[k].intensity, inten)
                    for k, (ts, xyz, inten) in enumerate(frames)]
            shape = (log.height, log.width, len(log))
        print(f"tools: torch_bag2islog.convert wrote {n} frames of {shape[0]}x{shape[1]} "
              f"({os.path.getsize(out)} bytes); read back through ScanLog: "
              f"{'equal' if all(same) else same}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(n == 3 and shape == (sc.image_height, sc.image_width, 3) and all(same),
          f"bag2islog: {n} frames, shape {shape}, equal {same}")

    world, poses = torch_loop_eval._world("aliased", ALIASED_FRAMES, dev)
    t0 = time.perf_counter()
    xyz, inten = torch_loop_eval._render(world, poses, cfg, 0, ALIASED_FRAMES, dev)
    t_render = time.perf_counter() - t0
    gt = synthetic.relative_positions(poses).cpu().numpy()
    res = torch_loop_eval.run_one(cfg, xyz, inten, gt, 0, ALIASED_FRAMES, dev)
    launches = read_launches()
    print(f"tools: torch_loop_eval.run_one, aliased corridor, {ALIASED_FRAMES} noisy "
          f"frames (rendered in {t_render:.1f} s): {res['keyframes']} keyframes, "
          f"{res['accepted_loops']} accepted loops, {res['correct_loops']} correct, "
          f"precision {res['precision']}, recall {res['recall']}, ATE corrected "
          f"{res['ate_corrected_m']:.4f} m, live {res['ate_live_m']:.4f} m, "
          f"{res['scans_per_sec']} scans/s")
    print(f"  tools phase {time.perf_counter() - t_phase:.1f} s; nn kernel launches "
          f"{launches['nn']}, pack kernel launches {launches['pack']}; "
          f"{devices.describe('cuda')}")
    check(res["correct_loops"] >= 1, f"the aliased corridor closed no correct loop: {res}")
    check(launches["nn"] >= 1 and launches["pack"] >= 1,
          f"the tools phase did not launch both kernels: {launches}")
    return dict(launches=launches)


# the measurement and scale-out tools at the measure phase's depth
MEASURE_TOOLS = (
    ("torch_bench_full", ["--frames", "32"]),
    ("torch_stream_probe", ["--frames", "32"]),
    ("torch_slope_probe", ["--frames", "48"]),
    ("torch_profile_stages", ["--reps", "5"]),
    ("torch_scaling_bench", ["--devices", "1"]),
    ("torch_scaling_projection", ["--reps", "2"]),
    ("torch_multiproc_product", []),
)
PRODUCT_NODES, PRODUCT_LOOPS = 1024, 200


def measure_phase(dev) -> dict:
    """The measurement and scale-out tools on the card, each through its
    `main(argv)`, their records read back and held: the tools' own checks
    (their exit codes), the slope classes summing to the timed frames,
    device time and a kernel count on every profile row, the product-scale
    solves within 1e-3 m of the dense and local ones with a lower ATE.
    Kernel launches are counted over the whole phase."""
    sys.path.insert(0, TOOLS_DIR)
    t_phase = time.perf_counter()
    reset_launches()
    rec = {}
    tmp = tempfile.mkdtemp(prefix="islam_measure.")
    try:
        for name, argv in MEASURE_TOOLS:
            out = os.path.join(tmp, f"{name}.json")
            print(f"measure: {name} {' '.join(argv)}", flush=True)
            t0 = time.perf_counter()
            rc = importlib.import_module(name).main(argv + ["--device", dev.type, "--out", out])
            check(rc == 0, f"measure: {name} {' '.join(argv)} exited {rc}")
            with open(out) as f:
                rec[name] = json.load(f)
            print(f"measure: {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_launches()

    bf, sp = rec["torch_bench_full"], rec["torch_stream_probe"]
    print(f"measure: bench_full front end {bf['frontend_scans_per_sec']:.2f} scans/s, back end "
          f"{bf['backend_ms_per_keyframe']:.1f} ms a keyframe, streaming "
          f"{bf['streaming_scans_per_sec']:.2f} scans/s ({bf['streaming_keyframes']} kf), "
          f"preloaded {bf['streaming_preloaded_scans_per_sec']:.2f}; stream probe writer on "
          f"{sp['preloaded_writer_on_sps']}, off {sp['preloaded_writer_off_sps']}, bare "
          f"{sp['bare_dispatch_sps']} scans/s")
    sl = rec["torch_slope_probe"]
    counted = sum(c["count"] for c in sl["classes"].values())
    print("measure: slope classes " + ", ".join(
        f"{k} {v['count']} x {v['mean_ms']} ms (max {v['max_ms']})"
        for k, v in sl["classes"].items()))
    check(counted == sl["frames"] - 1,
          f"measure: slope classes count {counted} frames of {sl['frames'] - 1}")
    rows = rec["torch_profile_stages"]["rows"]
    for r in rows:
        print(f"measure: profile {r['stage']}: host {r['host_ms']:.3f} ms, device "
              f"{r['device_us']} us, {r['kernels']} kernels, bound {r['bound_us']} us "
              f"({r['bound_by']})")
    check(len(rows) == 10 and all(isinstance(r["device_us"], float) and r["device_us"] > 0
                                  and isinstance(r["kernels"], int) and r["kernels"] > 0
                                  for r in rows),
          f"measure: profile rows without device time or kernels: {rows}")
    sb = rec["torch_scaling_bench"]["sections"]["single_device_solve_vs_size"]["per_poses"]
    pj = rec["torch_scaling_projection"]
    print("measure: BA solve " + ", ".join(f"{v['observations']} obs {v['ms_per_solve']} ms"
                                           for v in sb.values())
          + f"; PGO K={pj['graph']['K']} {pj['measured_single_chip']['t_solve_s']} s, "
          f"Amdahl limit {pj['amdahl_speedup_limit']}")
    mp = rec["torch_multiproc_product"]
    print(f"measure: product {mp['graph_nodes']} nodes, {mp['loop_edges']} loop edges, "
          f"{mp['ba_observations']} BA observations, ATE {mp['pgo_ate_before_m']} -> "
          f"{mp['pgo_ate_after_m']} m, PGO {mp['pgo_max_abs_dt_vs_dense_reference_m']:.3g} m "
          f"and refine {mp['refine_max_abs_dt_vs_single_process_m']:.3g} m off")
    check(mp["graph_nodes"] == PRODUCT_NODES and mp["loop_edges"] == PRODUCT_LOOPS
          and mp["pgo_max_abs_dt_vs_dense_reference_m"] < 1e-3
          and mp["refine_max_abs_dt_vs_single_process_m"] < 1e-3
          and mp["pgo_ate_after_m"] < mp["pgo_ate_before_m"],
          f"measure: the product-scale record fails its checks: {mp}")
    print(f"  measure phase {time.perf_counter() - t_phase:.1f} s; nn kernel launches "
          f"{launches['nn']}, pack kernel launches {launches['pack']}; "
          f"{devices.describe('cuda')}")
    return dict(launches=launches)


MS_SESSIONS, MS_FRAMES, MS_FLAT = 8, 24, 3
MS_POSE_TOL_M = 1e-4       # odometry pose, batched against unbatched
MS_MAP_TOL_M = 0.1         # scan-to-map pose (see the phase's docstring)
MS_COUNT_FRAMES = 6


@contextlib.contextmanager
def solver_loop_tests():
    """Count the loop tests (host reads) that `solver.solve_pose`'s calls
    make for the length of the block: a solve that stops after k < iters
    iterations tests k + 1 times, one that reaches `iters` tests iters
    times, and a batched solve iterates as long as its slowest session."""
    fn = solver.solve_pose
    calls = []

    def counting(*a, **k):
        out = fn(*a, **k)
        calls.append((out.iterations, k.get("iters", 20)))
        return out

    solver.solve_pose = counting
    try:
        yield calls
    finally:
        solver.solve_pose = fn


def loop_tests(calls) -> int:
    """The loop tests of `solver_loop_tests`' recorded calls (read after
    the sync counter has closed: the reads are the counter's own)."""
    tests = 0
    for its, cap in calls:
        k = int(its.max())
        tests += k + 1 if k < cap else cap
    return tests


def _ms_run(cfg, xb, ib, seeds, mask, dev, count=False):
    """Step the sessions `seeds` over (F, B, ...) streams with
    `slam_step_batched`; returns the outputs and the steps' seconds, and
    with `count` the host syncs by call site and the solver's loop tests
    over every step but the first (whose constants come over to the card)
    and the last, and the last step's device kernels by name (a
    `torch.profiler` trace)."""
    st = slam.init_batched_state(cfg, seeds, device=dev)
    outs, secs = [], []
    F = xb.shape[0]
    sites, kernels, tests = collections.Counter(), collections.Counter(), 0
    from torch.profiler import ProfilerActivity, profile
    for k in range(F):
        last = count and k == F - 1
        counted = count and 0 < k < F - 1
        with contextlib.ExitStack() as stack:
            step_sites = stack.enter_context(sync_counter(counted))
            step_tests = stack.enter_context(solver_loop_tests())
            prof = (stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
                    if last else None)
            _sync_untracked(dev)
            t0 = time.perf_counter()
            st, out = slam.slam_step_batched(st, xb[k], ib[k], k * 0.1, mask, cfg)
            _sync_untracked(dev)
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        if counted:
            sites.update(step_sites)
            tests += loop_tests(step_tests)
        if last:
            kernels.update(e.name for e in prof.events() if e.device_type.name == "CUDA")
    return outs, secs, sites, tests, kernels


def solver_loop_line() -> int:
    """The line of `solver.solve_pose`'s loop test (its one host read an
    iteration), as the sync counter keys it."""
    import inspect
    lines, first = inspect.getsourcelines(solver.solve_pose)
    return first + next(i for i, ln in enumerate(lines) if "if not bool(" in ln)


def multisession_phase(dev) -> dict:
    """The batched step at full width: 8 sessions held against their
    unbatched runs, the host syncs and device kernels per step at B = 1 and
    B = 8, then the scaling tool at reduced depth."""
    t_phase = time.perf_counter()
    cfg = config.os0_64_config()
    B, F = MS_SESSIONS, MS_FRAMES
    poses = synthetic.circuit_trajectory(F + B - 1, speed=0.4, device=dev)
    xyz, inten = synthetic.render_sequence(poses, synthetic.circuit_world(device=dev),
                                           cfg.sensor)
    xb = torch.stack([xyz[b:b + F] for b in range(B)], 1)          # (F, B, N, 3)
    ib = torch.stack([inten[b:b + F] for b in range(B)], 1).clone()
    ib[:, MS_FLAT] = 100.0
    mask = projection.detection_mask(cfg.sensor, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    outs, secs, *_ = _ms_run(cfg, xb, ib, range(B), mask, dev)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    skips = [[h.skip for h in o.host] for o in outs]
    check(all(s[MS_FLAT] for s in skips[1:]) and not all(all(s) for s in skips[1:]),
          f"multisession: the batch is not mixed (skips {skips})")
    worst = {"odom_pose": 0.0, "pose": 0.0}
    for b in range(B):
        st = slam.init_state(cfg, seed=b, device=dev)
        for k in range(F):
            st, o = slam.slam_step(st, xb[k, b], ib[k, b], k * 0.1, mask, cfg)
            bo = outs[k]
            for f in ("skip", "is_keyframe", "num_good", "ground_ok"):
                check(int(getattr(o, f)) == int(getattr(bo, f)[b]),
                      f"multisession: session {b} frame {k}: {f} {int(getattr(o, f))} alone, "
                      f"{int(getattr(bo, f)[b])} in the batch")
            check(o.host == bo.host[b], f"multisession: session {b} frame {k}: host flags "
                  f"{o.host} alone, {bo.host[b]} in the batch")
            for name in worst:
                d = float((getattr(o, name).t - getattr(bo, name).t[b]).abs().max())
                worst[name] = max(worst[name], d)
    print(f"multisession: {B} sessions x {F} frames at full width held against their "
          f"unbatched runs: discrete outputs equal, largest odometry pose difference "
          f"{worst['odom_pose']:.3g} m (bar {MS_POSE_TOL_M}), scan-to-map pose "
          f"{worst['pose']:.3g} m (bar {MS_MAP_TOL_M}); fallback session skipped "
          f"{sum(s[MS_FLAT] for s in skips)} of {F} frames", flush=True)
    check(worst["odom_pose"] <= MS_POSE_TOL_M and worst["pose"] <= MS_MAP_TOL_M,
          f"multisession: a batched session strays {worst} m from its unbatched run")

    # host syncs and device kernels per step: B copies of stream 0 from one
    # seed against one, and against the unbatched step
    n = MS_COUNT_FRAMES
    one = xb[:n, :1].contiguous(), ib[:n, :1].contiguous()
    many = (xb[:n, :1].expand(n, B, *xb.shape[2:]).contiguous(),
            ib[:n, :1].expand(n, B, *ib.shape[2:]).contiguous())
    _, t1, s1, n1, k1 = _ms_run(cfg, *one, [0], mask, dev, count=True)
    _, t8, s8, n8, k8 = _ms_run(cfg, *many, [0] * B, mask, dev, count=True)
    st = slam.init_state(cfg, seed=0, device=dev)
    s0, n0 = collections.Counter(), 0
    for k in range(n - 1):
        with sync_counter(k > 0) as step_sites, solver_loop_tests() as step_tests:
            st, _ = slam.slam_step(st, one[0][k, 0], one[1][k, 0], k * 0.1, mask, cfg)
        if k > 0:
            s0.update(step_sites)
            n0 += loop_tests(step_tests)
    loop_site = "solver.py:" + str(solver_loop_line())
    print(f"multisession: host syncs over steps 1..{n - 2}: B=1 {sum(s1.values())}, "
          f"B={B} {sum(s8.values())}, unbatched {sum(s0.values())}; solver loop tests "
          f"{n1}, {n8}, {n0} (at {loop_site}); device kernels of step {n - 1}: B=1 "
          f"{sum(k1.values())}, B={B} {sum(k8.values())}", flush=True)
    print_sync_sites(s8)
    for name, runs in ((f"B=1", (s1, n1)), (f"B={B}", (s8, n8)), ("unbatched", (s0, n0))):
        sites, tests = runs
        check(sites[loop_site] == tests,
              f"multisession: {name}: {sites[loop_site]} syncs at the solver's loop test "
              f"for {tests} loop tests")
    others = [{k: v for k, v in c.items() if k != loop_site} for c in (s1, s8, s0)]
    check(others[0] == others[1] == others[2],
          f"multisession: host syncs outside the solver's loop test differ: B=1 "
          f"{others[0]}, B={B} {others[1]}, unbatched {others[2]}")
    diff = collections.Counter(k8)
    diff.subtract(k1)
    print("multisession: device kernels, B=8 against B=1, by name: " + "; ".join(
        f"{v:+d} {name[:70]}" for name, v in sorted(diff.items(), key=lambda x: -abs(x[1]))
        if v)[:1500], flush=True)
    check(sum(k8.values()) < 1.5 * sum(k1.values()),
          f"multisession: {sum(k8.values())} kernels a step at B={B} against "
          f"{sum(k1.values())} at B=1: the launches grow with the sessions")
    ms1, ms8 = 1e3 * statistics.median(t1[1:]), 1e3 * statistics.median(t8[1:])
    print(f"multisession: {ms1:.2f} ms a step at B=1 ({1e3 / ms1:.1f} scans/s), "
          f"{ms8:.2f} ms at B={B} ({B * 1e3 / ms8:.1f} scans/s in all; the staggered run "
          f"{1e3 * statistics.median(secs[1:]):.2f} ms); peak memory of the B={B} run "
          f"{peak / 2**20:.0f} MiB; {devices.describe('cuda')}", flush=True)

    sys.path.insert(0, TOOLS_DIR)
    tmp = tempfile.mkdtemp(prefix="islam_ms.")
    try:
        out = os.path.join(tmp, "ms.json")
        rc = importlib.import_module("torch_scaling_multisession").main(
            ["--batches", f"1,{B}", "--frames", "12", "--warm", "4", "--device", "cuda",
             "--out", out])
        check(rc == 0, f"multisession: the scaling tool exited {rc}")
        with open(out) as f:
            tool = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(set(tool["batch"]) == {"1", str(B)} and "one_chip_batch8_efficiency" in tool,
          f"multisession: the scaling tool's record lacks keys: {tool}")
    print(f"  multisession phase {time.perf_counter() - t_phase:.1f} s; nn kernel launches "
          f"{launches['nn']}, pack kernel launches {launches['pack']}", flush=True)
    return dict(launches=launches)


KERNELS = (
    ("nn", "nn_packed_kernel"),
    ("pack", "pack_kernel"),
)


def kernel_records(kern: dict, by_path: dict) -> dict:
    """The per-kernel record; `launches` sums the main paths' runs (the
    slice's `SlamSystem.process`, the circuit's `StreamingRunner.run`, the
    refine phase's full-width `SlamSystem(cfg, mesh=...)` run, part b, its
    small-config card run, part c, the tools phase, the measure phase and
    the multisession phase's B = 8 run),
    each counted from 0 just before its run and read just after it;
    `launches_by_path` splits it."""
    return {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "intensity_slam_tpu_torch/csrc/nn.cu",
        "replaces": "intensity_slam_tpu/ops/pallas_nn.py:103",
        "launches": sum(v[key] for v in by_path.values()),
        "launches_by_path": {path: v[key] for path, v in by_path.items()},
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
    print(devices.describe("cuda"))
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
                  "slice": lambda: slice_phase(dev),
                  "stream-small": lambda: stream_small_phase(dev),
                  "checkpoint": lambda: checkpoint_phase(dev),
                  "geoslam": lambda: geoslam_phase(dev),
                  "stream": lambda: stream_phase(dev),
                  "refine": lambda: refine_phase(dev, stream_phase(dev)),
                  "tools": lambda: tools_phase(dev),
                  "measure": lambda: measure_phase(dev),
                  "multisession": lambda: multisession_phase(dev)}
        phases[only]()
        return 0
    kern = kernel_phase(dev, cfg)
    grid_phase(dev)
    small_phase(dev)
    fallback_phase(dev)
    sl = slice_phase(dev)
    stream_small_phase(dev)
    checkpoint_phase(dev)
    geoslam_phase(dev)
    st = stream_phase(dev)
    rf = refine_phase(dev, st)
    tl = tools_phase(dev)
    ms = measure_phase(dev)
    mu = multisession_phase(dev)
    print(devices.describe("cuda"))
    print(json.dumps(kernel_records(kern, {"slice": sl["launches"],
                                           "stream": st["launches"],
                                           "refine": rf["online"]["launches"],
                                           "refine-small": rf["small"]["launches"],
                                           "tools": tl["launches"],
                                           "measure": ms["launches"],
                                           "multisession": mu["launches"]})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
