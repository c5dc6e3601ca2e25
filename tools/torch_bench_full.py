#!/usr/bin/env python
"""Full-system benchmark of the PyTorch/CUDA port: front end, back end and
streaming runner measured apart.  The counterpart of `tools/bench_full.py`.

    python tools/torch_bench_full.py [--frames 64] [--device cuda]
                                     [--out RESULTS_torch_full_bench.json]

Four parts, all at os0_64_config over the corridor (`--frames` scans):

1. front end: `slam.slam_step` in steady state (after the first frame)
   [scans/s];
2. back end: `loop.backend_step` at the keyframe subsample of the front
   end's outputs (ScanContext, BoW, ICP verification at a candidate, the
   PGO at an accepted loop) [keyframes/s];
3. `StreamingRunner.run` over a native scan log (prefetcher, upload ring,
   wire decode, `fused_step`, pose writer) [scans/s];
4. `StreamingRunner.run_preloaded` over the same log uploaded once, so that
   run minus run_preloaded is the transport's cost.

One runner serves both streaming parts.  Each part runs twice with
`reset()` between, and the second, warm pass is timed: a process's first
PGO pays a cold start-up on the card.  Every timing ends in
`utils.device.synchronize`.  The streaming pass and the preloaded pass must
take the same keyframes; the tool exits 1 when they do not.

Writes the JAX tool's keys with `platform` replaced by `device` (the card's
name and power limit).  `--small` (small_test_config) rehearses the tool
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_full_bench.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.ops import projection  # noqa: E402
from intensity_slam_tpu_torch.pipeline import loop as loop_mod  # noqa: E402
from intensity_slam_tpu_torch.pipeline import slam  # noqa: E402
from intensity_slam_tpu_torch.runtime import ScanLog, ScanLogWriter  # noqa: E402
from intensity_slam_tpu_torch.runtime.stream import StreamingRunner  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.os0_64_config()
    frames = args.frames
    world = synthetic.corridor_world(device=dev)
    poses = synthetic.corridor_trajectory(frames, speed=0.35, yaw_rate=0.005, device=dev)
    xyz, inten = synthetic.render_sequence(poses, world, cfg.sensor)
    times = [k * cfg.sensor.scan_period for k in range(frames)]
    mask = projection.detection_mask(cfg.sensor, device=dev)
    results = {"device": devices.describe(dev), "frames": frames}

    # ---- 1. front end in steady state -------------------------------------
    state = slam.init_state(cfg, device=dev)
    state, out = slam.slam_step(state, xyz[0], inten[0], times[0], mask, cfg)
    devices.synchronize(dev)
    outs = []
    t0 = time.perf_counter()
    for k in range(1, frames):
        state, out = slam.slam_step(state, xyz[k], inten[k], times[k], mask, cfg)
        outs.append(out)
    devices.synchronize(dev)
    dt = time.perf_counter() - t0
    results["frontend_scans_per_sec"] = (frames - 1) / dt
    print(f"front-end          {(frames - 1) / dt:9.1f} scans/s")

    # ---- 2. back end in steady state (keyframe rate) ----------------------
    stride = max(1, len(outs) // 32)
    kf_outs = outs[::stride]                      # keyframe-rate subsample
    scan_masks = [torch.linalg.norm(xyz[k], dim=-1) >= cfg.sensor.min_range
                  for k in range(1, frames, stride)]

    def backend(bst, j, o):
        k = min(j * 2 + 1, frames - 1)
        return loop_mod.backend_step(
            bst, xyz[k], scan_masks[min(j, len(scan_masks) - 1)], o.desc, o.desc_valid,
            o.pose, times[k], cfg)

    o = kf_outs[0]
    bstate, bout = loop_mod.backend_step(loop_mod.init_state(cfg, device=dev), xyz[1],
                                         scan_masks[0], o.desc, o.desc_valid, o.pose,
                                         times[1], cfg)
    devices.synchronize(dev)
    n_kf = len(kf_outs) - 1
    bouts = []
    t0 = time.perf_counter()
    for j, o in enumerate(kf_outs[1:], start=1):
        bstate, bout = backend(bstate, j, o)
        bouts.append(bout)
    devices.synchronize(dev)
    dt = time.perf_counter() - t0
    results["backend_keyframes_per_sec"] = n_kf / dt
    results["backend_ms_per_keyframe"] = 1e3 * dt / n_kf
    verified = sum(bool(torch.isfinite(b.icp_fitness)) for b in bouts)
    accepted = sum(bool(b.loop_found) for b in bouts)
    print(f"back-end           {n_kf / dt:9.1f} keyframes/s ({1e3 * dt / n_kf:.1f} ms/kf; "
          f"{verified} candidates verified, {accepted} accepted)")

    # ---- 3. StreamingRunner end to end over a native scan log -------------
    xyz_np, inten_np = xyz.cpu().numpy(), inten.cpu().numpy()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench.islog")
        with ScanLogWriter(path, cfg.sensor.image_height, cfg.sensor.image_width) as w:
            for k in range(frames):
                w.append(float(times[k]), xyz_np[k], inten_np[k])

        # one runner for every pass: the first pass warms it, reset() gives
        # the timed pass a pristine state
        runner = StreamingRunner(cfg, traj_path=os.path.join(td, "t.tum"), device=dev)

        def timed(preloaded: bool):
            with ScanLog(path) as log:
                go = runner.run_preloaded if preloaded else runner.run
                go(log)                       # warm
                runner.reset()
                devices.synchronize(dev)
                t0 = time.perf_counter()
                stats = go(log)
                devices.synchronize(dev)
                return stats, time.perf_counter() - t0

        stats, dt = timed(preloaded=False)
        results["streaming_scans_per_sec"] = frames / dt
        results["streaming_keyframes"] = stats["keyframes"]
        results["streaming_loops"] = stats["loops"]
        n_pts = cfg.sensor.image_height * cfg.sensor.image_width
        results["wire_bytes_per_frame"] = (n_pts + 1) * 2 * 2     # uint16 pairs
        results["float_bytes_per_frame"] = (n_pts + 1) * 4 * 4    # f32 quads
        print(f"streaming e2e      {frames / dt:9.1f} scans/s ({stats['keyframes']} kf, "
              f"{stats['loops']} loops, {results['wire_bytes_per_frame'] / 1e3:.0f} "
              f"kB/frame wire)")

        # ---- 4. the same runner with the log on the device ----------------
        pstats, dtp = timed(preloaded=True)
        rate_wire, rate_pre = frames / dt, frames / dtp
        results["streaming_preloaded_scans_per_sec"] = rate_pre
        # share of the preloaded rate lost to the host->device transport
        results["streaming_transport_overhead_pct"] = round(
            100.0 * (rate_pre - rate_wire) / rate_pre, 1)
        print(f"streaming preload  {rate_pre:9.1f} scans/s (transport-free; "
              f"{pstats['keyframes']} kf)")

    # against the reference system's 10 Hz real-time claim
    results["vs_baseline_frontend"] = results["frontend_scans_per_sec"] / 10.0
    results["vs_baseline_streaming"] = results["streaming_scans_per_sec"] / 10.0
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"results -> {args.out}")
    print(json.dumps(results))
    if pstats["keyframes"] != stats["keyframes"]:
        print(f"FAIL: the streaming pass took {stats['keyframes']} keyframes, the "
              f"preloaded pass {pstats['keyframes']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
