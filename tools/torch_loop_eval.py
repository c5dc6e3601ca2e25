#!/usr/bin/env python
"""Loop-closure evaluation battery of the PyTorch/CUDA port: the
counterpart of `tools/loop_eval.py`.

    python tools/torch_loop_eval.py [--seeds 5] [--worlds circuit,figure8,aliased]
                                    [--channels sc,bow,radius,all] [--frames 560]
                                    [--device cuda] [--out RESULTS_torch_loops.json]

Three worlds x four detection-channel configurations x N noise seeds,
os0_64_config, through the port's `SlamSystem`:

  worlds:   circuit  — the hard benchmark, 1.5 laps (continuous revisit)
            figure8  — nested figure-eight; the shared middle leg repeats
            aliased  — 80 m corridor whose geometry AND texture tile every
                       10 m, out and back: every return frame is a true
                       revisit, aliased WRONG candidates one period away
  channels: sc / bow / radius — each strategy alone — plus `all` (every
            channel gated on, the default config)

Per run: accepted loops with ground-truth correctness (a loop (i, j) is
CORRECT iff the true keyframe positions are within GT_NEAR_M), precision,
opportunity-coverage recall, the LIVE trajectory error (the pose the system
believed at dispatch time) and the corrected-export ATE.

Sensor noise comes from a `torch.Generator` seeded with seed * 100003 + s
for the 32-frame chunk starting at frame s (the JAX tool's key numbers;
torch cannot reproduce `jax.random`'s draws).  Finished renders are cached
under `.render_cache_torch/`, keyed by world, seed, frames, beam table and
device type: the port's renders differ from the JAX package's, so this tool
never reads the JAX tool's `.render_cache/`.  `--small` (small_test_config)
exists to rehearse the tool on the CPU.
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
OUT = os.path.join(ROOT, "RESULTS_torch_loops.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import se3  # noqa: E402

GT_NEAR_M = 3.0      # a loop (i, j) is correct iff |gt_i - gt_j| < this
SCAN_DT = 0.1
RENDER_CHUNK = 32


def _world(name: str, frames: int, dev):
    if name == "circuit":
        return (synthetic.circuit_world(device=dev),
                synthetic.circuit_trajectory(frames, speed=0.4, device=dev))
    if name == "figure8":
        return (synthetic.figure_eight_world(device=dev),
                synthetic.figure_eight_trajectory(frames, speed=0.4, device=dev))
    if name == "aliased":
        return (synthetic.aliased_corridor_world(device=dev),
                synthetic.aliased_corridor_trajectory(frames, speed=0.4, device=dev))
    raise ValueError(name)


def _channel_cfg(base: config.SlamConfig, channel: str) -> config.SlamConfig:
    lc = base.loop
    flags = {
        "sc": (True, False, False),
        "bow": (False, True, False),
        "radius": (False, False, True),
        "all": (lc.use_scancontext, lc.use_bow_loop, lc.use_radius_search),
    }[channel]
    return base.replace(loop=dataclasses.replace(
        lc, use_scancontext=flags[0], use_bow_loop=flags[1],
        use_radius_search=flags[2]))


def _render(world, poses, cfg, seed: int, frames: int, dev, world_name: str = "",
            cache_dir: str | None = None):
    """The noisy sequence on `dev`, from the cache when it holds it."""
    cache = None
    if world_name and cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        sc = cfg.sensor
        cache = os.path.join(
            cache_dir, f"{world_name}_s{seed}_f{frames}_{sc.image_height}x"
            f"{sc.image_width}_fov{sc.fov_up:g}_{sc.fov_down:g}_{dev.type}.npz")
        if os.path.exists(cache):
            d = np.load(cache)
            return (torch.from_numpy(d["xyz"]).to(dev),
                    torch.from_numpy(d["inten"]).to(dev))
    xs, its = [], []
    for s in range(0, frames, RENDER_CHUNK):
        chunk = se3.Pose(poses.q[s:s + RENDER_CHUNK], poses.t[s:s + RENDER_CHUNK])
        n = chunk.q.shape[0]
        gen = torch.Generator(device=dev).manual_seed(seed * 100003 + s)
        times = SCAN_DT * (s + torch.arange(n, dtype=torch.float32, device=dev))
        x, i = synthetic.render_sequence(chunk, world, cfg.sensor,
                                         noise=synthetic.DEFAULT_NOISE, gen=gen,
                                         times=times)
        xs.append(x)
        its.append(i)
    xyz, inten = torch.cat(xs), torch.cat(its)
    if cache:
        np.savez_compressed(cache, xyz=xyz.cpu().numpy(), inten=inten.cpu().numpy())
    return xyz, inten


def _host(a) -> np.ndarray:
    return torch.as_tensor(a).cpu().numpy()


def _evaluate(sys_, gt_t: np.ndarray, live_t: np.ndarray,
              cfg: config.SlamConfig) -> dict:
    """Loop precision, opportunity recall and trajectory errors of a
    finished run (`tools/loop_eval.py:121`, the same arithmetic)."""
    lc = cfg.loop
    bst = sys_.bstate
    n_kf = int(bst.num_kf)
    kf_times = _host(bst.kf_time[:n_kf])
    kf_frame = np.clip(np.round(kf_times / SCAN_DT).astype(int), 0, len(gt_t) - 1)
    kf_gt = gt_t[kf_frame]

    loops = sys_.loops            # [(cur_kf, loop_kf, fitness)]
    correct = []
    for (i, j, fit) in loops:
        if i < n_kf and j < n_kf:
            d = float(np.linalg.norm(kf_gt[i] - kf_gt[j]))
            correct.append(d < GT_NEAR_M)
        else:
            correct.append(False)
    n_acc = len(loops)
    n_corr = int(sum(correct))

    # opportunities: keyframe j with a gap-older keyframe within GT_NEAR_M
    gap = lc.min_loop_search_gap
    opp = np.zeros(n_kf, bool)
    for j in range(n_kf):
        if j <= gap:
            continue
        d = np.linalg.norm(kf_gt[: j - gap] - kf_gt[j], axis=-1)
        opp[j] = bool((d < GT_NEAR_M).any())
    # coverage: a correct accepted loop within the trailing cooldown window
    cov = np.zeros(n_kf, bool)
    for (i, j, fit), ok in zip(loops, correct):
        if ok:
            cov[max(0, i - lc.loop_cooldown_kf): i + 1] = True
    n_opp = int(opp.sum())
    n_cov = int((opp & cov).sum())

    err_live = np.linalg.norm(live_t - gt_t[: len(live_t)], axis=-1)
    traj = sys_.trajectory()
    err_corr = np.linalg.norm(traj - gt_t[: len(traj)], axis=-1)
    return {
        "keyframes": n_kf,
        "accepted_loops": n_acc,
        "correct_loops": n_corr,
        "precision": (n_corr / n_acc) if n_acc else None,
        "opportunity_keyframes": n_opp,
        "covered_opportunities": n_cov,
        "recall": (n_cov / n_opp) if n_opp else None,
        "ate_live_m": float(np.sqrt(np.mean(err_live ** 2))),
        "max_live_err_m": float(err_live.max()),
        "ate_corrected_m": float(np.sqrt(np.mean(err_corr ** 2))),
        "end_err_m": float(err_corr[-1]),
    }


def run_one(cfg: config.SlamConfig, xyz, inten, gt_t: np.ndarray, seed: int,
            frames: int, dev) -> dict:
    """One `SlamSystem` over the frames, evaluated; the live poses are read
    once, after the last frame."""
    sys_ = SlamSystem(cfg, seed=seed, device=dev)
    live = []
    t0 = time.perf_counter()
    for k in range(frames):
        info = sys_.process(xyz[k], inten[k], SCAN_DT * k)
        live.append(info.pose_t)
    live_t = torch.stack(live).cpu().numpy()
    dt = time.perf_counter() - t0
    res = _evaluate(sys_, gt_t, live_t, cfg)
    res["scans_per_sec"] = round(frames / dt, 1)
    res["seed"] = seed
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--worlds", type=str, default="circuit,figure8,aliased")
    ap.add_argument("--channels", type=str, default="sc,bow,radius,all")
    ap.add_argument("--frames", type=int, default=560)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cache-dir", type=str,
                    default=os.path.join(ROOT, ".render_cache_torch"))
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    base_cfg = config.small_test_config() if args.small else config.os0_64_config()
    channels = args.channels.split(",")

    results = {"frames": args.frames, "seeds": args.seeds,
               "gt_near_m": GT_NEAR_M, "noise": "DEFAULT_NOISE",
               "device": devices.describe(dev), "worlds": {}}
    for wname in args.worlds.split(","):
        frames = args.frames if wname != "aliased" else min(args.frames, 400)
        results["worlds"][wname] = {"frames": frames, "channels": {}}
        all_runs = {ch: [] for ch in channels}
        for seed in range(args.seeds):
            # render once per (world, seed); every channel replays it
            world, poses = _world(wname, frames, dev)
            xyz, inten = _render(world, poses, base_cfg, seed, frames, dev,
                                 world_name=wname, cache_dir=args.cache_dir)
            gt_t = synthetic.relative_positions(poses).cpu().numpy()
            for ch in channels:
                r = run_one(_channel_cfg(base_cfg, ch), xyz, inten, gt_t, seed,
                            frames, dev)
                all_runs[ch].append(r)
                print(f"[{wname}/{ch}/seed{seed}] acc={r['accepted_loops']}"
                      f" corr={r['correct_loops']} prec={r['precision']}"
                      f" rec={r['recall']} ate_corr={r['ate_corrected_m']:.3f}"
                      f" ate_live={r['ate_live_m']:.3f}"
                      f" max_live={r['max_live_err_m']:.2f}"
                      f" ({r['scans_per_sec']} sc/s)", flush=True)
        for ch in channels:
            runs = all_runs[ch]
            agg = {}
            for key in ("precision", "recall", "ate_corrected_m",
                        "ate_live_m", "max_live_err_m"):
                vals = [r[key] for r in runs if r[key] is not None]
                agg[key] = {
                    "mean": round(float(np.mean(vals)), 4) if vals else None,
                    "max": round(float(np.max(vals)), 4) if vals else None,
                }
            agg["accepted_loops_total"] = sum(r["accepted_loops"] for r in runs)
            agg["correct_loops_total"] = sum(r["correct_loops"] for r in runs)
            results["worlds"][wname]["channels"][ch] = {"aggregate": agg, "runs": runs}
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
