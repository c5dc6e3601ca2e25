#!/usr/bin/env python
"""Headless visualization dumps of the PyTorch/CUDA port: the counterpart
of `tools/visualize.py` (the reference publishes these artifacts to rviz:
matched-keypoint images, keyposes, the map).

Usage:
  python tools/torch_visualize.py --frames 12                  # synthetic
  python tools/torch_visualize.py --islog seq.islog --out viz_torch
  (--small for small_test_config, --device cpu to run without a card;
  the default --out is `viz_torch/` at the repo root, git-ignored)
Outputs:
  out/matches_XXXX.png   intensity pair + the match lines that enter the
                         odometry solve (`features.matched_points` weight
                         > 0: mutual, kept, both ends lifted), keyframes only
  out/range_0000.png     first-frame range image at the reference's debug
                         gain (range * range_scale clamped to 255)
  out/trajectory.png     top-down trajectory (+ ground truth if known)
  out/map.png            the voxel maps' ground and corner points, top-down

matplotlib is imported here and nowhere else in the port.
"""

from __future__ import annotations

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "viz_torch")   # git-ignored

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.ops import features, projection  # noqa: E402
from intensity_slam_tpu_torch.pipeline import slam  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402


def draw_matches(img_a, img_b, uv_a, uv_b, valid, path):
    """Two intensity images stacked with match lines, like the reference's
    cv::drawMatches debug topic."""
    H, W = img_a.shape
    canvas = np.concatenate([img_a, img_b], axis=0)
    fig, ax = plt.subplots(figsize=(14, 3.5), dpi=110)
    ax.imshow(canvas, cmap="gray", vmin=0, vmax=255, aspect="auto")
    sel = np.nonzero(valid)[0][:120]
    for i in sel:
        ax.plot([uv_a[i, 0], uv_b[i, 0]], [uv_a[i, 1], uv_b[i, 1] + H],
                lw=0.6, alpha=0.8)
    ax.scatter(uv_a[sel, 0], uv_a[sel, 1], s=3, c="lime")
    ax.scatter(uv_b[sel, 0], uv_b[sel, 1] + H, s=3, c="cyan")
    ax.set_title(f"{len(sel)} matches in the solve (top shown)")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def draw_trajectory(est, gt, path):
    fig, ax = plt.subplots(figsize=(7, 6), dpi=110)
    ax.plot(est[:, 0], est[:, 1], "-o", ms=2, label="estimate")
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], "--", label="ground truth")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title("trajectory (top-down)")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def draw_map(ground_pts, corner_pts, path):
    fig, ax = plt.subplots(figsize=(8, 6), dpi=110)
    if len(ground_pts):
        ax.scatter(ground_pts[:, 0], ground_pts[:, 1], s=0.5, c=ground_pts[:, 2],
                   cmap="terrain", label=f"ground ({len(ground_pts)})")
    if len(corner_pts):
        ax.scatter(corner_pts[:, 0], corner_pts[:, 1], s=2.0, c="red",
                   label=f"corners ({len(corner_pts)})")
    ax.set_aspect("equal")
    ax.legend(markerscale=8)
    ax.set_title("device-resident voxel map (top-down)")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_range_image(scan, cfg, path):
    """The range image at the reference's debug gain (CV_8UC1 clamp,
    `image_handler.h_ouster:131`)."""
    rng8 = np.clip(scan.range.cpu().numpy() * cfg.sensor.range_scale, 0, 255)
    fig, ax = plt.subplots(figsize=(14, 2), dpi=110)
    ax.imshow(rng8, cmap="gray", vmin=0, vmax=255, aspect="auto")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def _map_points(m) -> np.ndarray:
    return m.pts.reshape(-1, 3)[m.valid.reshape(-1)].cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--islog", type=str, default=None)
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    os.makedirs(args.out, exist_ok=True)

    cfg = config.small_test_config() if args.small else config.SlamConfig()
    gt = None
    if args.islog:
        from intensity_slam_tpu_torch.runtime import ScanLog

        with ScanLog(args.islog) as log:
            frames = [(log[k].timestamp, torch.from_numpy(np.array(log[k].xyz)).to(dev),
                       torch.from_numpy(np.array(log[k].intensity)).to(dev))
                      for k in range(min(args.frames, len(log)))]
    else:
        poses = synthetic.corridor_trajectory(args.frames, speed=0.35, yaw_rate=0.02,
                                              device=dev)
        xyz, inten = synthetic.render_sequence(
            poses, synthetic.corridor_world(device=dev), cfg.sensor)
        frames = [(0.1 * k, xyz[k], inten[k]) for k in range(args.frames)]
        gt = synthetic.relative_positions(poses).cpu().numpy()

    mask = projection.detection_mask(cfg.sensor, device=dev)
    st = slam.init_state(cfg, device=dev)
    prev = None
    traj = []
    for k, (ts, x, i) in enumerate(frames):
        st, out = slam.slam_step(st, x, i, ts, mask, cfg)
        traj.append(out.pose.t)
        scan = projection.project_organized(x, i, cfg.sensor)
        img = scan.intensity.cpu().numpy()
        if k == 0:
            save_range_image(scan, cfg, os.path.join(args.out, "range_0000.png"))
        feats = features.extract(scan, mask, cfg.feature)
        if prev is not None and bool(out.is_keyframe):
            m = features.match(feats.desc, feats.xyz_valid, prev[1].desc,
                               prev[1].xyz_valid, cfg.feature.match_keep_frac,
                               cfg.feature.max_hamming)
            _, _, w = features.matched_points(feats, prev[1], m)
            draw_matches(img, prev[0], feats.uv.cpu().numpy(),
                         prev[1].uv[m.dst_idx.long()].cpu().numpy(),
                         (w > 0).cpu().numpy(),
                         os.path.join(args.out, f"matches_{k:04d}.png"))
        prev = (img, feats)

    traj = torch.stack(traj).cpu().numpy()
    draw_trajectory(traj, gt[: len(traj)] if gt is not None else None,
                    os.path.join(args.out, "trajectory.png"))
    draw_map(_map_points(st.mapping.ground_map), _map_points(st.mapping.corner_map),
             os.path.join(args.out, "map.png"))
    print(f"wrote {len(os.listdir(args.out))} artifacts -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
