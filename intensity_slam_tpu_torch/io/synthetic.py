"""Synthetic LiDAR world: raycast organized scans with intensity textures.

PyTorch counterpart of the noise-free path of
`intensity_slam_tpu/io/synthetic.py`: a raycaster that renders organized
(H, W) Ouster-style scans (ranges + procedurally textured intensity) of a
ground plane plus axis-aligned boxes, from arbitrary sensor poses, on the
device the poses live on.  It exists so that a full-width run can make its
scans on the card; sensor noise, rolling-shutter motion, textureless zones
and dynamic objects are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SensorConfig
from ..utils import se3


class World(NamedTuple):
    # axis-aligned boxes: centers (B, 3), half-extents (B, 3)
    box_centers: torch.Tensor
    box_halves: torch.Tensor
    ground_z: float = 0.0


def corridor_world(device="cuda") -> World:
    """A 40 m corridor along +x, 4 m wide, with wall pillars for texture
    parallax and a few boxes as obstacles."""
    walls = [
        # left / right walls (thin boxes); bottom exactly at ground z=0
        ([20.0, 2.2, 1.6], [22.0, 0.2, 1.6]),
        ([20.0, -2.2, 1.6], [22.0, 0.2, 1.6]),
        # end wall
        ([42.5, 0.0, 1.6], [0.5, 3.0, 1.6]),
        # back wall behind start
        ([-3.5, 0.0, 1.6], [0.5, 3.0, 1.6]),
    ]
    boxes = [
        ([8.0, 1.2, 0.4], [0.4, 0.4, 0.4]),
        ([15.0, -1.0, 0.6], [0.5, 0.3, 0.6]),
        ([24.0, 0.8, 0.5], [0.3, 0.5, 0.5]),
        ([31.0, -1.3, 0.4], [0.4, 0.4, 0.4]),
    ]
    all_b = walls + boxes
    f32 = dict(dtype=torch.float32, device=device)
    return World(
        torch.tensor([b[0] for b in all_b], **f32),
        torch.tensor([b[1] for b in all_b], **f32),
        ground_z=0.0,
    )


def _ray_dirs(cfg: SensorConfig, device) -> torch.Tensor:
    """(H, W, 3) unit ray directions in sensor frame; row 0 = top ring,
    column azimuth spans [-pi, pi) matching an Ouster organized cloud."""
    H, W = cfg.image_height, cfg.image_width
    elev = torch.deg2rad(torch.linspace(cfg.fov_up, cfg.fov_down, H,
                                        device=device))
    azim = -torch.pi + (2 * torch.pi / W) * torch.arange(
        W, dtype=torch.float32, device=device)
    ce, se_ = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    return torch.stack([ce * ca, ce * sa, se_.expand(H, W)], dim=-1)


def _hash_noise(cell: torch.Tensor) -> torch.Tensor:
    """Deterministic value noise per integer cell (..., 3) -> [0, 1)."""
    h = torch.sin(
        cell[..., 0] * 12.9898 + cell[..., 1] * 78.233 + cell[..., 2] * 45.164
    ) * 43758.5453
    return h - torch.floor(h)


def _intensity_texture(p: torch.Tensor, normal_id: torch.Tensor) -> torch.Tensor:
    """Procedural intensity at world hit points: unique-per-cell value noise
    (two scales) + mild sinusoids."""
    x, y = p[..., 0], p[..., 1]
    n_f = _hash_noise(torch.floor(p * 4.0))   # 0.25 m cells
    n_c = _hash_noise(torch.floor(p * 1.0))   # 1 m cells
    waves = torch.sin(x * 7.3) * torch.sin(y * 9.1 + 1.7)
    base = 40.0 + 120.0 * n_f + 60.0 * n_c + 20.0 * waves
    # different surfaces get different albedo so edges are visible
    albedo = 1.0 + 0.15 * (normal_id.float() % 3.0)
    return torch.clamp(base * albedo, 1.0, 255.0)


def render_scan(pose: se3.Pose, world: World, cfg: SensorConfig,
                max_range: float = 120.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Render one organized scan from `pose` (sensor->world).

    Returns (xyz_sensor (H*W, 3), intensity (H*W,)) — points in the SENSOR
    frame, row-major, the layout `project_organized` expects.  Rays with no
    hit (or beyond max_range) are zeroed."""
    dev = pose.q.device
    dirs_s = _ray_dirs(cfg, dev)                              # (H, W, 3)
    R = se3.quat_to_mat(pose.q)
    dirs_w = torch.einsum("ij,hwj->hwi", R, dirs_s)
    origin = pose.t[None, None, :].expand(dirs_w.shape)

    big = 1e9
    # ground plane z = ground_z
    dz = dirs_w[..., 2]
    t_g = (world.ground_z - origin[..., 2]) / torch.where(
        torch.abs(dz) < 1e-6, 1e-6, dz)
    t_ground = torch.where((t_g > 0.05) & (dz < 0), t_g, big)

    # axis-aligned boxes, slab method, vectorized over boxes
    o = origin[:, :, None, :]
    d = dirs_w[:, :, None, :]
    c = world.box_centers[None, None, :, :]
    h = world.box_halves[None, None, :, :]
    inv = 1.0 / torch.where(torch.abs(d) < 1e-6, 1e-6, d)
    t1 = (c - h - o) * inv
    t2 = (c + h - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)          # (H, W, B)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= tmin) & (tmax > 0.05) & (tmin > 0.05)
    t_box = torch.where(hit, tmin, big)
    t_box_best, box_id = torch.min(t_box, dim=-1)

    t_best = torch.minimum(t_ground, t_box_best)
    surf_id = torch.where(t_box_best < t_ground, box_id + 1, 0)
    valid = t_best < min(max_range, big * 0.5)

    p_world = origin + t_best[..., None] * dirs_w
    inten = _intensity_texture(p_world, surf_id)

    xyz_sensor = torch.where(valid[..., None], t_best[..., None] * dirs_s, 0.0)
    inten = torch.where(valid, torch.clamp(inten, 1.0, 255.0), 0.0)
    return xyz_sensor.reshape(-1, 3), inten.reshape(-1)


def render_sequence(poses: se3.Pose, world: World, cfg: SensorConfig):
    """Renders each pose of a batch: returns (F, H*W, 3) xyz + (F, H*W)
    intensity."""
    outs = [render_scan(se3.Pose(poses.q[i], poses.t[i]), world, cfg)
            for i in range(poses.q.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
