"""Synthetic LiDAR world: raycast organized scans with intensity textures.

PyTorch counterpart of `intensity_slam_tpu/io/synthetic.py`: a raycaster
that renders organized (H, W) Ouster-style scans (ranges + procedurally
textured intensity) of a ground plane plus axis-aligned boxes, from
arbitrary sensor poses, on the device the poses live on.  It has the whole
realism model of the reference: rolling-shutter motion within a scan
(`delta`), dynamic boxes at `frame_time`, textureless zones, a periodic
texture, and the stochastic sensor model (`SensorNoise`), plus the
evaluation worlds and trajectories (corridor, circuit, figure-eight,
aliased corridor, any closed polyline).

Random draws.  `jax.random` streams cannot be reproduced in torch, so the
noise draws come from a `torch.Generator` (`gen`), three (H, W) arrays per
scan in the order range noise, speckle, dropout; or the caller hands those
three arrays over itself (`draws`), which is how a parity test feeds the
reference's own draws in.

Memory.  The slab test holds (H, W, B, 3) temporaries (~20 MB at 64x1024
with the circuit's 25 boxes), so `render_sequence` renders one frame at a
time and only the finished scans are stacked.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SensorConfig
from ..utils import se3


def _rows(rows, device) -> torch.Tensor:
    """A list of 3-vectors as a (n, 3) float32 tensor (n may be 0)."""
    return torch.tensor(rows, dtype=torch.float32, device=device).reshape(-1, 3)


_NONE = torch.zeros((0, 3), dtype=torch.float32)


class World(NamedTuple):
    # axis-aligned boxes: centers (B, 3), half-extents (B, 3)
    box_centers: torch.Tensor
    box_halves: torch.Tensor
    ground_z: float = 0.0
    # textureless zones (axis-aligned): world regions whose hits render at
    # CONSTANT intensity, degenerate for the intensity front-end, forcing
    # the geometric fallback.  Zero-size tensors = no zones.
    flat_centers: torch.Tensor = _NONE
    flat_halves: torch.Tensor = _NONE
    # DYNAMIC boxes (moving objects): centers at t=0, half-extents, and
    # constant world-frame velocities, rendered at center + v * time
    dyn_centers: torch.Tensor = _NONE
    dyn_halves: torch.Tensor = _NONE
    dyn_vel: torch.Tensor = _NONE
    # intensity texture tiling period along x (0 = aperiodic): physically
    # different places look identical to appearance-based loop detectors
    texture_period: float = 0.0


class SensorNoise(NamedTuple):
    """Stochastic sensor model: per-beam range noise, multiplicative
    intensity speckle, and random beam dropout.  Zero-valued fields disable
    a term."""

    range_sigma: float = 0.03         # m, 1-sigma radial noise (OS0 ~2-5 cm)
    intensity_speckle: float = 0.10   # lognormal sd of the return-strength
    # multiplier (surface micro-structure + photon noise)
    dropout_rate: float = 0.02        # per-beam probability of no return


DEFAULT_NOISE = SensorNoise()


def _world(boxes, device, flat=(), dyn=(), texture_period: float = 0.0) -> World:
    return World(
        _rows([b[0] for b in boxes], device),
        _rows([b[1] for b in boxes], device),
        ground_z=0.0,
        flat_centers=_rows([f[0] for f in flat], device),
        flat_halves=_rows([f[1] for f in flat], device),
        dyn_centers=_rows([d[0] for d in dyn], device),
        dyn_halves=_rows([d[1] for d in dyn], device),
        dyn_vel=_rows([d[2] for d in dyn], device),
        texture_period=texture_period,
    )


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
    return _world(walls + boxes, device)


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


def noise_draws(shape, gen: torch.Generator, device) -> tuple:
    """One scan's three noise draws from `gen`, in the reference's order:
    range noise (normal), speckle (normal), dropout (uniform)."""
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    return (torch.randn(shape, **kw), torch.randn(shape, **kw),
            torch.rand(shape, **kw))


def render_scan(pose: se3.Pose, world: World, cfg: SensorConfig,
                max_range: float = 120.0,
                delta: se3.Pose | None = None,
                frame_time: torch.Tensor | float = 0.0,
                noise: SensorNoise | None = None,
                gen: torch.Generator | None = None,
                return_world: bool = False,
                draws: tuple | None = None,
                ) -> tuple[torch.Tensor, ...]:
    """Render one organized scan from `pose` (sensor->world at SCAN START).

    Returns (xyz_sensor (H*W, 3), intensity (H*W,)) — points in the SENSOR
    frame, row-major, the layout `project_organized` expects.  Rays with no
    hit (or beyond max_range) are zeroed.

    - `delta`: the sensor's motion over ONE scan period (scan start -> scan
      end, sensor frame).  Column c fires from pose o delta^(c/W), and its
      point is r * dir in the COLUMN'S OWN sensor frame (rolling shutter,
      what `slam.undistort_scan` corrects).
    - `frame_time` + `world.dyn_*`: dynamic boxes at center + v * time.
    - `noise` + `gen` (or `draws`, the three (H, W) arrays of
      `noise_draws`): range noise, intensity speckle, dropout.
    - `return_world`: also the noise-free world hit points (H*W, 3).
    """
    H, W = cfg.image_height, cfg.image_width
    dev = pose.q.device
    dirs_s = _ray_dirs(cfg, dev)                              # (H, W, 3)
    if delta is not None:
        # per-column firing pose: pose o delta^(c/W)
        alpha = (torch.arange(W, dtype=torch.float32, device=dev) / W)[:, None]
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        q_c = se3.quat_normalize(
            se3.quat_mul(pose.q[None, :], se3.slerp(ident, delta.q, alpha)))
        t_c = pose.t[None, :] + se3.quat_rotate(
            pose.q[None, :], alpha * delta.t[None, :])        # (W, 3)
        R_c = se3.quat_to_mat(q_c)                            # (W, 3, 3)
        dirs_w = torch.einsum("wij,hwj->hwi", R_c, dirs_s)
        origin = t_c[None, :, :].expand(H, W, 3)
    else:
        R = se3.quat_to_mat(pose.q)
        dirs_w = torch.einsum("ij,hwj->hwi", R, dirs_s)
        origin = pose.t[None, None, :].expand(H, W, 3)

    big = 1e9
    # ground plane z = ground_z
    dz = dirs_w[..., 2]
    t_g = (world.ground_z - origin[..., 2]) / torch.where(
        torch.abs(dz) < 1e-6, 1e-6, dz)
    t_ground = torch.where((t_g > 0.05) & (dz < 0), t_g, big)

    # axis-aligned boxes, slab method, vectorized over boxes (static +
    # time-advected dynamic)
    centers, halves = world.box_centers, world.box_halves
    n_dyn = world.dyn_centers.shape[0]
    if n_dyn > 0:
        t_now = torch.as_tensor(frame_time, dtype=torch.float32, device=dev)
        centers = torch.cat([centers, world.dyn_centers + world.dyn_vel * t_now])
        halves = torch.cat([halves, world.dyn_halves])
    o = origin[:, :, None, :]
    d = dirs_w[:, :, None, :]
    c = centers[None, None, :, :]
    h = halves[None, None, :, :]
    inv = 1.0 / torch.where(torch.abs(d) < 1e-6, 1e-6, d)
    t1 = (c - h - o) * inv
    t2 = (c + h - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)          # (H, W, B)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    del t1, t2, inv
    hit = (tmax >= tmin) & (tmax > 0.05) & (tmin > 0.05)
    t_box = torch.where(hit, tmin, big)
    t_box_best, box_id = torch.min(t_box, dim=-1)

    t_best = torch.minimum(t_ground, t_box_best)
    surf_id = torch.where(t_box_best < t_ground, box_id + 1, 0)
    valid = t_best < min(max_range, big * 0.5)

    p_world = origin + t_best[..., None] * dirs_w
    p_tex = p_world
    if world.texture_period > 0:
        p_tex = torch.cat([torch.remainder(p_world[..., :1], world.texture_period),
                           p_world[..., 1:]], dim=-1)
    inten = _intensity_texture(p_tex, surf_id)
    # textureless zones: constant return inside any flat box
    if world.flat_centers.shape[0] > 0:
        rel = torch.abs(p_world[:, :, None, :] - world.flat_centers[None, None])
        in_zone = torch.any(
            torch.all(rel <= world.flat_halves[None, None], dim=-1), dim=-1)
        inten = torch.where(in_zone, 100.0, inten)
    # dynamic surfaces get a constant albedo of their own
    if n_dyn > 0:
        inten = torch.where(surf_id > world.box_centers.shape[0], 140.0, inten)

    if noise is not None and (gen is not None or draws is not None):
        if draws is None:
            draws = noise_draws((H, W), gen, dev)
        d_r, d_s, d_d = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                         for a in draws)
        if noise.range_sigma > 0:
            t_best = t_best + noise.range_sigma * d_r
        if noise.intensity_speckle > 0:
            inten = inten * torch.exp(noise.intensity_speckle * d_s)
        if noise.dropout_rate > 0:
            valid = valid & (d_d >= noise.dropout_rate)

    xyz_sensor = torch.where(valid[..., None], t_best[..., None] * dirs_s, 0.0)
    inten = torch.where(valid, torch.clamp(inten, 1.0, 255.0), 0.0)
    if return_world:
        # the TRUE (noise-free-ray) world hit points
        pw = torch.where(valid[..., None], p_world, 0.0)
        return xyz_sensor.reshape(-1, 3), inten.reshape(-1), pw.reshape(-1, 3)
    return xyz_sensor.reshape(-1, 3), inten.reshape(-1)


def corridor_trajectory(num_frames: int, speed: float = 0.3,
                        yaw_rate: float = 0.0, height: float = 0.8,
                        device="cuda") -> se3.Pose:
    """Ground-truth poses (num_frames batch): forward motion along +x with
    optional constant yaw rate; sensor at `height` above ground."""
    yaw = yaw_rate * torch.arange(num_frames, dtype=torch.float32)
    dx = speed * torch.cos(yaw)
    dy = speed * torch.sin(yaw)
    zero = torch.zeros(1)
    x = torch.cat([zero, torch.cumsum(dx, 0)[:-1]])
    y = torch.cat([zero, torch.cumsum(dy, 0)[:-1]])
    q = se3.so3_exp(torch.stack([torch.zeros_like(yaw), torch.zeros_like(yaw), yaw], -1))
    t = torch.stack([x, y, torch.full_like(x, height)], -1)
    return se3.Pose(q.to(device), t.to(device))


def circuit_world(textureless: bool = True, dynamic: bool = False,
                  device="cuda") -> World:
    """The hard-benchmark world: a rectangular corridor CIRCUIT around a
    32 x 22 m inner block (~140 m per lap) with pillar/box clutter, two
    rooms (alcoves) at opposite corners, and (optionally) a 12 m
    TEXTURELESS span on the far leg where intensity odometry must hand over
    to the geometric fallback; `dynamic` adds a walking person and a cart.
    Revisiting the start closes the loop."""
    wall_h = 1.6
    walls = [
        # outer boundary: x in [-4, 44], y in [-4, 34]
        ([20.0, -4.2, wall_h], [25.0, 0.2, wall_h]),   # south
        ([20.0, 34.2, wall_h], [25.0, 0.2, wall_h]),   # north
        ([-4.2, 15.0, wall_h], [0.2, 20.0, wall_h]),   # west
        ([44.2, 15.0, wall_h], [0.2, 20.0, wall_h]),   # east
        # inner block: [4, 36] x [4, 26] (its faces are the inner walls)
        ([20.0, 15.0, wall_h], [16.0, 11.0, wall_h]),
        # room alcoves off the south leg near the start and the north leg
        ([8.0, -7.0, wall_h], [4.0, 0.2, wall_h]),     # room 1 far wall
        ([3.8, -5.5, wall_h], [0.2, 1.5, wall_h]),     # room 1 side
        ([12.2, -5.5, wall_h], [0.2, 1.5, wall_h]),    # room 1 side
        ([30.0, 37.0, wall_h], [4.0, 0.2, wall_h]),    # room 2 far wall
        ([25.8, 35.5, wall_h], [0.2, 1.5, wall_h]),
        ([34.2, 35.5, wall_h], [0.2, 1.5, wall_h]),
    ]
    boxes = [
        ([9.0, 1.5, 0.4], [0.4, 0.4, 0.4]),
        ([18.0, -1.8, 0.6], [0.5, 0.3, 0.6]),
        ([28.0, 1.2, 0.5], [0.3, 0.5, 0.5]),
        ([41.5, 8.0, 0.4], [0.4, 0.4, 0.4]),
        ([38.5, 18.0, 0.5], [0.4, 0.3, 0.5]),
        ([33.0, 28.6, 0.5], [0.4, 0.4, 0.5]),
        ([10.0, 31.5, 0.6], [0.3, 0.4, 0.6]),
        # clutter INSIDE the textureless span: constant intensity but real
        # geometric corners, so the fallback can observe forward motion
        ([16.0, 29.5, 0.5], [0.4, 0.4, 0.5]),
        ([20.5, 33.2, 0.6], [0.3, 0.4, 0.6]),
        ([24.0, 30.2, 0.5], [0.4, 0.3, 0.5]),
        ([1.5, 22.0, 0.4], [0.4, 0.4, 0.4]),
        ([-1.5, 10.0, 0.5], [0.3, 0.3, 0.5]),
        ([6.0, -5.8, 0.4], [0.3, 0.3, 0.4]),           # room 1 furniture
        ([31.5, 35.8, 0.4], [0.3, 0.3, 0.4]),          # room 2 furniture
    ]
    flat = ([([20.0, 30.0, wall_h], [6.0, 5.0, wall_h + 0.5])]  # north-leg span
            if textureless else [])
    # a walking "person" pacing the south corridor and a cart drifting down
    # the east leg: moving geometry every lap passes twice
    dyn = ([([30.0, 0.3, 0.85], [0.25, 0.25, 0.85], [-0.5, 0.0, 0.0]),
            ([40.2, 12.0, 0.6], [0.3, 0.4, 0.6], [0.0, 0.35, 0.0])]
           if dynamic else [])
    return _world(walls + boxes, device, flat=flat, dyn=dyn)


def circuit_trajectory(num_frames: int, speed: float = 0.4,
                       height: float = 0.8, turn_frames: int = 10,
                       device="cuda") -> se3.Pose:
    """Ground-truth circuit path: counter-clockwise laps of the corridor
    rectangle (0,0) -> (40,0) -> (40,30) -> (0,30) -> (0,0) with smooth
    quarter-turns; repeats until num_frames.  ~140 m per lap.  Composed
    pose by pose in float32 on the host, as the reference does."""
    legs = [40.0, 30.0, 40.0, 30.0]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    ident = f32([1.0, 0.0, 0.0, 0.0])
    pose = se3.Pose(ident, f32([0.0, 0.0, height]))
    fwd = se3.Pose(ident, f32([speed, 0.0, 0.0]))
    dyaw = (math.pi / 2) / turn_frames
    turn = se3.Pose(se3.so3_exp(f32([0.0, 0.0, dyaw])), f32([speed * 0.4, 0.0, 0.0]))
    qs, ts = [], []
    leg, dist_in_leg = 0, 0.0
    while len(qs) < num_frames:
        qs.append(pose.q)
        ts.append(pose.t)
        if dist_in_leg + speed >= legs[leg % 4]:
            # quarter turn over turn_frames while creeping forward
            for _ in range(turn_frames):
                if len(qs) >= num_frames:
                    break
                pose = se3.compose(pose, turn)
                qs.append(pose.q)
                ts.append(pose.t)
            leg += 1
            dist_in_leg = 0.0
        else:
            pose = se3.compose(pose, fwd)
            dist_in_leg += speed
    return se3.Pose(torch.stack(qs[:num_frames]).to(device),
                    torch.stack(ts[:num_frames]).to(device))


def polyline_trajectory(waypoints, num_frames: int, speed: float = 0.4,
                        height: float = 0.8, yaw_smooth: int = 8,
                        device="cuda") -> se3.Pose:
    """Ground-truth path along a closed 2-D polyline at `speed` m/frame,
    heading along the direction of motion (yaw smoothed over `yaw_smooth`
    frames so corners are sharp-but-trackable turns).  Wraps around the
    waypoint list until `num_frames`.  Computed in float64 numpy, as the
    reference does, then cast to float32."""
    wps = np.asarray(waypoints, np.float64)
    n = len(wps)
    pos, yaw = [], []
    seg, s = 0, 0.0
    while len(pos) < num_frames:
        a, b = wps[seg % n], wps[(seg + 1) % n]
        L = float(np.linalg.norm(b - a))
        if s >= L:
            s -= L
            seg += 1
            continue
        d = (b - a) / L
        pos.append(a + s * d)
        yaw.append(np.arctan2(d[1], d[0]))
        s += speed
    pos = np.asarray(pos)
    yaw = np.unwrap(np.asarray(yaw))
    if yaw_smooth > 1:
        k = np.ones(yaw_smooth) / yaw_smooth
        pad = yaw_smooth // 2
        yaw = np.convolve(np.pad(yaw, (pad, yaw_smooth - 1 - pad), mode="edge"),
                          k, mode="valid")
    half = 0.5 * yaw
    q = np.stack([np.cos(half), np.zeros_like(half), np.zeros_like(half),
                  np.sin(half)], axis=-1)
    t = np.concatenate([pos, np.full((len(pos), 1), height)], axis=-1)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return se3.Pose(as_t(q), as_t(t))


def figure_eight_world(device="cuda") -> World:
    """Figure-eight building: an outer rectangle with TWO inner blocks and a
    shared middle corridor (y ~ 11) that the figure-eight path traverses
    twice per cycle: early AND frequent revisits."""
    wall_h = 1.6
    walls = [
        ([20.0, -4.2, wall_h], [25.0, 0.2, wall_h]),   # outer south
        ([20.0, 26.2, wall_h], [25.0, 0.2, wall_h]),   # outer north
        ([-4.2, 11.0, wall_h], [0.2, 15.4, wall_h]),   # outer west
        ([44.2, 11.0, wall_h], [0.2, 15.4, wall_h]),   # outer east
        ([20.0, 6.0, wall_h], [16.0, 2.0, wall_h]),    # south inner block
        ([20.0, 16.0, wall_h], [16.0, 2.0, wall_h]),   # north inner block
    ]
    boxes = [
        ([8.0, 1.4, 0.4], [0.4, 0.4, 0.4]),
        ([22.0, -1.6, 0.5], [0.4, 0.3, 0.5]),
        ([34.0, 1.2, 0.5], [0.3, 0.4, 0.5]),
        ([41.6, 5.5, 0.4], [0.4, 0.4, 0.4]),
        ([12.0, 10.2, 0.5], [0.3, 0.3, 0.5]),          # middle corridor
        ([27.0, 12.0, 0.4], [0.4, 0.3, 0.4]),
        ([2.0, 17.5, 0.5], [0.3, 0.4, 0.5]),
        ([15.0, 24.4, 0.4], [0.4, 0.4, 0.4]),
        ([31.0, 20.8, 0.5], [0.3, 0.3, 0.5]),
        ([38.0, 24.0, 0.4], [0.4, 0.3, 0.4]),
    ]
    return _world(walls + boxes, device)


def figure_eight_trajectory(num_frames: int, speed: float = 0.4,
                            device="cuda") -> se3.Pose:
    """Figure-eight over figure_eight_world: south loop then north loop,
    both sharing the westbound middle-corridor leg (y = 11)."""
    wps = [(0.0, 0.0), (40.0, 0.0), (40.0, 11.0), (0.0, 11.0),
           (0.0, 22.0), (40.0, 22.0), (40.0, 11.0), (0.0, 11.0)]
    return polyline_trajectory(wps, num_frames, speed, device=device)


def aliased_corridor_world(period: float = 10.0, device="cuda") -> World:
    """A long corridor whose geometry AND intensity texture repeat every
    `period` meters: every section looks like every other section to an
    appearance-based detector."""
    wall_h = 1.6
    L = 80.0
    walls = [
        ([L / 2, 2.2, wall_h], [L / 2 + 4.0, 0.2, wall_h]),
        ([L / 2, -2.2, wall_h], [L / 2 + 4.0, 0.2, wall_h]),
        ([L + 3.5, 0.0, wall_h], [0.5, 3.0, wall_h]),
        ([-3.5, 0.0, wall_h], [0.5, 3.0, wall_h]),
    ]
    boxes = []
    x0 = 5.0
    while x0 < L - 1.0:
        # IDENTICAL furniture per period: a pillar pair + an off-center box
        boxes.append(([x0, 1.5, 0.6], [0.25, 0.25, 0.6]))
        boxes.append(([x0, -1.5, 0.6], [0.25, 0.25, 0.6]))
        boxes.append(([x0 + 4.0, -0.9, 0.4], [0.35, 0.35, 0.4]))
        x0 += period
    return _world(walls + boxes, device, texture_period=period)


def aliased_corridor_trajectory(num_frames: int, speed: float = 0.4,
                                device="cuda") -> se3.Pose:
    """Out to x = 78 and back: the whole return leg is revisits."""
    return polyline_trajectory([(0.0, 0.0), (78.0, 0.0)], num_frames, speed,
                               device=device)


def scan_deltas(poses: se3.Pose) -> se3.Pose:
    """[F] per-scan motion pose_i^-1 o pose_{i+1}; the last frame reuses the
    previous delta (constant velocity)."""
    F = poses.q.shape[0]
    nxt = se3.Pose(torch.roll(poses.q, -1, 0), torch.roll(poses.t, -1, 0))
    deltas = se3.compose(se3.inverse(poses), nxt)
    if F > 1:
        deltas = se3.pose_map(
            lambda a: torch.cat([a[:-1], a[-2:-1]]), deltas)
    return deltas


def relative_positions(poses: se3.Pose) -> torch.Tensor:
    """(F, 3) positions of `poses` in the frame of the first: the ground
    truth of an estimate that starts at the identity."""
    p0 = se3.inverse(se3.Pose(poses.q[0], poses.t[0]))
    return se3.compose(p0, poses).t


def render_sequence(poses: se3.Pose, world: World, cfg: SensorConfig,
                    distort: bool = False,
                    noise: SensorNoise | None = None,
                    gen: torch.Generator | None = None,
                    times: torch.Tensor | None = None):
    """Renders each pose of a batch, ONE frame at a time: returns (F, H*W, 3)
    xyz + (F, H*W) intensity.

    `distort=True` renders each frame with its true per-column firing poses
    (inter-frame motion as the per-scan delta); `noise`+`gen` turn on the
    stochastic sensor model (frame by frame from the one generator);
    `times` (F,) drives dynamic objects."""
    F = poses.q.shape[0]
    if times is None:
        times = torch.arange(F, dtype=torch.float32, device=poses.q.device) * cfg.scan_period
    deltas = scan_deltas(poses) if distort else None
    xs, its = [], []
    for i in range(F):
        x, it = render_scan(
            se3.Pose(poses.q[i], poses.t[i]), world, cfg,
            delta=se3.Pose(deltas.q[i], deltas.t[i]) if distort else None,
            frame_time=times[i], noise=noise, gen=gen)
        xs.append(x)
        its.append(it)
    return torch.stack(xs), torch.stack(its)
