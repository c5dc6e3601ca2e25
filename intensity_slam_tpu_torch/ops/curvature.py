"""A-LOAM curvature feature extraction (reference C11).

PyTorch counterpart of `intensity_slam_tpu/ops/curvature.py`, which
replicates `src/scanRegistration.cpp`:

- curvature per point: squared norm of the sum of coordinate differences to
  the +/-5 same-ring neighbours (`:397-412`), divided by range^2
- per ring, 6 azimuth segments (`:437`); per segment, by curvature: 2 sharp
  corners + 20 less-sharp (curv > 0.1, `:456,472-500`), 4 flat (curv < 0.1,
  `:521-536`), remaining flat-ish points voxel-downsampled 0.2 into
  less-flat (`:560-565`)
- neighbour suppression: local-max NMS over +/-5 columns before the
  per-segment pick (`:476-485`)
- points closer than the removal radius are dropped (`:241,695`)

Rings are image rows, so the window sums and maxima are rolls along the row
axis (wrapping azimuth).  `_forward_window_reduce` keeps the JAX package's
prefix-doubling order, so the box sums add the same pairs of floats as the
reference does.  Per-segment picks use a stable descending sort: equal
scores (the eligibility masks make long runs of -inf) come out in column
order, as `jax.lax.top_k` gives them.  Everything emits fixed-capacity point
buffers + masks, with a leading session axis when the scan has one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GeometricConfig, SensorConfig
from ..utils import index
from .projection import ScanImage
from .voxel import voxel_downsample


class FeatureClouds(NamedTuple):
    sharp: torch.Tensor          # (Ns, 3) corner points (strongest)
    sharp_mask: torch.Tensor     # (Ns,)
    sharp_ring: torch.Tensor     # (Ns,) int32 ring index
    less_sharp: torch.Tensor     # (Nl, 3)
    less_sharp_mask: torch.Tensor
    less_sharp_ring: torch.Tensor
    flat: torch.Tensor           # (Nf, 3)
    flat_mask: torch.Tensor
    flat_ring: torch.Tensor
    less_flat: torch.Tensor      # (Nd, 3) downsampled surface points
    less_flat_mask: torch.Tensor


def _forward_window_reduce(x: torch.Tensor, k: int, op) -> torch.Tensor:
    """Associative reduce over the forward window [i, i+k-1] along the last
    axis with wraparound, by prefix doubling: reduces over power-of-two
    spans with log2(k) shifted `op`s, then the spans of k's binary
    decomposition combined from the largest down."""
    pows = [(1, x)]
    m, p = x, 1
    while p * 2 <= k:
        m = op(m, torch.roll(m, -p, dims=-1))
        p *= 2
        pows.append((p, m))
    total, off, rem = None, 0, k
    for p, arr in reversed(pows):
        if rem >= p:
            part = torch.roll(arr, -off, dims=-1) if off else arr
            total = part if total is None else op(total, part)
            off += p
            rem -= p
    return total


def _row_conv_sum(x: torch.Tensor, half: int) -> torch.Tensor:
    """Sum over a +/-half window along the last axis with wraparound."""
    fwd = _forward_window_reduce(x, 2 * half + 1, torch.add)
    return torch.roll(fwd, half, dims=-1)


def compute_curvature(scan: ScanImage, half: int = 5):
    """Returns (curvature (H, W), window_valid (H, W)).  The curvature is
    range-normalized (the sum-of-differences norm over range^2), so that it
    is scale-free: smooth walls score low at any range, physical kinks
    high."""
    chans = torch.cat([scan.xyz.movedim(-1, 0), scan.valid[None].float()])
    sums = _row_conv_sum(chans, half)
    diff = sums[:3] - (2 * half + 1) * scan.xyz.movedim(-1, 0)
    curv = torch.sum(diff * diff, dim=0) / torch.clamp(scan.range, min=0.1) ** 2
    # a window is only meaningful if every contributing point is valid
    window_valid = scan.valid & (sums[3] >= (2 * half + 1) - 0.5)
    return curv, window_valid


def _nms_row(score: torch.Tensor, radius: int) -> torch.Tensor:
    """True where score is the max of its +/-radius row neighbourhood
    (wrapping)."""
    fwd = _forward_window_reduce(score, 2 * radius + 1, torch.maximum)
    pooled = torch.roll(fwd, radius, dims=-1)
    return score >= pooled


def _topk_per_segment_multi(scores: list, eligibles: list, ks: list,
                            num_segments: int):
    """Per-(ring, segment) top-k for several (score, eligible, k) channels in
    one stable descending sort: the channels stack on a leading axis and each
    slices its own prefix.  Returns [(rows, cols, ok), ...] aligned with the
    inputs, each (..., H * S * k_c)."""
    lead = scores[0].shape[:-2]
    H, W = scores[0].shape[-2:]
    seg_w = W // num_segments
    kmax = max(ks)
    dev = scores[0].device
    s = torch.stack([torch.where(e, sc, -torch.inf)
                     for sc, e in zip(scores, eligibles)])
    s = s[..., : seg_w * num_segments].reshape(
        (len(scores),) + lead + (H, num_segments, seg_w))
    val, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    val, idx = val[..., :kmax], idx[..., :kmax]          # (C, ..., H, S, kmax)
    col = idx + torch.arange(num_segments, device=dev)[:, None] * seg_w
    row = torch.arange(H, device=dev)[:, None, None].expand(col.shape)
    ok = torch.isfinite(val)
    out = []
    for c, k_per in enumerate(ks):
        out.append(tuple(a[c, ..., :k_per].reshape(lead + (-1,))
                         for a in (row, col, ok)))
    return out


def extract_features(
    scan: ScanImage, sensor_cfg: SensorConfig, cfg: GeometricConfig
) -> FeatureClouds:
    curv, wvalid = compute_curvature(scan)
    # removal radius (`remove_radius` 0.3, scanRegistration.cpp:695)
    far_enough = scan.range > cfg.min_range
    # occlusion / parallel-beam exclusion (`scanRegistration.cpp:412-436`
    # generalized to both scan directions): at an azimuth range jump the
    # points on the FARTHER side are where background emerges from behind
    # the occluder and ride the viewpoint; the nearer side is the occluder's
    # own edge and stays.  The gap threshold is absolute + relative; only
    # valid neighbours count.
    r = scan.range
    v = scan.valid
    lf, rt = torch.roll(r, 1, dims=-1), torch.roll(r, -1, dims=-1)
    gap = 0.3 + 0.05 * r
    v_next = torch.roll(v, -1, dims=-1)
    e1 = (r - rt > gap) & v & v_next        # i farther than i+1
    e2 = (rt - r > gap) & v & v_next        # i+1 farther than i
    occ = torch.zeros_like(e1)
    for d in range(0, 6):
        occ = occ | torch.roll(e1, -d, dims=-1)  # e1 at i+d marks i..i+5
    for d in range(1, 7):
        occ = occ | torch.roll(e2, d, dims=-1)   # e2 at i-d marks i+1..i+6
    # near-parallel beams: both azimuth neighbour diffs > 2 % of range
    parallel = ((torch.abs(r - lf) > 0.02 * r)
                & (torch.abs(rt - r) > 0.02 * r))
    base_ok = wvalid & far_enough & ~occ & ~parallel

    # corners: high curvature, locally maximal; flats: lowest curvature.
    # ELIGIBILITY uses the scale-free normalized curvature; RANKING uses the
    # raw (range-scaled) measure, which prefers near, strong edges.
    curv_raw = curv * torch.clamp(scan.range, min=0.1) ** 2
    corner_elig = base_ok & (curv > cfg.curvature_threshold)
    nms = _nms_row(torch.where(corner_elig, curv_raw, -torch.inf), 5)
    flat_elig = base_ok & (curv < cfg.curvature_threshold)
    (sharp_r, sharp_c, sharp_ok), (ls_r, ls_c, ls_ok), (fl_r, fl_c, fl_ok) \
        = _topk_per_segment_multi(
            [curv_raw, curv_raw, -curv],
            [corner_elig & nms, corner_elig, flat_elig],
            [cfg.sharp_per_segment, cfg.less_sharp_per_segment,
             cfg.flat_per_segment],
            cfg.num_segments,
        )

    batch = scan.range.dim() - 2

    def gather(rr, cc, ok):
        return (index.at(scan.xyz, rr, cc, batch=batch),
                ok & index.at(scan.valid, rr, cc, batch=batch), rr.to(torch.int32))

    sharp, sharp_m, sharp_ring = gather(sharp_r, sharp_c, sharp_ok)
    less_sharp, less_sharp_m, ls_ring = gather(ls_r, ls_c, ls_ok)
    flat, flat_m, flat_ring = gather(fl_r, fl_c, fl_ok)

    # less-flat: flat-eligible points, azimuth-strided, voxel-downsampled
    # (`:560-565`); the capacity bounds the buffer
    stride = max(1, cfg.less_flat_column_stride)
    lead = scan.range.shape[:-2]
    all_flat_pts = scan.xyz[..., ::stride, :].reshape(lead + (-1, 3))
    all_flat_mask = flat_elig[..., ::stride].reshape(lead + (-1,))
    less_flat, less_flat_m = voxel_downsample(
        all_flat_pts, all_flat_mask, cfg.less_flat_voxel, cfg.max_surf_points
    )
    return FeatureClouds(
        sharp, sharp_m, sharp_ring,
        less_sharp, less_sharp_m, ls_ring,
        flat, flat_m, flat_ring,
        less_flat, less_flat_m,
    )
