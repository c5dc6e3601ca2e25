"""Fixed-iteration trimmed ICP — loop-closure verification (reference C10).

PyTorch counterpart of `intensity_slam_tpu/ops/icp.py`, the PCL ICP use in
`loopClosureThread` (`src/intensity_feature_tracker.cpp:216-316`): each
iteration is one masked nearest-neighbour pass (`ops.pallas_nn`, the CUDA
kernel on the card) and one closed-form weighted Umeyama update (its 3x3
SVD the `csrc/svd3.cu` kernel on the card, `ops.svd3`); 32 iterations plus a
final pass = 33 nearest-neighbour and 32 SVD launches per alignment, all on
one pack of the target cloud's valid points, and no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import index, se3
from ..utils.se3 import Pose
from . import pallas_nn, svd3


class ICPResult(NamedTuple):
    pose: Pose                  # T such that T(src) aligns to tgt
    fitness: torch.Tensor       # () mean squared distance of inlier correspondences
    inlier_frac: torch.Tensor   # () fraction of source points within radius
    num_corr: torch.Tensor      # () int32 accepted correspondences at exit
    converged: torch.Tensor     # () bool — last update below epsilon
    nn_idx: torch.Tensor        # (P,) int32 final NN index into tgt per src point
    inlier: torch.Tensor        # (P,) bool — src point within fitness_radius of NN


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` of a 1-D tensor: the MEAN of the two middle values for
    an even count (`torch.nanmedian` takes the lower one); NaN when every
    entry is NaN.  No host read."""
    s, _ = torch.sort(x)                       # NaNs sort last
    n = torch.sum(~torch.isnan(x))
    last = x.shape[0] - 1
    lo = index.take(s, torch.clamp((n - 1) // 2, 0, last))
    hi = index.take(s, torch.clamp(n // 2, 0, last))
    return torch.where(n > 0, 0.5 * lo + 0.5 * hi, torch.nan)


def _nn(src_w: torch.Tensor, src_mask, packed: pallas_nn.PackedTargets):
    j, dj = pallas_nn.nearest_neighbor_packed(src_w.contiguous(), packed)
    dj = torch.where(src_mask & (dj < 1e29), dj, torch.inf)
    return j.long(), dj


def _umeyama_step(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor) -> Pose:
    """Weighted closed-form rigid alignment (Horn/Umeyama, no scale)."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_t = torch.sum(tgt * w[:, None], dim=0) / wsum
    cov = torch.einsum("ni,nj,n->ij", tgt - mu_t, src - mu_s, w) / wsum
    U, _, Vt = svd3.svd3(cov)      # the reflection fixed: U @ Vt is the rotation
    R = U @ Vt
    t = mu_t - R @ mu_s
    return Pose(se3.mat_to_quat(R), t)


def icp_align(
    src: torch.Tensor, src_mask: torch.Tensor,
    tgt: torch.Tensor, tgt_mask: torch.Tensor,
    init: Pose,
    iters: int = 32,
    max_corr_dist: float = 100.0,
    fitness_radius: float = 1.0,
    eps: float = 1e-6,
) -> ICPResult:
    """Align src to tgt starting from `init`; fixed `iters` iterations."""
    max_sq = max_corr_dist * max_corr_dist
    # the 33 searches share one target cloud: pack its valid points once
    packed = pallas_nn.pack_targets(tgt.contiguous(), tgt_mask.contiguous())
    pose = init
    floor = torch.full((), 1e-6, device=src.device)
    last_step = torch.full((), torch.inf, device=src.device)
    for _ in range(iters):
        src_w = se3.transform_points(pose, src)
        j, dj = _nn(src_w, src_mask, packed)
        acc = torch.isfinite(dj) & (dj <= max_sq)
        # trimming: reject correspondences beyond 9x the median accepted
        # squared distance (partial overlap leaves forced, biased NNs)
        med = nanmedian(torch.where(acc, dj, torch.nan))
        trim = torch.maximum(9.0 * med, floor)
        w = (acc & (dj <= trim)).float()
        upd = _umeyama_step(src_w, tgt[j], w)
        # guard: with no correspondences keep the pose
        has = torch.sum(w) >= 3
        pose = se3.pose_where(has, se3.compose(upd, pose), pose)
        last_step = torch.sqrt(torch.sum(se3.se3_log(upd) ** 2))
    src_w = se3.transform_points(pose, src)
    j, dj = _nn(src_w, src_mask, packed)
    n_src = torch.clamp(torch.sum(src_mask), min=1)
    inl = torch.isfinite(dj) & (dj <= fitness_radius * fitness_radius)
    n_inl = torch.sum(inl)
    fitness = torch.where(
        n_inl > 0,
        torch.sum(torch.where(inl, dj, 0.0)) / torch.clamp(n_inl, min=1),
        torch.inf,
    )
    return ICPResult(
        pose=pose,
        fitness=fitness,
        inlier_frac=n_inl / n_src,
        num_corr=n_inl.to(torch.int32),
        converged=last_step < eps * 10 + 1e-4,
        nn_idx=j.to(torch.int32),
        inlier=inl,
    )


def intensity_correlation(
    src_int: torch.Tensor,   # (P,) per-point intensity of the source cloud
    tgt_int: torch.Tensor,   # (M,) target cloud intensities
    res: ICPResult,
) -> torch.Tensor:
    """Pearson correlation of intensities over the converged ICP's inlier
    correspondences — the appearance half of loop verification.  Neutral
    (1.0) with fewer than 8 inlier pairs or near-zero intensity variance on
    either side."""
    w = res.inlier.float()
    n = torch.sum(w)
    a = src_int
    b = tgt_int[res.nn_idx.long()]
    ma = torch.sum(a * w) / torch.clamp(n, min=1.0)
    mb = torch.sum(b * w) / torch.clamp(n, min=1.0)
    va = torch.sum(w * (a - ma) ** 2)
    vb = torch.sum(w * (b - mb) ** 2)
    cov = torch.sum(w * (a - ma) * (b - mb))
    corr = cov / torch.clamp(torch.sqrt(va * vb), min=1e-6)
    # informative = both sides vary by more than ~1 intensity unit RMS
    informative = (va > n) & (vb > n) & (n >= 8)
    return torch.where(informative, corr, 1.0)
