"""Build a bundle-adjustment problem from the LIVE keyframe store.

PyTorch counterpart of `intensity_slam_tpu/parallel/ba_builder.py` (see its
docstring for the design): consecutive keyframes' feature sets are matched
with the front-end's mutual-NN Hamming matcher; every (keyframe, feature
slot) gets the ROOT id of its track, the flat index of its first
observation; roots are the landmark indices (L = K*F, sparse); observations
of tracks seen fewer than twice are weighted out, and each landmark starts
at the mean of its world-frame observations under the graph poses.

The reference runs a `lax.scan` of `features.match` over the K - 1
consecutive pairs.  Only the id propagation is serial, so here:

1. the K - 1 matches are computed batched over pairs (`features.match` on
   a chunk of pairs: one float32 product of +-1 descriptor bits per chunk,
   the chunk sized so that its (chunk, F, F) matrices stay under ~1 GB);
2. the parent of slot (k, f) is (k - 1, dst) where the match is valid, else
   itself, and ceil(log2 K) rounds of pointer jumping (parent =
   parent[parent]) give exactly the scan's root ids.

The integer outputs (`obs_lm`, `obs_pose`, `obs_w`, `fixed_poses`) equal the
reference's on the same descriptors: Hamming distances are integers, and
ties go to the lowest index in both.

Under a mesh the keyframe store is sharded (`dist_backend.
shard_backend_state`: each rank holds its block of keyframes plus the one
before it).  Each rank matches its block's pairs, the parent pointers are
all-gathered, the landmark sums and counts all-reduced; every rank then
holds the same landmarks and gauge, and its own block of the observation
rows.
"""

from __future__ import annotations

import math

import torch

from ..config import SlamConfig
from ..ops import features as feat_ops
from ..pipeline.loop import BackendState
from ..utils import se3
from ..utils.se3 import Pose
from .dist_ba import BAProblem, _segment_sum
from .multiproc import Mesh, all_gather_rows, all_reduce, row_block

_CHUNK_BYTES = 1 << 30


def _parents(desc, valid, k0: int, keep_frac: float, max_hamming: int) -> torch.Tensor:
    """(n - 1, F) int64 parent ids of keyframes k0+1 .. k0+n-1 given the
    feature sets of keyframes k0 .. k0+n-1 (each matched against the one
    before it)."""
    n, F = valid.shape
    chunk = max(1, _CHUNK_BYTES // (16 * F * F))
    own = torch.arange(F, device=desc.device)
    out = [torch.zeros((0, F), dtype=torch.long, device=desc.device)]
    for a in range(1, n, chunk):
        b = min(a + chunk, n)
        m = feat_ops.match(desc[a:b], valid[a:b], desc[a - 1:b - 1],
                           valid[a - 1:b - 1], keep_frac, max_hamming)
        k = torch.arange(k0 + a, k0 + b, device=desc.device)[:, None]
        out.append(torch.where(m.valid, (k - 1) * F + m.dst_idx, k * F + own))
    return torch.cat(out)


def build_problem(state: BackendState, cfg: SlamConfig,
                  mesh: Mesh | None = None) -> BAProblem:
    """BAProblem from the live keyframe store (fixed shapes: K*F observation
    rows, L = K*F landmark slots, most weighted out).  `state` may be the
    whole store (payloads at physical slots) or, under `mesh`, the sharded
    store of `dist_backend.shard_backend_state`."""
    pc, fc = cfg.parallel, cfg.feature
    K = state.graph.node_valid.shape[0]
    F = state.kf_feat_valid.shape[1]
    dev = state.kf_feat_valid.device
    lo, hi = row_block(K, mesh)
    start = max(lo - 1, 0)                  # the halo keyframe for the first pair
    desc, xyz, valid = state.kf_feat_desc, state.kf_feat_xyz, state.kf_feat_valid
    if valid.shape[0] == K:                 # the whole store: logical order
        rows = state.kf_slot.long()[start:hi]
        desc, xyz, valid = desc[rows], xyz[rows], valid[rows]
    ids = torch.arange(start, hi, device=dev)
    valid = valid & (ids < state.num_kf)[:, None]

    # parents of this rank's block [lo, hi) (keyframe 0 starts every track)
    par = _parents(desc, valid, start, pc.ba_keep_frac, fc.max_hamming)
    if lo == 0 and hi > 0:
        par = torch.cat([torch.arange(F, device=dev)[None], par])
    if mesh is not None:
        B = -(-K // mesh.size)
        pad = torch.zeros((B - (hi - lo), F), dtype=torch.long, device=dev)
        par = all_gather_rows(torch.cat([par, pad]), mesh)[:K]
    parent = par.reshape(-1)
    for _ in range(max(1, math.ceil(math.log2(K)))):
        parent = parent[parent]

    # this rank's observation rows: slots of keyframes [lo, hi)
    own = slice(lo - start, hi - start)
    lm_obs = parent[lo * F:hi * F]
    w_slot = valid[own].reshape(-1).float()
    poses = state.graph.poses
    world = se3.transform_points(Pose(poses.q[lo:hi], poses.t[lo:hi]), xyz[own])
    sums = torch.cat([_segment_sum(w_slot[:, None], lm_obs, K * F),
                      _segment_sum(w_slot[:, None] * world.reshape(-1, 3), lm_obs, K * F)],
                     dim=1)
    sums = all_reduce(sums, mesh)
    count, wsum = sums[:, 0], sums[:, 1:]
    idx = torch.arange(K, device=dev)
    return BAProblem(
        poses=poses,
        landmarks=wsum / torch.clamp(count, min=1.0)[:, None],
        obs_pose=idx[lo:hi].repeat_interleave(F).to(torch.int32),
        obs_lm=lm_obs.to(torch.int32),
        obs_z=xyz[own].reshape(-1, 3),
        obs_w=w_slot * (count[lm_obs] >= 2.0),
        fixed_poses=(idx == 0) | (idx >= state.num_kf),
    )


def track_stats(prob: BAProblem, mesh: Mesh | None = None) -> dict:
    """Host-side diagnostics: observation and track counts (for tests,
    logs); under `mesh`, over every rank's observation rows."""
    L = prob.landmarks.shape[0]
    cnt = all_reduce(_segment_sum(prob.obs_w, prob.obs_lm.long(), L), mesh)
    n_obs = all_reduce(torch.sum(prob.obs_w > 0, dtype=torch.int32), mesh)
    return {
        "num_obs": int(n_obs),
        "num_landmarks": int(torch.sum(cnt >= 2.0)),
        "max_track_len": int(cnt.max()),
    }
