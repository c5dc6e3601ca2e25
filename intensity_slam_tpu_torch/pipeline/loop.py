"""Loop-closure back-end: keyframe store, detection, ICP verify, PGO.

PyTorch counterpart of `intensity_slam_tpu/pipeline/loop.py` (the
reference's back-end threads CS-4/CS-5, `src/intensity_feature_tracker.cpp:
195-595`), one call per keyframe:

- ingestion: pose-graph node from the map-frame pose; the voxel-downsampled
  keyframe cloud, its ScanContext descriptor and BoW signature enter the
  fixed-capacity store (payload arrays by PHYSICAL slot, `kf_slot` maps
  logical keyframe -> slot, exactly the JAX state layout)
- detection: ScanContext and BoW channels (and the optional kd-radius one),
  candidates pre-filtered by the linear-in-path drift envelope
- verification: trimmed ICP of the current cloud against the loop
  keyframe's +/-1 submap in its local frame (the CUDA nearest-neighbour
  kernel on the card), intensity-correlation, chi2 and PCM gates
- on acceptance: loop edge + the dense PGO solve

The JAX package's three `lax.cond`s (capacity compaction, "candidate found",
"loop accepted") are Python `if`s on device scalars here: one host read
each, plus one inside `posegraph.consistent_loop_mask`.  `BackendOutput`
hands the last one out (`accepted`), so a caller need not read it again.  Functions return
new state tensors and leave their inputs untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import bow, icp, scancontext
from ..ops.voxel import compact, voxel_downsample
from ..utils import index, se3
from ..utils.se3 import Pose
from . import posegraph


class BackendState(NamedTuple):
    """Keyframe back-end state; field for field the JAX `BackendState`
    (payload arrays are indexed by PHYSICAL slot, the rest logically)."""

    graph: posegraph.PoseGraph
    kf_cloud: torch.Tensor       # (K, P, 3) sensor-frame subsampled clouds [PHYS]
    kf_cloud_mask: torch.Tensor  # (K, P)                                  [PHYS]
    kf_cloud_int: torch.Tensor   # (K, P) per-point intensity              [PHYS]
    kf_sc: torch.Tensor          # (K, R, S)
    kf_ringkey: torch.Tensor     # (K, R)
    kf_sig: torch.Tensor         # (K, V, 9) int32 BoW signatures
    kf_time: torch.Tensor        # (K,)
    num_kf: torch.Tensor         # () int32
    kf_feat_desc: torch.Tensor   # (K, F, 8) int32 words                   [PHYS]
    kf_feat_xyz: torch.Tensor    # (K, F, 3)                               [PHYS]
    kf_feat_valid: torch.Tensor  # (K, F)                                  [PHYS]
    kf_raw: Pose                 # [K] raw map pose at ingestion
    kf_ground: torch.Tensor      # (K, Pg, 3)                              [PHYS]
    kf_ground_mask: torch.Tensor # (K, Pg)                                 [PHYS]
    kf_corner: torch.Tensor      # (K, Pc, 3)                              [PHYS]
    kf_corner_mask: torch.Tensor # (K, Pc)                                 [PHYS]
    last_loop_kf: torch.Tensor   # () int32 keyframe of the last accepted loop
    kf_slot: torch.Tensor        # (K,) int32 logical keyframe -> physical slot
    free_slots: torch.Tensor     # (K,) int32 stack of free physical slots
    free_count: torch.Tensor     # () int32 — always K - num_kf


class SmallState(NamedTuple):
    """The control half of BackendState (everything but payloads)."""

    graph: posegraph.PoseGraph
    kf_sc: torch.Tensor
    kf_ringkey: torch.Tensor
    kf_sig: torch.Tensor
    kf_time: torch.Tensor
    num_kf: torch.Tensor
    kf_raw: Pose
    last_loop_kf: torch.Tensor
    kf_slot: torch.Tensor
    free_slots: torch.Tensor
    free_count: torch.Tensor


class SlotData(NamedTuple):
    """One keyframe's payload + its physical slot (`phys` = K: no write)."""

    phys: torch.Tensor           # () int32
    cloud: torch.Tensor          # (P, 3)
    cloud_mask: torch.Tensor     # (P,)
    cloud_int: torch.Tensor      # (P,)
    feat_desc: torch.Tensor      # (F, 8) int32 words
    feat_xyz: torch.Tensor       # (F, 3)
    feat_valid: torch.Tensor     # (F,)
    ground: torch.Tensor         # (Pg, 3)
    ground_mask: torch.Tensor    # (Pg,)
    corner: torch.Tensor         # (Pc, 3)
    corner_mask: torch.Tensor    # (Pc,)


class BackendOutput(NamedTuple):
    loop_found: torch.Tensor     # () bool (accepted loop this keyframe)
    loop_idx: torch.Tensor       # () int32
    icp_fitness: torch.Tensor    # () f32
    correction: Pose             # T_new o map_pose^-1 (identity when no loop)
    sc_found: torch.Tensor       # () bool — a candidate went to verification
    sc_dist: torch.Tensor        # () f32 — best ScanContext distance
    icp_inlier_frac: torch.Tensor  # () f32
    icp_int_corr: torch.Tensor   # () f32 (-2 when nothing was verified)
    compacted: torch.Tensor      # () bool — store decimated before ingest
    accepted: bool = False       # `loop_found` as `keyframe_core` read it on
    # the host, for a caller that branches on it (the map rebuild)


_PAYLOAD_FIELDS = (
    "kf_cloud", "kf_cloud_mask", "kf_cloud_int", "kf_feat_desc", "kf_feat_xyz",
    "kf_feat_valid", "kf_ground", "kf_ground_mask", "kf_corner",
    "kf_corner_mask",
)
_SLOT_OF = dict(zip(_PAYLOAD_FIELDS, (
    "cloud", "cloud_mask", "cloud_int", "feat_desc", "feat_xyz", "feat_valid",
    "ground", "ground_mask", "corner", "corner_mask")))


def small_of(state: BackendState) -> SmallState:
    return SmallState(**{f: getattr(state, f) for f in SmallState._fields})


def merge_small(state: BackendState, small: SmallState) -> BackendState:
    return state._replace(**small._asdict())


def _sizes(cfg: SlamConfig):
    lc = cfg.loop
    return (lc.max_keyframes, lc.keyframe_cloud_size, cfg.feature.num_features,
            cfg.mapping.max_query_points, cfg.mapping.max_query_points // 2)


def empty_slot(cfg: SlamConfig, device="cuda") -> SlotData:
    K, P, F, Pg, Pc = _sizes(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return SlotData(
        phys=torch.tensor(K, dtype=torch.int32, device=device),
        cloud=torch.zeros((P, 3), **f32), cloud_mask=torch.zeros((P,), **b),
        cloud_int=torch.zeros((P,), **f32),
        feat_desc=torch.zeros((F, 8), dtype=torch.int32, device=device),
        feat_xyz=torch.zeros((F, 3), **f32), feat_valid=torch.zeros((F,), **b),
        ground=torch.zeros((Pg, 3), **f32), ground_mask=torch.zeros((Pg,), **b),
        corner=torch.zeros((Pc, 3), **f32), corner_mask=torch.zeros((Pc,), **b),
    )


def write_slot(state: BackendState, small: SmallState, slot: SlotData
               ) -> BackendState:
    """Merge the small state and write the payload into its physical slot
    (nothing is written when `phys` is out of range)."""
    K = state.kf_slot.shape[0]
    # an out-of-range slot writes the spare row that is sliced off again
    p = torch.clamp(slot.phys.long(), max=K)
    upd = {}
    for f in _PAYLOAD_FIELDS:
        arr = getattr(state, f)
        out = torch.cat([arr, arr[:1]])
        out.index_copy_(0, p.reshape(1), getattr(slot, _SLOT_OF[f])[None])
        upd[f] = out[:K]
    return merge_small(state, small)._replace(**upd)


def logical_view(state: BackendState) -> BackendState:
    """BackendState with the payload arrays gathered into LOGICAL keyframe
    order (`kf_slot` becomes the identity, the free-slot stack its initial
    order).  For consumers that index payloads by keyframe id: the
    distributed back-end (`parallel.ba_builder`,
    `parallel.dist_backend.shard_backend_state`) and host-side analysis."""
    s = state.kf_slot.long()
    K = s.shape[0]
    i32 = dict(dtype=torch.int32, device=s.device)
    return state._replace(
        kf_slot=torch.arange(K, **i32),
        free_slots=torch.arange(K - 1, -1, -1, **i32),
        free_count=(K - state.num_kf).to(torch.int32),
        **{f: getattr(state, f)[s] for f in _PAYLOAD_FIELDS},
    )


def init_state(cfg: SlamConfig, device="cuda") -> BackendState:
    lc = cfg.loop
    K, P, F, Pg, Pc = _sizes(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return BackendState(
        graph=posegraph.empty(K, 256, device=device),
        kf_cloud=torch.zeros((K, P, 3), **f32),
        kf_cloud_mask=torch.zeros((K, P), **b),
        kf_cloud_int=torch.zeros((K, P), **f32),
        kf_sc=torch.zeros((K, lc.sc_num_ring, lc.sc_num_sector), **f32),
        kf_ringkey=torch.zeros((K, lc.sc_num_ring), **f32),
        kf_sig=torch.zeros((K, bow.SIG_FEATURES, 9), **i32),
        kf_time=torch.zeros((K,), **f32),
        num_kf=torch.tensor(0, **i32),
        kf_feat_desc=torch.zeros((K, F, 8), **i32),
        kf_feat_xyz=torch.zeros((K, F, 3), **f32),
        kf_feat_valid=torch.zeros((K, F), **b),
        kf_raw=Pose.identity((K,), device=device),
        kf_ground=torch.zeros((K, Pg, 3), **f32),
        kf_ground_mask=torch.zeros((K, Pg), **b),
        kf_corner=torch.zeros((K, Pc, 3), **f32),
        kf_corner_mask=torch.zeros((K, Pc), **b),
        last_loop_kf=torch.tensor(-(1 << 30), **i32),
        kf_slot=torch.arange(K, **i32),
        free_slots=torch.arange(K - 1, -1, -1, **i32),
        free_count=torch.tensor(K, **i32),
    )


def _compact_small(st: SmallState) -> SmallState:
    """Decimate-by-2 on the small state only (see posegraph.compact_half):
    even keyframes survive; odd keyframes' physical slots go back onto the
    free stack — the payload arrays are never touched."""
    K = st.kf_slot.shape[0]
    dev = st.kf_slot.device
    idx = torch.arange(K, device=dev)
    src = torch.clamp(2 * idx, max=K - 1)
    new_num = (st.num_kf + 1) // 2
    n_freed = st.num_kf // 2
    odd = torch.clamp(2 * idx + 1, max=K - 1)
    phys_freed = st.kf_slot[odd]
    tgt = torch.where(idx < n_freed, st.free_count + idx, K).long()
    free_slots = torch.cat([st.free_slots, st.free_slots[:1]])
    free_slots[tgt] = phys_freed
    return SmallState(
        graph=posegraph.compact_half(st.graph),
        kf_sc=st.kf_sc[src],
        kf_ringkey=st.kf_ringkey[src],
        kf_sig=st.kf_sig[src],
        kf_time=st.kf_time[src],
        num_kf=new_num.to(torch.int32),
        kf_raw=Pose(st.kf_raw.q[src], st.kf_raw.t[src]),
        last_loop_kf=st.last_loop_kf // 2,
        kf_slot=st.kf_slot[src],
        free_slots=free_slots[:K],
        free_count=(st.free_count + n_freed).to(torch.int32),
    )


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def keyframe_core(
    small: SmallState,
    payload: BackendState,       # payload READS only (kf_cloud via kf_slot)
    scan_xyz: torch.Tensor,      # (N, 3) sensor-frame scan of this keyframe
    scan_mask: torch.Tensor,     # (N,)
    desc: torch.Tensor,          # (F, 8) int32 keyframe feature descriptor words
    desc_valid: torch.Tensor,    # (F,)
    map_pose: Pose,              # mapping-refined pose of this keyframe
    timestamp,
    cfg: SlamConfig,
    feat_xyz: torch.Tensor | None = None,
    ground_pts: torch.Tensor | None = None,
    ground_mask: torch.Tensor | None = None,
    corner_pts: torch.Tensor | None = None,
    corner_mask: torch.Tensor | None = None,
    scan_int: torch.Tensor | None = None,
    era_qual=1.0,
) -> tuple[SmallState, SlotData, BackendOutput]:
    """One keyframe's back-end work on the small state: slot allocation,
    graph node, loop detect, ICP verify, PGO.  Returns the payload as
    SlotData for the caller to write via `write_slot`."""
    lc = cfg.loop
    dev = small.kf_slot.device
    K = lc.max_keyframes
    timestamp = index.as_scalar(timestamp, torch.float32, dev)

    # capacity: decimate the store + graph by 2 when full
    need_compact = small.num_kf >= lc.max_keyframes
    if bool(need_compact):
        small = _compact_small(small)
    k = small.num_kf.long()

    # ingest: physical slot + node + descriptors
    phys = index.take(small.free_slots, small.free_count - 1)
    graph = posegraph.add_node(small.graph, map_pose, qual=era_qual)
    if scan_int is None:
        scan_int = torch.zeros(scan_xyz.shape[0], dtype=torch.float32, device=dev)
    if lc.use_voxel:
        cloud, cmask, cint = voxel_downsample(
            scan_xyz, scan_mask, lc.voxel_size * 2.0, lc.keyframe_cloud_size,
            aux=scan_int)
    else:
        cloud, cmask, cint = compact(
            scan_xyz, scan_mask, lc.keyframe_cloud_size, aux=scan_int)
    sc = scancontext.make_scancontext(scan_xyz, scan_mask, lc)
    rk = scancontext.ring_key(sc)
    sig = bow.signature(desc, desc_valid)
    if feat_xyz is None:
        feat_xyz = torch.zeros_like(payload.kf_feat_xyz[0])
    if ground_pts is None:
        ground_pts = torch.zeros_like(payload.kf_ground[0])
        ground_mask = torch.zeros_like(payload.kf_ground_mask[0])
    if corner_pts is None:
        corner_pts = torch.zeros_like(payload.kf_corner[0])
        corner_mask = torch.zeros_like(payload.kf_corner_mask[0])
    slot = SlotData(
        phys=phys, cloud=cloud, cloud_mask=cmask, cloud_int=cint,
        feat_desc=desc, feat_xyz=feat_xyz, feat_valid=desc_valid,
        ground=ground_pts, ground_mask=ground_mask,
        corner=corner_pts, corner_mask=corner_mask,
    )
    state = small._replace(
        graph=graph,
        kf_sc=index.put(small.kf_sc, k, sc),
        kf_ringkey=index.put(small.kf_ringkey, k, rk),
        kf_sig=index.put(small.kf_sig, k, sig),
        kf_time=index.put(small.kf_time, k, timestamp),
        num_kf=small.num_kf + 1,
        kf_raw=Pose(index.put(small.kf_raw.q, k, map_pose.q),
                    index.put(small.kf_raw.t, k, map_pose.t)),
        kf_slot=index.put(small.kf_slot, k, phys),
        free_count=small.free_count - 1,
    )

    # detect: each channel config-gated; priority ScanContext > BoW > radius.
    # Candidates are pre-filtered by the drift envelope: a true revisit's
    # graph-frame separation is bounded by accumulated drift.
    ar = torch.arange(K, device=dev)
    kf_valid = ar < state.num_kf
    g = state.graph
    step_env = torch.where((ar >= 1) & (ar < g.num_nodes), _norm(g.odo_rel.t), 0.0)
    cum_env = torch.cumsum(step_env, 0)
    path_env = torch.abs(index.take(cum_env, k) - cum_env)
    sep_env = _norm(g.poses.t - index.take(g.poses.t, k)[None, :])
    cand_plausible = sep_env <= (
        3.0 * lc.loop_drift_rate * torch.clamp(path_env, min=1.0) + 1.0)
    kf_eligible = kf_valid & cand_plausible
    false = torch.zeros((), dtype=torch.bool, device=dev)
    minus1 = index.scalar(-1, torch.int32, dev)
    yaw = index.scalar(0.0, device=dev)
    if lc.use_scancontext:
        sc_idx, yaw, sc_dist, sc_found = scancontext.detect_loop(
            sc, rk, state.kf_sc, state.kf_ringkey, kf_eligible, k, lc)
    else:
        sc_idx, sc_dist, sc_found = minus1, index.scalar(torch.inf, device=dev), false
    if lc.use_bow_loop:
        bow_idx, _, bow_found = bow.detect_loop(
            sig, state.kf_sig, kf_eligible, k, lc)
    else:
        bow_idx, bow_found = minus1, false
    if lc.use_radius_search:
        # kd-radius strategy (`loop_closure_handler.cpp:42-84`): nearest
        # keyframe within radius_search_m (graph frame) whose timestamp
        # differs by more than min_time_gap
        dpos = _norm(g.poses.t - index.take(g.poses.t, k)[None, :])
        eligible = (kf_valid & (ar < k) & (dpos < lc.radius_search_m)
                    & (torch.abs(state.kf_time - timestamp) > lc.min_time_gap))
        dmask = torch.where(eligible, dpos, torch.inf)
        rad_idx = torch.argmin(dmask).to(torch.int32)
        rad_found = torch.isfinite(index.take(dmask, rad_idx))
    else:
        rad_idx, rad_found = minus1, false
    loop_idx = torch.where(sc_found, sc_idx, torch.where(bow_found, bow_idx, rad_idx))
    # cooldown after an accepted loop (config.loop_cooldown_kf)
    cooled = (k - state.last_loop_kf) >= lc.loop_cooldown_kf
    found = (sc_found | bow_found | rad_found) & cooled

    if not bool(found):
        bout = BackendOutput(
            loop_found=false, loop_idx=minus1,
            icp_fitness=index.scalar(torch.inf, device=dev),
            correction=Pose.identity(device=dev),
            sc_found=found, sc_dist=sc_dist,
            icp_inlier_frac=index.scalar(0.0, device=dev),
            icp_int_corr=index.scalar(-2.0, device=dev),
            compacted=need_compact,
        )
        return state, slot, bout

    # verify: submap of the loop keyframe +/- submap_window assembled in the
    # LOOP keyframe's local frame; ICP of the current sensor-frame cloud
    # against it, initialized with the ScanContext yaw (else the rotation of
    # the graph's relative estimate)
    li = loop_idx.long()
    T_cur = Pose(index.take(g.poses.q, k), index.take(g.poses.t, k))
    T_loop = Pose(index.take(g.poses.q, li), index.take(g.poses.t, li))
    win = torch.arange(-lc.submap_window, lc.submap_window + 1, device=dev)
    idxs = torch.minimum(torch.clamp(li + win, min=0),
                         torch.clamp(state.num_kf.long() - 1, min=0))
    Ti = Pose(g.poses.q[idxs], g.poses.t[idxs])                        # (W,)
    rel_i = se3.compose(se3.inverse(T_loop), Ti)
    si = state.kf_slot[idxs].long()
    tgt = se3.transform_points(rel_i, payload.kf_cloud[si]).reshape(-1, 3)
    tgt_mask = payload.kf_cloud_mask[si].reshape(-1)
    tgt_int = payload.kf_cloud_int[si].reshape(-1)
    src, src_mask = cloud, cmask
    half = 0.5 * torch.where(sc_found, yaw, 0.0)
    zero = torch.zeros_like(half)
    q_sc = torch.stack([torch.cos(half), zero, zero, torch.sin(half)])
    q_graph = se3.compose(se3.inverse(T_loop), T_cur).q
    init = Pose(torch.where(sc_found, q_sc, q_graph), torch.zeros(3, device=dev))
    if lc.use_crop:
        # CropBox(+/-CROP_SIZE) around the revisited place
        src_mask = src_mask & torch.all(torch.abs(src) <= lc.crop_size, dim=-1)
        tgt_mask = tgt_mask & torch.all(torch.abs(tgt) <= lc.crop_size, dim=-1)
    res = icp.icp_align(src, src_mask, tgt, tgt_mask, init,
                        iters=lc.icp_iters, max_corr_dist=lc.icp_max_corr)
    int_corr = icp.intensity_correlation(cint, tgt_int, res)
    # between measurement: M maps cur-sensor to loop-local, Z_{cur->loop} = M^-1
    rel = se3.inverse(res.pose)
    # consistency gate: implied correction whitened by the drift envelope
    rel_est = se3.compose(se3.inverse(T_cur), T_loop)
    r_gate = se3.se3_log(se3.compose(se3.inverse(rel), rel_est))
    step_len = torch.where((ar >= 1) & (ar < g.num_nodes), _norm(g.odo_rel.t), 0.0)
    cum_len = torch.cumsum(step_len, 0)
    path_e = torch.clamp(torch.abs(index.take(cum_len, k) - index.take(cum_len, li)),
                         min=1.0)
    n_e = torch.clamp(torch.abs(k - li).float(), min=1.0)
    odo_var = index.constant(lc.odom_noise, device=dev)
    env = n_e * odo_var + torch.cat([
        ((lc.loop_drift_rot_rate * path_e) ** 2).expand(3),
        ((lc.loop_drift_rate * path_e) ** 2).expand(3),
    ])
    chi2 = torch.sum(r_gate * r_gate / env)
    # tentatively add the edge; the candidate must join the PCM clique
    l_new = (g.num_loops % g.loop_valid.shape[0]).long()
    g_cand = posegraph.add_loop(g, k, loop_idx, rel, res.fitness, lc)
    if lc.use_pcm:
        active = posegraph.consistent_loop_mask(
            g_cand, odo_noise=lc.odom_noise, drift_rate=lc.loop_drift_rate,
            drift_rot_rate=lc.loop_drift_rot_rate, chi2_max=lc.pcm_chi2)
        pcm_ok = index.take(active, l_new)
    else:
        active, pcm_ok = g_cand.loop_valid, torch.ones((), dtype=torch.bool, device=dev)
    accept = (
        (res.fitness <= lc.icp_fitness_score)
        & (res.inlier_frac >= lc.icp_min_inlier_frac)
        & (chi2 <= lc.loop_gate_chi2)
        & (int_corr >= lc.loop_intensity_min)
        & pcm_ok
    )
    g_out = g
    accepted = bool(accept)
    if accepted:
        g_out = g_cand
        if lc.online_pgo:
            g_out = posegraph.optimize(
                g_cand, gn_iters=lc.pgo_gn_iters, cg_iters=64,
                odo_noise=lc.odom_noise, prior_noise=lc.prior_noise,
                loop_cauchy_c=lc.loop_cauchy_c,
                drift_rate=lc.loop_drift_rate,
                drift_rot_rate=lc.loop_drift_rot_rate,
                loop_active=active,
            )
    T_new = Pose(index.take(g_out.poses.q, k), index.take(g_out.poses.t, k))
    # raw->PGO-frame correction; identity unless accepted
    corr = se3.pose_where(accept, se3.compose(T_new, se3.inverse(map_pose)),
                          Pose.identity(device=dev))
    state = state._replace(
        graph=g_out,
        last_loop_kf=torch.where(accept, k.to(torch.int32), state.last_loop_kf),
    )
    bout = BackendOutput(
        loop_found=accept, loop_idx=loop_idx,
        icp_fitness=res.fitness, correction=corr,
        sc_found=found, sc_dist=sc_dist,
        icp_inlier_frac=res.inlier_frac,
        icp_int_corr=int_corr,
        compacted=need_compact,
        accepted=accepted,
    )
    return state, slot, bout


def backend_step(
    state: BackendState,
    scan_xyz: torch.Tensor,
    scan_mask: torch.Tensor,
    desc: torch.Tensor,
    desc_valid: torch.Tensor,
    map_pose: Pose,
    timestamp,
    cfg: SlamConfig,
    feat_xyz: torch.Tensor | None = None,
    ground_pts: torch.Tensor | None = None,
    ground_mask: torch.Tensor | None = None,
    corner_pts: torch.Tensor | None = None,
    corner_mask: torch.Tensor | None = None,
    scan_int: torch.Tensor | None = None,
    era_qual=1.0,
) -> tuple[BackendState, BackendOutput]:
    """Whole-state keyframe step: `keyframe_core` + `write_slot` (the
    standalone, always-a-keyframe entry)."""
    small, slot, bout = keyframe_core(
        small_of(state), state, scan_xyz, scan_mask, desc, desc_valid,
        map_pose, timestamp, cfg, feat_xyz=feat_xyz,
        ground_pts=ground_pts, ground_mask=ground_mask,
        corner_pts=corner_pts, corner_mask=corner_mask,
        scan_int=scan_int, era_qual=era_qual,
    )
    return write_slot(state, small, slot), bout


def apply_correction(st, accepted: torch.Tensor, corr: Pose):
    """Rebase the back-end's raw anchors after the live system adopts `corr`
    (`intensity_feature_tracker.cpp:110-145,555-582`): the graph's
    `last_raw` and the current keyframe's `kf_raw` move to the corrected
    frame.  `st` may be a BackendState or a SmallState."""
    k = (st.num_kf - 1).long()
    raw_k = Pose(index.take(st.kf_raw.q, k), index.take(st.kf_raw.t, k))
    T_new = se3.pose_where(accepted, se3.compose(corr, raw_k), raw_k)
    kf_raw = Pose(index.put(st.kf_raw.q, k, T_new.q),
                  index.put(st.kf_raw.t, k, T_new.t))
    last_raw = se3.pose_where(accepted, T_new, st.graph.last_raw)
    return st._replace(kf_raw=kf_raw,
                       graph=st.graph._replace(last_raw=last_raw))
