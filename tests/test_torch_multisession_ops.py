"""The batched ops of the multi-session step against the same ops called one
session at a time, on the CPU.

- `solver.solve_pose` over a batch of three point-to-point problems whose
  Gauss-Newton runs stop after 3, 4 and 8 iterations: every session's
  iteration count and convergence flag EQUAL its own solve's, its pose,
  costs and smallest Hessian eigenvalue within 1e-12 absolute or relative
  (a frozen session keeps its state while the others iterate, as
  `jax.vmap` runs a `while_loop`).  In float64: in float32 the batch's J^T W r (a batched
  product) and one session's (a single one) sum in another order, and the
  stopping test on the relative cost decrease (1e-6) sits close enough to
  float32 rounding that the last iterations can differ, as they can
  between the reference and the port.
- `grid_hash.insert`, `knn` and `evict_far` over three sessions' maps (one
  flat table with the session folded into the set index) against three
  separate maps, EXACTLY: way keys, slots, validity, counts, neighbours.
  The way-contention case (few sets, distinct keys fighting for ways) keeps
  the reference's non-idempotence per session: a second insert of the same
  batch still adds points, and the batched maps add the same ones.
- `index.take`/`put` with a (B,) index, and `voxel_downsample` with its
  prefilter, per session.
- each module of the step (se3, projection, features, curvature, ground,
  the geometric fallback) batched against per-session calls.
- the window case: `slam_step_batched` at `sliding_window_size = 2`
  against three unbatched `slam_step` runs, 4 frames: the window's match
  counts and the window rings' descriptors equal, the odometry pose within
  1e-5 m and the scan-to-map pose within 2e-3 m
  (tests/test_torch_multisession.py says why not bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

from intensity_slam_tpu import config as JC
from intensity_slam_tpu.io import synthetic          # the JAX renderer
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import grid_hash, solver, voxel
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.pipeline import slam as TS
from intensity_slam_tpu_torch.utils import index
from intensity_slam_tpu_torch.utils.se3 import Pose

torch.set_num_threads(1)


def _problems():
    """Three point-to-point problems: a clean small motion (few iterations),
    a noisy larger motion and a heavily noisy one (more iterations)."""
    rng = np.random.default_rng(3)
    src = rng.uniform(-8, 8, (3, 200, 3)).astype(np.float32)
    motions = [(0.01, 0.05, 0.01), (0.2, 0.6, 0.02), (0.35, 1.0, 0.2)]
    dst = np.empty_like(src)
    for b, (ang, tr, noise) in enumerate(motions):
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        dst[b] = src[b] @ R.T + np.float32(tr) + rng.normal(0, noise, (200, 3))
    w = (rng.uniform(size=(3, 200)) > 0.1).astype(np.float32)
    return torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w)


def test_batched_solve_pose_freezes_each_session():
    src, dst, w = (a.double() for a in _problems())
    ident = lambda shape: Pose.identity(shape, dtype=torch.float64, device="cpu")
    res = solver.solve_pose(ident((3,)), solver.point_to_point(src, dst, w), iters=20,
                            robust="huber", robust_scale=0.1)
    iters = []
    for b in range(3):
        one = solver.solve_pose(ident(()), solver.point_to_point(src[b], dst[b], w[b]),
                                iters=20, robust="huber", robust_scale=0.1)
        for x, y in ((res.pose.q[b], one.pose.q), (res.pose.t[b], one.pose.t),
                     (res.initial_cost[b], one.initial_cost),
                     (res.final_cost[b], one.final_cost),
                     (res.min_hessian_eig[b], one.min_hessian_eig)):
            torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
        assert bool(one.converged) == bool(res.converged[b])
        assert int(one.iterations) == int(res.iterations[b])
        iters.append(int(one.iterations))
    assert iters == [3, 4, 8], iters             # they stop at different iterations
    assert res.iterations.shape == (3,) and res.pose.t.shape == (3, 3)


def _uniform(seed, n, lo, hi, sessions=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, (sessions, n, 3)).astype(np.float32))


def _assert_maps_equal(batched, maps):
    for b, m in enumerate(maps):
        for f in grid_hash.VoxelHashMap._fields:
            assert torch.equal(getattr(batched, f)[b], getattr(m, f)), (b, f)


@pytest.mark.parametrize("case", ["spread", "way_contention"])
def test_batched_grid_hash_equals_per_session(case):
    sets, lo, hi, n = (1 << 10, -10, 10, 400) if case == "spread" else (128, -6, 6, 300)
    pts = _uniform(7, n, lo, hi)
    mask = torch.from_numpy(np.random.default_rng(8).uniform(size=(3, n)) > 0.05)
    cell = 0.8
    bm = grid_hash.empty(sets, 4, device="cpu", batch=(3,))
    maps = [grid_hash.empty(sets, 4, device="cpu") for _ in range(3)]
    counts = []
    for _ in range(2):
        bm = grid_hash.insert(bm, pts, mask, cell)
        maps = [grid_hash.insert(m, pts[b], mask[b], cell) for b, m in enumerate(maps)]
        _assert_maps_equal(bm, maps)
        counts.append(bm.num_points.clone())
    if case == "way_contention":
        # crowded sets, and the reference's second insert still adds points
        assert int(((bm.way_keys >= 0).sum(dim=-1) >= 3).sum()) > 60
        assert bool((counts[1] > counts[0]).any())
    q = _uniform(9, 64, lo, hi)
    for nb in (27, 8):
        sel, sq, ok = grid_hash.knn(bm, q, cell, k=5, neighborhood=nb)
        for b, m in enumerate(maps):
            s1, q1, o1 = grid_hash.knn(m, q[b], cell, k=5, neighborhood=nb)
            assert torch.equal(sel[b], s1) and torch.equal(sq[b], q1) and torch.equal(ok[b], o1)
    center = torch.tensor([[0.0, 0.0, 0.0], [2.0, 1.0, 0.0], [-3.0, 0.0, 1.0]])
    when = torch.tensor([True, False, True])
    ev = grid_hash.evict_far(bm, center, 4.0, when=when)
    _assert_maps_equal(ev, [grid_hash.evict_far(m, center[b], 4.0, when=when[b])
                            for b, m in enumerate(maps)])
    assert int(ev.num_points[1]) == int(bm.num_points[1])
    assert int(ev.num_points[0]) < int(bm.num_points[0])


def test_index_take_put_and_voxel_per_session():
    arr = torch.arange(3 * 4 * 2, dtype=torch.float32).reshape(3, 4, 2)
    k = torch.tensor([1, -1, 2])
    assert torch.equal(index.take(arr, k), torch.stack([arr[0, 1], arr[1, 3], arr[2, 2]]))
    v = -torch.ones(3, 2) * torch.tensor([1.0, 2.0, 3.0])[:, None]
    out = index.put(arr, k, v)
    for b, kb in enumerate([1, 3, 2]):
        assert torch.equal(out[b], index.put(arr[b], torch.tensor(kb), v[b]))
    pts = _uniform(4, 600, -5, 5)
    mask = torch.from_numpy(np.random.default_rng(5).uniform(size=(3, 600)) > 0.3)
    bo, bmk = voxel.voxel_downsample(pts, mask, 0.5, 128, prefilter=300)
    for b in range(3):
        o, mk = voxel.voxel_downsample(pts[b], mask[b], 0.5, 128, prefilter=300)
        assert torch.equal(o, bo[b]) and torch.equal(mk, bmk[b])


def test_window_case_matches_unbatched():
    """sliding_window_size = 2 (off at the default): the batched step's
    window residuals against the unbatched step's, per session."""
    tcfg = tconfig.small_test_config()
    tcfg = tcfg.replace(mapping=dataclasses.replace(
        tcfg.mapping, sliding_window_size=2, window_min_matches=2, window_min_good=1))
    cfg_j = JC.small_test_config()
    F, B = 4, 3
    poses = synthetic.corridor_trajectory(F + B, speed=0.35)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg_j.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    xb = np.stack([np.roll(xyz, -b, 0) for b in range(B)], 1)
    ib = np.stack([np.roll(inten, -b, 0) for b in range(B)], 1)
    mask = TP.detection_mask(tcfg.sensor, device="cpu")
    bs = TS.init_batched_state(tcfg, [0, 1, 2], device="cpu")
    outs = []
    for k in range(F):
        bs, o = TS.slam_step_batched(bs, torch.from_numpy(xb[k].copy()),
                                     torch.from_numpy(ib[k].copy()), k * 0.1, mask, tcfg)
        outs.append(o)
    for b in range(B):
        s = TS.init_state(tcfg, seed=b, device="cpu")
        for k in range(F):
            s, o = TS.slam_step(s, torch.from_numpy(xb[k, b].copy()),
                                torch.from_numpy(ib[k, b].copy()), k * 0.1, mask, tcfg)
            assert int(o.num_window_residuals) == int(outs[k].num_window_residuals[b])
            torch.testing.assert_close(outs[k].odom_pose.t[b], o.odom_pose.t, rtol=0, atol=1e-5)
            torch.testing.assert_close(outs[k].pose.t[b], o.pose.t, rtol=0, atol=2e-3)
        assert torch.equal(s.mapping.win_desc, bs.mapping.win_desc[b])
        assert torch.equal(s.mapping.win_count, bs.mapping.win_count[b])
        torch.testing.assert_close(bs.mapping.win_pose.t[b], s.mapping.win_pose.t,
                                   rtol=0, atol=2e-3)
    assert int(outs[-1].num_window_residuals.sum()) > 0


def _scans(B=3):
    """B staggered small-config corridor scans (the JAX renderer's) as
    (B, N, 3) and (B, N) tensors, the third at constant intensity."""
    cfg = JC.small_test_config()
    poses = synthetic.corridor_trajectory(B + 1, speed=0.35)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg.sensor)
    xyz, inten = np.asarray(xyz)[:B].copy(), np.asarray(inten)[:B].copy()
    inten[2] = 100.0
    return torch.from_numpy(xyz), torch.from_numpy(inten)


def _assert_tree(batched, singles):
    """Every field of a batched NamedTuple EQUALS the per-session calls'."""
    for b, one in enumerate(singles):
        for name, x, y in zip(type(one)._fields, batched, one):
            assert torch.equal(x[b], y), (b, name)


@pytest.mark.parametrize("module", ["se3", "projection", "features", "curvature",
                                    "ground", "geometric"])
def test_module_batched_equals_per_session(module):
    """Each module of the step over a leading session axis against the same
    call per session: the per-element and sorting ops EQUAL, the ground
    plane (a batched 3x3 `eigh` and product against single ones) within
    1e-6 with equal masks, the fallback solve within 1e-6 m."""
    from intensity_slam_tpu_torch.ops import curvature, features, ground
    from intensity_slam_tpu_torch.pipeline import geometric
    from intensity_slam_tpu_torch.utils import se3
    tcfg = tconfig.small_test_config()
    xyz, inten = _scans()
    scan = TP.project_organized(xyz, inten, tcfg.sensor)
    singles = [TP.project_organized(xyz[b], inten[b], tcfg.sensor) for b in range(3)]
    if module == "se3":
        rng = np.random.default_rng(1)
        q = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))
        p = Pose(se3.quat_normalize(q), torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32)))
        xi = torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32)) * 0.1
        cond = torch.tensor([True, False, True])
        ident = Pose.identity((3,), device="cpu")
        outs = (se3.pose_where(cond, p, ident), se3.compose(p, ident), se3.retract(p, xi),
                Pose(se3.slerp(ident.q, p.q, 0.3), p.t),
                Pose(p.q, se3.transform_points(p, xyz[:, :5])))
        for b in range(3):
            pb = Pose(p.q[b], p.t[b])
            ib = Pose.identity(device="cpu")
            want = (se3.pose_where(cond[b], pb, ib), se3.compose(pb, ib), se3.retract(pb, xi[b]),
                    Pose(se3.slerp(ib.q, pb.q, 0.3), pb.t),
                    Pose(pb.q, se3.transform_points(pb, xyz[b, :5])))
            for got, w in zip(outs, want):
                torch.testing.assert_close(got.q[b], w.q, rtol=0, atol=1e-7)
                torch.testing.assert_close(got.t[b], w.t, rtol=0, atol=1e-6)
    elif module == "projection":
        _assert_tree(scan, singles)
    elif module == "features":
        mask = TP.detection_mask(tcfg.sensor, device="cpu")
        _assert_tree(features.extract(scan, mask, tcfg.feature),
                     [features.extract(s, mask, tcfg.feature) for s in singles])
    elif module == "curvature":
        _assert_tree(curvature.extract_features(scan, tcfg.sensor, tcfg.geometric),
                     [curvature.extract_features(s, tcfg.sensor, tcfg.geometric)
                      for s in singles])
    elif module == "ground":
        u = torch.from_numpy(np.random.default_rng(2).uniform(
            size=(3, tcfg.ground.ransac_iters, 3)).astype(np.float32))
        g = ground.extract_ground(u, xyz, scan.valid.flatten(-2), tcfg.ground)
        for b, s in enumerate(singles):
            one = ground.extract_ground(u[b], xyz[b], s.valid.reshape(-1), tcfg.ground)
            torch.testing.assert_close(g.plane[b], one.plane, rtol=0, atol=1e-6)
            assert torch.equal(g.ground_mask[b], one.ground_mask)
            assert int(g.inlier_count[b]) == int(one.inlier_count) and bool(g.ok[b]) == bool(one.ok)
    else:
        fc = curvature.extract_features(scan, tcfg.sensor, tcfg.geometric)
        fcs = [curvature.extract_features(s, tcfg.sensor, tcfg.geometric) for s in singles]
        # the previous frame: each session's own scan moved 0.3 m back
        shifted = TP.project_organized(xyz + torch.tensor([0.3, 0.0, 0.0]), inten,
                                       tcfg.sensor)
        nl = tcfg.sensor.image_height * tcfg.geometric.num_segments \
            * tcfg.geometric.less_sharp_per_segment
        st = geometric.update_state(
            geometric.init_state(tcfg, nl, tcfg.geometric.max_surf_points, device="cpu",
                                 batch=(3,)),
            curvature.extract_features(shifted, tcfg.sensor, tcfg.geometric),
            Pose.identity((3,), device="cpu"))
        got = geometric.geometric_delta(st, fc, tcfg)
        for b in range(3):
            stb = type(st)(*[Pose(f.q[b], f.t[b]) if isinstance(f, Pose) else f[b] for f in st])
            want = geometric.geometric_delta(stb, fcs[b], tcfg)
            torch.testing.assert_close(got.t[b], want.t, rtol=0, atol=1e-6)
            torch.testing.assert_close(got.q[b], want.q, rtol=0, atol=1e-6)
        assert float(got.t[:, 0].abs().min()) > 0.1      # the solves moved
