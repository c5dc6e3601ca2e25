"""Parity: the keyframe back-end of the port (ops.grid_hash key mix,
ops.voxel, ops.scancontext, ops.bow, pipeline.posegraph, pipeline.loop) vs
the JAX package on the same inputs (CPU, small shapes).

`backend_step` starts from a JAX `BackendState` carried over with
`interop.state_from_numpy`, then both packages run the same keyframes in
lockstep through at least one accepted loop (ICP verify + PGO) and one
store compaction.  Decisions, indices, slots and counts are compared
exactly; poses at 1e-4 (float32 rounding order: FMAs, Cholesky)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.ops import bow as JB
from intensity_slam_tpu.ops import grid_hash as JG
from intensity_slam_tpu.ops import scancontext as JSC
from intensity_slam_tpu.ops import voxel as JV
from intensity_slam_tpu.pipeline import loop as JL
from intensity_slam_tpu.pipeline import posegraph as JPG
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.ops import bow as TB
from intensity_slam_tpu_torch.ops import grid_hash as TG
from intensity_slam_tpu_torch.ops import scancontext as TSC
from intensity_slam_tpu_torch.ops import voxel as TV
from intensity_slam_tpu_torch.pipeline import loop as TL
from intensity_slam_tpu_torch.pipeline import posegraph as TPG
from intensity_slam_tpu_torch.utils import se3 as T3

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)


def _room(rng, n=2048):
    side = rng.randint(0, 4, n)
    u = rng.uniform(-5, 5, n)
    z = rng.uniform(-1, 2, n)
    x = np.where(side == 0, 5.0, np.where(side == 1, -5.0, u))
    y = np.where(side == 2, 5.0, np.where(side == 3, -5.0, u))
    return np.stack([x, y, z], -1).astype(np.float32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_mix_and_pack_exact():
    rng = np.random.RandomState(0)
    c = rng.randint(-600, 600, size=(4096, 3)).astype(np.int32)
    jk = JG._mix(JG._pack(_j(c))).astype(jnp.int32)
    tk = TG.as_int32(TG._mix(TG._pack(_t(c))))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    p = rng.randn(1000, 3).astype(np.float32) * 30
    np.testing.assert_array_equal(np.asarray(JG._voxel_coord(_j(p), 0.4)),
                                  TG._voxel_coord(_t(p), 0.4).numpy())


@pytest.mark.parametrize("capacity,prefilter", [(512, None), (128, None),
                                                (512, 1024)],
                         ids=["fits", "overflow", "prefilter"])
def test_voxel_downsample_parity(capacity, prefilter):
    rng = np.random.RandomState(1)
    pts = (rng.randn(4096, 3) * [6, 3, 1]).astype(np.float32)
    mask = rng.rand(4096) < 0.9
    aux = rng.uniform(1, 255, 4096).astype(np.float32)
    jo = JV.voxel_downsample(_j(pts), _j(mask), 0.5, capacity, prefilter, aux=_j(aux))
    to = TV.voxel_downsample(_t(pts), _t(mask), 0.5, capacity, prefilter, aux=_t(aux))
    np.testing.assert_array_equal(np.asarray(jo[1]), to[1].numpy())
    np.testing.assert_array_equal(np.asarray(jo[0]), to[0].numpy())
    # per-voxel intensity means: summation order differs (scatter-add)
    np.testing.assert_allclose(np.asarray(jo[2]), to[2].numpy(), rtol=1e-5)
    jc = JV.compact(_j(pts), _j(mask), capacity, _j(aux))
    tc = TV.compact(_t(pts), _t(mask), capacity, _t(aux))
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_scancontext_parity():
    rng = np.random.RandomState(2)
    lc = config.LoopConfig()
    clouds = [_room(rng) for _ in range(6)]
    mask = np.ones(2048, bool)
    jd = [JSC.make_scancontext(_j(c), _j(mask), lc) for c in clouds]
    td = [TSC.make_scancontext(_t(c), _t(mask), lc) for c in clouds]
    for a, b in zip(jd, td):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)
    ja, jsft = JSC.sc_distance_all_shifts(jd[0], jnp.roll(jd[0], 7, axis=1))
    ta, tsft = TSC.sc_distance_all_shifts(td[0], torch.roll(td[0], 7, dims=1))
    assert int(jsft) == int(tsft)
    np.testing.assert_allclose(float(ja), float(ta), atol=1e-5)
    K = 16
    hist = jnp.zeros((K, 20, 60)).at[:6].set(jnp.stack(jd))
    hist_t = torch.zeros(K, 20, 60)
    hist_t[:6] = torch.stack(td)
    valid = np.arange(K) < 6
    jr = JSC.detect_loop(jd[5], JSC.ring_key(jd[5]), hist, JSC.ring_key(hist),
                         _j(valid), jnp.int32(5), dataclasses.replace(
                             lc, sc_num_exclude_recent=1))
    tr = TSC.detect_loop(td[5], TSC.ring_key(td[5]), hist_t, TSC.ring_key(hist_t),
                         _t(valid), torch.tensor(5), dataclasses.replace(
                             lc, sc_num_exclude_recent=1))
    assert int(jr[0]) == int(tr[0]) and bool(jr[3]) == bool(tr[3])
    np.testing.assert_allclose(float(jr[1]), float(tr[1]), atol=1e-6)
    np.testing.assert_allclose(float(jr[2]), float(tr[2]), atol=1e-5)


def test_bow_parity():
    rng = np.random.RandomState(3)
    K, F = 8, 300
    base = rng.randint(0, 2**32, size=(F, 8), dtype=np.uint64).astype(np.uint32)
    sigs_j, sigs_t = [], []
    for k in range(K):
        d = base.copy() if k % 3 == 0 else rng.randint(
            0, 2**32, size=(F, 8), dtype=np.uint64).astype(np.uint32)
        v = rng.rand(F) < 0.9
        sj = JB.signature(_j(d), _j(v))
        st = TB.signature(_t(d.view(np.int32)), _t(v))
        np.testing.assert_array_equal(np.asarray(sj), st.numpy().view(np.uint32))
        sigs_j.append(sj)
        sigs_t.append(st)
    lc = dataclasses.replace(config.LoopConfig(), min_loop_search_gap=2)
    jr = JB.detect_loop(sigs_j[6], jnp.stack(sigs_j), jnp.ones(K, bool),
                        jnp.int32(6), lc)
    tr = TB.detect_loop(sigs_t[6], torch.stack(sigs_t), torch.ones(K, dtype=torch.bool),
                        torch.tensor(6), lc)
    assert int(jr[0]) == int(tr[0]) and bool(jr[2]) == bool(tr[2])
    np.testing.assert_allclose(float(jr[1]), float(tr[1]), atol=1e-7)


def _graph_with_loops():
    """A 12-node drifting chain with three loop edges (one inconsistent)."""
    add_node = jax.jit(JPG.add_node)
    add_loop = jax.jit(JPG.add_loop, static_argnames=("cfg",))
    g = JPG.empty(16, 8)
    rng = np.random.RandomState(5)
    pose = J3.Pose.identity()
    raws = []
    for k in range(12):
        yaw = 0.25 if 3 <= k < 9 else 0.02
        step = J3.Pose(J3.so3_exp(jnp.array([0.0, 0.0, yaw])),
                       jnp.array([1.0, 0.05 * rng.randn(), 0.0], jnp.float32))
        pose = J3.compose(pose, step) if k else pose
        raws.append(pose)
        g = add_node(g, pose, qual=1.0 + 0.2 * k)
    lc = config.LoopConfig()
    for (i, j, dx) in [(11, 0, 0.3), (10, 1, 0.25), (9, 2, 6.0)]:
        rel = J3.compose(J3.inverse(raws[i]), raws[j])
        rel = J3.Pose(rel.q, rel.t + jnp.array([dx, 0.0, 0.0]))
        g = add_loop(g, jnp.int32(i), jnp.int32(j), rel, jnp.float32(0.05), lc)
    return g, lc


def test_posegraph_optimize_and_pcm_parity():
    g, lc = _graph_with_loops()
    tg = interop.state_from_numpy(jax.tree.map(np.asarray, g), "cpu")
    kw = dict(odo_noise=lc.odom_noise, drift_rate=lc.loop_drift_rate,
              drift_rot_rate=lc.loop_drift_rot_rate)
    ja = jax.jit(lambda g: JPG.consistent_loop_mask(g, chi2_max=lc.pcm_chi2, **kw))(g)
    ta = TPG.consistent_loop_mask(tg, chi2_max=lc.pcm_chi2, **kw)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    jo = JPG.optimize(g, gn_iters=3, loop_cauchy_c=lc.loop_cauchy_c,
                      loop_active=ja, **kw)
    to = TPG.optimize(tg, gn_iters=3, loop_cauchy_c=lc.loop_cauchy_c,
                      loop_active=ta, **kw)
    np.testing.assert_allclose(np.asarray(jo.poses.t), to.poses.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jo.poses.q), to.poses.q.numpy(), atol=1e-4)
    jc = jax.jit(JPG.compact_half)(g)
    tc = TPG.compact_half(tg)
    for f in ("loop_i", "loop_j", "loop_valid", "node_valid", "num_nodes"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(jc.loop_rel.t), tc.loop_rel.t.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(jc.last_raw.t), tc.last_raw.t.numpy(),
                               atol=1e-5)
    ch = JPG.chain_poses(g.odo_rel, g.num_nodes)
    tch = TPG.chain_poses(tg.odo_rel, tg.num_nodes)
    np.testing.assert_allclose(np.asarray(ch.t), tch.t.numpy(), atol=1e-5)


def _loop_cfg():
    base = config.small_test_config()
    return base.replace(loop=dataclasses.replace(
        base.loop, max_keyframes=6, keyframe_cloud_size=512,
        min_loop_search_gap=2, sc_num_exclude_recent=2, loop_cooldown_kf=2))


# out to 12 m and back to the start (keyframe 4 revisits keyframe 0), then
# out again: keyframe 6 finds the 6-slot store full and compacts it
_PATH = [0, 6, 12, 6.2, 0.3, 6.4, 12.2, 6.1]


def _corridor_points(rng, n=2048):
    """A static 'world' of 2048 points: two walls along x plus random
    pillars, so every place along the corridor looks different."""
    n_wall = n // 2
    x = rng.uniform(-6, 26, n_wall)
    y = np.where(rng.rand(n_wall) < 0.5, 3.0, -3.0)
    z = rng.uniform(-0.8, 2.0, n_wall)
    walls = np.stack([x, y, z], -1)
    centers = np.stack([rng.uniform(-4, 24, 16), rng.uniform(-2.5, 2.5, 16)], -1)
    c = centers[rng.randint(0, 16, n - n_wall)]
    pil = np.stack([c[:, 0] + rng.uniform(-0.2, 0.2, len(c)),
                    c[:, 1] + rng.uniform(-0.2, 0.2, len(c)),
                    rng.uniform(-0.8, 1.5, len(c))], -1)
    return np.concatenate([walls, pil]).astype(np.float32)


def test_backend_step_from_carried_state():
    cfg = _loop_cfg()
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    assert tcfg == dataclasses.replace(tcfg) and tcfg.loop.max_keyframes == 6
    rng = np.random.RandomState(6)
    world = _corridor_points(rng)
    inten = rng.uniform(1, 255, 2048).astype(np.float32)
    mask = np.ones(2048, bool)
    F = cfg.feature.num_features
    desc = rng.randint(0, 2**32, size=(F, 8), dtype=np.uint64).astype(np.uint32)
    dv = rng.rand(F) < 0.9
    fxyz = rng.randn(F, 3).astype(np.float32)

    jstep = jax.jit(lambda st, p, t: JL.backend_step(
        st, _j(world) - p[None, :], _j(mask), _j(desc), _j(dv),
        J3.Pose(jnp.array([1.0, 0, 0, 0]), p), t, cfg, feat_xyz=_j(fxyz),
        scan_int=_j(inten)))
    js = JL.init_state(cfg)
    # the first two keyframes run on the JAX side only; the port starts from
    # the carried-over state
    for k in range(2):
        js, _ = jstep(js, jnp.array([_PATH[k], 0.0, 0.0], jnp.float32),
                      jnp.float32(k))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    back = interop.state_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)

    n_acc = n_comp = 0
    for k in range(2, len(_PATH)):
        p = np.array([_PATH[k], 0.0, 0.0], np.float32)
        js, jo = jstep(js, jnp.asarray(p), jnp.float32(k))
        ts, to = TL.backend_step(
            ts, _t(world - p[None, :]), _t(mask), _t(desc.view(np.int32)), _t(dv),
            T3.Pose(torch.tensor([1.0, 0, 0, 0]), _t(p)), float(k), tcfg,
            feat_xyz=_t(fxyz), scan_int=_t(inten))
        for f in ("loop_found", "loop_idx", "sc_found", "compacted"):
            assert np.asarray(getattr(jo, f)).item() == getattr(to, f).item(), (k, f)
        if bool(jo.sc_found):
            np.testing.assert_allclose(float(jo.icp_fitness), float(to.icp_fitness),
                                       rtol=1e-3, atol=1e-6)
        n_acc += int(bool(jo.loop_found))
        n_comp += int(bool(jo.compacted))
        for f in ("num_kf", "kf_slot", "free_slots", "free_count", "last_loop_kf"):
            np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                          getattr(ts, f).numpy(), err_msg=f)
        for f in ("num_nodes", "num_loops", "loop_i", "loop_j", "loop_valid",
                  "node_valid"):
            np.testing.assert_array_equal(np.asarray(getattr(js.graph, f)),
                                          getattr(ts.graph, f).numpy(), err_msg=f)
        np.testing.assert_allclose(np.asarray(js.graph.poses.t),
                                   ts.graph.poses.t.numpy(), atol=1e-4)
        np.testing.assert_allclose(np.asarray(js.kf_cloud), ts.kf_cloud.numpy())
        np.testing.assert_array_equal(np.asarray(js.kf_sig),
                                      ts.kf_sig.numpy().view(np.uint32))
        np.testing.assert_allclose(np.asarray(js.kf_sc), ts.kf_sc.numpy(), atol=1e-6)
    assert n_acc >= 1 and n_comp >= 1, (n_acc, n_comp)

    # the correction rebase on an accepted loop
    corr = J3.Pose(J3.so3_exp(jnp.array([0.0, 0.0, 0.1])), jnp.array([0.2, 0.0, 0.0]))
    ja = JL.apply_correction(js, jnp.asarray(True), corr)
    ta = TL.apply_correction(ts, torch.tensor(True),
                             T3.Pose(_t(corr.q), _t(corr.t)))
    np.testing.assert_allclose(np.asarray(ja.kf_raw.t), ta.kf_raw.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ja.graph.last_raw.q),
                               ta.graph.last_raw.q.numpy(), atol=1e-6)
