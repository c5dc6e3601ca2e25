"""The distributed back-end fed from a LIVE run: `loop.logical_view`,
`ba_builder.build_problem` / `track_stats` and `dist_backend.refine` of the
port against the JAX package's, and the port's `SlamSystem` with
`refine_every_kf` against the JAX one.

One module-scoped run of each package's `SlamSystem` over
tests/test_dist_backend.py's out-and-back and config, with two more frames
out and back (36 frames) so that the keyframe-count check at frame 32 fires
`refine` (`refine_every_kf = 4`) and four frames run after it.  The port
gets the JAX-rendered scans and the reference's ground-RANSAC draws.  The
reference's final `BackendState` is carried into the port with `interop`
for the function-level comparisons, also with its payloads moved to
permuted physical slots.

Exact: `logical_view`, the integer outputs of `build_problem` (`obs_lm`,
`obs_pose`, `obs_w`, `fixed_poses`), `track_stats`, `refine`'s `num_obs`
and `landmark_valid`, and the runs' keyframes, loops and log ids.
Landmarks 1e-5 m.  `refine`: poses 1e-3 m (tests/test_dist_backend.py's
tolerance between the reference's two solves), BA costs rtol 1e-3.  The two
runs' trajectories: 0.1 m, tests/test_torch_fused.py's tolerance, for its
reason.
"""

import contextlib
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic as JSyn
from intensity_slam_tpu.parallel import ba_builder as JBB
from intensity_slam_tpu.parallel import dist_backend as JDB
from intensity_slam_tpu.pipeline import loop as JL
from intensity_slam_tpu.pipeline.system import SlamSystem as JSystem
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.parallel import ba_builder as TBB
from intensity_slam_tpu_torch.parallel import dist_backend as TDB
from intensity_slam_tpu_torch.parallel import multiproc
from intensity_slam_tpu_torch.pipeline import loop as TL
from intensity_slam_tpu_torch.pipeline.system import SlamSystem as TSystem

torch.set_num_threads(1)


def _loop_trajectory(n_out=12, n_turn=6, speed=0.4):
    """tests/test_dist_backend.py::_loop_trajectory."""
    ident = jnp.array([1.0, 0, 0, 0])
    fwd = J3.Pose(ident, jnp.array([speed, 0, 0]))
    turn = J3.Pose(J3.so3_exp(jnp.array([0.0, 0.0, np.pi / n_turn])),
                   jnp.array([speed * 0.5, 0, 0]))
    pose = J3.Pose(ident, jnp.array([0.0, 0.0, 0.8]))
    qs, ts = [], []
    for step, n in ((fwd, n_out), (turn, n_turn), (fwd, n_out + 2)):
        for _ in range(n):
            qs.append(pose.q); ts.append(pose.t)
            pose = J3.compose(pose, step)
    return J3.Pose(jnp.stack(qs), jnp.stack(ts))


def _cfg():
    base = config.small_test_config()
    return base.replace(
        loop=dataclasses.replace(base.loop, sc_num_exclude_recent=4, min_loop_search_gap=4,
                                 max_keyframes=64, keyframe_cloud_size=512),
        odometry=dataclasses.replace(base.odometry, keyframe_time_interval=0.15),
        parallel=dataclasses.replace(base.parallel, refine_every_kf=4))


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


@contextlib.contextmanager
def _counting(mod, name):
    fn, calls = getattr(mod, name), []

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    setattr(mod, name, counted)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg()
    poses = _loop_trajectory(n_out=14)
    xyz, inten = jax.jit(lambda q, t: JSyn.render_sequence(
        J3.Pose(q, t), JSyn.corridor_world(), cfg.sensor))(poses.q, poses.t)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    jsys, tsys = JSystem(cfg), TSystem(_tcfg(cfg), device="cpu")
    t = lambda a: torch.from_numpy(np.array(a))
    jinfo, tinfo = [], []
    with _counting(JDB, "refine") as jcalls, _counting(TDB, "refine") as tcalls:
        for k in range(xyz.shape[0]):
            _, sub = jax.random.split(jsys.state.slam.rng)
            u = np.asarray(jax.random.uniform(sub, (cfg.ground.ransac_iters, 3)))
            jinfo.append(jax.tree.map(np.asarray, jsys.process(
                jnp.asarray(xyz[k]), jnp.asarray(inten[k]), 0.1 * k)))
            tinfo.append(tsys.process(t(xyz[k]), t(inten[k]), 0.1 * k, ground_u=t(u)))
    return dict(cfg=cfg, jsys=jsys, tsys=tsys, jinfo=jinfo, tinfo=tinfo,
                jcalls=len(jcalls), tcalls=len(tcalls),
                jback=jax.tree.map(np.asarray, jsys.state.backend))


def _permuted(jback, seed=7):
    """The same store with its payloads moved to other physical slots."""
    K = jback.kf_slot.shape[0]
    perm = np.random.RandomState(seed).permutation(K)
    moved = {}
    for f in JL._PAYLOAD_FIELDS:
        a = getattr(jback, f)
        b = np.empty_like(a)
        b[perm] = a
        moved[f] = b
    return jback._replace(kf_slot=perm[jback.kf_slot].astype(np.int32), **moved)


@pytest.fixture(scope="module", params=["resident", "permuted"])
def store(runs, request):
    jb = runs["jback"] if request.param == "resident" else _permuted(runs["jback"])
    return jb, interop.state_from_numpy(jb, device="cpu")


def test_the_run_refined_once_and_took_the_reference_s_decisions(runs):
    assert runs["jcalls"] == runs["tcalls"] == 1
    for f in ("is_keyframe", "skip", "loop_found", "loop_idx", "num_kf"):
        assert ([getattr(i, f).item() for i in runs["jinfo"]]
                == [getattr(i, f).item() for i in runs["tinfo"]]), f
    jsys, tsys = runs["jsys"], runs["tsys"]
    assert jsys.num_keyframes == tsys.num_keyframes >= 8
    assert [(a, b) for a, b, _ in jsys.loops] == [(a, b) for a, b, _ in tsys.loops]
    jl, tl = jsys.state.log, tsys.state.log
    for f in ("kf", "skip", "count", "num_skips"):
        np.testing.assert_array_equal(np.asarray(getattr(jl, f)), getattr(tl, f).numpy(), f)


def test_the_refined_runs_agree(runs):
    jsys, tsys = runs["jsys"], runs["tsys"]
    n = jsys.num_keyframes
    np.testing.assert_allclose(np.asarray(jsys.state.backend.graph.poses.t)[:n],
                               tsys.state.backend.graph.poses.t.numpy()[:n], atol=0.1)
    tt = tsys.trajectory()
    assert tt.shape == (36, 3) and np.isfinite(tt).all()
    np.testing.assert_allclose(jsys.trajectory(), tt, atol=0.1)


def test_logical_view_matches_reference(store):
    jb, tb = store
    want = jax.tree.map(np.asarray, jax.jit(JL.logical_view)(jax.tree.map(jnp.asarray, jb)))
    got = interop.state_to_numpy(TL.logical_view(tb))
    for f in JL.BackendState._fields:
        for a, b in zip(jax.tree.leaves(getattr(want, f)), jax.tree.leaves(getattr(got, f))):
            np.testing.assert_array_equal(a, b, f)
    assert got.free_count.dtype == np.int32
    assert int(got.free_count) == jb.kf_slot.shape[0] - int(jb.num_kf)


def test_build_problem_matches_reference(runs, store):
    jb, tb = store
    cfg = runs["cfg"]
    want = jax.tree.map(np.asarray, jax.jit(JBB.build_problem, static_argnums=1)(
        jax.tree.map(jnp.asarray, jb), cfg))
    got = interop.state_to_numpy(TBB.build_problem(tb, _tcfg(cfg)))
    for f in ("obs_lm", "obs_pose", "obs_w", "fixed_poses", "obs_z"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    np.testing.assert_allclose(got.landmarks, want.landmarks, atol=1e-5)
    np.testing.assert_array_equal(got.poses.t, want.poses.t)
    stats = TBB.track_stats(TBB.build_problem(tb, _tcfg(cfg)))
    assert stats == JBB.track_stats(jax.tree.map(jnp.asarray, want))
    n_kf = int(jb.num_kf)
    assert stats["num_obs"] >= 2 * n_kf and stats["max_track_len"] >= 3, stats


def test_batched_match_equals_the_per_pair_matcher(runs):
    """The builder's batched matcher (one product of +-1 bits per chunk)
    against `features.match` pair by pair on the live descriptors; its
    batched Hamming matrices against the reference's pair by pair."""
    from intensity_slam_tpu.ops import features as JF
    from intensity_slam_tpu_torch.ops import features as TF
    tb = TL.logical_view(interop.state_from_numpy(runs["jback"], device="cpu"))
    n = int(tb.num_kf)
    d, v = tb.kf_feat_desc[:n], tb.kf_feat_valid[:n]
    pc, fc = runs["cfg"].parallel, runs["cfg"].feature
    du = d.numpy().view(np.uint32)
    want = np.stack([np.asarray(JF.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(du[1:], du[:-1])])
    np.testing.assert_array_equal(TF.hamming_matrix(d[1:], d[:-1]).numpy(), want)
    batched = TF.match(d[1:], v[1:], d[:-1], v[:-1], pc.ba_keep_frac, fc.max_hamming)
    for k in range(1, n):
        one = TF.match(d[k], v[k], d[k - 1], v[k - 1], pc.ba_keep_frac, fc.max_hamming)
        for a, b in zip(one, batched):
            assert torch.equal(a, b[k - 1])
    assert int(batched.num_good.sum()) > 0


def test_refine_matches_reference(runs, store):
    jb, tb = store
    cfg = runs["cfg"]
    want = jax.tree.map(np.asarray, JDB.refine(jax.tree.map(jnp.asarray, jb), cfg))
    got = interop.state_to_numpy(TDB.refine(tb, _tcfg(cfg)))
    n = int(jb.num_kf)
    np.testing.assert_allclose(got.state.graph.poses.t[:n], want.state.graph.poses.t[:n],
                               atol=1e-3)
    np.testing.assert_allclose(got.state.graph.poses.q[:n], want.state.graph.poses.q[:n],
                               atol=1e-3)
    assert int(got.num_obs) == int(want.num_obs) > 0
    np.testing.assert_array_equal(got.landmark_valid, want.landmark_valid)
    np.testing.assert_allclose(got.ba_initial_cost, want.ba_initial_cost, rtol=1e-3)
    np.testing.assert_allclose(got.ba_final_cost, want.ba_final_cost, rtol=1e-3)
    assert float(got.ba_final_cost) <= float(got.ba_initial_cost)
    # landmarks are not written to the graph (ba_pose_writeback is off)
    lv = got.landmark_valid
    np.testing.assert_allclose(got.landmarks[lv], want.landmarks[lv], atol=1e-3)
    assert type(got).__name__ == "RefineResult"


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group in this process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = multiproc.initialize(0, 1, f"127.0.0.1:{port}", "gloo", timeout_s=60)
    yield mesh
    dist.destroy_process_group()


def test_refine_over_a_process_group_matches_one_device(runs, store, mesh1):
    _, tb = store
    cfg = _tcfg(runs["cfg"])
    sharded = TDB.shard_backend_state(tb, mesh1)
    assert sharded.kf_cloud.shape[0] == tb.kf_cloud.shape[0]      # one rank: all of it
    assert torch.equal(sharded.kf_slot, torch.arange(64, dtype=torch.int32))
    got = TDB.refine(sharded, cfg, mesh=mesh1)
    want = TDB.refine(tb, cfg)
    n = int(tb.num_kf)
    np.testing.assert_allclose(got.state.graph.poses.t.numpy()[:n],
                               want.state.graph.poses.t.numpy()[:n], atol=1e-5)
    assert int(got.num_obs) == int(want.num_obs)
    assert TBB.track_stats(TBB.build_problem(sharded, cfg, mesh=mesh1), mesh1) == \
        TBB.track_stats(TBB.build_problem(tb, cfg))


@pytest.mark.parametrize("size", [2, 3, 5])
def test_shard_backend_state_keeps_each_rank_s_block(runs, size):
    """Each rank holds rows [max(lo - 1, 0), hi) of every keyframe-major
    array (its block plus the keyframe before it), in logical order; the
    graph and the scalars whole."""
    tb = interop.state_from_numpy(_permuted(runs["jback"]), device="cpu")
    full = TL.logical_view(tb)
    K = 64
    b = -(-K // size)
    for r in range(size):
        st = TDB.shard_backend_state(tb, multiproc.Mesh(None, r, size, torch.device("cpu")))
        lo, hi = min(r * b, K), min(r * b + b, K)
        rows = slice(max(lo - 1, 0), hi)
        assert st.kf_cloud.shape[0] == hi - max(lo - 1, 0) < K
        for f in TDB._KF_FIELDS:
            for a, c in zip(jax.tree.leaves(interop.state_to_numpy(getattr(st, f))),
                            jax.tree.leaves(interop.state_to_numpy(getattr(full, f)))):
                np.testing.assert_array_equal(a, c[rows], f)
        assert st.graph.poses.t.shape[0] == K and torch.equal(st.num_kf, tb.num_kf)
