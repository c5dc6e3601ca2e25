"""The keyframe branch inside the frame graph, on the CPU at
small_test_config shapes:

(a) the BoW scores (`bow._chunk_scores`, `detect_loop`) from the exact +-1
    float32 product are equal to the JAX package's popcount sums, on seeded
    signatures with near copies, ties (duplicate history rows and equal
    scores) and invalid rows on both sides;
(b) `posegraph.consistent_loop_mask`, its growth steps guarded by "the last
    step added a loop" (`graph_cond.when`), is bit-equal to the
    host-bounded loop it replaces and equal to the JAX function, on random
    graphs with 0, 1 and many valid loops and with the loop store full;
(c) `posegraph.optimize` with the two triangular solves is within 1e-6 (m,
    quaternion components) of the `cholesky_solve` form it replaces and
    within 1e-4 of the JAX PGO (test_torch_loop.py's tolerance: float32
    rounding order); its Jacobian blocks, one `vmap` pass over six tangents,
    and the solve they feed are bit-equal to six single-tangent passes;
(d) `FrameGraph` over the 38-frame out-and-back with `max_keyframes` 8 (a
    compaction at the ninth keyframe, an accepted loop at frame 36, the map
    rebuilt: `rebuild_on_loop`) is bit-equal to a loop of the functional
    `fused.fused_step`, every segment and the keyframe region under the
    host-read guard of tests/test_torch_frame_graph.py (the CPU's proxy for
    capturability), the solver and the capacity policy in their conditional
    forms; the keyframe, compact, verify, accept and rebuild regions run
    exactly where the flags read after the frame say, and the frame's flags
    read (the flags, then the regions' device stamps) is its one `tolist`.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from intensity_slam_tpu import config as JC
from intensity_slam_tpu.ops import bow as JB
from intensity_slam_tpu.pipeline import posegraph as JPG
from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.ops import bow as TB
from intensity_slam_tpu_torch.ops import projection, solver
from intensity_slam_tpu_torch.pipeline import frame_graph, fused, mapping
from intensity_slam_tpu_torch.pipeline import posegraph as TPG
from intensity_slam_tpu_torch.utils import graph_cond, se3, spans
from intensity_slam_tpu_torch.utils.se3 import Pose
from test_torch_frame_graph import _same_info, _same_state, host_read_guard

torch.set_num_threads(1)


# ---- (a) the BoW scores --------------------------------------------------------

def _signatures(seed: int, n_hist: int):
    """The current signature (S, 9) and a history (n_hist, S, 9) of near
    copies (0-40 bits flipped a descriptor), duplicate rows (Hamming ties),
    strangers, invalid rows; uint32 words."""
    rng = np.random.default_rng(seed)
    S = TB.SIG_FEATURES
    cur = rng.integers(0, 2 ** 32, size=(S, 8), dtype=np.uint64).astype(np.uint32)
    cv = rng.random(S) < 0.85
    hist, hval = [], []
    for c in range(n_hist):
        if c % 4 == 3:      # a stranger
            d = rng.integers(0, 2 ** 32, size=(S, 8), dtype=np.uint64).astype(np.uint32)
        else:
            d = cur.copy()
            for i in range(S):
                for _ in range(int(rng.integers(0, 41))):
                    b = int(rng.integers(0, 256))
                    d[i, b // 32] ^= np.uint32(1 << (b % 32))
            perm = rng.permutation(S)
            d = d[perm]
            d[1::7] = d[0::7][:len(d[1::7])]          # duplicate rows: ties
        hist.append(d)
        hval.append(rng.random(S) < 0.8)
    hist = np.stack(hist)
    hval = np.stack(hval)
    hist[n_hist // 2] = hist[0]                        # equal scores: a tie
    hval[n_hist // 2] = hval[0]
    sig = lambda d, v: np.concatenate([d, v.astype(np.uint32)[..., None]], -1)
    return sig(cur, cv), sig(hist, hval)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_bow_chunk_scores_equal_jax(seed):
    cur, hist = _signatures(seed, 9)
    cd, cv = cur[:, :8], cur[:, 8] > 0
    hd, hv = hist[..., :8], hist[..., 8] > 0
    want = np.asarray(JB._chunk_scores(jnp.asarray(cd), jnp.asarray(cv),
                                       jnp.asarray(hd), jnp.asarray(hv)))
    got = TB._chunk_scores(_i32(cd), torch.from_numpy(cv), _i32(hd), torch.from_numpy(hv))
    np.testing.assert_array_equal(want, got.numpy())
    assert (want > 0.2).sum() >= 3 and (want == 0).sum() >= 1


@pytest.mark.parametrize("cur_idx", [9, 12])
def test_bow_detect_loop_equal_jax(cur_idx):
    cur, hist = _signatures(2, 14)
    valid = np.ones(14, bool)
    valid[5] = False
    lc = dataclasses.replace(JC.LoopConfig(), min_loop_search_gap=2)
    tlc = dataclasses.replace(config.LoopConfig(), min_loop_search_gap=2)
    j = JB.detect_loop(jnp.asarray(cur), jnp.asarray(hist), jnp.asarray(valid),
                       jnp.int32(cur_idx), lc)
    t = TB.detect_loop(_i32(cur), _i32(hist), torch.from_numpy(valid),
                       torch.tensor(cur_idx), tlc)
    assert int(j[0]) == int(t[0]) and bool(j[2]) == bool(t[2])
    assert float(j[1]) == float(t[1])


# ---- (b) the PCM vote ----------------------------------------------------------

K_NODES, L_LOOPS = 24, 256


def _random_graph(seed: int, n_loops: int, full: bool = False) -> TPG.PoseGraph:
    """A drifting chain of 22 nodes with `n_loops` loop edges (a third of
    them inconsistent), or every slot of the loop ring written (`full`)."""
    rng = np.random.default_rng(seed)
    g = TPG.empty(K_NODES, L_LOOPS, device="cpu")
    n = K_NODES - 2
    pose = Pose.identity(device="cpu")
    raws = []
    for k in range(n):
        step = Pose(se3.so3_exp(torch.tensor([0.0, 0.0, float(rng.normal(0, 0.2))])),
                    torch.tensor([1.0, float(rng.normal(0, 0.05)), 0.0]))
        pose = se3.compose(pose, step) if k else pose
        raws.append(pose)
        g = TPG.add_node(g, pose, qual=float(rng.uniform(1, 3)))
    lc = config.LoopConfig()
    for e in range(L_LOOPS + 3 if full else n_loops):
        i, j = (int(x) for x in rng.choice(n, 2, replace=False))
        rel = se3.compose(se3.inverse(raws[i]), raws[j])
        off = rng.normal(0, 3.0 if e % 3 == 2 else 0.02, 3)
        rel = Pose(rel.q, rel.t + torch.tensor(off, dtype=torch.float32))
        g = TPG.add_loop(g, torch.tensor(i), torch.tensor(j), rel,
                         torch.tensor(float(rng.uniform(0.01, 0.2))), lc)
    return g


def _to_jax(g: TPG.PoseGraph):
    proto = JPG.empty(K_NODES, L_LOOPS)
    return jax.tree.unflatten(jax.tree.structure(proto),
                              [jnp.asarray(x.numpy()) for x in frame_graph.leaves(g)])


def _host_bounded(g, **kw):
    """The loop `consistent_loop_mask` replaces: (valid loops - 1) growth
    steps, the bound and the indexing read on the host."""
    valid = g.loop_valid
    Cmat, deg = TPG.pairwise_consistency(g, **kw)
    pivot = torch.argmax(torch.where(valid, deg, -1))
    S = torch.zeros((L_LOOPS,), dtype=torch.bool)
    S[pivot] = torch.any(valid)
    for _ in range(int(torch.sum(valid)) - 1):
        with_all = torch.all(torch.where(S[None, :], Cmat, True), dim=1)
        cand = valid & (~S) & with_all
        score = torch.where(cand, deg, -1)
        nxt = torch.argmax(score)
        S[nxt] = S[nxt] | (score[nxt] >= 0)
    return S


def _pcm_kw():
    lc = config.LoopConfig()
    return dict(odo_noise=lc.odom_noise, drift_rate=lc.loop_drift_rate,
                drift_rot_rate=lc.loop_drift_rot_rate, chi2_max=lc.pcm_chi2)


@pytest.mark.parametrize("n_loops,full", [(0, False), (1, False), (17, False), (0, True)],
                         ids=["none", "one", "many", "full"])
def test_pcm_mask_equals_host_bounded_and_jax(n_loops, full):
    g = _random_graph(n_loops + 11 * full, n_loops, full)
    kw = _pcm_kw()
    graph_cond.ran.clear()
    with host_read_guard():
        got = TPG.consistent_loop_mask(g, **kw)
    want = _host_bounded(g, **kw)
    assert torch.equal(got, want)
    j = jax.jit(lambda jg: JPG.consistent_loop_mask(jg, **kw))(_to_jax(g))
    np.testing.assert_array_equal(np.asarray(j), got.numpy())
    n_valid = int(g.loop_valid.sum())
    assert n_valid == (L_LOOPS if full else n_loops)
    # a step for each loop added after the pivot, and the one that added none
    assert graph_cond.ran["pcm"] == (min(int(got.sum()), L_LOOPS - 1) if n_valid else 0)
    if n_loops == 17 or full:
        assert 1 < int(got.sum()) < n_valid


# ---- (c) the PGO's triangular solves -------------------------------------------

def test_optimize_triangular_solves_against_cholesky_solve_and_jax(monkeypatch):
    g = _random_graph(5, 6)
    lc = config.LoopConfig()
    kw = dict(gn_iters=3, odo_noise=lc.odom_noise, loop_cauchy_c=lc.loop_cauchy_c,
              drift_rate=lc.loop_drift_rate, drift_rot_rate=lc.loop_drift_rot_rate)
    active = TPG.consistent_loop_mask(g, **_pcm_kw())
    with host_read_guard():
        new = TPG.optimize(g, loop_active=active, **kw)
    monkeypatch.setattr(TPG, "_cholesky_solve", lambda L, b: torch.cholesky_solve(b, L))
    old = TPG.optimize(g, loop_active=active, **kw)
    monkeypatch.undo()
    moved = float((new.poses.t - g.poses.t).abs().max())
    assert moved > 1e-3
    for a, b in ((new.poses.t, old.poses.t), (new.poses.q, old.poses.q)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    jo = JPG.optimize(_to_jax(g), loop_active=jnp.asarray(active.numpy()), **kw)
    np.testing.assert_allclose(np.asarray(jo.poses.t), new.poses.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(jo.poses.q), new.poses.q.numpy(), atol=1e-4)


def _jac6_six_passes(f, batch_shape, device):
    """The six single-tangent forward-mode passes `posegraph._jac6` replaces."""
    x0 = torch.zeros(tuple(batch_shape) + (6,), device=device)
    eye = torch.eye(6, device=device)
    return torch.stack([jvp(f, (x0,), (eye[i].expand_as(x0),))[1] for i in range(6)], dim=-1)


def test_jacobians_in_one_pass_equal_six_passes(monkeypatch):
    g = _random_graph(7, 17)
    lc = config.LoopConfig()
    kw = dict(gn_iters=3, odo_noise=lc.odom_noise, loop_cauchy_c=lc.loop_cauchy_c,
              drift_rate=lc.loop_drift_rate, drift_rot_rate=lc.loop_drift_rot_rate,
              loop_active=None)
    poses = g.poses
    rel_est = se3.compose(se3.inverse(Pose(torch.roll(poses.q, 1, 0),
                                           torch.roll(poses.t, 1, 0))), poses)
    si = torch.rand(L_LOOPS, 6, generator=torch.Generator().manual_seed(0)) * g.loop_valid[:, None]

    def blocks():
        return (TPG._edge_jacobians(rel_est, g.odo_rel, si[:K_NODES])[1],
                TPG._loop_jacobians(poses, g.loop_i, g.loop_j, g.loop_rel, si)[1],
                TPG._solve(g, **kw))

    edge, loop, solved = blocks()
    monkeypatch.setattr(TPG, "_jac6", _jac6_six_passes)
    edge6, loop6, solved6 = blocks()
    assert torch.equal(edge, edge6) and torch.equal(loop, loop6)
    assert float(edge.abs().max()) > 0 and float(loop.abs().max()) > 0
    assert torch.equal(solved.t, solved6.t) and torch.equal(solved.q, solved6.q)


# ---- (d) the frame graph over keyframes, a compaction and an accepted loop -------

FRAMES = 38


def _cfg():
    cfg = config.small_test_config()
    return cfg.replace(loop=dataclasses.replace(
        cfg.loop, sc_num_exclude_recent=4, min_loop_search_gap=4, max_keyframes=8,
        keyframe_cloud_size=512))


@pytest.fixture(scope="module")
def out_and_back():
    cfg = _cfg()
    xyz, inten = synthetic.render_sequence(synthetic.out_and_back_trajectory(device="cpu"),
                                           synthetic.corridor_world(device="cpu"), cfg.sensor)
    mask = projection.detection_mask(cfg.sensor, device="cpu")
    st = fused.init_state(cfg, seed=3, device="cpu")
    infos = []
    for k in range(FRAMES):
        st, info = fused.fused_step(st, xyz[k], inten[k], 0.1 * k, mask, cfg)
        infos.append(info)
    return cfg, xyz, inten, st, infos


SEGMENTS = ("_front", "_fallback", "_back", "_keyframe", "_log")


def test_frame_graph_keyframe_branch_bit_equal_to_fused_step(out_and_back, monkeypatch):
    cfg, xyz, inten, st, infos = out_and_back
    kfs = [k for k, i in enumerate(infos) if bool(i.is_keyframe)]
    loops = [k for k, i in enumerate(infos) if bool(i.loop_found)]
    compacted = [k for k, i in enumerate(infos) if bool(i.compacted)]
    assert len(kfs) >= 9 and loops and compacted and compacted[0] < loops[-1], \
        (kfs, loops, compacted)
    monkeypatch.setattr(solver, "solve_pose", functools.partial(solver.solve_pose, cond=True))
    monkeypatch.setattr(mapping, "evict_policy",
                        functools.partial(mapping.evict_policy, cond=True))
    fg = frame_graph.FrameGraph(cfg, "cpu", seed=3)
    ran = []
    for name in SEGMENTS:
        seg = getattr(fg, name)

        def guarded(*a, _seg=seg, _n=name):
            ran.append(_n)
            with host_read_guard():
                return _seg(*a)
        setattr(fg, name, guarded)
    reads = []
    tolist = torch.Tensor.tolist

    def counted(t):
        reads.append(tuple(t.shape))
        return tolist(t)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    regions = []
    for k in range(FRAMES):
        graph_cond.ran.clear()
        reads.clear()
        info = fg.step(xyz[k], inten[k], 0.1 * k)
        assert reads == [(len(fg.FLAGS) + spans.SLOTS,)], (k, reads)
        assert _same_info(infos[k], info), k
        flags = fg.last_flags
        taken = {r: graph_cond.ran[r] for r in fg.REGIONS}
        assert taken == {r: int(bool(flags[r])) for r in fg.REGIONS}, (k, taken, flags)
        regions.append(taken)
    monkeypatch.undo()
    assert set(SEGMENTS) <= set(ran)
    assert _same_state(st, fg.state)
    for r in ("keyframe", "compact", "verify", "accept", "rebuild"):
        assert sum(t[r] for t in regions) >= 1, (r, regions)
    assert [k for k, t in enumerate(regions) if t["accept"]] == loops
    assert [k for k, t in enumerate(regions) if t["compact"]] == compacted


def test_regions_hand_results_on_through_buffers(out_and_back):
    """`graph_cond.cond` returns a copy of its default made before the
    region and leaves its inputs untouched, taken or not."""
    x = torch.arange(4.0)
    default = (x, Pose.identity(device="cpu"))
    for pred in (True, False):
        out = graph_cond.cond(torch.tensor(pred), "test", lambda: (x + 1, Pose(
            torch.ones(4), torch.ones(3))), default)
        assert out[0].data_ptr() != x.data_ptr()
        assert torch.equal(out[0], x + 1 if pred else x)
        assert torch.equal(x, torch.arange(4.0))


def test_warm_up_forces_the_keyframe_regions(out_and_back, monkeypatch):
    """Before its capture `FrameGraph` runs the keyframe branch once with
    every region forced (each timed into `warmup_s`) on the live state,
    which it leaves untouched."""
    cfg, xyz, inten, st, _ = out_and_back
    fg = frame_graph.FrameGraph(cfg, "cpu", seed=3)
    fg.step(xyz[0], inten[0], 0.0)
    before = fg.snapshot()
    fr = fg._front()
    out = fg._back(fr)
    fg.adopt(before)
    forced = []
    when = graph_cond.when

    @contextlib.contextmanager
    def seen(pred, name):
        with when(pred, name) as taken:
            if taken and name in fg.KEYFRAME_REGIONS:
                forced.append(name)
            yield taken

    monkeypatch.setattr(graph_cond, "when", seen)
    fg._warm_up(fr, out)
    monkeypatch.undo()
    assert set(forced) == set(fg.KEYFRAME_REGIONS), forced
    assert set(fg.warmup_s) >= set(fg.KEYFRAME_REGIONS) | {"keyframe"}
    assert all(v >= 0 for v in fg.warmup_s.values()), fg.warmup_s
    assert _same_state(before, fg.state)


def test_profile_tool_keyframe_rows_run():
    """`tools/torch_profile_stages.py`'s `FULL keyframe (graphs)` and `FULL
    keyframe, accepted loop (graphs)` rows (timed on the card only) on the
    CPU at small_test_config: the plain keyframe verifies nothing, the loop
    frame accepts its loop, and every call set back to the same state gives
    the same frame."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_profile_stages.py"
    spec = importlib.util.spec_from_file_location("torch_profile_stages", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    prof = tool.Profiler(torch.device("cpu"), reps=1)
    fg = tool.keyframe_graph_rows(prof, tool.out_and_back_config(config.small_test_config()))
    rows = {r["stage"]: r for r in prof.rows}
    assert set(rows) == {"FULL keyframe (graphs)", "FULL keyframe, accepted loop (graphs)"}
    assert all(r["host_ms"] > 0 and r["repeat_outputs_differing"] == 0 for r in rows.values())
    assert fg.last_flags["accept"] and fg.last_flags["rebuild"]
