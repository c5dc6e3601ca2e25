"""The batched `slam_step` (B sessions in one launch sequence) against
`jax.vmap` of the JAX package's `slam.slam_step`, and against the port's
own unbatched step session by session, at small_test_config.

Three corridor streams, staggered by one frame each (stream b starts at
frame b of the render), the third at constant intensity 100 so that its
intensity odometry skips every frame and its frames after the first go
through the geometric fallback (solved on all three sessions, kept for it
alone) while the others do not: a mixed batch.  Four frames.  The scans
are the JAX renderer's; the reference runs `jax.jit(jax.vmap(
JS.slam_step))` from states seeded 0, 1, 2, and the port gets each
session's own RANSAC draws along its key chain, as tests/test_torch_slam.py
does.

- Against the reference, per session: `skip`, `is_keyframe`, `num_good`,
  `ground_ok` EQUAL on every frame; `odom_pose` within 1e-4 on the textured
  sessions and 5e-3 on the flat one; the mapping pose within 2e-3 and 1e-2
  (tests/test_torch_slam.py's tolerances, for the same reasons; found:
  1.5e-6 and 2.1e-4, 3.1e-4 and 6.7e-4).
- Against the port's unbatched `slam_step` (same draws), per session:
  discrete fields and host flags EQUAL, `num_plane_residuals` within 4 and
  `map_points` within 1 % (the reference comparison's bounds); the odometry
  pose within 1e-5 m (found: 1.8e-8 textured, 1.2e-6 on the flat session's
  fallback solves); the scan-to-map pose within the reference comparison's
  2e-3 / 1e-2 (found: 5.1e-4 textured, 7.7e-4 flat).  The
  batch sums a few products in another order than one session does (a
  batched matrix product against a single one: the solver's J^T W r, the
  small 3x3 products of `se3_exp`/`se3_log`), and the scan-to-map solve
  amplifies that rounding as it does the port-vs-reference one; the
  unbatched step keeps its arithmetic bit for bit.  For the same reason a
  solve's last iterations may differ (its stopping test on a 1e-6 relative
  cost decrease sits near float32 rounding): each session makes the same
  solver calls in the batch as alone, with equal iteration counts over the
  first two frames, and tests/test_torch_multisession_ops.py holds the
  freeze itself in float64.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu.pipeline import slam as JS
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.ops import solver
from intensity_slam_tpu_torch.pipeline import slam as TS

torch.set_num_threads(1)

B, FRAMES = 3, 4
FLAT = 2
POS_TOL = {"textured": 1e-4, "flat": 5e-3}
MAP_TOL = {"textured": 2e-3, "flat": 1e-2}
FIELDS = ("skip", "is_keyframe", "num_good", "ground_ok")
ODOM_TOL_UNBATCHED = 1e-5
EQUAL_ITER_CALLS = 4          # frames 0-1: odometry and scan-to-map solves


def _kind(b):
    return "flat" if b == FLAT else "textured"


def _streams(cfg):
    poses = synthetic.corridor_trajectory(FRAMES + B, speed=0.35)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(), cfg.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    xb = np.stack([np.roll(xyz, -b, 0) for b in range(B)], 1)[:FRAMES]
    ib = np.stack([np.roll(inten, -b, 0) for b in range(B)], 1)[:FRAMES]
    ib[:, FLAT] = 100.0
    return xb, ib


class _IterationSpy:
    """Records the iteration counts of every `solver.solve_pose` call, with
    whether the geometric fallback (`geometric.geometric_delta`) made it."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = solver.solve_pose

        def spy(*a, **kw):
            res = orig(*a, **kw)
            caller = sys._getframe(1).f_globals["__name__"]
            self.calls.append((res.iterations.clone(), caller.endswith(".geometric")))
            return res

        monkeypatch.setattr(solver, "solve_pose", spy)


def reference_rows(cfg, xb, ib):
    """`jax.jit(jax.vmap(JS.slam_step))` over the streams from states seeded
    0..B-1: its rows (numpy), and each frame's (B, K, 3) RANSAC draws along
    the sessions' key chains, for the port."""
    jmask = JP.detection_mask(cfg.sensor)
    jstep = jax.jit(jax.vmap(lambda s, x, i, t: JS.slam_step(s, x, i, t, jmask, cfg)))
    js = jax.vmap(lambda sd: JS.init_state(cfg, sd))(jnp.arange(B))
    K = cfg.ground.ransac_iters
    jrows, draws = [], []
    for k in range(FRAMES):
        draws.append(np.stack([
            np.asarray(jax.random.uniform(jax.random.split(js.rng[b])[1], (K, 3)))
            for b in range(B)]))
        js, jo = jstep(js, xb[k], ib[k], jnp.full((B,), k * 0.1, jnp.float32))
        jrows.append(jax.tree.map(np.asarray, jo))
    return jrows, draws


@pytest.fixture(scope="module")
def runs():
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    xb, ib = _streams(cfg)
    jrows, draws = reference_rows(cfg, xb, ib)
    tmask = TP.detection_mask(tcfg.sensor, device="cpu")
    mp = pytest.MonkeyPatch()
    spy = _IterationSpy(mp)
    ts = TS.init_batched_state(tcfg, range(B), device="cpu")
    trows, batched_calls = [], []
    for k in range(FRAMES):
        ts, to = TS.slam_step_batched(ts, torch.from_numpy(xb[k].copy()),
                                      torch.from_numpy(ib[k].copy()), k * 0.1, tmask, tcfg,
                                      ground_u=torch.from_numpy(draws[k]))
        trows.append(to)
        batched_calls.append(spy.calls)
        spy.calls = []
    singles = []
    for b in range(B):
        s = TS.init_state(tcfg, seed=b, device="cpu")
        outs = []
        for k in range(FRAMES):
            s, o = TS.slam_step(s, torch.from_numpy(xb[k, b].copy()),
                                torch.from_numpy(ib[k, b].copy()), k * 0.1, tmask, tcfg,
                                ground_u=torch.from_numpy(draws[k][b].copy()))
            outs.append(o)
        singles.append((outs, spy.calls))
        spy.calls = []
    mp.undo()
    return jrows, trows, batched_calls, singles


@pytest.mark.parametrize("field", FIELDS)
def test_discrete_outputs_equal_the_reference(runs, field):
    jrows, trows, *_ = runs
    for jo, to in zip(jrows, trows):
        assert getattr(jo, field).tolist() == getattr(to, field).tolist()
    skips = np.array([to.skip.tolist() for to in trows])
    assert skips[:, FLAT].all() and not skips[1:, :FLAT].any()   # a mixed batch


def test_poses_follow_the_reference(runs):
    jrows, trows, *_ = runs
    for jo, to in zip(jrows, trows):
        for b in range(B):
            tol, mtol = POS_TOL[_kind(b)], MAP_TOL[_kind(b)]
            np.testing.assert_allclose(to.odom_pose.t[b].numpy(), jo.odom_pose.t[b], atol=tol)
            np.testing.assert_allclose(to.odom_pose.q[b].numpy(), jo.odom_pose.q[b], atol=tol)
            np.testing.assert_allclose(to.pose.t[b].numpy(), jo.pose.t[b], atol=mtol)
            np.testing.assert_allclose(to.pose.q[b].numpy(), jo.pose.q[b], atol=mtol)
    assert trows[-1].pose.t.shape == (B, 3) and trows[-1].map_points.shape == (B,)


def test_each_session_is_its_unbatched_run(runs):
    _, trows, batched_calls, singles = runs
    for b, (outs, calls) in enumerate(singles):
        for k, o in enumerate(outs):
            bo = trows[k]
            assert bo.host[b] == o.host
            for f in FIELDS:
                assert int(getattr(bo, f)[b]) == int(getattr(o, f)), (b, k, f)
            a, c = int(bo.num_plane_residuals[b]), int(o.num_plane_residuals)
            assert abs(a - c) <= 4, (b, k, a, c)
            a, c = int(bo.map_points[b]), int(o.map_points)
            assert abs(a - c) <= 0.01 * c, (b, k, a, c)
            for pose, tol in (("odom_pose", ODOM_TOL_UNBATCHED), ("pose", MAP_TOL[_kind(b)])):
                for f in ("t", "q"):
                    d = (getattr(getattr(bo, pose), f)[b] - getattr(getattr(o, pose), f))
                    assert float(d.abs().max()) <= tol, (b, k, pose, f, float(d.abs().max()))
        # the session's solver calls, in order, in the batch (whose calls
        # carry (B,) counts; the fallback solves every session when one
        # takes it, and counts for those whose flags say `skip & has_prev`):
        # as many calls, the same iterations over the first frames
        mine = []
        for k, frame_calls in enumerate(batched_calls):
            h = trows[k].host[b]
            for it, fallback in frame_calls:
                assert it.shape == (B,)
                if not fallback or (h.skip and h.has_prev):
                    mine.append(int(it[b]))
        alone = [int(it) for it, _ in calls]
        assert len(mine) == len(alone), (b, mine, alone)
        assert mine[:EQUAL_ITER_CALLS] == alone[:EQUAL_ITER_CALLS], (b, mine, alone)
