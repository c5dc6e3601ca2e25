"""The scan-to-map pose solve's wrapper (`ops/mapsolve.py`) on the CPU,
where it runs the plain composition; the kernels of `csrc/mapsolve.cu` are
held to it on the card (tests/test_torch_mapsolve_cuda.py, `-m cuda`).

- `mapsolve.solve` on CPU tensors bit-equal to `solver.solve_pose` over
  the residual stack `mapping_step` built before the kernels (its closures
  and `concat_residuals`, written out here), on the arguments that
  `mapping_step` passes: each frame of tests/test_torch_mapping.py's
  corridor (corner rows on), three of its frames as B = 3 sessions, and
  the sliding window at W = 2 (point-to-point rows) through `slam_step`.
- `mapping_step`'s outputs and new state from the reference's carried
  states bit-equal to those of `mapping_step` with that stack solved in
  place of the wrapper.
- The wrapper's argument checks: dtype, shape, device, leading dims.
"""

import dataclasses

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.io import synthetic as tsynthetic
from intensity_slam_tpu_torch.ops import mapsolve, projection, solver
from intensity_slam_tpu_torch.pipeline import slam as TS
from intensity_slam_tpu_torch.utils import tree
from intensity_slam_tpu_torch.utils.se3 import Pose

from test_torch_mapping import FRAMES, _port_step, _tcfg, seq  # noqa: F401  (the fixture)

torch.set_num_threads(1)
FIELDS = ("final_cost", "initial_cost", "iterations", "converged", "min_hessian_eig",
          "damping", "rel_decrease", "rejections", "grad_norm")


def stack_solve(prior, prior_sqrt_info, planes, lines=None, points=None, iters=10,
                robust_scale=0.2):
    """The solve `mapping_step` made before the kernels: its residual sets
    in its order, stacked, through `solver.solve_pose`."""
    residual_sets = [
        (solver.point_to_plane_nd(*planes), 1),
        (mapsolve.pose_prior(prior, prior_sqrt_info), 6),
    ]
    if lines is not None:
        residual_sets.append((solver.point_to_line(*lines), 3))
    if points is not None:
        residual_sets.append((solver.point_to_point(*points), 3))
    return solver.solve_pose(prior, solver.concat_residuals(*residual_sets), iters=iters,
                             robust="huber", robust_scale=robust_scale)


def _same(a: solver.SolveResult, b: solver.SolveResult) -> bool:
    return (torch.equal(a.pose.q, b.pose.q) and torch.equal(a.pose.t, b.pose.t)
            and all(getattr(a, f).dtype == getattr(b, f).dtype
                    and torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS))


def _recorded(run):
    """The arguments of every `mapsolve.solve` call that `run()` makes."""
    calls, solve = [], mapsolve.solve

    def recording(*a, **k):
        calls.append(tree.clone_state((a, k)))
        return solve(*a, **k)
    mapsolve.solve = recording
    try:
        run()
    finally:
        mapsolve.solve = solve
    return calls


@pytest.fixture(scope="module")
def corridor_calls(seq):  # noqa: F811
    """`mapping_step`'s solve arguments on each frame of the corridor, from
    the reference's carried states."""
    cfg, rows, _ = seq
    tcfg = _tcfg(cfg)
    assert tcfg.mapping.use_corner_residuals and tcfg.mapping.sliding_window_size == 0

    def run():
        for inputs, before, _ in rows:
            _port_step(interop.state_from_numpy(before, device="cpu"), inputs, tcfg)
    return _recorded(run)


@pytest.fixture(scope="module")
def window_calls():
    """`mapping_step`'s solve arguments through `slam_step` with the
    sliding window at W = 2 (test_torch_mapping.py's gates)."""
    cfg = tconfig.small_test_config()
    cfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, sliding_window_size=2, window_min_matches=10, window_min_good=3,
        window_keep_frac=0.5))
    poses = tsynthetic.corridor_trajectory(5, speed=0.35, device="cpu")
    xyz, inten = tsynthetic.render_sequence(poses, tsynthetic.corridor_world(device="cpu"),
                                            cfg.sensor)
    mask = projection.detection_mask(cfg.sensor, device="cpu")

    def run():
        st = TS.init_state(cfg, device="cpu")
        for k in range(xyz.shape[0]):
            st, _ = TS.slam_step(st, xyz[k], inten[k], k * 0.1, mask, cfg)
    return _recorded(run)


def test_each_corridor_frame_bit_equal_to_the_stack(corridor_calls):
    assert len(corridor_calls) == FRAMES
    moved = 0
    for a, k in corridor_calls:
        assert a[3] is not None and a[4] is None       # corner rows, no window
        res = mapsolve.solve(*a, **k)
        assert _same(res, stack_solve(*a, **k))
        moved += int(res.iterations) > 1
    assert moved >= 5


def test_three_sessions_bit_equal_to_the_stack(corridor_calls):
    """Frames 1, 5 and 9 as one batch: the wrapper against the batched
    stack; a session stops before the others."""
    picked = [corridor_calls[k][0] for k in (1, 5, 9)]
    st = lambda f: torch.stack([f(a) for a in picked])
    prior = Pose(st(lambda a: a[0].q), st(lambda a: a[0].t))
    si = st(lambda a: a[1])
    planes = tuple(st(lambda a, i=i: a[2][i]) for i in range(4))
    lines = tuple(st(lambda a, i=i: a[3][i]) for i in range(4))
    res = mapsolve.solve(prior, si, planes, lines, None, iters=10, robust_scale=0.2)
    assert res.pose.q.shape == (3, 4) and res.iterations.shape == (3,)
    assert _same(res, stack_solve(prior, si, planes, lines, None, iters=10,
                                  robust_scale=0.2))
    assert len(set(res.iterations.tolist())) > 1


def test_sliding_window_bit_equal_to_the_stack(window_calls):
    used = 0
    for a, k in window_calls:
        assert a[4] is not None
        assert _same(mapsolve.solve(*a, **k), stack_solve(*a, **k))
        used += int((a[4][2] > 0).sum()) > 0
    assert used >= 2


def test_mapping_step_unchanged(seq, monkeypatch):  # noqa: F811
    """`mapping_step` from the reference's carried states: outputs and new
    state bit-equal to a run with the stack solved in place of the
    wrapper."""
    cfg, rows, _ = seq
    tcfg = _tcfg(cfg)
    for k in (0, 1, 5, 9):
        inputs, before, _ = rows[k]
        new, out = _port_step(interop.state_from_numpy(before, device="cpu"), inputs, tcfg)
        with monkeypatch.context() as m:
            m.setattr(mapsolve, "solve", stack_solve)
            ref_new, ref_out = _port_step(interop.state_from_numpy(before, device="cpu"),
                                          inputs, tcfg)
        for x, y in zip(tree.leaves((new, out)), tree.leaves((ref_new, ref_out))):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        assert int(out.solve_iterations) >= 1


def _args(B=None, gp=16, gl=8, gw=0):
    lead = () if B is None else (B,)
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(lead + s, generator=g)
    prior = Pose.identity(lead, device="cpu")
    planes = (r(gp, 3), r(gp, 3), r(gp), torch.ones(lead + (gp,)))
    lines = (r(gl, 3), r(gl, 3), r(gl, 3), torch.ones(lead + (gl,)))
    points = (r(gw, 3), r(gw, 3), torch.ones(lead + (gw,))) if gw else None
    return [prior, torch.ones(lead + (6,)), planes, lines, points]


def _bad(case):
    a = _args()
    if case == "float64 points":
        a[2] = (a[2][0].double(),) + a[2][1:]
    elif case == "float64 prior":
        a[0] = Pose(a[0].q.double(), a[0].t.double())
    elif case == "int weights":
        a[3] = a[3][:3] + (torch.ones(8, dtype=torch.int32),)
    elif case == "normals of width 2":
        a[2] = (a[2][0], a[2][1][:, :2]) + a[2][2:]
    elif case == "offsets of another length":
        a[2] = a[2][:2] + (a[2][2][:-1], a[2][3])
    elif case == "sqrt_info of 3":
        a[1] = a[1][:3]
    elif case == "three line tensors":
        a[3] = a[3][:3]
    elif case == "no planes":
        a[2] = None
    elif case == "sessions of two dims":
        a = _args()
        a[0] = Pose.identity((2, 2), device="cpu")
    elif case == "33 sessions":
        a = _args(B=33)
    elif case == "points on another device":
        a[2] = (a[2][0].to("meta"),) + a[2][1:]
    elif case == "every tensor on meta":
        a = [tree.map_leaves(x, lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t)
             for x in a]
    return a


BAD = {"float64 points": TypeError, "float64 prior": TypeError, "int weights": TypeError,
       "normals of width 2": ValueError, "offsets of another length": ValueError,
       "sqrt_info of 3": ValueError, "three line tensors": ValueError,
       "no planes": ValueError, "sessions of two dims": ValueError,
       "33 sessions": ValueError, "points on another device": ValueError,
       "every tensor on meta": ValueError}


@pytest.mark.parametrize("case", sorted(BAD))
def test_argument_checks_raise(case):
    with pytest.raises(BAD[case], match="mapsolve"):
        mapsolve.solve(*_bad(case), iters=3)


@pytest.mark.parametrize("B,gw", [(None, 0), (3, 0), (2, 5)])
def test_valid_shapes_pass_the_checks(B, gw):
    res = mapsolve.solve(*_args(B=B, gw=gw), iters=3)
    lead = () if B is None else (B,)
    assert res.pose.t.shape == lead + (3,) and res.iterations.shape == lead
    assert np.isfinite(res.final_cost.numpy()).all()
