"""`solver.solve_pose` in its fixed-iteration form (what a CUDA graph
captures: no loop test read back, every one of `iters` iterations run, the
solve frozen once it meets its test) against the early-exit loop: pose,
costs, iterations, damping, step test, rejections and gradient norm must be
bit-equal, in float32 and float64, for a solve that stops after two
iterations, one that reaches `iters`, one that stops on rejected steps, and
a batch of three sessions (a batched solve freezes each session once it
meets its test), one of them converging after two iterations while the
others go on.
No JAX: the early-exit loop is the port's own, held to the reference by
tests/test_torch_solver.py."""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch.ops import solver
from intensity_slam_tpu_torch.utils import se3
from intensity_slam_tpu_torch.utils.se3 import Pose

torch.set_num_threads(1)

# (seed, point noise, motion scale, iters, what stops the early-exit loop);
# a batch has a tuple of seeds, noises and scales, one a session
CASES = {
    "two_iterations": (1, 0.01, 0.0, 20),
    "reaches_iters": (2, 0.05, 4.0, 3),
    "rejected_steps": (0, 0.05, 1.0, 20),
    "batched": ((1, 2, 3), (0.01, 0.05, 0.02), (0.0, 1.0, 2.0), 20),
}
G = 64


def _points(seed, noise, scale):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(G, 3)) * 3
    xi = np.concatenate([rng.normal(size=3) * 0.1 * scale,
                         rng.normal(size=3) * 0.5 * scale])
    dst = (se3.transform_points(se3.se3_exp(torch.tensor(xi)), torch.tensor(src)).numpy()
           + rng.normal(size=(G, 3)) * noise)
    return src, dst


def _problem(case, dtype):
    seed, noise, scale, iters = CASES[case]
    if case == "batched":
        pts = [_points(*p) for p in zip(seed, noise, scale)]
        src, dst = np.stack([p[0] for p in pts]), np.stack([p[1] for p in pts])
    else:
        src, dst = _points(seed, noise, scale)
    t = lambda a: torch.tensor(a, dtype=dtype)
    fn = solver.point_to_point(t(src), t(dst), t(np.ones(src.shape[:-1])))
    if case == "rejected_steps":
        # the Jacobian's sign flipped: every step goes uphill and is rejected
        jac = fn.jacobian
        fn.jacobian = lambda p: -jac(p)
    return fn, iters


def _fields(res):
    return {"pose.q": res.pose.q, "pose.t": res.pose.t,
            **{f: getattr(res, f) for f in res._fields if f != "pose"}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", list(CASES))
def test_fixed_iterations_bit_equal_to_early_exit(case, dtype):
    fn, iters = _problem(case, dtype)
    lead = (len(CASES[case][0]),) if case == "batched" else ()
    p0 = Pose.identity(lead, dtype=dtype, device="cpu")
    early = solver.solve_pose(p0, fn, iters=iters)
    fixed = solver.solve_pose(p0, fn, iters=iters, fixed=True)
    if case == "batched":
        # one session stops after two iterations, the batch before `iters`
        # (so the fixed form runs frozen iterations the early exit does not)
        its = early.iterations.tolist()
        assert its[0] == 2 and min(its[1:]) > 2 and max(its) < iters, its
    elif case == "two_iterations":
        its = int(early.iterations)
        assert its == 2 and int(early.rejections) == 0
    elif case == "reaches_iters":
        its = int(early.iterations)
        assert its == iters and bool(early.grad_norm > 1.0)
    else:
        assert int(early.rejections) == 3 and int(early.iterations) == 3
    for name, a in _fields(early).items():
        b = _fields(fixed)[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, a, b)


def test_fixed_form_reads_nothing(monkeypatch):
    """The fixed form never turns a tensor into a Python value (the early
    exit does, once an iteration)."""
    fn, iters = _problem("two_iterations", torch.float32)
    p0 = Pose.identity(device="cpu")

    def refuse(*a, **k):
        raise AssertionError("host read in the fixed-iteration solve")

    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    solver.solve_pose(p0, fn, iters=iters, fixed=True)
    with pytest.raises(AssertionError, match="host read"):
        solver.solve_pose(p0, fn, iters=iters)
