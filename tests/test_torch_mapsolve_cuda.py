"""The scan-to-map solve's kernels (`csrc/mapsolve.cu`, through
`ops/mapsolve.py`) against its plain version (`mapsolve.solve_plain`:
`solver.solve_pose` over the residual closures) on the card (`-m cuda`;
skipped elsewhere).  No JAX: the cases are the port's own, each
`mapping_step` solve of a 10-frame corridor rendered and stepped on the
card at small_test_config (corner rows on), the same with the sliding
window at W = 2 (point-to-point rows), and three of the corridor's solves
as B = 3 sessions, of which one stops iterations before the others.

The kernels sum in another order than torch's einsums, and a solve's last
tests (a trial cost against the cost, a relative decrease against 1e-6)
are often decided by rounding: on such a step the plain solve itself ends
elsewhere when only the order of its rows changes.  So each case also
solves the plain version with its rows permuted (`PERMUTATIONS` times),
and the kernels must agree with the plain solve to within the larger of
a fixed tolerance (pose 1e-5 m, quaternion 1e-6, cost 1e-5 relative) and
twice that spread; each session's iterations must be the plain solve's, or
one of its permuted runs', or at most the three rejections in a row that
end a solve away from the plain solve's.

Besides: a batch bit-equal to its sessions solved one at a time; a solve
captured as a chain of conditional nodes, replayed twice bit-equal, and on
other inputs bit-equal to the eager kernels (iterations included); the
kernels counted by name in a trace (an evaluation and a step kernel to
start and an iteration, eagerly and in a replay, which also runs the
handle kernel of each of the `gn_iters` nodes)."""

import dataclasses
import os
import sys

import pytest
import torch

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.ops import mapsolve, projection, solver
from intensity_slam_tpu_torch.pipeline import slam
from intensity_slam_tpu_torch.utils import graph_cond, tree
from intensity_slam_tpu_torch.utils.se3 import Pose
from kernel_trace import launched

pytestmark = pytest.mark.cuda

FRAMES = 10
PERMUTATIONS = 8
MAX_REJECT = 3              # the rejections in a row that end a solve
POSE_TOL_M, QUAT_TOL, COST_TOL = 1e-5, 1e-6, 1e-5
KERNELS = ("mapsolve_eval_kernel", "mapsolve_step_kernel", "set_handle_kernel")
FIELDS = ("final_cost", "initial_cost", "iterations", "converged", "min_hessian_eig",
          "damping", "rel_decrease", "rejections", "grad_norm")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels exist only on the card")


def _calls(window: bool):
    """The arguments of each `mapsolve.solve` call of `slam_step` over the
    corridor on the card, and the modules that called `solver.solve_pose`
    meanwhile."""
    dev = torch.device("cuda")
    cfg = config.small_test_config()
    if window:
        cfg = cfg.replace(mapping=dataclasses.replace(
            cfg.mapping, sliding_window_size=2, window_min_matches=10, window_min_good=3,
            window_keep_frac=0.5))
    poses = synthetic.corridor_trajectory(FRAMES, speed=0.35, device=dev)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(device=dev),
                                           cfg.sensor)
    mask = projection.detection_mask(cfg.sensor, device=dev)
    calls, callers, solve, solve_pose = [], set(), mapsolve.solve, solver.solve_pose

    def recording(*a, **k):
        calls.append(tree.clone_state((a, k)))
        return solve(*a, **k)

    def plain_caller(*a, **k):
        callers.add(os.path.basename(sys._getframe(1).f_code.co_filename))
        return solve_pose(*a, **k)
    mapsolve.solve, solver.solve_pose = recording, plain_caller
    try:
        st = slam.init_state(cfg, device=dev)
        for k in range(FRAMES):
            st, _ = slam.slam_step(st, xyz[k], inten[k], k * 0.1, mask, cfg)
    finally:
        mapsolve.solve, solver.solve_pose = solve, solve_pose
    return calls, callers


@pytest.fixture(scope="module")
def corridor_run():
    _need_card()
    return _calls(window=False)


@pytest.fixture(scope="module")
def corridor(corridor_run):
    return corridor_run[0]


@pytest.fixture(scope="module")
def window():
    _need_card()
    return _calls(window=True)[0]


def test_mapping_step_leaves_solve_pose_to_the_others(corridor_run):
    """On the card `mapping_step` solves through the kernels only; the
    odometry still calls `solver.solve_pose`."""
    calls, callers = corridor_run
    assert len(calls) == FRAMES
    assert "odometry.py" in callers and "mapping.py" not in callers \
        and "mapsolve.py" not in callers, callers


def _permuted(a, gen):
    """The call's arguments with the rows of each residual set permuted."""
    prior, si, *groups = a

    def perm(group):
        if group is None:
            return None
        n = group[0].shape[-2]
        p = torch.randperm(n, generator=gen, device="cpu").to(group[0].device)
        return tuple(x[..., p, :] if x.dim() == group[0].dim() else x[..., p] for x in group)
    return (prior, si, *map(perm, groups))


def _max(x) -> float:
    return float(x.abs().max())


def _agree(kern, plain, spread):
    """(the kernels within tolerance of the plain solve, a line to print)."""
    dt, dq = _max(kern.pose.t - plain.pose.t), _max(kern.pose.q - plain.pose.q)
    dc = _max((kern.final_cost - plain.final_cost) / plain.final_cost.abs().clamp(min=1e-12))
    st = max(_max(s.pose.t - plain.pose.t) for s in spread)
    sq = max(_max(s.pose.q - plain.pose.q) for s in spread)
    sc = max(_max((s.final_cost - plain.final_cost) / plain.final_cost.abs().clamp(min=1e-12))
             for s in spread)
    its, p_its = kern.iterations.tolist(), plain.iterations.tolist()
    others = [s.iterations.tolist() for s in spread]
    per = lambda x: x if isinstance(x, list) else [x]
    its_ok = all(k in seen or abs(k - p) <= MAX_REJECT
                 for k, p, *seen in zip(per(its), per(p_its), *map(per, others)))
    ok = (dt <= max(POSE_TOL_M, 2 * st) and dq <= max(QUAT_TOL, 2 * sq)
          and dc <= max(COST_TOL, 2 * sc) and its_ok)
    line = (f"its {its} plain {p_its} permuted {sorted(map(str, others))}; |dt| {dt:.3g} m "
            f"(spread {st:.3g}), |dq| {dq:.3g} ({sq:.3g}), cost {dc:.3g} ({sc:.3g})")
    return ok, line


def _check_cases(calls):
    gen = torch.Generator().manual_seed(0)
    bad, equal = [], 0
    for n, (a, k) in enumerate(calls):
        kern = mapsolve.solve(*a, **k)
        plain = mapsolve.solve_plain(*a, **k)
        spread = [mapsolve.solve_plain(*_permuted(a, gen), **k) for _ in range(PERMUTATIONS)]
        ok, line = _agree(kern, plain, spread)
        equal += kern.iterations.tolist() == plain.iterations.tolist()
        print(f"case {n}: {line}")
        if not ok:
            bad.append((n, line))
    print(f"iterations equal to the plain solve's in {equal} of {len(calls)} cases")
    assert not bad, bad


def test_each_corridor_step_against_plain(corridor):
    assert len(corridor) == FRAMES and all(a[3] is not None for a, _ in corridor)
    _check_cases(corridor)


def test_window_rows_against_plain(window):
    assert any(int((a[4][2] > 0).sum()) for a, _ in window)
    _check_cases(window)


def _batch(picked):
    st = lambda f: torch.stack([f(a) for a in picked])
    prior = Pose(st(lambda a: a[0].q), st(lambda a: a[0].t))
    groups = [None if picked[0][g] is None else
              tuple(st(lambda a, g=g, i=i: a[g][i]) for i in range(len(picked[0][g])))
              for g in (2, 3, 4)]
    return (prior, st(lambda a: a[1]), *groups)


def test_three_sessions_one_stopping_early(corridor):
    """The solve that stops first and two that iterate longer, as one batch:
    each session bit-equal to its own solve, the batch against the batched
    plain solve."""
    its = [int(mapsolve.solve(*a, **k).iterations) for a, k in corridor]
    order = sorted(range(len(its)), key=lambda n: its[n])
    picked = [order[0], order[-1], order[-2]]
    assert its[picked[0]] < min(its[picked[1]], its[picked[2]]), its
    args = [corridor[n][0] for n in picked]
    k = corridor[0][1]
    batch = _batch(args)
    kern = mapsolve.solve(*batch, **k)
    for b, a in enumerate(args):
        one = mapsolve.solve(*a, **k)
        assert torch.equal(one.pose.q, kern.pose.q[b]) and torch.equal(one.pose.t, kern.pose.t[b])
        for f in FIELDS:
            assert torch.equal(getattr(one, f), getattr(kern, f)[b]), (b, f)
    assert kern.iterations.tolist() == [its[n] for n in picked]
    gen = torch.Generator().manual_seed(1)
    plain = mapsolve.solve_plain(*batch, **k)
    spread = [mapsolve.solve_plain(*_permuted(batch, gen), **k) for _ in range(PERMUTATIONS)]
    ok, line = _agree(kern, plain, spread)
    print(f"three sessions {picked}: {line}")
    assert ok, line


def _capture(a, k):
    """The solve of `a` captured (a node an iteration), its inputs' buffers
    and its result."""
    buffers = tree.clone_state(a)
    mapsolve.solve(*buffers, **k)              # the library loaded, the allocator warm
    g = torch.cuda.CUDAGraph()
    with graph_cond.capture(g, torch.cuda.graph_pool_handle()):
        res = mapsolve.solve(*buffers, **k)
    torch.cuda.synchronize()
    return g, buffers, res


def _fields(r):
    return [r.pose.q, r.pose.t] + [getattr(r, f) for f in FIELDS]


def test_captured_solve_replays_bit_equal(corridor):
    k = corridor[0][1]
    iters = k["iters"]
    g, buffers, res = _capture(corridor[1][0], k)
    seen = set()
    for n in (1, 5, 9, 0):
        donor = corridor[n][0]
        for dst, src in zip(tree.leaves(buffers), tree.leaves(donor)):
            dst.copy_(src)
        eager = mapsolve.solve(*donor, **k)
        # an evaluation and a step kernel to start and in each iteration
        # that ran; a replay runs the handle kernel of every node
        pairs = 1 + int(eager.iterations)
        assert launched(lambda: mapsolve.solve(*donor, **k), KERNELS) == dict(
            zip(KERNELS, (pairs, pairs, 0)))
        assert launched(g.replay, KERNELS) == dict(zip(KERNELS, (pairs, pairs, iters)))
        g.replay()
        torch.cuda.synchronize()
        first = [x.clone() for x in _fields(res)]
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, _fields(res))), n
        assert all(torch.equal(x, y) for x, y in zip(first, _fields(eager))), n
        seen.add(int(eager.iterations))
    assert len(seen) > 1, seen


def test_kernel_rejects_bad_arguments_on_the_card(corridor):
    a, k = corridor[0]
    prior, si, planes, lines, points = a
    with pytest.raises(ValueError, match="mapsolve"):
        mapsolve.solve(prior, si, (planes[0].cpu(),) + planes[1:], lines, points, **k)
    with pytest.raises(TypeError, match="mapsolve"):
        mapsolve.solve(prior, si.double(), planes, lines, points, **k)
