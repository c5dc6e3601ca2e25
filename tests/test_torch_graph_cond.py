"""The conditional forms that a CUDA graph captures as If nodes
(`utils.graph_cond.when`), run on the CPU with each node's test read on the
host:

- `solver.solve_pose(..., cond=True)` (a node an iteration, its body one
  iteration that keeps a solve that met its test frozen, writing the loop's
  state in place) is bit-equal to the early-exit loop in every
  `SolveResult` field, in float32 and float64, for a solve that stops after
  two iterations, one that reaches `iters`, one that stops on rejected
  steps, and a batch of three sessions, one of them converging after two
  iterations while the others go on; it runs as many bodies as the early
  exit runs iterations (their most over a batch), reads the host only for
  its nodes' tests (which stand for the nodes' own on the card), and its
  state stays in the buffers made before the first node;
- the capacity policy under `when` (`mapping.evict_policy(..., cond=True)`)
  gives the masked pass's map, over and under the threshold, one map and a
  batch;
- `FrameGraph` and `BatchedStepGraph` in the conditional form (the solver
  and the capacity policy forced into it, the segments under the host-read
  guard of tests/test_torch_frame_graph.py) are bit-equal to the
  `fused_step` and `slam_step_batched` loops over corridor frames with
  keyframes and textureless skips; the fallback region runs exactly on the
  `skip & has_prev` frames (any session's, in a batch), the keyframe region
  exactly on the keyframes.

No JAX: the early-exit loop, `fused_step` and `slam_step_batched` are held
to the reference by tests/test_torch_{solver,fused,multisession}.py."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.ops import grid_hash, projection, solver
from intensity_slam_tpu_torch.pipeline import frame_graph, mapping
from intensity_slam_tpu_torch.pipeline import slam as TS
from intensity_slam_tpu_torch.utils import graph_cond, se3
from intensity_slam_tpu_torch.utils.se3 import Pose
from test_torch_frame_graph import FRAMES, _eager, _frames, _same_info, _same_state, \
    host_read_guard

torch.set_num_threads(1)


@pytest.fixture
def cond_forms(monkeypatch):
    """The solver and the capacity policy in their conditional forms."""
    monkeypatch.setattr(solver, "solve_pose", functools.partial(solver.solve_pose, cond=True))
    monkeypatch.setattr(mapping, "evict_policy",
                        functools.partial(mapping.evict_policy, cond=True))


# ---- the solver ---------------------------------------------------------------

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
def test_conditional_solve_bit_equal_to_early_exit(case, dtype):
    """Under the host-read guard of tests/test_torch_frame_graph.py the
    conditional form reads nothing but its nodes' tests (through
    `graph_cond`'s own host read, which stands for the node's test on the
    card and which the guard does not patch), runs a body an iteration of
    the early exit and equals it field by field."""
    fn, iters = _problem(case, dtype)
    lead = (len(CASES[case][0]),) if case == "batched" else ()
    p0 = Pose.identity(lead, dtype=dtype, device="cpu")
    early = solver.solve_pose(p0, fn, iters=iters)
    graph_cond.ran.clear()
    with host_read_guard():
        cond = solver.solve_pose(p0, fn, iters=iters, cond=True)
    assert graph_cond.ran["solve"] == int(early.iterations.max())
    for name, a in _fields(early).items():
        b = _fields(cond)[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_early_exit_stops_as_each_case_says(case):
    """Each case stops the early-exit loop as its name says, and the loop
    reads the host for its test (which the host-read guard sees)."""
    fn, iters = _problem(case, torch.float32)
    lead = (len(CASES[case][0]),) if case == "batched" else ()
    p0 = Pose.identity(lead, device="cpu")
    early = solver.solve_pose(p0, fn, iters=iters)
    if case == "batched":
        # one session stops after two iterations, the batch before `iters`
        # (so the conditional form runs bodies with a session frozen)
        its = early.iterations.tolist()
        assert its[0] == 2 and min(its[1:]) > 2 and max(its) < iters, its
    elif case == "two_iterations":
        assert int(early.iterations) == 2 and int(early.rejections) == 0
    elif case == "reaches_iters":
        assert int(early.iterations) == iters and bool(early.grad_norm > 1.0)
    else:
        assert int(early.rejections) == 3 and int(early.iterations) == 3
    with pytest.raises(AssertionError, match="host read"):
        with host_read_guard():
            solver.solve_pose(p0, fn, iters=iters)


def test_conditional_solve_keeps_its_state_in_place(monkeypatch):
    """Every body writes the same eight buffers (pose, cost, damping, step
    test, rejections, gradient norm, iterations), which the result holds."""
    fn, iters = _problem("batched", torch.float64)
    p0 = Pose.identity((3,), dtype=torch.float64, device="cpu")
    writes, copy = [], torch.Tensor.copy_

    @contextlib.contextmanager
    def body_writes(pred, name):
        with graph_cond_when(pred, name) as taken:
            writes.append([])
            yield taken

    def recording_copy(dst, src, *a, **k):
        if writes:
            writes[-1].append(dst.data_ptr())
        return copy(dst, src, *a, **k)

    graph_cond_when = graph_cond.when
    monkeypatch.setattr(graph_cond, "when", body_writes)
    monkeypatch.setattr(torch.Tensor, "copy_", recording_copy)
    res = solver.solve_pose(p0, fn, iters=iters, cond=True)
    monkeypatch.undo()
    held = {t.data_ptr() for t in (res.pose.q, res.pose.t, res.final_cost, res.damping,
                                   res.rel_decrease, res.rejections, res.grad_norm,
                                   res.iterations)}
    ran = [w for w in writes if w]
    assert len(ran) == int(res.iterations.max()) and len(writes) == iters
    assert all(len(w) == 8 and set(w) == held for w in ran), (ran, held)


# ---- the capacity policy ------------------------------------------------------

def _map(n, seed, batch=()):
    """A map of `n` random points (a batch's second map of half as many)."""
    rng = np.random.default_rng(seed)
    m = grid_hash.empty(256, 4, device="cpu", batch=batch)
    pts = torch.tensor(rng.uniform(-12.0, 12.0, size=batch + (n, 3)), dtype=torch.float32)
    mask = torch.ones(batch + (n,), dtype=torch.bool)
    if batch:
        mask[1, n // 2:] = False
    return grid_hash.insert(m, pts, mask, 0.5)


def _same_map(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("batch", [(), (2,)], ids=["one", "batch"])
@pytest.mark.parametrize("over", [True, False], ids=["over", "under"])
def test_capacity_policy_under_when_equals_the_masked_pass(batch, over):
    m = _map(3000, 5, batch)
    counts = m.num_points.reshape(-1).tolist()
    # over: one map (every map, alone) above the threshold; under: none
    thresh = (min(counts) - 1 if not batch else (counts[0] + counts[1]) // 2) if over \
        else max(counts)
    center = torch.zeros(batch + (3,))
    masked = mapping.evict_policy(m, center, 6.0, thresh, cond=False)
    graph_cond.ran.clear()
    cond = mapping.evict_policy(frame_graph.clone_state(m), center, 6.0, thresh, cond=True)
    assert _same_map(masked, cond)
    assert graph_cond.ran["evict"] == int(over)
    evicted = (masked.num_points < m.num_points).tolist()
    assert (any(evicted) if batch else evicted) == over


# ---- the graph owners ---------------------------------------------------------

@pytest.fixture(scope="module")
def corridor():
    cfg = config.small_test_config()
    xyz, inten = _frames(cfg)
    return cfg, xyz, inten, _eager(cfg, xyz, inten)


def _guarded(owner, names, ran):
    for name in names:
        seg = getattr(owner, name)

        def run(*a, _seg=seg, _n=name):
            ran.append(_n)
            with host_read_guard():
                return _seg(*a)
        setattr(owner, name, run)


def test_frame_graph_conditional_form_bit_equal_to_fused_step(corridor, cond_forms):
    cfg, xyz, inten, (st, infos) = corridor
    fg = frame_graph.FrameGraph(cfg, "cpu", seed=3)
    _guarded(fg, ("_front", "_fallback", "_back", "_keyframe", "_log"), [])
    regions = []
    for k in range(FRAMES):
        graph_cond.ran.clear()
        assert _same_info(infos[k], fg.step(xyz[k], inten[k], 0.1 * k)), k
        h = fg.last_output.host
        regions.append((graph_cond.ran["fallback"], graph_cond.ran["keyframe"],
                        int(h.skip and h.has_prev), int(h.is_keyframe)))
    assert _same_state(st, fg.state)
    assert all(fb == want_fb and lg == want_lg for fb, lg, want_fb, want_lg in regions), regions
    assert any(r[2] for r in regions) and any(r[3] for r in regions)
    assert not all(r[3] for r in regions)


B, BATCH_FRAMES, FLAT = 3, 4, 2     # sessions, frames, the constant-intensity one


@pytest.fixture(scope="module")
def batch_streams():
    cfg = config.small_test_config()
    traj = synthetic.corridor_trajectory(BATCH_FRAMES + B, speed=0.35, yaw_rate=0.02,
                                         device="cpu")
    xyz, inten = synthetic.render_sequence(traj, synthetic.corridor_world(device="cpu"),
                                           cfg.sensor)
    xb = torch.stack([xyz[b:b + BATCH_FRAMES] for b in range(B)], dim=1)
    ib = torch.stack([inten[b:b + BATCH_FRAMES] for b in range(B)], dim=1).clone()
    ib[:, FLAT] = 100.0
    mask = projection.detection_mask(cfg.sensor, device="cpu")
    st, rows = TS.init_batched_state(cfg, range(B), device="cpu"), []
    for k in range(BATCH_FRAMES):
        st, out = TS.slam_step_batched(st, xb[k], ib[k], k * 0.1, mask, cfg)
        rows.append(out)
    return cfg, xb, ib, (st, rows)


def test_batched_graph_conditional_form_bit_equal_to_eager(batch_streams, cond_forms):
    cfg, xb, ib, (st, rows) = batch_streams
    graph = frame_graph.BatchedStepGraph(cfg, range(B), "cpu")
    _guarded(graph, ("_front", "_fallback", "_back"), [])
    fell = []
    for k in range(BATCH_FRAMES):
        graph_cond.ran.clear()
        out = graph.step(xb[k], ib[k], k * 0.1)
        assert out.host == rows[k].host, k
        assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                   zip(frame_graph.leaves(rows[k]), frame_graph.leaves(out))), k
        fell.append((graph_cond.ran["fallback"],
                     int(any(h.skip and h.has_prev for h in out.host))))
    assert all(x == y for x, y in fell) and fell[0] == (0, 0) and fell[-1] == (1, 1), fell
    assert _same_state(st, graph.state)
    for g, h in zip(st.gen, graph.state.gen):
        assert torch.equal(g.get_state(), h.get_state())


# ---- on the card --------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a conditional node exists only in a CUDA graph")


@pytest.mark.cuda
def test_cuda_replayed_solve_follows_each_problem():
    """One solve captured as a chain of If nodes (20 at most) and replayed
    on the points of `CASES`' one-session cases, the
    last with its Jacobian's sign flipped (rejected steps): each replay
    bit-equal to its eager early exit, iterations included."""
    _need_card()
    dev = torch.device("cuda")
    src = torch.zeros(64, 3, device=dev)
    dst = torch.zeros(64, 3, device=dev)
    base = solver.point_to_point(src, dst, torch.ones(64, device=dev))
    flip = torch.ones((), device=dev)      # -1: the rejected steps' Jacobian sign

    def fn(p):
        return base(p)
    fn.jacobian = lambda p: flip * base.jacobian(p)
    p0 = Pose.identity(device=dev)
    solver.solve_pose(p0, fn, iters=20)
    g = torch.cuda.CUDAGraph()
    with graph_cond.capture(g, torch.cuda.graph_pool_handle()):
        res = solver.solve_pose(p0, fn, iters=20)
    for case in ("two_iterations", "reaches_iters", "rejected_steps"):
        s_, d_ = _points(*CASES[case][:3])
        src.copy_(torch.tensor(s_, dtype=torch.float32))
        dst.copy_(torch.tensor(d_, dtype=torch.float32))
        flip.fill_(-1.0 if case == "rejected_steps" else 1.0)
        eager = solver.solve_pose(p0, fn, iters=20)
        g.replay()
        torch.cuda.synchronize()
        for name, a in _fields(eager).items():
            assert torch.equal(a, _fields(res)[name]), (case, name)
