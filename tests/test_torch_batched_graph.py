"""`pipeline.frame_graph.BatchedStepGraph` (B sessions' frames through
replayed graphs) on the CPU, where its segments (`slam.front`, the padded
fallback `slam._fallback_batched`, `slam.back`) run eagerly with the same
in-place copies it captures on the card, over the mixed B = 3 batch of
tests/test_torch_multisession.py (three staggered corridor streams, the
third at constant intensity so that it takes the fallback while the others
do not), four frames:

- bit-equal to the eager `slam.slam_step_batched` in every output, the host
  flags and the final state, with the reference's draws handed in and with
  each session's generator drawing them;
- against `jax.jit(jax.vmap(JS.slam_step))`, per session: `skip`,
  `is_keyframe`, `num_good`, `ground_ok` equal, poses at
  tests/test_torch_multisession.py's tolerances;
- its segments run under the host-read guard of
  tests/test_torch_frame_graph.py with the solver in its conditional form,
  as a capture runs them, and the step reads the host once a frame: the flags'
  `tolist`.
"""

import functools

import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.ops import solver
from intensity_slam_tpu_torch.pipeline import frame_graph
from intensity_slam_tpu_torch.pipeline import slam as TS
from test_torch_frame_graph import HOST_READS, host_read_guard
from test_torch_multisession import (B, FIELDS, FLAT, FRAMES, MAP_TOL, POS_TOL, _kind,
                                     _streams, reference_rows)

torch.set_num_threads(1)


def _eager(tcfg, xb, ib, draws):
    mask = TP.detection_mask(tcfg.sensor, device="cpu")
    st = TS.init_batched_state(tcfg, range(B), device="cpu")
    rows = []
    for k in range(FRAMES):
        u = None if draws is None else torch.from_numpy(draws[k])
        st, out = TS.slam_step_batched(st, xb[k], ib[k], k * 0.1, mask, tcfg, ground_u=u)
        rows.append(out)
    return st, rows


def _graphed(tcfg, xb, ib, draws, graph=None):
    graph = graph or frame_graph.BatchedStepGraph(tcfg, range(B), "cpu")
    rows = [graph.step(xb[k], ib[k], k * 0.1,
                       ground_u=None if draws is None else torch.from_numpy(draws[k]))
            for k in range(FRAMES)]
    return graph, rows


@pytest.fixture(scope="module")
def runs():
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    xb_n, ib_n = _streams(cfg)
    jrows, draws = reference_rows(cfg, xb_n, ib_n)
    xb, ib = torch.from_numpy(xb_n), torch.from_numpy(ib_n)
    return dict(tcfg=tcfg, xb=xb, ib=ib, jrows=jrows, draws=draws,
                eager=_eager(tcfg, xb, ib, draws), graph=_graphed(tcfg, xb, ib, draws),
                eager_drawn=_eager(tcfg, xb, ib, None))


def _same(a, b) -> bool:
    la, lb = list(frame_graph.leaves(a)), list(frame_graph.leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _assert_same_run(eager, graphed):
    (st, rows), (graph, grows) = eager, graphed
    for k, (a, b) in enumerate(zip(rows, grows)):
        assert a.host == b.host, k
        assert _same(a, b), k
    assert _same(st, graph.state)
    for g, h in zip(st.gen, graph.state.gen):
        assert torch.equal(g.get_state(), h.get_state())


def test_the_batch_is_mixed(runs):
    skips = np.array([[h.skip for h in o.host] for o in runs["eager"][1]])
    assert skips[:, FLAT].all() and not skips[1:, :FLAT].any()
    assert all(o.host[FLAT].has_prev for o in runs["eager"][1][1:])


def test_graph_bit_equal_to_eager_batched_step(runs):
    _assert_same_run(runs["eager"], runs["graph"])


def test_graph_matches_the_reference(runs):
    for jo, to in zip(runs["jrows"], runs["graph"][1]):
        for f in FIELDS:
            assert getattr(jo, f).tolist() == getattr(to, f).tolist(), f
        for b in range(B):
            tol, mtol = POS_TOL[_kind(b)], MAP_TOL[_kind(b)]
            for pose, t in (("odom_pose", tol), ("pose", mtol)):
                for f in ("t", "q"):
                    np.testing.assert_allclose(getattr(getattr(to, pose), f)[b].numpy(),
                                               getattr(getattr(jo, pose), f)[b], atol=t)


def test_only_the_flags_read_reads_the_host(runs, monkeypatch):
    """Segments guarded (a host read raises), the step's own reads counted;
    the RANSAC draws from each session's generator, against the eager step
    drawing them too."""
    tcfg = runs["tcfg"]
    monkeypatch.setattr(solver, "solve_pose",
                        functools.partial(solver.solve_pose, cond=True))
    graph = frame_graph.BatchedStepGraph(tcfg, range(B), "cpu")
    ran = []
    for name in ("_front", "_fallback", "_back"):
        seg = getattr(graph, name)

        def guarded(*a, _seg=seg, _n=name):
            ran.append(_n)
            with host_read_guard():
                return _seg(*a)
        setattr(graph, name, guarded)
    reads = []
    for name in HOST_READS:
        fn = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda *a, _fn=fn, _n=name, **k: reads.append(_n) or _fn(*a, **k))
    graphed = _graphed(tcfg, runs["xb"], runs["ib"], None, graph)
    monkeypatch.undo()
    assert reads == ["tolist"] * FRAMES
    assert ran.count("_fallback") == FRAMES - 1 and ran.count("_back") == FRAMES
    _assert_same_run(runs["eager_drawn"], graphed)
