"""`geometric_slam.GeoStepGraph` and the graphed `run_sequence` on the CPU,
where the step runs eagerly with the same in-place copies it captures on
the card, over the 12-frame unorganized corridor of
tests/test_torch_geometric_slam.py (rendered and permuted by JAX) at
small_test_config:

- `run_sequence` (through `GeoStepGraph`) is bit-equal to a loop of the
  eager `geo_slam_step`, in every output and in the final state;
- the step runs under the host-read guard of
  tests/test_torch_frame_graph.py, with the solver in its conditional
  form, as a capture runs it, and gives the same bits;
- `snapshot()` does not move with the state, and `adopt` of a snapshot
  continues as the eager loop does;
- the whole sequence agrees with the JAX package's jitted `run_sequence`
  (its `lax.scan`, as tests/test_geometric_slam.py runs it) within that
  file's 0.05 m, with the same `converged` flags;
- `tools/torch_profile_stages.py`'s `geo_slam_step (graphs)` row (timed on
  the card only) runs: every call set back to the same state gives the
  same step.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.pipeline import geometric_slam as JG
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.ops import solver
from intensity_slam_tpu_torch.pipeline import frame_graph
from intensity_slam_tpu_torch.pipeline import geometric_slam as TG
from test_torch_frame_graph import host_read_guard
from test_torch_geometric_slam import T, corridor

torch.set_num_threads(1)
CUT = 5


def _eager(tcfg, xyz, inten, state, frames):
    outs = []
    for k in frames:
        state, out = TG.geo_slam_step(state, xyz[k], inten[k], tcfg)
        outs.append(out)
    return state, outs


@pytest.fixture(scope="module")
def runs():
    cfg = config.small_test_config()
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    xyz_n, inten_n, gt = corridor(cfg)
    xyz, inten = torch.tensor(xyz_n), torch.tensor(inten_n)
    st, outs = _eager(tcfg, xyz, inten, TG.init_state(tcfg, device="cpu"), range(T))
    graph = TG.GeoStepGraph(tcfg, "cpu")
    gouts, snaps = [], []
    for k in range(T):
        gouts.append(graph.step(xyz[k], inten[k]))
        snaps.append(graph.snapshot())
    jouts = jax.tree.map(np.asarray, jax.jit(
        lambda x, i: JG.run_sequence(x, i, cfg))(xyz_n, inten_n))
    return dict(tcfg=tcfg, xyz=xyz, inten=inten, gt=gt, eager=(st, outs), graph=graph,
                gouts=gouts, snaps=snaps, seq=TG.run_sequence(xyz, inten, tcfg),
                jouts=jouts)


def _same(a, b) -> bool:
    la, lb = list(frame_graph.leaves(a)), list(frame_graph.leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_run_sequence_bit_equal_to_eager_steps(runs):
    st, outs = runs["eager"]
    seq = runs["seq"]
    for k, (a, b) in enumerate(zip(outs, runs["gouts"])):
        assert _same(a, b), k
    for name in ("num_corner_residuals", "num_surf_residuals", "num_sharp", "converged"):
        assert torch.equal(getattr(seq, name), torch.stack([getattr(o, name) for o in outs]))
    for pose in ("pose", "odom_pose"):
        for f in ("q", "t"):
            want = torch.stack([getattr(getattr(o, pose), f) for o in outs])
            assert torch.equal(getattr(getattr(seq, pose), f), want), (pose, f)
    assert _same(st, runs["graph"].state)
    assert int(seq.num_surf_residuals[-1]) > 10


def test_step_runs_under_the_host_read_guard(runs, monkeypatch):
    tcfg, xyz, inten = runs["tcfg"], runs["xyz"], runs["inten"]
    monkeypatch.setattr(solver, "solve_pose",
                        functools.partial(solver.solve_pose, cond=True))
    graph = TG.GeoStepGraph(tcfg, "cpu")
    step, ran = graph._step, []

    def guarded():
        ran.append(1)
        with host_read_guard():
            return step()

    graph._step = guarded
    gouts = [graph.step(xyz[k], inten[k]) for k in range(T)]
    assert len(ran) == T
    # the conditional solves are bit-equal to the early-exit ones
    assert _same(runs["eager"][0], graph.state)
    for a, b in zip(runs["eager"][1], gouts):
        assert _same(a, b)
    # the guard sees the eager step's reads (the solvers' loop tests)
    monkeypatch.undo()
    with pytest.raises(AssertionError, match="host read"):
        with host_read_guard():
            TG.geo_slam_step(TG.init_state(tcfg, device="cpu"), xyz[0], inten[0], tcfg)


def test_snapshot_and_adopt(runs):
    """Each frame's snapshot holds that frame's map count, though the state
    moved on; a fresh graph that adopts the snapshot after frame CUT gives
    the eager loop's frames after it, bit for bit."""
    assert [int(s.lmap.frame_idx) for s in runs["snaps"]] == list(range(1, T + 1))
    assert int(runs["graph"].state.lmap.frame_idx) == T
    tcfg, xyz, inten = runs["tcfg"], runs["xyz"], runs["inten"]
    graph = TG.GeoStepGraph(tcfg, "cpu")
    graph.adopt(runs["snaps"][CUT])
    gouts = [graph.step(xyz[k], inten[k]) for k in range(CUT + 1, T)]
    for a, b in zip(runs["eager"][1][CUT + 1:], gouts):
        assert _same(a, b)
    assert _same(runs["eager"][0], graph.state)
    # adopt copies: the snapshot is not the graph's buffer
    assert int(runs["snaps"][CUT].lmap.frame_idx) == CUT + 1


def test_sequence_matches_the_jax_run_sequence(runs):
    jo, to = runs["jouts"], runs["seq"]
    np.testing.assert_array_equal(jo.converged, to.converged.numpy())
    np.testing.assert_allclose(jo.pose.t, to.pose.t.numpy(), atol=0.05)
    np.testing.assert_allclose(jo.odom_pose.t, to.odom_pose.t.numpy(), atol=0.05)
    np.testing.assert_allclose(jo.pose.q, to.pose.q.numpy(), atol=0.01)
    est, gt = to.pose.t.numpy(), runs["gt"]
    ate = float(np.sqrt(np.mean(np.linalg.norm(est - gt, axis=-1) ** 2)))
    assert ate < 0.25 * float(np.linalg.norm(gt[-1] - gt[0]))


def test_profile_tool_geo_graph_row_runs(runs):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_profile_stages.py"
    spec = importlib.util.spec_from_file_location("torch_profile_stages", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    prof = tool.Profiler(torch.device("cpu"), reps=2)
    xyz, inten = runs["xyz"], runs["inten"]
    g = tool.geo_graph_row(prof, runs["tcfg"], xyz[:CUT], inten[:CUT], xyz[CUT], inten[CUT])
    row = prof.rows[-1]
    assert row["stage"] == "geo_slam_step (graphs)" and row["host_ms"] > 0
    assert row["repeat_outputs_differing"] == 0 and row["flops"] > 0
    assert int(g.state.lmap.frame_idx) == CUT + 1
    assert _same(g.state, runs["snaps"][CUT])
