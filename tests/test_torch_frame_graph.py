"""`pipeline.frame_graph.FrameGraph` on the CPU, where it runs its segments
(`slam.front`, `slam.fallback`, `slam.back`, the log append) eagerly with the
same in-place copies it captures on the card:

- over 8 frames of the corridor at small_test_config, with keyframes and
  textureless frames (a skip with a previous geometric frame, so the
  fallback segment runs), its `FrameInfo` and its final state are bit-equal
  to a loop of the functional `fused.fused_step` from the same seed (the
  RANSAC draws drawn from the state's generator in both);
- every segment runs under a host-read guard (`Tensor.__bool__`, `item`,
  `tolist`, `__int__`, `__float__`, `numpy`, `nonzero`, `torch.nonzero` and
  `torch.unique` raise), with the solver in its conditional form, as a
  capture runs it (each node's test read on the host, which the guard does
  not see): the CPU's proxy for capturability; and gives the same results;
- `FrameInfo` stays valid across frames, and `snapshot()` does not move
  with the state.

No JAX: `fused_step` is held to the reference by tests/test_torch_fused.py,
and `SlamSystem`/`StreamingRunner`, which step through `FrameGraph`, by
tests/test_torch_{fused,stream,checkpoint,capacity*}.py."""

import contextlib
import functools

import pytest
import torch

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.ops import projection, solver
from intensity_slam_tpu_torch.pipeline import frame_graph, fused

torch.set_num_threads(1)

FRAMES = 8
TEXTURELESS = (3, 4)      # constant intensity: the intensity stream skips


def _frames(cfg):
    traj = synthetic.corridor_trajectory(FRAMES, speed=0.35, yaw_rate=0.02, device="cpu")
    xyz, inten = synthetic.render_sequence(traj, synthetic.corridor_world(device="cpu"),
                                           cfg.sensor)
    inten = inten.clone()
    for k in TEXTURELESS:
        inten[k] = 100.0
    return xyz, inten


def _eager(cfg, xyz, inten):
    mask = projection.detection_mask(cfg.sensor, device="cpu")
    st = fused.init_state(cfg, seed=3, device="cpu")
    infos = []
    for k in range(FRAMES):
        st, info = fused.fused_step(st, xyz[k], inten[k], 0.1 * k, mask, cfg)
        infos.append(info)
    return st, infos


@pytest.fixture(scope="module")
def runs():
    cfg = config.small_test_config()
    xyz, inten = _frames(cfg)
    st, infos = _eager(cfg, xyz, inten)
    fg = frame_graph.FrameGraph(cfg, "cpu", seed=3)
    ginfos, snaps = [], []
    for k in range(FRAMES):
        ginfos.append(fg.step(xyz[k], inten[k], 0.1 * k))
        snaps.append(fg.snapshot())
    return dict(cfg=cfg, xyz=xyz, inten=inten, eager=(st, infos), graph=fg,
                ginfos=ginfos, snaps=snaps)


def _same_state(a, b) -> bool:
    la, lb = list(frame_graph.leaves(a)), list(frame_graph.leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _same_info(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_frames_take_every_branch(runs):
    flags = [(bool(i.skip), bool(i.is_keyframe)) for i in runs["eager"][1]]
    assert sum(kf for _, kf in flags) >= 2 and flags[0][1]
    assert any(s for s, _ in flags[1:]), flags      # a skip with a previous frame
    assert any(not kf for _, kf in flags[1:])


def test_frame_info_bit_equal_to_fused_step(runs):
    for k, (a, b) in enumerate(zip(runs["eager"][1], runs["ginfos"])):
        assert _same_info(a, b), k


def test_final_state_bit_equal_to_fused_step(runs):
    st, fg = runs["eager"][0], runs["graph"]
    assert _same_state(st, fg.state)
    assert torch.equal(st.slam.gen.get_state(), fg.state.slam.gen.get_state())


def test_snapshots_do_not_move(runs):
    """Each frame's snapshot holds that frame's log count, though the state
    it was taken from moved on."""
    counts = [int(s.log.count) for s in runs["snaps"]]
    assert counts == list(range(1, FRAMES + 1))
    assert int(runs["graph"].state.log.count) == FRAMES


HOST_READS = ("__bool__", "item", "tolist", "__int__", "__float__", "numpy", "nonzero")


@contextlib.contextmanager
def host_read_guard():
    """Every way a segment could turn a tensor into a Python value raises."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"host read ({name}) inside a segment")
        return fn

    saved = [(torch.Tensor, n, getattr(torch.Tensor, n)) for n in HOST_READS]
    saved += [(torch, n, getattr(torch, n)) for n in ("nonzero", "unique")]
    for owner, name, _ in saved:
        setattr(owner, name, refuse(name))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _guarded(fn):
    @functools.wraps(fn)
    def run(*a):
        with host_read_guard():
            return fn(*a)
    return run


def test_segments_run_under_the_host_read_guard(runs, monkeypatch):
    cfg, xyz, inten = runs["cfg"], runs["xyz"], runs["inten"]
    monkeypatch.setattr(solver, "solve_pose",
                        functools.partial(solver.solve_pose, cond=True))
    fg = frame_graph.FrameGraph(cfg, "cpu", seed=3)
    ran = []
    for name in ("_front", "_fallback", "_back", "_log"):
        seg = _guarded(getattr(fg, name))
        setattr(fg, name, lambda *a, _seg=seg, _n=name: ran.append(_n) or _seg(*a))
    infos = [fg.step(xyz[k], inten[k], 0.1 * k) for k in range(FRAMES)]
    assert {"_front", "_fallback", "_back", "_log"} <= set(ran)
    # the conditional solves are bit-equal to the early-exit ones
    assert _same_state(runs["eager"][0], fg.state)
    for a, b in zip(runs["eager"][1], infos):
        assert _same_info(a, b)
    # the guard sees the eager step's reads
    mask = projection.detection_mask(cfg.sensor, device="cpu")
    with pytest.raises(AssertionError, match="host read"):
        with host_read_guard():
            fused.fused_step(fused.init_state(cfg, device="cpu"), xyz[0], inten[0],
                             0.0, mask, cfg)


def test_profile_tool_graph_row_runs(runs):
    """`tools/torch_profile_stages.py`'s `FULL frame (graphs)` row (timed on
    the card only) on the CPU: every call set back to the same state gives
    the same frame."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_profile_stages.py"
    spec = importlib.util.spec_from_file_location("torch_profile_stages", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg = runs["cfg"]
    prof = tool.Profiler(torch.device("cpu"), reps=2)
    u = torch.rand((cfg.ground.ransac_iters, 3), generator=torch.Generator().manual_seed(0))
    fstate = runs["eager"][0]
    fg = tool.graph_row(prof, cfg, fstate, runs["xyz"][-1], runs["inten"][-1], u, flops=0)
    row = prof.rows[-1]
    assert row["stage"] == "FULL frame (graphs)" and row["host_ms"] > 0
    assert row["repeat_outputs_differing"] == 0
    assert int(fg.state.log.count) == int(fstate.log.count) + 1
