"""`FrameGraph.adopt` on the CPU: a state made outside the step's segments
(a checkpoint `SlamSystem.load` restores, the poses `SlamSystem.refine`
writes back) is copied into the buffers the segments update in place, and
the frames after it give what a fresh eager run of `fused.fused_step` from
that same state gives, bit for bit.  No JAX (tests/test_torch_checkpoint.py
and tests/test_torch_dist_backend.py hold `load` and `refine` to the
reference)."""

import pytest
import torch

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.ops import projection
from intensity_slam_tpu_torch.parallel import dist_backend
from intensity_slam_tpu_torch.pipeline import frame_graph, fused
from intensity_slam_tpu_torch.pipeline.system import SlamSystem
from intensity_slam_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

FRAMES, CUT = 9, 6


@pytest.fixture(scope="module")
def run():
    cfg = config.small_test_config()
    traj = synthetic.corridor_trajectory(FRAMES, speed=0.35, yaw_rate=0.03, device="cpu")
    xyz, inten = synthetic.render_sequence(traj, synthetic.corridor_world(device="cpu"),
                                           cfg.sensor)
    system = SlamSystem(cfg, seed=5, device="cpu")
    for k in range(CUT):
        system.process(xyz[k], inten[k], 0.1 * k)
    return dict(cfg=cfg, xyz=xyz, inten=inten, system=system)


def _same_state(a, b) -> bool:
    la, lb = list(frame_graph.leaves(a)), list(frame_graph.leaves(b))
    return (len(la) == len(lb)
            and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))
            and torch.equal(a.slam.gen.get_state(), b.slam.gen.get_state()))


def _continue_both(run, system, state):
    """The frames after the cut through `system` and through `fused_step`
    from `state`: (infos, final state) of each."""
    cfg = run["cfg"]
    mask = projection.detection_mask(cfg.sensor, device="cpu")
    got, want = [], []
    for k in range(CUT, FRAMES):
        x, i = run["xyz"][k], run["inten"][k]
        got.append(system.process(x, i, 0.1 * k))
        state, info = fused.fused_step(state, x, i, 0.1 * k, mask, cfg)
        want.append(info)
    return got, want, state


def _assert_continuations_equal(got, want, system, state):
    assert any(bool(i.is_keyframe) for i in want)
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _same_state(system.state, state)


def test_load_adopts_the_checkpoint(run, tmp_path):
    cfg = run["cfg"]
    prefix = str(tmp_path / "cut")
    run["system"].save(prefix)
    resumed = SlamSystem(cfg, seed=9, device="cpu")
    resumed.load(prefix)
    state = checkpoint.restore(prefix + ".fused.npz", fused.init_state(cfg, 9, device="cpu"))
    assert _same_state(resumed.state, state) and _same_state(resumed.state, run["system"].state)
    got, want, state = _continue_both(run, resumed, state)
    _assert_continuations_equal(got, want, resumed, state)


def test_refine_adopts_the_refined_graph(run):
    cfg = run["cfg"]
    system = SlamSystem(cfg, seed=5, device="cpu")
    # the second keyframe's graph pose moved off its odometry: the refine's
    # PGO pulls it back
    start = run["system"].snapshot()
    start.backend.graph.poses.t[1] += 0.2
    system.graph.adopt(start)
    before = system.snapshot()
    system.refine()
    poses = dist_backend.refine(before.backend, cfg).state.graph.poses
    state = fused.adopt_graph(before, poses, cfg)
    assert int(state.backend.num_kf) >= 2
    assert _same_state(system.state, state)
    assert not torch.equal(system.state.backend.graph.poses.t, before.backend.graph.poses.t)
    got, want, state = _continue_both(run, system, state)
    _assert_continuations_equal(got, want, system, state)
