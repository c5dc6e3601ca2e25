"""The BA's segment sums (`parallel/dist_ba.py::_segment_sum`) and a whole
`ba_solve` give the same bits on every run on the card: its CUDA path adds
each row's duplicates in one sorted order (`index_put_(accumulate=True)`)
where `index_add_` would add in atomic order.  Both are held against a
float64 sum (the segment sums) and against the CPU's solve.  The card's
tests are marked `cuda` and skip where there is no card.  This file imports
no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_dist_ba_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch.parallel import dist_ba
from intensity_slam_tpu_torch.utils import se3

torch.set_num_threads(1)


def _rows(M, n, seed=0):
    """(M, 3, 3) float32 rows and their indices into n segments."""
    rng = np.random.RandomState(seed)
    vals = rng.randn(M, 3, 3).astype(np.float32)
    idx = rng.randint(0, n, M)
    want = np.zeros((n, 3, 3))
    np.add.at(want, idx, vals.astype(np.float64))
    return torch.from_numpy(vals), torch.from_numpy(idx), want


def _problem(K=16, L=512, noise=0.01, seed=3):
    """Poses on a line, every landmark seen from every pose, pose 0 the
    gauge (tests/test_torch_dist_ba.py's problem, larger)."""
    rng = np.random.RandomState(seed)
    gt_t = np.stack([np.arange(K), np.zeros(K), np.zeros(K)], -1).astype(np.float32)
    lms = rng.uniform(-5, 12, (L, 3)).astype(np.float32)
    op = np.repeat(np.arange(K), L)
    ol = np.tile(np.arange(L), K)
    z = (lms[ol] - gt_t[op] + rng.randn(K * L, 3) * noise).astype(np.float32)
    pert = np.concatenate([rng.randn(K, 3) * 0.05, rng.randn(K, 3) * 0.2], -1)
    pert[0] = 0.0
    q = se3.quat_normalize(se3.so3_exp(torch.from_numpy(pert[:, :3].astype(np.float32))))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dist_ba.BAProblem(
        poses=se3.Pose(q, torch.from_numpy((gt_t + pert[:, 3:]).astype(np.float32))),
        landmarks=torch.from_numpy((lms + rng.randn(L, 3) * 0.05).astype(np.float32)),
        obs_pose=torch.from_numpy(op.astype(np.int32)),
        obs_lm=torch.from_numpy(ol.astype(np.int32)),
        obs_z=torch.from_numpy(z), obs_w=torch.ones(K * L),
        fixed_poses=torch.from_numpy(fixed))


def _to(prob, dev):
    return dist_ba.BAProblem(*[se3.Pose(f.q.to(dev), f.t.to(dev)) if isinstance(f, se3.Pose)
                               else f.to(dev) for f in prob])


def test_segment_sum_on_the_cpu():
    vals, idx, want = _rows(4096, 64)
    got = dist_ba._segment_sum(vals, idx, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,n", [(1 << 20, 1024), (1 << 20, 1 << 18)],
                         ids=["pose_rows", "landmark_rows"])
def test_segment_sum_is_the_same_on_every_run(M, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    vals, idx, want = _rows(M, n)
    vals, idx = vals.cuda(), idx.cuda()
    runs = [dist_ba._segment_sum(vals, idx, n) for _ in range(5)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    np.testing.assert_allclose(runs[0].cpu().numpy(), want, rtol=1e-4, atol=2e-3)


@pytest.mark.cuda
def test_ba_solve_is_the_same_on_every_run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prob = _problem()
    cpu = dist_ba.ba_solve(prob, gn_iters=8, cg_iters=48)
    card = [dist_ba.ba_solve(_to(prob, "cuda"), gn_iters=8, cg_iters=48) for _ in range(3)]
    for r in card[1:]:
        assert torch.equal(r.poses.t, card[0].poses.t) and torch.equal(r.poses.q, card[0].poses.q)
        assert torch.equal(r.landmarks, card[0].landmarks)
        assert torch.equal(r.final_cost, card[0].final_cost)
    np.testing.assert_allclose(card[0].poses.t.cpu().numpy(), cpu.poses.t.numpy(), atol=2e-4)
    np.testing.assert_allclose(card[0].landmarks.cpu().numpy(), cpu.landmarks.numpy(), atol=2e-4)
    assert float(card[0].final_cost) < float(card[0].initial_cost)
