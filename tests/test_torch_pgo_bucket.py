"""The dense PGO sized to the pose graph's live nodes, on the CPU:
`posegraph.optimize` solves the leading `bucket(num_nodes, K)` slots alone
(a `pgo.<size>` region a bucket), and matches the same solve run on all K
slots (`posegraph._solve`) within 1e-4 m and 1e-5 in quaternion: the
slots past `num_nodes` are identity rows with a zero right-hand side,
decoupled from the rest, so the two differ by float32 rounding only.

The graphs are drifting chains with loop edges, their positions perturbed
so that the solve moves them, and invalid loop slots holding stale indices
past the bucket.  The slot counts are cut to what the cases need (256
slots, whose buckets are 128 and 256, and 384, whose are 128, 256 and
384; 32 loop slots; one Gauss-Newton iteration) to keep the dense CPU
solves short; at 1024 nodes in 1024 slots the bucket is the whole graph,
so `optimize` must hand `_solve` the graph itself.
"""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch import config
from intensity_slam_tpu_torch.pipeline import posegraph as TPG
from intensity_slam_tpu_torch.utils import graph_cond, se3
from intensity_slam_tpu_torch.utils.se3 import Pose
from intensity_slam_tpu_torch.utils.tree import leaves

torch.set_num_threads(1)

LOOP_SLOTS = 32
STALE = 4           # invalid loop slots with indices past the bucket


def _kw():
    lc = config.LoopConfig()
    return dict(gn_iters=1, odo_noise=lc.odom_noise, loop_cauchy_c=lc.loop_cauchy_c,
                drift_rate=lc.loop_drift_rate, drift_rot_rate=lc.loop_drift_rot_rate,
                loop_active=None)


def _graph(K: int, n: int, seed: int = 0, stale: bool = True) -> TPG.PoseGraph:
    """A chain of `n` nodes in `K` slots, 0.4 m a step with heading drift,
    closed by up to 15 loop edges from later nodes to earlier ones; every
    position then moved by 0.3 m (sd).  With `stale`, `STALE` invalid loop
    slots point past `bucket(n, K)` (where the slots reach past it)."""
    rng = np.random.default_rng(seed)
    g = TPG.empty(K, LOOP_SLOTS, device="cpu")
    pose, raws = Pose.identity(device="cpu"), []
    for k in range(n):
        step = Pose(se3.so3_exp(torch.tensor([0.0, 0.0, float(rng.normal(0, 0.05))])),
                    torch.tensor([0.4, float(rng.normal(0, 0.02)), 0.0]))
        pose = se3.compose(pose, step) if k else pose
        raws.append(pose)
        g = TPG.add_node(g, pose, qual=float(rng.uniform(1, 2)))
    lc = config.LoopConfig()
    for _ in range(15 if n > 2 else 0):
        i, j = sorted(int(x) for x in rng.choice(n, 2, replace=False))
        rel = se3.compose(se3.inverse(raws[j]), raws[i])
        g = TPG.add_loop(g, torch.tensor(j), torch.tensor(i), rel, torch.tensor(0.05), lc)
    b = TPG.bucket(n, K)
    if stale and b < K:
        slots = torch.arange(LOOP_SLOTS - STALE, LOOP_SLOTS)
        g = g._replace(loop_i=g.loop_i.index_put((slots,), torch.tensor(K - 1, dtype=torch.int32)),
                       loop_j=g.loop_j.index_put((slots,), torch.tensor(b, dtype=torch.int32)))
    moved = torch.tensor(rng.normal(0, 0.3, (K, 3)), dtype=torch.float32)
    return g._replace(poses=Pose(g.poses.q, g.poses.t + moved * g.node_valid[:, None]))


def _optimize(g: TPG.PoseGraph):
    """`optimize` eagerly: (its graph, the bucket regions it ran)."""
    graph_cond.ran.clear()
    out = TPG.optimize(g, **_kw())
    K = g.node_valid.shape[0]
    return out, {r: graph_cond.ran[r] for r in TPG.regions(K)}


def _check_against_full(g: TPG.PoseGraph, n: int):
    K = g.node_valid.shape[0]
    b = TPG.bucket(n, K)
    got, ran = _optimize(g)
    want = TPG._solve(g, **_kw())
    np.testing.assert_allclose(got.poses.t[:n].numpy(), want.t[:n].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.poses.q[:n].numpy(), want.q[:n].numpy(), atol=1e-5, rtol=0)
    # the slots past the bucket are the input's, bit for bit
    assert torch.equal(got.poses.t[b:], g.poses.t[b:]) and torch.equal(got.poses.q[b:],
                                                                        g.poses.q[b:])
    assert ran == {r: int(r == f"pgo.{b}") for r in TPG.regions(K)}
    return got, want


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 200, 256])
def test_bucketed_solve_matches_the_full_solve(n):
    K = 256 if n <= 128 else 384
    g = _graph(K, n)
    got, want = _check_against_full(g, n)
    assert TPG.bucket(n, K) == (128 if n <= 128 else 256) < K
    if n > 2:       # the solve moved the perturbed chain
        assert float((want.t[:n] - g.poses.t[:n]).abs().max()) > 0.1


def test_bucketed_solve_after_a_compaction():
    full = _graph(256, 256, seed=1)
    g = TPG.compact_half(full)
    n = int(g.num_nodes)
    assert n == 128 and int(g.loop_valid.sum()) >= 10
    # the loop indices the compaction halved lie in the leading bucket;
    # the invalid slots keep what they held
    _, want = _check_against_full(g, n)
    assert float((want.t[:n] - g.poses.t[:n]).abs().max()) > 0.1


def test_stale_loop_indices_past_the_bucket_change_nothing():
    stale = _graph(384, 200, seed=2)
    clean = _graph(384, 200, seed=2, stale=False)
    assert int(stale.loop_i.max()) == 383 and int(clean.loop_i.max()) < 200
    a, _ = _optimize(stale)
    b, _ = _optimize(clean)
    assert torch.equal(a.poses.t, b.poses.t) and torch.equal(a.poses.q, b.poses.q)


def test_graph_at_its_slot_count_is_solved_whole(monkeypatch):
    """1024 nodes in 1024 slots take the last bucket, 1024: `_solve` gets
    the graph itself and its poses are the result."""
    K = n = 1024
    g = TPG.empty(K, LOOP_SLOTS, device="cpu")
    gen = torch.Generator().manual_seed(0)
    g = g._replace(node_valid=torch.ones(K, dtype=torch.bool),
                   num_nodes=torch.tensor(n, dtype=torch.int32),
                   poses=Pose(se3.quat_normalize(torch.randn(K, 4, generator=gen)),
                              torch.randn(K, 3, generator=gen)))
    solved = Pose(se3.quat_normalize(torch.randn(K, 4, generator=gen)),
                  torch.randn(K, 3, generator=gen))
    seen = []

    def solve(h, **kw):
        seen.append(h)
        return solved

    monkeypatch.setattr(TPG, "_solve", solve)
    got, ran = _optimize(g)
    assert len(seen) == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(seen[0]), leaves(g)))
    assert torch.equal(got.poses.t, solved.t) and torch.equal(got.poses.q, solved.q)
    assert ran == {"pgo.128": 0, "pgo.256": 0, "pgo.512": 0, "pgo.1024": 1}


@pytest.mark.parametrize("K,sizes", [(8, (8,)), (64, (64,)), (128, (128,)), (129, (128, 129)),
                                     (384, (128, 256, 384)), (1024, (128, 256, 512, 1024))])
def test_bucket_rule(K, sizes):
    assert TPG.buckets(K) == sizes
    assert TPG.regions(K) == (tuple(f"pgo.{b}" for b in sizes) if len(sizes) > 1 else ())
    for n in range(K + 1):
        # the smallest power of two from 128 that holds n, else K
        want = min(K, max(128, 1 << max(n - 1, 0).bit_length()))
        assert TPG.bucket(n, K) == want, n
