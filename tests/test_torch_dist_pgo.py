"""The port's distributed pose-graph solve (`parallel/dist_pgo.py`) and
`posegraph._edge_residuals`, against the port's own dense solve and the JAX
package's `optimize_shmap` on its 8-device CPU mesh.

Graphs: tests/test_dist_pgo.py's drifted 32-node line closed by one loop
(64 node slots, 16 loop slots), and the same line with three loops, one of
them switched off by `loop_active`.  Tolerance 5e-4 (m, quaternion
components), as tests/test_dist_backend.py:139-142 holds the reference's
two solves to each other: the sums run in another order.  The port's
solve runs without a mesh and over a one-rank gloo group in this process
(the two-rank run is tests/test_torch_multiproc.py).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh

from intensity_slam_tpu import config
from intensity_slam_tpu.parallel import dist_pgo as JD
from intensity_slam_tpu.pipeline import posegraph as JP
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.parallel import dist_pgo as TD
from intensity_slam_tpu_torch.parallel import multiproc
from intensity_slam_tpu_torch.pipeline import posegraph as TP
from intensity_slam_tpu_torch.utils.se3 import Pose as TPose

torch.set_num_threads(1)
KW = dict(gn_iters=4, cg_iters=64, odo_noise=config.LoopConfig().odom_noise,
          loop_cauchy_c=1.0, drift_rate=0.02, drift_rot_rate=0.003)


def _graph(loops=((0, 31, 31.0),)):
    g = JP.empty(64, 16)
    meas = J3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([1.02, 0.005, 0]))
    pose = J3.Pose.identity()
    for k in range(32):
        if k > 0:
            pose = J3.compose(pose, meas)
        g = JP.add_node(g, pose)
    for i, j, d in loops:
        g = JP.add_loop(g, jnp.int32(i), jnp.int32(j),
                        J3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([d, 0, 0])),
                        jnp.float32(1e-4), config.LoopConfig())
    return jax.tree.map(np.asarray, g)


GRAPHS = {"one_loop": _graph(),
          "three_loops": _graph(((0, 31, 31.0), (4, 20, 16.0), (2, 28, 27.5)))}
ACTIVE = {"one_loop": None, "three_loops": np.arange(16) != 1}


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group in this process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = multiproc.initialize(0, 1, f"127.0.0.1:{port}", "gloo", timeout_s=60)
    yield mesh
    dist.destroy_process_group()


def _solve(name, mesh):
    act = ACTIVE[name]
    tg = interop.state_from_numpy(GRAPHS[name], device="cpu")
    return tg, TD.optimize_shmap(tg, mesh, loop_active=None if act is None
                                 else torch.from_numpy(act), **KW)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_optimize_shmap_matches_dense(name, mesh1):
    act = ACTIVE[name]
    tg, alone = _solve(name, None)
    _, ranked = _solve(name, mesh1)
    dense = TP.optimize(tg, loop_active=None if act is None else torch.from_numpy(act), **KW)
    n = 32
    for out in (alone, ranked):
        np.testing.assert_allclose(out.poses.t.numpy()[:n], dense.poses.t.numpy()[:n], atol=5e-4)
        np.testing.assert_allclose(out.poses.q.numpy()[:n], dense.poses.q.numpy()[:n], atol=5e-4)
    # the drift is removed: the loop pulls the end back to 31 m
    assert abs(float(ranked.poses.t[31, 0]) - 31.0) < 0.1
    # padding slots and the graph's other fields are untouched
    np.testing.assert_array_equal(ranked.poses.t.numpy()[n:], tg.poses.t.numpy()[n:])
    assert torch.equal(ranked.loop_i, tg.loop_i) and torch.equal(ranked.odo_rel.t, tg.odo_rel.t)


def test_optimize_shmap_matches_reference_on_its_mesh(mesh1):
    """Against the JAX `optimize_shmap` with the 16 loop slots over 8
    devices (one graph: each call of the reference compiles anew)."""
    name = "three_loops"
    g = GRAPHS[name]
    jmesh = JMesh(np.array(jax.devices()[:8]), axis_names=("data",))
    ref = JD.optimize_shmap(jax.tree.map(jnp.asarray, g), jmesh,
                            loop_active=jnp.asarray(ACTIVE[name]), **KW)
    _, ranked = _solve(name, mesh1)
    np.testing.assert_allclose(ranked.poses.t.numpy()[:32], np.asarray(ref.poses.t)[:32],
                               atol=5e-4)
    np.testing.assert_allclose(ranked.poses.q.numpy()[:32], np.asarray(ref.poses.q)[:32],
                               atol=5e-4)


def test_pad_to_and_shard_graph(mesh1):
    a = torch.arange(6.0).reshape(3, 2)
    assert TD._pad_to(a, 3, 0.0) is a
    np.testing.assert_array_equal(TD._pad_to(a, 5, -1.0).numpy()[3:], -np.ones((2, 2)))
    tg = interop.state_from_numpy(GRAPHS["one_loop"], device="cpu")
    sg = TD.shard_graph(tg, mesh1)
    assert all(torch.equal(x, y) for x, y in zip(sg.poses, tg.poses))
    assert TD.optimize_sharded is TP.optimize


def test_collectives_refuse_a_device_the_backend_cannot_reduce(mesh1):
    """A gloo group reduces CPU tensors only (it would stage CUDA tensors
    through the host): anything else raises."""
    with pytest.raises(ValueError, match="gloo group cannot reduce meta"):
        multiproc.all_reduce(torch.zeros(3, device="meta"), mesh1)
    x = multiproc.all_reduce(torch.ones(3), mesh1)
    assert torch.equal(x, torch.ones(3))
    assert torch.equal(multiproc.all_gather_rows(torch.ones(2, 3), mesh1), torch.ones(2, 3))


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_residuals_matches_reference(seed):
    g = GRAPHS["three_loops"]
    rng = np.random.RandomState(seed)
    K = g.poses.t.shape[0]
    xi = np.concatenate([rng.randn(K, 3) * 0.02, rng.randn(K, 3) * 0.2], 1).astype(np.float32)
    poses = J3.compose(jax.tree.map(jnp.asarray, g.poses), J3.se3_exp(jnp.asarray(xi)))
    odo_si = rng.uniform(0.5, 2.0, (K, 6)).astype(np.float32)
    prior = np.array([1e3, 1e3, 1e3, 1e4, 1e4, 1e3], np.float32)
    want = np.asarray(jax.jit(JP._edge_residuals)(
        jax.tree.map(jnp.asarray, g), poses, jnp.asarray(odo_si), jnp.asarray(prior)))
    tg = interop.state_from_numpy(g, device="cpu")
    got = TP._edge_residuals(tg, TPose(torch.from_numpy(np.array(poses.q)),
                                       torch.from_numpy(np.array(poses.t))),
                             torch.from_numpy(odo_si), torch.from_numpy(prior))
    assert got.shape == want.shape == ((1 + 64 + 16) * 6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-4)
    # padding rows are weighted out in both
    assert not got.numpy()[6 * (1 + 32):6 * (1 + 64)].any()
