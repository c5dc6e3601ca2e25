"""Parity: intensity_slam_tpu_torch.utils.se3 vs intensity_slam_tpu.utils.se3
on the same numpy inputs (CPU).  Float tolerance 2e-5 absolute: both sides
run float32 and differ only in rounding order (XLA's CPU backend contracts
multiply-adds into FMAs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu.utils import se3 as J
from intensity_slam_tpu_torch.utils import se3 as T

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)

ATOL = 2e-5


def _quats(rng, n, tiny=False):
    if tiny:  # rotations within ~1e-7 rad of identity: the Taylor branches
        v = rng.randn(n, 3).astype(np.float32) * 1e-7
        return np.concatenate([np.ones((n, 1), np.float32), v], -1)
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pose(rng, n, tiny=False):
    return _quats(rng, n, tiny), (rng.randn(n, 3) * 3).astype(np.float32)


def _both(fn_j, fn_t, *args):
    out_j = fn_j(*[jnp.asarray(a) for a in args])
    out_t = fn_t(*[torch.from_numpy(a) for a in args])
    return out_j, out_t


def _close(a, b, atol=ATOL):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _close(x, y, atol)
        return
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


def _wrap(mod):
    return {
        "quat_mul": lambda a, b: mod.quat_mul(a, b),
        "quat_rotate": lambda q, v: mod.quat_rotate(q, v),
        "quat_to_mat": lambda q: mod.quat_to_mat(q),
        "mat_to_quat": lambda q: mod.mat_to_quat(mod.quat_to_mat(q)),
        "so3_exp": lambda v: mod.so3_exp(v),
        "so3_log": lambda q: mod.so3_log(q),
        "se3_exp": lambda xi: tuple(mod.se3_exp(xi)),
        "se3_log": lambda q, t: mod.se3_log(mod.Pose(q, t)),
        "compose": lambda q, t, q2, t2: tuple(mod.compose(mod.Pose(q, t),
                                                          mod.Pose(q2, t2))),
        "inverse": lambda q, t: tuple(mod.inverse(mod.Pose(q, t))),
        "transform_points": lambda q, t, p: mod.transform_points(
            mod.Pose(q[0], t[0]), p),
        "retract": lambda q, t, xi: tuple(mod.retract(mod.Pose(q, t), xi)),
        "slerp": lambda a, b: mod.slerp(a, b, 0.3),
        "geodesic": lambda a, b: mod.rotation_geodesic_angle(a, b),
        "skew": lambda v: mod.skew(v),
        "matrix": lambda q, t: mod.Pose(q, t).matrix(),
    }


def _inputs(name, rng, tiny):
    n = 64
    q, t = _pose(rng, n, tiny)
    q2, t2 = _pose(rng, n, tiny)
    v = (rng.randn(n, 3) * (1e-7 if tiny else 1.0)).astype(np.float32)
    xi = (rng.randn(n, 6) * (1e-7 if tiny else 0.5)).astype(np.float32)
    return {
        "quat_mul": (q, q2), "quat_rotate": (q, v), "quat_to_mat": (q,),
        "mat_to_quat": (q,), "so3_exp": (v,), "so3_log": (q,),
        "se3_exp": (xi,), "se3_log": (q, t), "compose": (q, t, q2, t2),
        "inverse": (q, t), "transform_points": (q, t, v * 10),
        "retract": (q, t, xi),
        # near-identical pairs exercise slerp's lerp branch
        "slerp": (q, q2 if not tiny else q), "geodesic": (q, q2),
        "skew": (v,), "matrix": (q, t),
    }[name]


NAMES = list(_wrap(J))


@pytest.mark.parametrize("tiny", [False, True], ids=["generic", "near_zero"])
@pytest.mark.parametrize("name", NAMES)
def test_se3_parity(name, tiny):
    rng = np.random.RandomState(sum(map(ord, name)))
    args = _inputs(name, rng, tiny)
    out_j, out_t = _both(_wrap(J)[name], _wrap(T)[name], *args)
    # geodesic angle of a near-identity pair goes through arccos near 1,
    # whose float32 slope amplifies a 1-ulp input difference to ~5e-4
    _close(out_j, out_t, 1e-3 if name == "geodesic" else ATOL)


def test_identity_and_pose_where():
    p = T.Pose.identity((3,), device="cpu")
    np.testing.assert_array_equal(p.q.numpy(), np.asarray(J.Pose.identity((3,)).q))
    a = T.Pose(torch.zeros(3, 4), torch.ones(3, 3))
    sel = T.pose_where(torch.tensor([True, False, True]), a, p)
    assert sel.t[:, 0].tolist() == [1.0, 0.0, 1.0]
