"""The port's synthetic renderer (`intensity_slam_tpu_torch/io/synthetic.py`)
against the JAX package's, at small_test_config.

Exact: every world's fields; the polyline trajectories (both packages build
them in float64 numpy).  To 1e-6 (absolute, metres and quaternion
components): the composed trajectories (corridor, circuit), which both
packages compose in float32 op by op; the circuit's 160 composes stay
within 1e-6 over the first lap's first turn.  Geometry of `render_scan`
(rolling-shutter `delta`, dynamic boxes at `frame_time`, textureless zones,
the periodic texture, `return_world`): the valid masks equal on all but
grazing rays (at most 1 in 2000), points within 1e-4 m relative to range.
With the reference's own noise draws handed over (`draws`): the same range
noise and dropout (masks and points as above), and speckled intensity equal
(rtol 1e-5) wherever the unspeckled textures agree.  The texture itself
hashes `sin(large argument)`, so last-bit differences decorrelate a
minority of pixels: it is compared statistically, as
tests/test_torch_slice.py does for the corridor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic as JSyn
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.io import synthetic as TSyn
from intensity_slam_tpu_torch.utils import se3 as T3

CFG = config.small_test_config()
TCFG = interop.config_from_dict(dataclasses.asdict(CFG))

WORLDS = {
    "corridor": ((), {}),
    "circuit": ((), {}),
    "circuit_plain": ((), {"textureless": False}),
    "circuit_dynamic": ((), {"dynamic": True}),
    "figure_eight": ((), {}),
    "aliased_corridor": ((7.5,), {}),
}


def _world_fn(pkg, name):
    base = name.split("_plain")[0].split("_dynamic")[0]
    return getattr(pkg, f"{base}_world")


@pytest.mark.parametrize("name", list(WORLDS))
def test_world_fields_equal(name):
    args, kw = WORLDS[name]
    jw = _world_fn(JSyn, name)(*args, **kw)
    tw = _world_fn(TSyn, name)(*args, **kw, device="cpu")
    assert jw._fields == tw._fields
    for f in jw._fields:
        a, b = getattr(jw, f), getattr(tw, f)
        if isinstance(a, float):
            assert a == b, f
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), f)
            assert b.dtype == torch.float32


TRAJS = {
    "corridor_default": ("corridor_trajectory", (5,), {}),
    "corridor_yaw": ("corridor_trajectory", (12,), {"speed": 0.35, "yaw_rate": 0.01}),
    "circuit": ("circuit_trajectory", (160,), {"speed": 0.4}),
    "polyline": ("polyline_trajectory", ([(0.0, 0.0), (10.0, 0.0), (10.0, 10.0)], 80),
                 {"speed": 0.5, "yaw_smooth": 4}),
    "figure_eight": ("figure_eight_trajectory", (200,), {}),
    "aliased_corridor": ("aliased_corridor_trajectory", (120,), {}),
}


@pytest.mark.parametrize("name", list(TRAJS))
def test_trajectory_equal(name):
    fn, args, kw = TRAJS[name]
    jp = getattr(JSyn, fn)(*args, **kw)
    tp = getattr(TSyn, fn)(*args, **kw, device="cpu")
    assert tp.q.dtype == tp.t.dtype == torch.float32
    assert tp.q.shape == jp.q.shape and tp.t.shape == jp.t.shape
    if name in ("polyline", "figure_eight", "aliased_corridor"):
        np.testing.assert_array_equal(np.asarray(jp.q), tp.q.numpy())
        np.testing.assert_array_equal(np.asarray(jp.t), tp.t.numpy())
    else:
        np.testing.assert_allclose(np.asarray(jp.q), tp.q.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(jp.t), tp.t.numpy(), rtol=0, atol=1e-6)


def _jpose(q, t):
    return J3.Pose(jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32))


def _tpose(p):
    return T3.Pose(torch.tensor(np.asarray(p.q)), torch.tensor(np.asarray(p.t)))


# (world, pose q, pose t, delta (rotvec, t) or None, frame_time)
CASES = {
    # the north leg, looking into the textureless span
    "textureless_zone": ("circuit", {}, [0.0, 0.0, 0.0, 1.0], [30.0, 30.0, 0.8], None, 0.0),
    # the south corridor with the walking person and the cart, 7 s in
    "dynamic_boxes": ("circuit", {"dynamic": True}, [1.0, 0.0, 0.0, 0.0],
                      [24.0, 0.0, 0.8], None, 7.0),
    # fast forward + yaw motion within one scan: strong rolling shutter
    "rolling_shutter": ("corridor", {}, [1.0, 0.0, 0.0, 0.0], [5.0, 0.0, 0.8],
                        ([0.0, 0.0, 0.06], [0.5, 0.0, 0.0]), 0.0),
    "periodic_texture": ("aliased_corridor", {}, [1.0, 0.0, 0.0, 0.0],
                         [23.0, 0.0, 0.8], None, 0.0),
}


def _render_both(case, noise=None, key=None):
    wname, wkw, q, t, delta, ftime = CASES[case]
    jw = _world_fn(JSyn, wname)(**wkw)
    tw = _world_fn(TSyn, wname)(**wkw, device="cpu")
    jp = _jpose(q, t)
    jd = None
    if delta is not None:
        jd = J3.Pose(J3.so3_exp(jnp.asarray(delta[0], jnp.float32)),
                     jnp.asarray(delta[1], jnp.float32))
    jout = jax.jit(lambda p, d, k: JSyn.render_scan(
        p, jw, CFG.sensor, delta=d, frame_time=ftime, noise=noise, key=k,
        return_world=True))(jp, jd, key)
    draws = None
    if noise is not None:
        k_r, k_s, k_d = jax.random.split(key, 3)
        hw = (CFG.sensor.image_height, CFG.sensor.image_width)
        draws = tuple(torch.tensor(np.asarray(a)) for a in (
            jax.random.normal(k_r, hw), jax.random.normal(k_s, hw),
            jax.random.uniform(k_d, hw)))
    tout = TSyn.render_scan(_tpose(jp), tw, TCFG.sensor,
                            delta=None if jd is None else _tpose(jd),
                            frame_time=ftime, noise=noise, return_world=True,
                            draws=draws)
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout]


def _geometry_equal(j, t):
    (jx, ji, jw), (tx, ti, tw) = j, t
    jv, tv = ji > 0, ti > 0
    assert (jv != tv).sum() <= max(1, jv.size // 2000), (jv != tv).sum()
    both = jv & tv
    for a, b in ((jx, tx), (jw, tw)):
        err = np.abs(a - b)[both]
        assert (err <= 1e-4 * (1 + np.abs(a[both]))).all(), err.max()
    return jv, tv, both


@pytest.mark.parametrize("case", list(CASES))
def test_render_scan_geometry(case):
    j, t = _render_both(case)
    jv, tv, both = _geometry_equal(j, t)
    assert both.mean() > 0.5
    ji, ti = j[1], t[1]
    # intensity: the texture's distribution is the same (the share of
    # pixels within 1 of each other falls with the distance from the
    # origin, as the hash's argument grows: 0.39-0.83 here); the constant
    # returns (textureless 100, dynamic 140) are identical where they are
    assert (np.abs(ji - ti)[both] <= 1.0).mean() > 0.3
    a, b = ji[both], ti[both]
    assert abs(a.mean() - b.mean()) < 0.03 * a.mean()
    assert abs(a.std() - b.std()) < 0.06 * a.std()
    for const in (100.0, 140.0):
        jc, tc = (ji == const) & both, (ti == const) & both
        assert (jc == tc).mean() > 0.999
        if case == "textureless_zone" and const == 100.0:
            assert jc.sum() > 200
        if case == "dynamic_boxes" and const == 140.0:
            assert jc.sum() > 20


def test_undistort_inverts_the_port_s_rolling_shutter():
    """The port's `slam.undistort_scan` with the true per-scan delta maps
    the port's rolling-shutter render onto its own world hit points
    (tests/test_sensor_noise.py's check, on the port alone)."""
    from intensity_slam_tpu_torch.pipeline import slam as TS
    _, t = _render_both("rolling_shutter")
    _, _, q, tr, (rv, dt), _ = CASES["rolling_shutter"]
    pose = T3.Pose(torch.tensor(q), torch.tensor(tr))
    delta = T3.Pose(T3.so3_exp(torch.tensor(rv)), torch.tensor(dt))
    x = torch.from_numpy(t[0])
    valid = (x.norm(dim=-1) > 0.1).numpy()
    fixed = TS.undistort_scan(x, delta, TCFG)
    err_naive = np.linalg.norm((T3.transform_points(pose, x).numpy() - t[2])[valid], axis=-1)
    err_fixed = np.linalg.norm((T3.transform_points(pose, fixed).numpy() - t[2])[valid], axis=-1)
    assert np.median(err_naive) > 0.1
    assert err_fixed.max() < 2e-2
    assert np.median(err_fixed) < 0.05 * np.median(err_naive)


@pytest.mark.parametrize("case", ["textureless_zone", "rolling_shutter"])
def test_noise_with_reference_draws(case):
    noise = JSyn.SensorNoise(range_sigma=0.05, intensity_speckle=0.2, dropout_rate=0.1)
    tnoise = TSyn.SensorNoise(*noise)
    key = jax.random.PRNGKey(11)
    j, t = _render_both(case, noise=tnoise, key=key)
    jv, tv, both = _geometry_equal(j, t)
    j0, t0 = _render_both(case)
    dropped = (j0[1] > 0) & ~jv
    assert 0.05 < dropped.sum() / (j0[1] > 0).sum() < 0.15
    # speckle: equal where the unspeckled textures agree
    same_tex = both & (np.abs(j0[1] - t0[1]) <= 1e-5 * j0[1])
    assert same_tex.mean() > 0.3
    np.testing.assert_allclose(j[1][same_tex], t[1][same_tex], rtol=1e-5)


def test_generator_noise_statistics():
    """The port's own draws (a `torch.Generator`) give the configured
    magnitudes, and the same seed gives the same scan."""
    tw = TSyn.corridor_world(device="cpu")
    pose = T3.Pose(torch.tensor([1.0, 0, 0, 0]), torch.tensor([5.0, 0.0, 0.8]))
    clean_x, clean_i = TSyn.render_scan(pose, tw, TCFG.sensor)
    noise = TSyn.SensorNoise(range_sigma=0.05, intensity_speckle=0.2, dropout_rate=0.1)
    outs = [TSyn.render_scan(pose, tw, TCFG.sensor, noise=noise,
                             gen=torch.Generator().manual_seed(0)) for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    nx, ni = outs[0]
    cr, nr = clean_x.norm(dim=-1).numpy(), nx.norm(dim=-1).numpy()
    both = (cr > 0.1) & (nr > 0.1)
    dr = (nr - cr)[both]
    assert 0.03 < dr.std() < 0.08 and abs(dr.mean()) < 0.01
    drop = ((cr > 0.1) & (nr <= 0.1)).sum() / (cr > 0.1).sum()
    assert 0.05 < drop < 0.15
    li = np.log(ni.numpy()[both] / clean_i.numpy()[both])
    assert 0.1 < li.std() < 0.3


def test_render_sequence_distort_and_times():
    """`render_sequence` with `distort` and `times` against the reference's
    (geometry), frame by frame."""
    jpos = JSyn.corridor_trajectory(3, speed=0.4, yaw_rate=0.03)
    times = jnp.asarray([0.0, 2.0, 4.0], jnp.float32)
    jw = JSyn.circuit_world(dynamic=True)
    jp = J3.Pose(jpos.q, jpos.t + jnp.asarray([20.0, 0.0, 0.0]))
    jx, ji = jax.jit(lambda p: JSyn.render_sequence(
        p, jw, CFG.sensor, distort=True, times=times))(jp)
    tx, ti = TSyn.render_sequence(_tpose(jp), TSyn.circuit_world(dynamic=True, device="cpu"),
                                  TCFG.sensor, distort=True,
                                  times=torch.tensor(np.asarray(times)))
    assert tx.shape == jx.shape and ti.shape == ji.shape
    for k in range(3):
        _geometry_equal((np.asarray(jx[k]), np.asarray(ji[k]), np.asarray(jx[k])),
                        (tx[k].numpy(), ti[k].numpy(), tx[k].numpy()))
    # noise from one generator, frame after frame: reproducible per seed
    noisy = [TSyn.render_sequence(_tpose(jp), TSyn.corridor_world(device="cpu"), TCFG.sensor,
                                  noise=TSyn.DEFAULT_NOISE,
                                  gen=torch.Generator().manual_seed(3))[0] for _ in range(2)]
    assert torch.equal(noisy[0], noisy[1])
    assert not torch.equal(noisy[0][0], noisy[0][1])
