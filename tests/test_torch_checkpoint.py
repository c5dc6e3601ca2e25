"""The port's checkpoints (`intensity_slam_tpu_torch/utils/checkpoint.py`,
`SlamSystem.save`/`load`) and metrics (`utils/metrics.py`).

Round trips of `SlamState`, `BackendState` and a whole `FusedState` are
exact (every leaf, the generator's state included).  Across packages, at
small_test_config over a 12-frame JAX-rendered corridor cut at frame 6:

- a checkpoint the JAX `SlamSystem` wrote at frame 6, loaded into the
  port's, continues with the reference's decisions (skip and keyframe
  flags, keyframe count, the log's keyframe ids and skips: exact; logged
  positions within 0.1 m, the tolerance of tests/test_torch_fused.py);
- a checkpoint the port wrote at frame 6, loaded into the JAX
  `SlamSystem` (with the reference's own key at frame 6, which the port's
  file does not carry), continues likewise;
- the port resumed from its own checkpoint equals its uninterrupted run
  exactly.

The ground-RANSAC draws come from the reference's key chain (as in
tests/test_torch_fused.py).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic as JSyn
from intensity_slam_tpu.pipeline.system import SlamSystem as JSystem
from intensity_slam_tpu.utils import checkpoint as JCkpt
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.pipeline import fused as TF
from intensity_slam_tpu_torch.pipeline import loop as TL
from intensity_slam_tpu_torch.pipeline import slam as TS
from intensity_slam_tpu_torch.pipeline.system import SlamSystem as TSystem
from intensity_slam_tpu_torch.utils import checkpoint, metrics

torch.set_num_threads(1)
FRAMES, CUT = 12, 6


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _leaves(tree):
    return list(checkpoint._leaves(tree))


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), p
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), p


def test_roundtrip_slam_state(tmp_path):
    cfg = _tcfg(config.small_test_config())
    st = TS.init_state(cfg, seed=3, device="cpu")
    st.gen.manual_seed(77)
    torch.rand(5, generator=st.gen)            # a generator mid-stream
    st = st._replace(merged_pose=st.merged_pose._replace(t=torch.tensor([1.0, 2.0, 3.0])))
    p = str(tmp_path / "slam.npz")
    checkpoint.save(p, st)
    back = checkpoint.restore(p, TS.init_state(cfg, device="cpu"), strict=True)
    _assert_same(st, back)
    assert torch.equal(torch.rand(3, generator=back.gen), torch.rand(3, generator=st.gen))


def test_roundtrip_backend_and_fused_state(tmp_path):
    cfg = _tcfg(config.small_test_config())
    b = TL.init_state(cfg, device="cpu")
    b = b._replace(num_kf=torch.tensor(5, dtype=torch.int32),
                   kf_sig=torch.full_like(b.kf_sig, -7))      # uint32 words
    p = str(tmp_path / "backend.npz")
    checkpoint.save(p, b)
    with np.load(p) as data:
        sig = [k for k in data.files if k.endswith("|kf_sig")]
        assert sig and data[sig[0]].dtype == np.uint32
    _assert_same(b, checkpoint.restore(p, TL.init_state(cfg, device="cpu"), strict=True))
    f = TF.init_state(cfg, seed=1, device="cpu")
    f = f._replace(log=f.log._replace(count=torch.tensor(9, dtype=torch.int32)))
    p = str(tmp_path / "fused.npz")
    checkpoint.save(p, f)
    _assert_same(f, checkpoint.restore(p, TF.init_state(cfg, device="cpu"), strict=True))


def test_shape_mismatch_and_strict(tmp_path):
    small = _tcfg(config.small_test_config())
    p = str(tmp_path / "state.npz")
    checkpoint.save(p, TS.init_state(small, device="cpu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(p, TS.init_state(_tcfg(config.SlamConfig()), device="cpu"))
    # a template with a leaf the file lacks: kept with a warning, or raises
    tmpl = TL.init_state(small, device="cpu")
    checkpoint.save(p, tmpl._replace(num_kf=None))
    with pytest.warns(UserWarning, match="1 template leaves not in checkpoint"):
        r = checkpoint.restore(p, tmpl)
    assert torch.equal(r.num_kf, tmpl.num_kf)
    with pytest.raises(ValueError):
        checkpoint.restore(p, tmpl, strict=True)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    cfg = config.small_test_config()
    poses = JSyn.corridor_trajectory(FRAMES, speed=0.35, yaw_rate=0.02)
    xyz, inten = jax.jit(lambda q, t: JSyn.render_sequence(
        J3.Pose(q, t), JSyn.corridor_world(), cfg.sensor))(poses.q, poses.t)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    jsys = JSystem(cfg)
    draws, jinfo, rng_at_cut = [], [], None
    for k in range(FRAMES):
        if k == CUT:
            jsys.save(str(d / "jax"))
            rng_at_cut = np.asarray(jsys.state.slam.rng)   # the state is donated
        _, sub = jax.random.split(jsys.state.slam.rng)
        draws.append(np.asarray(jax.random.uniform(sub, (cfg.ground.ransac_iters, 3))))
        jinfo.append(jax.tree.map(np.asarray, jsys.process(
            jnp.asarray(xyz[k]), jnp.asarray(inten[k]), 0.1 * k)))
    jfinal = jax.tree.map(np.asarray, jsys.state)
    t = lambda a: torch.from_numpy(np.array(a))

    def port_run(system, frames):
        return [system.process(t(xyz[k]), t(inten[k]), 0.1 * k, ground_u=t(draws[k]))
                for k in frames]

    # the port, uninterrupted, saving at the cut
    tsys = TSystem(_tcfg(cfg), device="cpu")
    tinfo = port_run(tsys, range(CUT))
    tsys.save(str(d / "port"))
    tinfo += port_run(tsys, range(CUT, FRAMES))
    # the port resumed from the JAX checkpoint, and from its own
    from_jax = TSystem(_tcfg(cfg), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        from_jax.load(str(d / "jax"))
    from_jax_info = port_run(from_jax, range(CUT, FRAMES))
    from_port = TSystem(_tcfg(cfg), device="cpu")
    from_port.load(str(d / "port"))
    from_port_info = port_run(from_port, range(CUT, FRAMES))
    # the reference resumed from the port's checkpoint, with its own key
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsys.load(str(d / "port"))
    jsys.state = jsys.state._replace(slam=jsys.state.slam._replace(rng=jnp.asarray(rng_at_cut)))
    j_from_port = [jax.tree.map(np.asarray, jsys.process(
        jnp.asarray(xyz[k]), jnp.asarray(inten[k]), 0.1 * k)) for k in range(CUT, FRAMES)]
    return dict(jinfo=jinfo, jfinal=jfinal, tsys=tsys, tinfo=tinfo, from_jax=from_jax,
                from_jax_info=from_jax_info, from_port=from_port,
                from_port_info=from_port_info, jsys=jsys, j_from_port=j_from_port,
                load_warnings=[str(w.message) for w in caught])


FLAGS = ("skip", "is_keyframe", "num_kf", "loop_found")


def _flags(infos):
    return [tuple(getattr(i, f).item() for f in FLAGS) for i in infos]


def test_jax_checkpoint_continues_in_the_port(session):
    s = session
    assert _flags(s["from_jax_info"]) == _flags(s["jinfo"][CUT:])
    assert sum(f[1] for f in _flags(s["jinfo"])) >= 3
    jlog, tlog = s["jfinal"].log, s["from_jax"].state.log
    for f in ("kf", "skip", "count", "num_skips"):
        np.testing.assert_array_equal(getattr(jlog, f), getattr(tlog, f).numpy(), f)
    np.testing.assert_allclose(jlog.t[:FRAMES], tlog.t.numpy()[:FRAMES], atol=0.1)
    assert s["from_jax"]._frames == FRAMES
    # only the random state differs between the two formats
    assert any("slam/rng" in w for w in s["load_warnings"])
    assert any("slam/gen" in w for w in s["load_warnings"])


def test_port_checkpoint_continues_in_the_reference(session):
    s = session
    assert _flags(s["j_from_port"]) == _flags(s["jinfo"][CUT:])
    jlog = jax.tree.map(np.asarray, s["jsys"].state.log)
    for f in ("kf", "skip", "count", "num_skips"):
        np.testing.assert_array_equal(getattr(jlog, f), getattr(s["jfinal"].log, f), f)
    np.testing.assert_allclose(jlog.t[:FRAMES], s["jfinal"].log.t[:FRAMES], atol=0.1)


def test_port_resumes_its_own_checkpoint_exactly(session):
    s = session
    assert _flags(s["from_port_info"]) == _flags(s["tinfo"][CUT:])
    _assert_same(s["from_port"].state.log, s["tsys"].state.log)
    _assert_same(s["from_port"].state.backend, s["tsys"].state.backend)
    np.testing.assert_array_equal(s["from_port"].trajectory(), s["tsys"].trajectory())


def test_checkpoint_files_share_the_format(session, tmp_path):
    """The same key paths in both packages' files, but the random state."""
    cfg = config.small_test_config()
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    from intensity_slam_tpu.pipeline import fused as JF
    JCkpt.save(jp, JF.init_state(cfg))
    checkpoint.save(tp, TF.init_state(_tcfg(cfg), device="cpu"))
    keys = lambda p: {k.split("|", 1)[1] for k in np.load(p).files}
    assert keys(jp) ^ keys(tp) == {"slam/rng", "slam/gen"}


def test_stage_timer_and_metrics():
    t = metrics.StageTimer()
    for _ in range(3):
        with t.stage("work"):
            sum(range(1000))
    s = t.summary()
    assert s["work"]["count"] == 3
    assert "work" in t.report()

    class FakeOut:
        skip = torch.tensor(False)
        is_keyframe = torch.tensor(True)
        num_good = torch.tensor(42)
        num_plane_residuals = torch.tensor(10)
        ground_ok = torch.tensor(True)
        map_points = 100

    m = metrics.FrameMetrics()
    m.add(FakeOut())
    m.add(FakeOut())
    out = m.summary()
    assert out["num_good"]["mean"] == 42.0 and out["frames"] == 2
    assert out["is_keyframe"]["last"] == 1.0 and out["map_points"]["max"] == 100.0


def test_device_trace_writes_a_trace(tmp_path):
    with metrics.device_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
