"""Capacity paths of the whole system against the reference: the port's
`SlamSystem` and the JAX package's on the same JAX-rendered scans and the
reference's own ground-RANSAC draws, at tests/test_capacity.py's
`_small_cfg` (small_test_config, 256-point keyframe clouds, every loop
channel off), over its 24-frame straight corridor at 0.5 m a frame.

Cases (one run per package each, module-scoped; this file runs
`wrap_compact`, tests/test_torch_capacity_kf.py `kf_2x` and
tests/test_torch_capacity_wrap.py `log_wrap`, with these tests):
- `kf_2x`: tests/test_capacity.py:160 — `max_keyframes` 8 and a keyframe
  nearly every frame, so the store compacts (halves) more than once and
  `fused_step` remaps the log's governing-keyframe ids (`log.kf // 2`).
- `log_wrap`: tests/test_capacity.py:190 — `max_keyframes` 16,
  `log_capacity` 12, 20 frames: the ring wraps and the spiller copies
  segments to the host before they are overwritten.
- `wrap_compact`: both at once — `kf_2x`'s keyframes with `log_capacity`
  12 over 24 frames, so segments spilled before a compaction are exported
  through the spiller's generation remap (`kf >> (gen_now - gen)`, the
  reference's `runtime/spill.py:131`).

Exact: per frame `is_keyframe`, `compacted` and `num_kf`; the log's
governing-keyframe ids (`state.log.kf`), its count and compactions; the
spiller's count and its segments' governing-keyframe ids and generations.
Within 5 mm: the merged odometry of the two runs (`odom_trajectory()`;
found: 1 mm).

`trajectory()` is held on the same state: the reference's final
`FusedState` and its spilled segments carried into the port
(`interop.state_from_numpy`), both exports within 1e-5 m.  With every loop
channel off, every keyframe's era->PGO correction is the identity, so a
wrong remap of a spilled segment's keyframe ids would not move the export.
`test_spill_remap_equal` therefore gives both packages' spillers the same
per-keyframe corrections, each naming its keyframe (t = (0, 0, k + 1)),
reads the remapped id of every spilled frame back out of the export, and
holds the ids equal; in `wrap_compact` segments spilled before a
compaction come out remapped.

The two runs' own `trajectory()` outputs are not compared at a tolerance:
on this corridor at this config they part by up to 0.205 m (frame 17, all
three cases alike), and one float32 rounding step of the input (each
coordinate scaled by 1 + u, u uniform in +-2e-7) moves the port's own
trajectory by 0.16-0.40 m, on this straight corridor and on curved ones
alike (tools/torch_capacity_sensitivity.py: yaw 0 and 0.01 rad a frame at
0.5 m, 0.02 at 0.35 m, two draws each; ROADMAP C.7).  No scene at this
config gives a tolerance that holds on every machine and still catches a
fault; the carried-state export does both.

The reference's spill-remap defect (a frame governed by a dropped odd
keyframe takes the preceding even keyframe's correction) is copied as it
is; the remapped ids above are equal with it.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic as JSyn
from intensity_slam_tpu.pipeline.system import SlamSystem as JSystem
from intensity_slam_tpu.runtime import spill as JSpill
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.pipeline import fused as TF
from intensity_slam_tpu_torch.pipeline.system import SlamSystem as TSystem
from intensity_slam_tpu_torch.runtime import spill as TSpill

torch.set_num_threads(1)

FRAMES = 24
ODOM_ATOL_M = 5e-3
EXPORT_ATOL_M = 1e-5


def _small_cfg(max_kf=8):
    """tests/test_capacity.py:91."""
    base = config.small_test_config()
    lc = dataclasses.replace(base.loop, max_keyframes=max_kf, keyframe_cloud_size=256,
                             use_scancontext=False, use_bow_loop=False,
                             use_radius_search=False)
    return base.replace(loop=lc)


def _every_frame(cfg):
    """A keyframe nearly every frame (tests/test_capacity.py:166-168)."""
    return cfg.replace(odometry=dataclasses.replace(
        cfg.odometry, keyframe_time_interval=0.05, keyframe_distance_interval=0.05))


CASES = {
    "kf_2x": (_every_frame(_small_cfg(8)), FRAMES),
    "log_wrap": (_small_cfg(16).replace(log_capacity=12), 20),
    "wrap_compact": (_every_frame(_small_cfg(8)).replace(log_capacity=12), FRAMES),
}


def _run(cfg, xyz, inten, frames):
    jsys = JSystem(cfg)
    tsys = TSystem(interop.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    jrows, trows = [], []
    for k in range(frames):
        _, sub = jax.random.split(jsys.state.slam.rng)
        u = np.asarray(jax.random.uniform(sub, (cfg.ground.ransac_iters, 3)))
        ji = jsys.process(jnp.asarray(xyz[k]), jnp.asarray(inten[k]), 0.1 * k)
        ti = tsys.process(torch.from_numpy(xyz[k].copy()), torch.from_numpy(inten[k].copy()), 0.1 * k,
                          ground_u=torch.from_numpy(u))
        jrows.append((bool(ji.is_keyframe), bool(ji.compacted), int(ji.num_kf)))
        trows.append((bool(ti.is_keyframe), bool(ti.compacted), int(ti.num_kf)))
    return dict(cfg=cfg, frames=frames, jsys=jsys, tsys=tsys, jrows=jrows, trows=trows,
                jtraj=jsys.trajectory(), ttraj=tsys.trajectory(),
                jodom=jsys.odom_trajectory(), todom=tsys.odom_trajectory())


CASE_NAMES = ("wrap_compact",)   # kf_2x, log_wrap: test_torch_capacity_{kf,wrap}.py


def pytest_generate_tests(metafunc):
    """Each capacity file runs the cases in its own `CASE_NAMES`: one
    reference compile per case, so that no file takes a minute."""
    if "case" in metafunc.fixturenames:
        metafunc.parametrize("case", metafunc.module.CASE_NAMES)


@pytest.fixture(scope="module")
def runs(request):
    cfg = _small_cfg()
    poses = JSyn.corridor_trajectory(FRAMES, speed=0.5, yaw_rate=0.0)
    xyz, inten = jax.jit(lambda q, t: JSyn.render_sequence(
        J3.Pose(q, t), JSyn.corridor_world(), cfg.sensor))(poses.q, poses.t)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    return {name: _run(CASES[name][0], xyz, inten, CASES[name][1])
            for name in request.module.CASE_NAMES}


def test_frame_flags_equal(runs, case):
    r = runs[case]
    assert r["trows"] == r["jrows"]
    max_kf = r["cfg"].loop.max_keyframes
    if case != "log_wrap":
        assert sum(c for _, c, _ in r["trows"]) >= 2          # compacted twice
        assert sum(k for k, _, _ in r["trows"]) > 2 * max_kf  # past 2 x capacity
    assert all(n <= max_kf for _, _, n in r["trows"])


def test_log_ids_and_spill_equal(runs, case):
    r = runs[case]
    jlog, tlog = r["jsys"].state.log, r["tsys"].state.log
    np.testing.assert_array_equal(np.asarray(jlog.kf), tlog.kf.numpy())
    for f in ("count", "compactions", "num_skips"):
        assert int(getattr(jlog, f)) == int(getattr(tlog, f)), f
    jseg, tseg = r["jsys"]._spiller.segments, r["tsys"]._spiller.segments
    assert r["tsys"]._spiller.spilled == r["jsys"]._spiller.spilled
    assert len(tseg) == len(jseg)
    for (_, jt, jkf, jgen), (_, tt, tkf, tgen) in zip(jseg, tseg):
        np.testing.assert_array_equal(tkf, jkf)
        assert tgen == jgen and tt.shape == jt.shape
    n_kf = r["tsys"].num_keyframes
    rows = min(r["frames"], r["cfg"].log_capacity)
    live = tlog.kf[:rows].numpy()
    assert (live >= 0).all() and (live < n_kf).all()
    if case != "kf_2x":
        assert r["tsys"]._spiller.spilled > 0                 # the ring wrapped


def _carried_export(r):
    """Both packages' `trajectory()` on the reference's final state and
    spilled segments: (reference, port) positions."""
    jsys, cfg, frames = r["jsys"], r["cfg"], r["frames"]
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    state = interop.state_from_numpy(jax.tree.map(np.asarray, jsys.state), device="cpu")
    spiller = TSpill.LogSpiller(tcfg)
    spiller.segments = [(np.array(q), np.array(t), np.array(kf), gen)
                        for q, t, kf, gen in jsys._spiller.segments]
    spiller.spilled = jsys._spiller.spilled
    _, tt = spiller.full_trajectory(state, frames, lambda st: TF.trajectory(st, tcfg))
    return jsys.trajectory(), tt


def test_trajectory_within_tolerance(runs, case):
    r = runs[case]
    jt, tt = r["jtraj"], r["ttraj"]
    assert tt.shape == jt.shape == (r["frames"], 3)
    assert np.isfinite(tt).all()
    np.testing.assert_allclose(r["todom"], r["jodom"], atol=ODOM_ATOL_M)
    assert (np.diff(tt[:, 0]) > -0.05).all()                  # chronological
    assert tt[-1, 0] > tt[0, 0] + 3.0
    jexp, texp = _carried_export(r)
    assert texp.shape == jexp.shape == (r["frames"], 3)
    np.testing.assert_allclose(texp, jexp, atol=EXPORT_ATOL_M)


def _naming_corrections(fused_mod, K, as_array):
    """A stand-in for a spill module's `fused` whose per-keyframe
    corrections name their keyframe: identity rotation, t = (0, 0, k + 1)."""
    q = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (K, 1))
    t = np.zeros((K, 3), np.float32)
    t[:, 2] = np.arange(1, K + 1)
    corr = types.SimpleNamespace(q=as_array(q), t=as_array(t))
    return types.SimpleNamespace(**{**vars(fused_mod), "keyframe_corrections": lambda b: corr})


def _spilled_ids(spiller, t_export):
    """The remapped keyframe id of every spilled frame, read back out of an
    export made under `_naming_corrections` (-1: no governing keyframe)."""
    raw = np.concatenate([seg[1] for seg in spiller.segments])
    return np.rint(t_export[: len(raw), 2] - raw[:, 2]).astype(int) - 1


def test_spill_remap_equal(runs, case, monkeypatch):
    r = runs[case]
    jsys, tsys = r["jsys"], r["tsys"]
    K = r["cfg"].loop.max_keyframes
    monkeypatch.setattr(JSpill, "fused", _naming_corrections(JSpill.fused, K, jnp.asarray))
    monkeypatch.setattr(TSpill, "fused", _naming_corrections(TSpill.fused, K, torch.from_numpy))
    jexp, texp = _carried_export(r)
    np.testing.assert_allclose(texp, jexp, atol=EXPORT_ATOL_M)
    jids = _spilled_ids(jsys._spiller, jexp)
    tids = _spilled_ids(tsys._spiller, tsys.trajectory())
    np.testing.assert_array_equal(tids, jids)
    assert (tids >= 0).all() and (tids < tsys.num_keyframes).all()
    gen_now = int(jsys.state.log.compactions)
    remapped = [(kf >= 0) & ((kf >> (gen_now - gen)) != kf)
                for _, _, kf, gen in jsys._spiller.segments]
    assert any(m.any() for m in remapped) == (case == "wrap_compact")
