"""The skip decision of both packages on the SAME scans of a textureless
span: the port's `odometry_step` against the JAX package's, from the
reference's carried `OdometryState`.

The skip is `odometry_step`'s decision (`intensity_slam_tpu/pipeline/
odometry.py:112-139`; `slam_step` only consumes it when undistortion is off,
the default) and it depends on the previous frame's features and the
current scan alone: the count gate `num_good >= min_good_matches`, the exact
integer test `num_good != num_mutual`, and the Hessian floor
`min_hessian_eig >= min_hessian_eig`.  So each case primes the reference
with the frames before its span, carries the reference's state into the port
(`interop.state_from_numpy`), and runs both over the span on the same
JAX-rendered scans.  No output carries `min_hessian_eig`: the test solves
each package's matched points of each frame (`features.matched_points` of
`match_retry`, both packages' `solve_pose` with the arguments of
`odometry.py:121-128`).

Exact: per-frame `skip`, `num_good`, `num_mutual` (the full-width case:
`num_mutual` within one, because there a descriptor bit near a tie can flip
under XLA's FMA contraction, tests/test_torch_features.py; found once, frame
237 at +-16.6 deg: 164 against 165, with `num_good` and the skip equal).
`min_hessian_eig`:
within 2e-3 relative (plus 1e-6 absolute for a frame with no match), the
float32 rounding of two libraries' feature lifts and solves; where the
reference's value is under EIG_FLOOR = 1e-2 (a 200th of the 2.0 gate) the
Hessian is rank-deficient, its smallest eigenvalue is float32 rounding
(the packages part there by up to 10 % at full width: 8.4e-4 against
9.2e-4), and both values must lie under the floor.

- Small case (tier-1): small_test_config, an 18-frame corridor whose walls
  turn textureless from x = 4 m on, compared from frame 6: the reference
  skips frames 8 and 10-17 (frame 15 by the count gate, the others by the
  Hessian floor) and tracks frames 6, 7 and 9.
- Full-width case (`slow`): `circuit_world()`, frames 236-260 of the
  420-frame `circuit_trajectory`, across the 12 m textureless span on the
  north leg, primed with frame 235, at os0_64_config (bench.py's sensor,
  +-45 deg) and at SlamConfig()'s +-16.6 deg beam table (the sensor of
  `tools/replay.py --benchmark`, which wrote `RESULTS_benchmark.json`).  It
  prints the per-frame table; run it with
  `pytest tests/test_torch_textureless.py -m slow -s`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic as JSyn
from intensity_slam_tpu.ops import features as JF
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu.ops import solver as JS
from intensity_slam_tpu.pipeline import odometry as JO
from intensity_slam_tpu.utils import se3 as J3
from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.ops import features as TF
from intensity_slam_tpu_torch.ops import projection as TP
from intensity_slam_tpu_torch.ops import solver as TS
from intensity_slam_tpu_torch.pipeline import odometry as TO
from intensity_slam_tpu_torch.utils.se3 import Pose as TPose

torch.set_num_threads(1)

EIG_RTOL, EIG_ATOL = 2e-3, 1e-6
EIG_FLOOR = 1e-2


def _render(world, poses, sensor):
    """JAX-rendered scans, one frame at a time, as numpy."""
    render = jax.jit(lambda q, t: JSyn.render_scan(J3.Pose(q, t), world, sensor))
    out = [render(poses.q[k], poses.t[k]) for k in range(poses.q.shape[0])]
    return (np.stack([np.asarray(x) for x, _ in out]),
            np.stack([np.asarray(i) for _, i in out]))


def _min_eig_ref(cfg, prev, cur):
    fc, oc = cfg.feature, cfg.odometry
    m = JF.match_retry(cur.desc, cur.xyz_valid, prev.desc, prev.xyz_valid,
                       fc.match_keep_frac, fc.match_keep_frac_retry * fc.detect_multiplier,
                       fc.min_good_matches, fc.max_hamming)
    src, dst, w = JF.matched_points(cur, prev, m)
    res = JS.solve_pose(J3.Pose.identity(), JS.point_to_point(src, dst, w),
                        iters=oc.gn_iters, robust="huber", robust_scale=oc.huber_delta,
                        lm_lambda0=oc.lm_lambda0)
    return float(res.min_hessian_eig)


def _min_eig_port(cfg, prev, cur):
    fc, oc = cfg.feature, cfg.odometry
    m = TF.match_retry(cur.desc, cur.xyz_valid, prev.desc, prev.xyz_valid,
                       fc.match_keep_frac, fc.match_keep_frac_retry * fc.detect_multiplier,
                       fc.min_good_matches, fc.max_hamming)
    src, dst, w = TF.matched_points(cur, prev, m)
    res = TS.solve_pose(TPose.identity(device="cpu"), TS.point_to_point(src, dst, w),
                        iters=oc.gn_iters, robust="huber", robust_scale=oc.huber_delta,
                        lm_lambda0=oc.lm_lambda0)
    return float(res.min_hessian_eig)


def frame_table(cfg, xyz, inten, start: int) -> list[dict]:
    """Prime the reference with frames [0, start), carry its state into the
    port, run both over [start, T): one row per frame of the span."""
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    jmask = JP.detection_mask(cfg.sensor)
    tmask = TP.detection_mask(tcfg.sensor, device="cpu")
    jproj = jax.jit(lambda x, i: JP.project_organized(x, i, cfg.sensor))
    jstep = jax.jit(lambda s, scan, t: JO.odometry_step(s, scan, t, jmask, cfg))
    js = JO.init_state(cfg)
    for k in range(start):
        js, jo = jstep(js, jproj(xyz[k], inten[k]), jnp.float32(0.1 * k))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jprev = tprev = None
    if start > 0:                         # the primer frame's own features
        jprev = jo.features
        tprev = TF.extract(TP.project_organized(torch.from_numpy(xyz[start - 1]),
                                                torch.from_numpy(inten[start - 1]),
                                                tcfg.sensor), tmask, tcfg.feature)
    rows = []
    for k in range(start, xyz.shape[0]):
        js, jo = jstep(js, jproj(xyz[k], inten[k]), jnp.float32(0.1 * k))
        scan = TP.project_organized(torch.from_numpy(xyz[k]), torch.from_numpy(inten[k]),
                                    tcfg.sensor)
        ts, to = TO.odometry_step(ts, scan, 0.1 * k, tmask, tcfg)
        row = dict(frame=k,
                   ref=(bool(jo.skip), int(jo.num_good), int(jo.num_mutual)),
                   port=(bool(to.skip), int(to.num_good), int(to.num_mutual)))
        if jprev is not None:
            row["ref_eig"] = _min_eig_ref(cfg, jprev, jo.features)
            row["port_eig"] = _min_eig_port(tcfg, tprev, to.features)
        rows.append(row)
        jprev, tprev = jo.features, to.features
    return rows


def print_table(rows) -> None:
    print("\nframe  skip ref/port  num_good ref/port  num_mutual ref/port  "
          "min_hessian_eig ref / port")
    for r in rows:
        print(f"{r['frame']:5d}  {r['ref'][0]!s:>5}/{r['port'][0]!s:<5}  "
              f"{r['ref'][1]:8d}/{r['port'][1]:<8d}  {r['ref'][2]:10d}/{r['port'][2]:<8d}  "
              f"{r.get('ref_eig', float('nan')):.6g} / {r.get('port_eig', float('nan')):.6g}")


def check_table(rows, cfg, mutual_slack: int = 0) -> None:
    assert [r["port"][:2] for r in rows] == [r["ref"][:2] for r in rows]
    for r in rows:
        assert abs(r["port"][2] - r["ref"][2]) <= mutual_slack, r
        if "ref_eig" not in r:
            continue
        if r["ref_eig"] < EIG_FLOOR:
            assert r["port_eig"] < EIG_FLOOR, r
        else:
            np.testing.assert_allclose(r["port_eig"], r["ref_eig"],
                                       rtol=EIG_RTOL, atol=EIG_ATOL, err_msg=str(r["frame"]))
        # the recomputed eigenvalue explains the reference's decision
        gated = (r["ref"][1] >= cfg.feature.min_good_matches
                 and r["ref"][1] != r["ref"][2])
        assert r["ref"][0] == (not gated or r["ref_eig"] < cfg.odometry.min_hessian_eig)


@pytest.fixture(scope="module")
def small_rows():
    cfg = config.small_test_config()
    world = JSyn.corridor_world()._replace(
        flat_centers=jnp.array([[17.0, 0.0, 1.6]]),
        flat_halves=jnp.array([[13.0, 3.0, 2.1]]))
    poses = JSyn.corridor_trajectory(18, speed=0.4, yaw_rate=0.0)
    xyz, inten = _render(world, poses, cfg.sensor)
    return cfg, frame_table(cfg, xyz, inten, start=6)


def test_small_span_decisions_equal(small_rows):
    cfg, rows = small_rows
    print_table(rows)
    check_table(rows, cfg)
    skips = [r["frame"] for r in rows if r["ref"][0]]
    assert len(skips) >= 6, skips
    assert any(not r["ref"][0] for r in rows)
    # both gates that part a skip from a tracked frame are reached
    by_count = [r for r in rows if r["ref"][1] < cfg.feature.min_good_matches]
    by_eig = [r for r in rows if r["ref"][0] and r["ref"][1] >= cfg.feature.min_good_matches]
    assert by_count and by_eig, (by_count, by_eig)


@pytest.mark.slow
@pytest.mark.parametrize("sensor", ["os0_64", "legacy_16.6"])
def test_full_width_circuit_span_decisions_equal(sensor):
    cfg = config.os0_64_config() if sensor == "os0_64" else config.SlamConfig()
    world = JSyn.circuit_world()
    poses = JSyn.circuit_trajectory(420, speed=0.4)
    span = J3.Pose(poses.q[235:261], poses.t[235:261])
    xyz, inten = _render(world, span, cfg.sensor)
    rows = frame_table(cfg, xyz, inten, start=1)
    for r in rows:
        r["frame"] += 235
    print(f"\n{sensor}:")
    print_table(rows)
    check_table(rows, cfg, mutual_slack=1)
