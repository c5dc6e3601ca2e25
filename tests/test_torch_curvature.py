"""Parity of intensity_slam_tpu_torch.ops.curvature with the JAX package's
A-LOAM feature extraction, at small_test_config, on JAX-rendered corridor
scans handed over as numpy.

- `compute_curvature`: the curvature to 1e-5 relative + 1e-6 absolute (the
  window sums add the same pairs in the same order; XLA's CPU backend fuses
  `sums - 11 * xyz` and the squared sum into FMAs, PyTorch does not), the
  window-valid mask exactly.
- `extract_features`: masks, ring ids and picked points.  The picks are
  ranked by float scores, so an FMA-sized difference can swap two nearly
  equal scores or move a point across `curvature_threshold`, the occlusion
  gap or the parallel-beam test.  What the test found on these four frames:
  every mask and ring id is identical; every sharp and less-sharp slot holds
  the identical point; of the 768 flat slots 64 to 80 per frame hold another
  point of the same ring and segment.  Flat picks are the LOWEST curvatures,
  on planar walls where the curvature is rounding noise around 1e-4: each
  differing pick's curvature (on the reference's own map) is within 1e-7 of
  the reference's pick in that slot, so these are swaps between numerical
  ties, not other features.  The less-flat clouds are equal as sets of
  points (the voxel dedup keeps the point nearest its voxel centre; order
  follows the hashed voxel key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import curvature as JC
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import curvature as TC
from intensity_slam_tpu_torch.ops import projection as TP

torch.set_num_threads(1)

FRAMES = 4


@pytest.fixture(scope="module")
def scans():
    cfg = config.small_test_config()
    poses = synthetic.corridor_trajectory(FRAMES, speed=0.3, yaw_rate=0.02)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(),
                                           cfg.sensor)
    return np.asarray(xyz), np.asarray(inten)


def _both(scans, k):
    cfg, tcfg = config.small_test_config(), tconfig.small_test_config()
    xyz, inten = scans
    js = JP.project_organized(jnp.asarray(xyz[k]), jnp.asarray(inten[k]), cfg.sensor)
    ts = TP.project_organized(torch.from_numpy(xyz[k].copy()),
                              torch.from_numpy(inten[k].copy()), tcfg.sensor)
    return cfg, tcfg, js, ts


@pytest.mark.parametrize("k", range(FRAMES))
def test_compute_curvature(scans, k):
    _, _, js, ts = _both(scans, k)
    jc, jv = JC.compute_curvature(js)
    tc, tv = TC.compute_curvature(ts)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("k", [1, 2, 3, 7, 11])
def test_forward_window_reduce_matches(op, k):
    """Same doubling order on both sides: the float sums are bit-equal (no
    multiply is involved, so nothing can be fused)."""
    x = np.random.RandomState(k).randn(3, 5, 64).astype(np.float32) * 100
    jop, top = (jnp.add, torch.add) if op == "add" else (jnp.maximum, torch.maximum)
    jr = JC._forward_window_reduce(jnp.asarray(x), k, jop)
    tr = TC._forward_window_reduce(torch.from_numpy(x), k, top)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    ref = sum(np.roll(x, -d, axis=-1) for d in range(k)) if op == "add" else \
        np.max([np.roll(x, -d, axis=-1) for d in range(k)], axis=0)
    np.testing.assert_allclose(tr.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_topk_per_segment_ties_in_column_order():
    """Equal scores (and the -inf of ineligible columns) come out in column
    order, as `jax.lax.top_k` gives them."""
    H, W, S = 4, 48, 6
    rng = np.random.RandomState(0)
    score = rng.randint(0, 3, size=(H, W)).astype(np.float32)   # many ties
    elig = rng.rand(H, W) < 0.5
    elig[0, :8] = False                                          # an empty segment
    jo = JC._topk_per_segment_multi([jnp.asarray(score)] * 2,
                                    [jnp.asarray(elig), jnp.asarray(~elig)], [2, 5], S)
    to = TC._topk_per_segment_multi([torch.from_numpy(score)] * 2,
                                    [torch.from_numpy(elig), torch.from_numpy(~elig)],
                                    [2, 5], S)
    for (jr, jc, jk), (tr, tc, tk) in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())


def _as_set(pts, mask):
    return {tuple(p) for p in np.asarray(pts)[np.asarray(mask)].tolist()}


@pytest.mark.parametrize("k", range(FRAMES))
def test_extract_features(scans, k):
    cfg, tcfg, js, ts = _both(scans, k)
    jf = JC.extract_features(js, cfg.sensor, cfg.geometric)
    tf = TC.extract_features(ts, tcfg.sensor, tcfg.geometric)
    jcurv, _ = JC.compute_curvature(js)
    curv_of = dict(zip(map(tuple, np.asarray(js.xyz).reshape(-1, 3).tolist()),
                       np.asarray(jcurv).reshape(-1).tolist()))
    for name in ("sharp", "less_sharp", "flat"):
        jm, tm = np.asarray(getattr(jf, name + "_mask")), getattr(tf, name + "_mask").numpy()
        jr, tr = np.asarray(getattr(jf, name + "_ring")), getattr(tf, name + "_ring").numpy()
        jp, tp = np.asarray(getattr(jf, name)), getattr(tf, name).numpy()
        assert tr.dtype == np.int32 and tp.shape == jp.shape
        np.testing.assert_array_equal(jm, tm)
        np.testing.assert_array_equal(jr, tr)
        assert jm.sum() > 0
        differ = (jp != tp).any(axis=1) & jm
        if name != "flat":
            assert not differ.any()
            continue
        assert differ.sum() <= 0.12 * jm.sum()
        for a, b in zip(jp[differ].tolist(), tp[differ].tolist()):
            assert abs(curv_of[tuple(a)] - curv_of[tuple(b)]) < 1e-7
    assert tf.less_flat.shape == tuple(jf.less_flat.shape)
    assert int(tf.less_flat_mask.sum()) == int(np.asarray(jf.less_flat_mask).sum()) > 0
    assert _as_set(jf.less_flat, jf.less_flat_mask) == \
        _as_set(tf.less_flat.numpy(), tf.less_flat_mask.numpy())
    np.testing.assert_array_equal(np.asarray(jf.less_flat_mask), tf.less_flat_mask.numpy())
