"""Parity: intensity_slam_tpu_torch.ops.{conv2d,projection,features} vs the
JAX package on the same scans (small_test_config, CPU).

Tolerances and tie rules:
- integers and bools (keypoint pixels, validity, match indices, counts)
  are compared exactly;
- floats at 1e-4 relative: XLA's CPU backend contracts multiply-adds into
  FMAs and sums the row filter as a matrix product, so filtered images
  differ from the port's in the last 1-2 bits;
- descriptor bits are compared exactly except where the two blurred samples
  of a pair are within 1e-3 of each other (a tie that last-bit rounding can
  flip); such near ties are counted and must be rare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu import config
from intensity_slam_tpu.io import synthetic
from intensity_slam_tpu.ops import conv2d as Jc
from intensity_slam_tpu.ops import features as JF
from intensity_slam_tpu.ops import projection as JP
from intensity_slam_tpu_torch import config as tconfig
from intensity_slam_tpu_torch.ops import conv2d as Tc
from intensity_slam_tpu_torch.ops import features as TF
from intensity_slam_tpu_torch.ops import projection as TP

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scans():
    cfg = config.small_test_config()
    poses = synthetic.corridor_trajectory(2, speed=0.35, yaw_rate=0.01)
    xyz, inten = synthetic.render_sequence(poses, synthetic.corridor_world(),
                                           cfg.sensor)
    xyz, inten = np.asarray(xyz), np.asarray(inten)
    tcfg = tconfig.small_test_config()
    out = []
    for k in range(2):
        js = JP.project_organized(jnp.asarray(xyz[k]), jnp.asarray(inten[k]),
                                  cfg.sensor)
        ts = TP.project_organized(torch.from_numpy(xyz[k]),
                                  torch.from_numpy(inten[k]), tcfg.sensor)
        out.append((js, ts))
    return cfg, tcfg, out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_projection_parity(scans):
    cfg, tcfg, frames = scans
    js, ts = frames[0]
    for f in ("valid",):
        np.testing.assert_array_equal(_np(getattr(js, f)), _np(getattr(ts, f)))
    for f in ("intensity", "range", "xyz"):
        np.testing.assert_allclose(_np(getattr(js, f)), _np(getattr(ts, f)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        _np(JP.detection_mask(cfg.sensor)),
        _np(TP.detection_mask(tcfg.sensor, device="cpu")))
    uv = np.stack([np.arange(40) * 5 % 256, np.arange(40) % 32], -1).astype(np.int32)
    jp, jo = JP.lift_uv_to_3d(js, jnp.asarray(uv))
    tp, to = TP.lift_uv_to_3d(ts, torch.from_numpy(uv))
    np.testing.assert_array_equal(_np(jo), _np(to))
    np.testing.assert_allclose(_np(jp), _np(tp), atol=1e-6)


@pytest.mark.parametrize("which", ["box5", "box7", "sobel", "moments"])
def test_filters_parity(scans, which):
    _, _, frames = scans
    img = _np(frames[0][0].intensity)
    ji, ti = jnp.asarray(img), torch.from_numpy(img)
    if which == "box5":
        pairs = [(Jc.box_filter(ji, 5), Tc.box_filter(ti, 5))]
    elif which == "box7":
        pairs = [(Jc.box_filter(ji, 7, row_mode="edge", col_mode="edge"),
                  Tc.box_filter(ti, 7, row_mode="edge", col_mode="edge"))]
    elif which == "sobel":
        pairs = list(zip(Jc.sobel(ji), Tc.sobel(ti)))
    else:
        pairs = [(Jc.sep_filter(ji, JF._ONES_COL, JF._DX_ROW),
                  Tc.sep_filter(ti, TF._ONES_COL, TF._DX_ROW))]
    # the moment filter sums +-(1..15)-weighted pixels over a 13x31 patch:
    # partial sums reach ~8e5, so float32 rounding leaves ~0.1 absolute
    atol = 0.2 if which == "moments" else 1e-3
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=atol)


def test_detect_parity(scans):
    cfg, tcfg, frames = scans
    js, ts = frames[0]
    jm = JP.detection_mask(cfg.sensor) & JF.depth_stable_mask(js)
    tm = TP.detection_mask(tcfg.sensor, device="cpu") & TF.depth_stable_mask(ts)
    np.testing.assert_array_equal(_np(jm), _np(tm))
    K = cfg.feature.num_features
    juv, jsub, jsc, jv = JF.detect(js.intensity, jm, K, cfg.feature.nms_radius)
    tuv, tsub, tsc, tv = TF.detect(ts.intensity, tm, K, tcfg.feature.nms_radius)
    np.testing.assert_array_equal(_np(juv), _np(tuv))
    np.testing.assert_array_equal(_np(jv), _np(tv))
    fin = np.isfinite(_np(jsc))
    np.testing.assert_array_equal(fin, np.isfinite(_np(tsc)))
    np.testing.assert_allclose(_np(jsc)[fin], _np(tsc)[fin], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(jsub), _np(tsub), atol=1e-3)
    np.testing.assert_allclose(_np(JF.corner_response(js.intensity)),
                               _np(TF.corner_response(ts.intensity)),
                               rtol=1e-4, atol=1e-3)


def test_top_k_ties_lowest_index_first():
    x = np.array([1.0, 3.0, 3.0, -np.inf, 3.0, 1.0, -np.inf], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = TF.top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def _desc_bits(words):
    w = np.asarray(words).view(np.uint32)[..., None]
    return ((w >> np.arange(32, dtype=np.uint32)) & 1).reshape(w.shape[0], 256)


def _near_ties(blur, uv, pattern_int):
    """(K, 256) bool: pairs whose two blurred samples lie within 1e-3."""
    H, W = blur.shape
    u, v = uv[:, 0][:, None], uv[:, 1][:, None]
    a = blur[(v + pattern_int[None, :, 0, 1]) % H, (u + pattern_int[None, :, 0, 0]) % W]
    b = blur[(v + pattern_int[None, :, 1, 1]) % H, (u + pattern_int[None, :, 1, 0]) % W]
    return np.abs(a - b) <= 1e-3


def test_describe_dense_bits(scans):
    cfg, _, frames = scans
    js, ts = frames[0]
    jm = JP.detection_mask(cfg.sensor) & JF.depth_stable_mask(js)
    uv = np.asarray(JF.detect(js.intensity, jm, cfg.feature.num_features)[0])
    jd = JF.describe_dense(js.intensity, jnp.asarray(uv))
    td = TF.describe_dense(ts.intensity, torch.from_numpy(uv))
    jb, tb = _desc_bits(jd), _desc_bits(td.numpy())
    ties = _near_ties(np.asarray(JF._box_blur(js.intensity)), uv,
                      JF._PATTERN_INT)
    assert not np.any((jb != tb) & ~ties), "descriptor bit differs off a tie"
    assert ties.mean() < 0.01


def test_describe_oriented(scans):
    """The oriented (rBRIEF) path, off by default: angles at 1e-4 rad; bits
    agree except where a rotated sample lands within rounding noise of a
    pixel boundary or a near tie — at most 0.5 % of bits."""
    cfg, _, frames = scans
    js, ts = frames[0]
    uv = np.asarray(JF.detect(js.intensity, JP.detection_mask(cfg.sensor),
                              cfg.feature.num_features)[0])
    jd, ja = JF.describe(js.intensity, jnp.asarray(uv))
    td, ta = TF.describe(ts.intensity, torch.from_numpy(uv))
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), atol=1e-4)
    assert (_desc_bits(jd) != _desc_bits(td.numpy())).mean() < 0.005


def test_lift_subpixel_parity(scans):
    cfg, _, frames = scans
    js, ts = frames[0]
    uv, uv_sub, _, _ = JF.detect(js.intensity, JP.detection_mask(cfg.sensor),
                                 cfg.feature.num_features)
    a = JF.lift_subpixel(js, uv, uv_sub)
    b = TF.lift_subpixel(ts, torch.from_numpy(np.asarray(uv)),
                         torch.from_numpy(np.asarray(uv_sub)))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)


def test_extract_parity(scans):
    cfg, tcfg, frames = scans
    for js, ts in frames:
        jf = JF.extract(js, JP.detection_mask(cfg.sensor), cfg.feature)
        tf = TF.extract(ts, TP.detection_mask(tcfg.sensor, device="cpu"),
                        tcfg.feature)
        for f in ("uv", "valid", "xyz_valid"):
            np.testing.assert_array_equal(_np(getattr(jf, f)), _np(getattr(tf, f)))
        np.testing.assert_allclose(_np(jf.xyz), _np(tf.xyz), atol=1e-4)
        ties = _near_ties(np.asarray(JF._box_blur(js.intensity)),
                          np.asarray(jf.uv), JF._PATTERN_INT)
        diff = _desc_bits(jf.desc) != _desc_bits(tf.desc.numpy())
        assert not np.any(diff & ~ties)


def test_hamming_and_popcount_exact():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 2**32, size=(37, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, size=(53, 8), dtype=np.uint64).astype(np.uint32)
    b[:4] = a[:4]
    b[4, 0] = a[4, 0] ^ np.uint32(0x80000001)
    jh = JF.hamming_matrix(jnp.asarray(a), jnp.asarray(b))
    th = TF.hamming_matrix(torch.from_numpy(a.view(np.int32)),
                           torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    w = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xF0F0F0F0],
                 np.uint32)
    np.testing.assert_array_equal(
        TF.popcount32(torch.from_numpy(w.view(np.int32))).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(w))))


@pytest.mark.parametrize("case", ["frames", "random", "few"])
def test_match_retry_exact(scans, case):
    """Same descriptors in -> identical matches out (ties in the Hamming
    argmin go lowest-index first, the rank sort is stable)."""
    cfg, _, frames = scans
    fc = cfg.feature
    if case == "frames":
        fs = [JF.extract(js, JP.detection_mask(cfg.sensor), fc) for js, _ in frames]
        da, va = np.asarray(fs[1].desc), np.asarray(fs[1].xyz_valid)
        db, vb = np.asarray(fs[0].desc), np.asarray(fs[0].xyz_valid)
    else:
        rng = np.random.RandomState(7)
        n = 64 if case == "random" else 6
        base = rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        flips = rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        flips &= rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        flips &= rng.randint(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        da, db = base, base ^ flips
        va, vb = rng.rand(n) < 0.9, rng.rand(n) < 0.9
    args = (fc.match_keep_frac, fc.match_keep_frac_retry * fc.detect_multiplier,
            fc.min_good_matches, fc.max_hamming)
    jm = JF.match_retry(jnp.asarray(da), jnp.asarray(va), jnp.asarray(db),
                        jnp.asarray(vb), *args)
    tm = TF.match_retry(torch.from_numpy(da.view(np.int32)), torch.from_numpy(va),
                        torch.from_numpy(db.view(np.int32)), torch.from_numpy(vb),
                        *args)
    for f in jm._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)),
                                      _np(getattr(tm, f)), err_msg=f)
