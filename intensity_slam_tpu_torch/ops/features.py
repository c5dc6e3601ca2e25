"""Corner detection + binary descriptors + matching on intensity images
(reference C3).

PyTorch counterpart of `intensity_slam_tpu/ops/features.py`: Shi-Tomasi
min-eigenvalue corner response, NMS by max-pooling, fixed-size top-K;
BRIEF-256 descriptors packed into 8 32-bit words; mutual-NN Hamming matching
with the reference's keep-top-fraction rule
(`src/intensity_feature_tracker.cpp:609-692`).

Port notes:
- Descriptors are stored as int32 words holding the same bit pattern as the
  JAX package's uint32 words (torch has little uint32 arithmetic): bit i of
  word w is sample 32*w+i.  Compare across packages via `.view(np.uint32)`.
- torch has no popcount: `popcount32` is a SWAR count on the two 16-bit
  halves of each word, in int32 arithmetic that cannot overflow.  The
  Hamming matrix is instead one float32 product of the descriptor bits
  mapped to +-1 (exact: its partial sums are small integers).
- `lax.top_k` and `jnp.argsort` put ties in index order; here a stable sort
  does the same.
- Every function takes an optional leading session axis on all of its
  inputs (a batch of independent frames, what `jax.vmap` makes of it); the
  per-session reads go through `utils.index.at`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..config import FeatureConfig
from ..utils import index
from . import conv2d
from .projection import ScanImage

_PATTERN_BITS = 256
_PATCH_X = 15  # half-extent in azimuth (cols)
_PATCH_Y = 6   # half-extent in elevation (rows) — vertical detection border


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """The fixed BRIEF sampling pattern, bit for bit the JAX package's."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(_PATTERN_BITS, 2, 2)
    pts[..., 0] = np.clip(pts[..., 0] * (_PATCH_X / 2.5), -_PATCH_X, _PATCH_X)
    pts[..., 1] = np.clip(pts[..., 1] * (_PATCH_Y / 2.5), -_PATCH_Y, _PATCH_Y)
    return pts.astype(np.float32)


_PATTERN = _make_pattern()                                  # (256, 2, 2) [pair, endpoint, (dx,dy)]
_PATTERN_INT = np.round(_PATTERN).astype(np.int64)          # (256, 2, 2)
_on_device: dict = {}


def _pattern(arr: np.ndarray, device) -> torch.Tensor:
    """The sampling pattern `arr` as a tensor on `device`, copied over once
    per device (a per-frame host-to-device copy stalls the host)."""
    key = (id(arr), str(device))
    if key not in _on_device:
        _on_device[key] = torch.as_tensor(arr, device=device)
    return _on_device[key]


class Features(NamedTuple):
    uv: torch.Tensor        # (K, 2) int32 — (col, row) like cv::KeyPoint.pt
    score: torch.Tensor     # (K,) float32 corner response
    angle: torch.Tensor     # (K,) float32 orientation (rad)
    desc: torch.Tensor      # (K, 8) int32 words — 256-bit binary descriptor
    valid: torch.Tensor     # (K,) bool
    xyz: torch.Tensor       # (K, 3) float32 lifted 3D points (sensor frame)
    xyz_valid: torch.Tensor # (K,) bool — valid AND non-zero 3D lookup


class Matches(NamedTuple):
    src_idx: torch.Tensor   # (M,) int32 into previous-frame features
    dst_idx: torch.Tensor   # (M,) int32 into current-frame features
    dist: torch.Tensor      # (M,) float32 Hamming distance
    valid: torch.Tensor     # (M,) bool
    num_mutual: torch.Tensor  # () int32 — mutual NN count before the keep-frac cut
    num_good: torch.Tensor    # () int32 — matches surviving all gates


def _box_blur(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    return conv2d.box_filter(img, k)


def corner_response(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue response of the structure tensor."""
    gx, gy = conv2d.sobel(img)
    a, b, c = conv2d.box_filter(torch.stack([gx * gx, gx * gy, gy * gy]),
                                window)
    tr2 = (a + c) * 0.5
    det = torch.sqrt(torch.clamp(((a - c) * 0.5) ** 2 + b * b, min=0.0))
    return tr2 - det


def _maxpool2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 max filter over (..., H, W), -inf outside the image
    (reduce_window "SAME")."""
    pooled = Fn.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), 2 * r + 1,
                           stride=1, padding=r)
    return pooled.reshape(x.shape)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` semantics along the last axis: descending, ties lowest
    index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect(
    img: torch.Tensor,
    detect_mask: torch.Tensor,
    num_features: int,
    nms_radius: int = 2,
    min_score: float = 1.0,
):
    """Top-K corners of (..., H, W) images: returns (uv (..., K, 2) int32,
    uv_sub (..., K, 2) f32 subpixel, score (..., K), valid (..., K))."""
    H, W = img.shape[-2:]
    resp_raw = corner_response(img)
    row = torch.arange(H, device=img.device)[:, None]
    border_ok = (row >= _PATCH_Y) & (row < H - _PATCH_Y)
    resp = torch.where(detect_mask & border_ok, resp_raw, -torch.inf)
    keep = resp >= _maxpool2d(resp, nms_radius)  # NMS
    resp = torch.where(keep, resp, -torch.inf)
    score, flat_idx = top_k(resp.flatten(-2), num_features)
    uv = torch.stack([flat_idx % W, flat_idx // W], dim=-1).to(torch.int32)
    valid = score > min_score
    uv_sub = _refine_subpixel(resp_raw, uv)
    return uv, uv_sub, score, valid


def _refine_subpixel(resp: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Quadratic sub-pixel refinement of response peaks (2x2 Newton step on
    the local quadratic model); offsets clamped to half a pixel."""
    H, W = resp.shape[-2:]
    u, v = uv[..., 0].long(), uv[..., 1].long()

    def at(du, dv):
        return index.at(resp, torch.clamp(v + dv, 0, H - 1), (u + du) % W,
                        batch=resp.dim() - 2)

    c = at(0, 0)
    dx = (at(1, 0) - at(-1, 0)) * 0.5
    dy = (at(0, 1) - at(0, -1)) * 0.5
    dxx = at(1, 0) + at(-1, 0) - 2 * c
    dyy = at(0, 1) + at(0, -1) - 2 * c
    dxy = (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1)) * 0.25
    det = dxx * dyy - dxy * dxy
    safe = torch.abs(det) > 1e-9
    det = torch.where(safe, det, 1.0)
    ox = -(dyy * dx - dxy * dy) / det
    oy = -(dxx * dy - dxy * dx) / det
    ok = safe & (torch.abs(ox) <= 0.5) & (torch.abs(oy) <= 0.5)
    ox = torch.where(ok, ox, 0.0)
    oy = torch.where(ok, oy, 0.0)
    return torch.stack([u.float() + ox, v.float() + oy], dim=-1)


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with azimuth wrap in x and clamp in y."""
    H, W = img.shape[-2:]
    batch = img.dim() - 2
    x0 = torch.floor(x).long()
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 2)
    fx, fy = x - x0.float(), y - y0.float()
    x0m, x1m = x0 % W, (x0 + 1) % W
    v00 = index.at(img, y0, x0m, batch=batch)
    v01 = index.at(img, y0, x1m, batch=batch)
    v10 = index.at(img, y0 + 1, x0m, batch=batch)
    v11 = index.at(img, y0 + 1, x1m, batch=batch)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., K, 256) bool -> (..., K, 8) int32 words; bit i of word w is
    sample 32*w+i."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(bits.reshape(bits.shape[:-1] + (8, 32)).long() << shifts,
                      dim=-1)
    # words are in [0, 2^32): reinterpret the low 32 bits as int32
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


_DX_ROW = np.arange(-_PATCH_X, _PATCH_X + 1, dtype=np.float32)
_DY_COL = np.arange(-_PATCH_Y, _PATCH_Y + 1, dtype=np.float32)
_ONES_ROW = np.ones(2 * _PATCH_X + 1, np.float32)
_ONES_COL = np.ones(2 * _PATCH_Y + 1, np.float32)


def describe(img: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Oriented BRIEF-256 for K keypoints: returns (desc (K,8) int32 words,
    angle (K,)).  Orientation by intensity centroid over a rectangular patch;
    rotated offsets round to integer pixels of the blurred image."""
    H, W = img.shape[-2:]
    batch = img.dim() - 2
    blurred = _box_blur(img, 5)
    ul, vl = uv[..., 0].long(), uv[..., 1].long()
    u, v = ul.float(), vl.float()
    m10 = conv2d.sep_filter(blurred, _ONES_COL, _DX_ROW)
    m01 = conv2d.sep_filter(blurred, _DY_COL, _ONES_ROW)
    angle = torch.atan2(index.at(m01, vl, ul, batch=batch),
                        index.at(m10, vl, ul, batch=batch))
    ca, sa = torch.cos(angle), torch.sin(angle)
    pat = _pattern(_PATTERN, img.device)
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    c3 = lambda a: a[..., None, None]
    rx = c3(ca) * px - c3(sa) * py + c3(u)
    ry = c3(sa) * px + c3(ca) * py + c3(v)
    xi = torch.round(rx).long() % W
    yi = torch.clamp(torch.round(ry).long(), 0, H - 1)
    samples = index.at(blurred.flatten(-2), yi * W + xi, batch=batch)  # (K, 256, 2)
    bits = samples[..., 0] < samples[..., 1]
    return _pack_bits(bits), angle


def describe_dense(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Unrotated BRIEF-256 (the JAX package's dense bit planes): bit p of a
    keypoint at (u, v) is blur[v+dy1, u+dx1] < blur[v+dy2, u+dx2] with both
    axes wrapped, exactly what the rolled-plane read gives at (v, u).  Only
    the K keypoints' 256 pairs are sampled.  Returns (K, 8) int32 words."""
    H, W = img.shape[-2:]
    blur = _box_blur(img, 5)
    pat = _pattern(_PATTERN_INT, img.device)                 # (256, 2, 2)
    u = uv[..., 0].long()[..., None, None]
    v = uv[..., 1].long()[..., None, None]
    xi = (u + pat[None, :, :, 0]) % W
    yi = (v + pat[None, :, :, 1]) % H
    samples = index.at(blur.flatten(-2), yi * W + xi,
                       batch=img.dim() - 2)                  # (K, 256, 2)
    return _pack_bits(samples[..., 0] < samples[..., 1])


def lift_subpixel(scan: ScanImage, uv_int: torch.Tensor, uv_sub: torch.Tensor):
    """3D lift at sub-pixel positions, guarded against depth discontinuities:
    the 4 neighbor ranges must agree with the center range within 2% + 5 cm,
    else fall back to the integer pixel's point
    (`intensity_feature_tracker.cpp:1082`)."""
    H, W = scan.range.shape[-2:]
    batch = scan.range.dim() - 2
    x, y = uv_sub[..., 0], uv_sub[..., 1]
    x0 = torch.floor(x).long()
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 2)
    ui, vi = uv_int[..., 0].long(), uv_int[..., 1].long()
    r_c = index.at(scan.range, vi, ui, batch=batch)

    def rng(dy, dx):
        return index.at(scan.range, y0 + dy, (x0 + dx) % W, batch=batch)

    tol = 0.02 * r_c + 0.05
    same_surf = (
        (torch.abs(rng(0, 0) - r_c) < tol) & (torch.abs(rng(0, 1) - r_c) < tol)
        & (torch.abs(rng(1, 0) - r_c) < tol) & (torch.abs(rng(1, 1) - r_c) < tol)
    )
    xyz_b = torch.stack([_bilinear(scan.xyz[..., ch], x, y) for ch in range(3)],
                        dim=-1)
    xyz_i = index.at(scan.xyz, vi, ui, batch=batch)
    return torch.where(same_surf[..., None], xyz_b, xyz_i)


def depth_stable_mask(scan: ScanImage, rel: float = 0.1,
                      abs_m: float = 0.5) -> torch.Tensor:
    """(H, W) bool: pixels NOT on an occlusion/depth discontinuity (see the
    JAX package's docstring for the three criteria): no valid 4-neighbor
    range jump above `abs_m + rel * range` within 3 px, under 15 % invalid
    pixels in the 7x7 support, and the center pixel valid."""
    r = scan.range
    v = scan.valid
    H = r.shape[-2]
    dev = r.device
    up = torch.clamp(torch.arange(H, device=dev) - 1, 0, H - 1)
    down = torch.clamp(torch.arange(H, device=dev) + 1, 0, H - 1)

    def nbrs(a):
        return [a[..., up, :], a[..., down, :], torch.roll(a, 1, dims=-1),
                torch.roll(a, -1, dims=-1)]

    jump = torch.stack([
        torch.where(nv, torch.abs(r - n), 0.0) for n, nv in zip(nbrs(r), nbrs(v))
    ]).amax(dim=0)
    bad = v & (jump >= abs_m + rel * r)
    near_bad = _maxpool2d(torch.where(bad, 1.0, 0.0), 3) > 0.5
    inv_frac = conv2d.box_filter(torch.where(v, 0.0, 1.0), 7)
    return v & ~near_bad & (inv_frac < 0.15)


def extract(scan: ScanImage, detect_mask: torch.Tensor, cfg: FeatureConfig,
            num_features: int | None = None) -> Features:
    """Full per-frame front-end: detect + orient + describe + 3D lift."""
    K = num_features or cfg.num_features
    uv, uv_sub, score, valid = detect(
        scan.intensity, detect_mask & depth_stable_mask(scan), K,
        cfg.nms_radius)
    if cfg.oriented:
        desc, angle = describe(scan.intensity, uv)
    else:
        desc = describe_dense(scan.intensity, uv)
        angle = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    xyz = lift_subpixel(scan, uv, uv_sub)
    # near-zero filter (`extractPointsAndFilterZeroValue`,
    # intensity_feature_tracker.cpp:1071-1099)
    xyz_valid = valid & index.at(scan.valid, uv[..., 1].long(), uv[..., 0].long(),
                                 batch=scan.valid.dim() - 2)
    return Features(uv, score, angle, desc, valid, xyz, xyz_valid)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its 32-bit pattern), as int32."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(..., Ka, 8) x (..., Kb, 8) int32 words -> (..., Ka, Kb) int32 Hamming
    distances (leading dims are a batch of pairs), as one (batched) float32
    product of the descriptors' 256 bits mapped to +-1:
    popcount(a ^ b) = (256 - <sa, sb>) / 2.  Exact, whatever the summation
    order: every partial sum is an integer of magnitude at most 256."""
    shifts = torch.arange(32, dtype=torch.int32, device=da.device)

    def signs(d):
        bits = (d[..., None] >> shifts) & 1                     # (..., K, 8, 32)
        return (1 - 2 * bits).flatten(-2).float()               # (..., K, 256)

    dot = torch.matmul(signs(da), signs(db).transpose(-1, -2))
    return dot.neg_().add_(256.0).mul_(0.5).to(torch.int32)


def _mutual_nn(d, fa_valid, fb_valid, max_hamming):
    """The part of matching that does not depend on the keep fraction:
    mutual nearest neighbours (BFMatcher crossCheck) under `max_hamming` and
    each source's rank by distance, over (..., Ka, Kb) Hamming distances `d`
    (leading dims are a batch of pairs).  Ties go to the lowest index.
    Returns (ia, best_b, dist, cand, num_mutual, rank)."""
    BIG = 1 << 20
    ok = fa_valid[..., :, None] & fb_valid[..., None, :]
    d = torch.where(ok, d, BIG)
    best_b = torch.argmin(d, dim=-1)
    best_a = torch.argmin(d, dim=-2)
    ia = torch.arange(d.shape[-2], device=d.device).expand_as(best_b)
    mutual = torch.gather(best_a, -1, best_b) == ia
    dist = torch.gather(d, -1, best_b[..., None])[..., 0]
    cand = mutual & (dist < max_hamming)
    num_mutual = torch.sum(cand, dim=-1, dtype=torch.int32)
    sort_key = torch.where(cand, dist, BIG)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(-1, order, ia)
    return ia, best_b, dist, cand, num_mutual, rank


def _matches(ia, best_b, dist, good, num_mutual) -> Matches:
    return Matches(
        src_idx=ia.to(torch.int32),
        dst_idx=best_b.to(torch.int32),
        dist=dist.float(),
        valid=good,
        num_mutual=num_mutual,
        num_good=torch.sum(good, dim=-1, dtype=torch.int32),
    )


def match(
    fa_desc: torch.Tensor, fa_valid: torch.Tensor,
    fb_desc: torch.Tensor, fb_valid: torch.Tensor,
    keep_frac: float,
    max_hamming: int = 64,
) -> Matches:
    """Mutual-NN Hamming matching with the reference's keep-top-fraction rule
    (`intensity_feature_tracker.cpp:631-646,684-689`), one cut.  With
    leading batch dims on every input, a batch of independent pairs."""
    ia, best_b, dist, cand, num_mutual, rank = _mutual_nn(
        hamming_matrix(fa_desc, fb_desc), fa_valid, fb_valid, max_hamming)
    keep_n = torch.ceil(num_mutual.float() * keep_frac).to(torch.int32)
    return _matches(ia, best_b, dist, cand & (rank < keep_n[..., None]), num_mutual)


def match_retry(
    fa_desc: torch.Tensor, fa_valid: torch.Tensor,
    fb_desc: torch.Tensor, fb_valid: torch.Tensor,
    keep_frac: float,
    keep_frac_retry: float,
    min_good: int,
    max_hamming: int = 64,
) -> Matches:
    """`match` with the reference's failure re-detect contract in one matrix
    pass (`intensity_feature_tracker.cpp:631-692`): when the first cut keeps
    fewer than `min_good` matches, the looser `keep_frac_retry` cut applies."""
    ia, best_b, dist, cand, num_mutual, rank = _mutual_nn(
        hamming_matrix(fa_desc, fb_desc), fa_valid, fb_valid, max_hamming)
    nm = num_mutual.float()
    keep_n1 = torch.ceil(nm * keep_frac).to(torch.int32)
    num_good1 = torch.sum(cand & (rank < keep_n1[..., None]), dim=-1)
    first_bad = num_good1 < min_good
    keep_n = torch.where(
        first_bad, torch.ceil(nm * keep_frac_retry).to(torch.int32), keep_n1)
    return _matches(ia, best_b, dist, cand & (rank < keep_n[..., None]), num_mutual)


def matched_points(fa: Features, fb: Features, m: Matches):
    """Gather matched 3D correspondences: (src (K,3), dst (K,3), w (K,)).

    Weight is zero unless both endpoints have valid 3D lifts — the analogue
    of the reference's zero-point filtering before the Ceres solve."""
    si, di = m.src_idx.long(), m.dst_idx.long()
    src = fa.xyz[si]
    dst = fb.xyz[di]
    w = (m.valid & fa.xyz_valid[si] & fb.xyz_valid[di]).float()
    return src, dst, w
