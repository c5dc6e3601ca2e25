"""Voxel grid-hash map: the port's `ops/grid_hash.py` against the JAX
package's on the same numpy inputs — the eight cases of
tests/test_grid_hash.py and `test_evict_far_frees_capacity_for_reuse` of
tests/test_capacity.py, each run through both packages, plus the cases where
a port can go wrong quietly: points exactly on a cell face, on a half-cell
face and at +-512 cells, exact distance ties in `insert` and in `knn`, both
neighborhoods, and a second insert of the same batch.

`way_keys`, `valid`, `num_points` and the k-NN validity must be EQUAL.
`pts` is bit-equal (stored points are copies of inputs).  `sq` is held to
1e-6 relative: XLA's CPU backend may contract the three multiply-adds of a
squared distance into FMAs, the port adds x^2 + y^2 + z^2 in that order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu.ops import grid_hash as JG
from intensity_slam_tpu_torch.ops import grid_hash as TG

torch.set_num_threads(1)

CELL = 0.8


def _t(a):
    return torch.from_numpy(np.array(a))


class Pair:
    """The same map in both packages, fed the same batches."""

    def __init__(self, num_sets, ways):
        self.j = JG.empty(num_sets, ways)
        self.t = TG.empty(num_sets, ways, device="cpu")

    def insert(self, pts, mask=None, cell=CELL):
        pts = np.asarray(pts, np.float32)
        mask = np.ones(len(pts), bool) if mask is None else np.asarray(mask)
        self.j = JG.insert(self.j, jnp.asarray(pts), jnp.asarray(mask), cell)
        self.t = TG.insert(self.t, _t(pts), _t(mask), cell)
        return self

    def assert_equal(self):
        for f in ("way_keys", "valid", "num_points"):
            np.testing.assert_array_equal(
                np.asarray(getattr(self.j, f)), getattr(self.t, f).numpy(), f)
        np.testing.assert_array_equal(
            np.asarray(self.j.pts).view(np.int32), self.t.pts.numpy().view(np.int32))
        assert self.t.way_keys.dtype == torch.int32
        assert self.t.num_points.dtype == torch.int32 and self.t.num_points.dim() == 0
        return self

    def knn(self, queries, k, neighborhood=27, cell=CELL):
        q = np.asarray(queries, np.float32)
        js, jsq, jok = JG.knn(self.j, jnp.asarray(q), cell, k=k,
                              neighborhood=neighborhood)
        ts, tsq, tok = TG.knn(self.t, _t(q), cell, k=k, neighborhood=neighborhood)
        jok, tok = np.asarray(jok), tok.numpy()
        np.testing.assert_array_equal(jok, tok)
        np.testing.assert_array_equal(np.isinf(np.asarray(jsq)), np.isinf(tsq.numpy()))
        np.testing.assert_allclose(np.asarray(jsq)[jok], tsq.numpy()[tok], rtol=1e-6)
        # the selected points are copies of stored points: the same bits
        np.testing.assert_array_equal(np.asarray(js)[jok], ts.numpy()[tok])
        return ts.numpy(), tsq.numpy(), tok


def _uniform(seed, n, lo, hi):
    return np.random.RandomState(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _brute(map_pts, queries, k):
    d = np.linalg.norm(queries[:, None, :] - map_pts[None, :, :], axis=-1)
    return np.sort(d, axis=1)[:, :k]


@pytest.mark.parametrize("neighborhood", [27, 8])
def test_insert_and_knn_exact(neighborhood):
    pts = _uniform(0, 2000, -20, 20)
    p = Pair(1 << 14, 4).insert(pts).assert_equal()
    assert int(p.t.num_points) > 1000
    retained = p.t.pts.reshape(-1, 3).numpy()[p.t.valid.reshape(-1).numpy()]
    queries = pts[:100] + 0.05
    _, sq, ok = p.knn(queries, 3, neighborhood)
    want = _brute(retained, queries, 3)[:, 0]
    # exact inside one cell (27) or half a cell (8)
    close = want < (CELL if neighborhood == 27 else CELL / 2)
    np.testing.assert_allclose(np.sqrt(sq[:, 0])[close], want[close], atol=1e-5)
    assert ok[close, 0].all()


def test_dedup_keeps_nearest_octant_center():
    center = np.array([[0.2, 0.2, 0.2]], np.float32)
    near, far = center + 0.01, center + 0.15
    p = Pair(1 << 10, 2).insert(np.concatenate([far, near])).assert_equal()
    assert int(p.t.num_points) == 1
    sel, _, _ = p.knn(center, 1)
    np.testing.assert_allclose(sel[0, 0], near[0], atol=1e-6)


def test_insert_idempotent():
    pts = _uniform(1, 500, -10, 10)
    p = Pair(1 << 12, 4).insert(pts).assert_equal()
    first = p.t
    p.insert(pts).assert_equal()
    assert torch.equal(first.valid, p.t.valid) and torch.equal(first.pts, p.t.pts)
    assert torch.equal(first.way_keys, p.t.way_keys)
    assert int(first.num_points) == int(p.t.num_points)


def test_insert_idempotent_under_way_contention():
    """Few sets, so distinct new keys contend for a set's ways (claim rounds
    3..W) and some sets fill up.  Both packages drop the same points: a key
    that claims its way in the LAST round leaves its other points unmatched,
    so a second insert of the batch still adds one or two, in the reference
    as in the port; from then on the batch changes nothing."""
    pts = _uniform(7, 300, -6, 6)
    p = Pair(128, 4).insert(pts).assert_equal()
    first = p.t
    per_set = (first.way_keys >= 0).sum(dim=1)
    assert int((per_set >= 3).sum()) > 20               # the sets are crowded
    p.insert(pts).assert_equal()
    assert torch.equal(first.way_keys, p.t.way_keys)
    second = p.t
    p.insert(pts).assert_equal()
    assert torch.equal(second.valid, p.t.valid) and torch.equal(second.pts, p.t.pts)
    assert int(second.num_points) == int(p.t.num_points)


def test_mask_respected():
    mask = np.zeros(10, bool)
    mask[0] = True
    p = Pair(1 << 10, 2).insert(np.ones((10, 3), np.float32), mask).assert_equal()
    assert int(p.t.num_points) == 1


def test_incremental_inserts_accumulate():
    p = Pair(1 << 14, 4)
    batches = [_uniform(10 + i, 400, -30, 30) for i in range(5)]
    for b in batches:
        p.insert(b).assert_equal()
    q = np.concatenate(batches)[::50]
    _, sq, ok = p.knn(q, 1)
    assert ok[:, 0].all()
    assert float(np.sqrt(sq[:, 0]).max()) < CELL


@pytest.mark.parametrize("neighborhood", [27, 8])
def test_knn_empty_map(neighborhood):
    p = Pair(1 << 10, 2)
    _, sq, ok = p.knn(np.zeros((4, 3), np.float32), 5, neighborhood)
    assert not ok.any() and np.isinf(sq).all()


def test_out_of_range_points_dropped():
    pts = np.array([[1e5, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
    p = Pair(1 << 10, 2).insert(pts).assert_equal()
    assert int(p.t.num_points) == 1


def test_radius_count_matches_brute_force():
    pts = _uniform(3, 1500, -10, 10)
    p = Pair(1 << 14, 4).insert(pts).assert_equal()
    retained = p.t.pts.reshape(-1, 3).numpy()[p.t.valid.reshape(-1).numpy()]
    queries, radius = pts[:64], 0.6
    got = TG.radius_count(p.t, _t(queries), CELL, radius).numpy()
    ref = np.asarray(JG.radius_count(p.j, jnp.asarray(queries), CELL, radius))
    np.testing.assert_array_equal(got, ref)
    d = np.linalg.norm(queries[:, None, :] - retained[None, :, :], axis=-1)
    np.testing.assert_array_equal(got, np.minimum((d <= radius).sum(axis=1), 32))


def test_evict_far_frees_capacity_for_reuse():
    near = _uniform(1, 500, -3, 3)
    far = near + 100.0
    p = Pair(1 << 10, 2).insert(near).insert(far).assert_equal()
    n_both = int(p.t.num_points)
    before = p.t
    p.j = JG.evict_far(p.j, jnp.zeros(3), 10.0)
    p.t = TG.evict_far(p.t, torch.zeros(3), 10.0)
    p.assert_equal()
    assert int(p.t.num_points) < n_both
    assert int(before.num_points) == n_both          # the input map is untouched
    assert int((p.t.way_keys >= 0).sum()) < int((before.way_keys >= 0).sum())
    _, _, ok = p.knn(near[:32], 1)
    assert ok[:, 0].all()
    _, _, ok_far = p.knn(far[:32], 1)
    assert not ok_far.any()
    # freed ways are reusable
    p.insert(far).assert_equal()
    _, _, ok_re = p.knn(far[:32], 1)
    assert ok_re[:, 0].all()


def test_evict_far_with_a_device_radius():
    """`radius` may be a 0-d tensor, as `mapping_step` could pass it."""
    pts = _uniform(4, 300, -20, 20)
    p = Pair(1 << 10, 4).insert(pts).assert_equal()
    a = TG.evict_far(p.t, torch.zeros(3), 12.5)
    b = TG.evict_far(p.t, torch.zeros(3), torch.tensor(12.5))
    assert torch.equal(a.valid, b.valid) and int(a.num_points) == int(b.num_points)
    j = JG.evict_far(p.j, jnp.zeros(3), 12.5)
    np.testing.assert_array_equal(np.asarray(j.valid), a.valid.numpy())


@pytest.mark.parametrize("cell", [0.8, 1.6, 0.3])
def test_cell_and_half_cell_faces(cell):
    """Points exactly on a cell face and on a half-cell (octant) face, at
    float32 values of k * cell and (k + 1/2) * cell: the cell coordinate,
    the octant, the stored map and the k-NN must all agree.  (0.3 has no
    exact reciprocal, so a true division puts ~7 % of these points into the
    neighboring cell; the reference multiplies by the reciprocal.)"""
    rng = np.random.RandomState(5)
    k = rng.randint(-40, 40, (1500, 3)).astype(np.float32)
    half = rng.randint(0, 2, (1500, 3)).astype(np.float32) * 0.5
    pts = ((k + half) * np.float32(cell)).astype(np.float32)

    def jfn(x):
        c = JG._voxel_coord(x, cell)
        o = JG._octant(x, c, cell)
        return c, o, JG._octant_center(c, o, cell)

    jc, jo, jcen = (np.asarray(a) for a in jax.jit(jfn)(pts))
    tc = TG._voxel_coord(_t(pts), cell)
    to = TG._octant(_t(pts), tc, cell)
    np.testing.assert_array_equal(jc, tc.numpy())
    np.testing.assert_array_equal(jo, to.numpy())
    np.testing.assert_array_equal(jcen, TG._octant_center(tc, to, cell).numpy())
    p = Pair(1 << 12, 4).insert(pts, cell=cell).assert_equal()
    for nb in (27, 8):
        p.knn(pts[:200], 5, nb, cell=cell)


def test_coordinate_limits():
    """Cells outside [-511, 511] are dropped.  Mid-cell points say where the
    limit lies; points on the faces at +-511 and +-512 cells (whose float32
    values lie a hair to one side) must fall as the reference's do."""
    x = np.array([-512.5, -511.5, -510.5, 511.5, 512.5,       # mid-cell
                  -512.0, -511.0, 511.0, 512.0], np.float32)  # on a face
    cells = np.zeros((len(x), 3), np.float32)
    cells[:, 0] = x
    cells[5:, 1] = np.arange(4)                               # distinct cells
    pts = (cells * np.float32(CELL)).astype(np.float32)
    p = Pair(1 << 10, 4).insert(pts).assert_equal()
    c = TG._voxel_coord(_t(pts), CELL).numpy()
    inside = (np.abs(c) < 512).all(axis=1)
    np.testing.assert_array_equal(inside[:5], [False, False, True, True, False])
    assert int(p.t.num_points) == int(inside.sum())
    for nb in (27, 8):          # neighbor cells beyond the limit clip alike
        p.knn(pts, 2, nb)


def test_insert_ties_go_to_the_first_point():
    """Two points equally far from their octant's center: the lower index
    stays.  A later, equally near point does not replace an occupant."""
    c = np.array([0.2, 0.2, 0.2], np.float32)              # octant center
    a = c + np.array([0.0625, 0, 0], np.float32)
    b = c - np.array([0.0625, 0, 0], np.float32)
    p = Pair(1 << 8, 2).insert(np.stack([a, b, a])).assert_equal()
    assert int(p.t.num_points) == 1
    sel, _, _ = p.knn(c[None], 1)
    np.testing.assert_array_equal(sel[0, 0], a)
    p.insert(b[None]).assert_equal()
    sel, _, _ = p.knn(c[None], 1)
    np.testing.assert_array_equal(sel[0, 0], a)


@pytest.mark.parametrize("neighborhood", [27, 8])
def test_knn_ties_keep_candidate_order(neighborhood):
    """Eight map points at the octant centers around a cell corner are all
    equally far from a query at that corner: both packages must list them in
    (neighbor cell, slot) order."""
    corner = np.array([0.8, 0.8, 0.8], np.float32)
    offs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                    np.float32) * 0.125
    pts = corner + offs
    p = Pair(1 << 8, 4).insert(pts[::-1].copy()).assert_equal()
    assert int(p.t.num_points) == 8
    sel, sq, ok = p.knn(corner[None], 5, neighborhood)
    assert ok.all() and np.ptp(sq) == 0.0
    # cells in lexicographic order, so the first candidates have x below
    assert (sel[0, :4, 0] < corner[0]).all()


def test_set_index_matches_reference():
    keys = np.random.RandomState(9).randint(0, 1 << 30, 5000).astype(np.int32)
    for sets in (1 << 10, 4096, 1000):
        np.testing.assert_array_equal(
            np.asarray(JG._set_index(jnp.asarray(keys), sets)),
            TG._set_index(_t(keys), sets).numpy())


def test_insert_leaves_its_input_untouched():
    pts = _uniform(2, 100, -5, 5)
    m0 = TG.empty(1 << 8, 4, device="cpu")
    m1 = TG.insert(m0, _t(pts), torch.ones(100, dtype=torch.bool), CELL)
    snapshot = [t.clone() for t in m1]
    TG.insert(m1, _t(pts + 3.0), torch.ones(100, dtype=torch.bool), CELL)
    assert int(m0.num_points) == 0 and not m0.valid.any()
    assert all(torch.equal(a, b) for a, b in zip(snapshot, m1))
