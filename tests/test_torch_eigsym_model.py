"""A numpy model of the sweeps of the Jacobi eigensolver kernels
(`intensity_slam_tpu_torch/csrc/eigsym.cu`), on the CPU, no kernel.

- `jacobi_kernel<3, ...>` (one thread a matrix, cyclic order, the classical
  rotation): its per-matrix exit, after the first sweep that neither
  rotated nor zeroed an element, gives the same bits as the fixed 12 sweeps
  in the model's own arithmetic (float32 and float64), because a sweep that
  changes nothing leaves a fixed point.
- `jacobi_kernel<6, values>` (one warp a matrix, a lane a lower-triangle
  element): the round-robin ordering visits every index pair once a sweep
  in 5 rounds of 3 disjoint pairs, and its eigenvalues are within the
  smoke run's bar (1e-5 of the largest |eigenvalue|) of
  `torch.linalg.eigvalsh`'s.
- The sweeps each takes on matrices shaped like its call sites' (the ground
  refit's plane covariances, `fit_lines`' neighbourhood covariances, the
  solver's Gauss-Newton Hessians), within the cap `eigsym.SWEEPS`.

The card rounds otherwise (fused multiply-adds, `rsqrt`), so this holds the
algorithm, not the kernel's bits; `tests/test_torch_eigsym_cuda.py` holds
the kernels on the card.  `pytest -s` prints the sweep counts.
"""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch.ops import eigsym

DTYPES = (np.float32, np.float64)
VAL_TOL = 1e-5            # chip_smoke.EIG_VAL_TOL


def round_robin(n=6):
    """The rounds of one sweep: round k pairs n-1 with k and (k+d, k-d)
    mod n-1 for d = 1 .. n/2-1 (the circle method), each pair (q, p) with
    q > p."""
    m = n - 1
    rounds = []
    for k in range(m):
        pairs = [(m, k)] + [((k + d) % m, (k - d) % m) for d in range(1, n // 2)]
        rounds.append([(max(a, b), min(a, b)) for a, b in pairs])
    return rounds


def partner(k, x, n=6):
    """The index paired with x in round k, as the kernel computes it."""
    m = n - 1
    return k if x == m else (m if x == k else (2 * k - x) % m)


# ---- the 3x3 kernel's sweeps ------------------------------------------------

def jacobi3(a, sweeps=eigsym.SWEEPS, early_exit=True):
    """(vals ascending, vecs as columns, sweeps run) of the symmetric (B, 3,
    3) `a` by the classical cyclic Jacobi of the 3x3 kernel: the negligible
    test from the fifth sweep, the tau-form update; with `early_exit` each
    matrix stops after a sweep that neither rotated nor zeroed an element."""
    dt = a.dtype.type
    B, n = a.shape[0], a.shape[-1]
    lo = np.tril(a)
    A = lo + np.swapaxes(np.tril(a, -1), -1, -2)
    V = np.broadcast_to(np.eye(n, dtype=a.dtype), A.shape).copy()
    active = np.ones(B, bool)
    ran = np.zeros(B, np.int64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for s in range(sweeps):
            ran += active
            changed = np.zeros(B, bool)
            for p in range(n - 1):
                for q in range(p + 1, n):
                    apq, app, aqq = A[:, p, q].copy(), A[:, p, p].copy(), A[:, q, q].copy()
                    g = dt(100) * np.abs(apq)
                    zero = active & (s > 3) & (np.abs(app) + g == np.abs(app)) \
                        & (np.abs(aqq) + g == np.abs(aqq))
                    rot = active & ~zero & (apq != 0)
                    A[zero, p, q] = A[zero, q, p] = 0
                    changed |= active & (apq != 0)      # zeroed or rotated
                    h = aqq - app
                    theta = dt(0.5) * h / apq
                    t = dt(1) / (np.abs(theta) + np.sqrt(dt(1) + theta * theta))
                    t = np.where(theta < 0, -t, t)
                    t = np.where(np.abs(h) + g == np.abs(h), apq / h, t)
                    c = dt(1) / np.sqrt(dt(1) + t * t)
                    sn = t * c
                    tau = sn / (dt(1) + c)
                    r_ = rot
                    A[r_, p, p] = (app - t * apq)[r_]
                    A[r_, q, q] = (aqq + t * apq)[r_]
                    A[r_, p, q] = A[r_, q, p] = 0
                    for r in range(n):
                        if r in (p, q):
                            continue
                        arp, arq = A[:, r, p].copy(), A[:, r, q].copy()
                        A[r_, r, p] = A[r_, p, r] = (arp - sn * (arq + tau * arp))[r_]
                        A[r_, r, q] = A[r_, q, r] = (arq + sn * (arp - tau * arq))[r_]
                    for r in range(n):
                        vrp, vrq = V[:, r, p].copy(), V[:, r, q].copy()
                        V[r_, r, p] = (vrp - sn * (vrq + tau * vrp))[r_]
                        V[r_, r, q] = (vrq + sn * (vrp - tau * vrq))[r_]
            if early_exit:
                active &= changed
    d = np.diagonal(A, axis1=-2, axis2=-1)
    order = np.argsort(d, axis=-1, kind="stable")
    vals = np.take_along_axis(d, order, -1)
    vecs = np.take_along_axis(V, order[:, None, :], -1)
    return vals, vecs, ran


# ---- the 6x6 kernel's rounds ------------------------------------------------

def jacobi6(a, sweeps=eigsym.SWEEPS):
    """(vals ascending, sweeps run) of the symmetric (B, 6, 6) `a` by the
    6x6 kernel's parallel Jacobi: each round computes the rotations of its 3
    disjoint pairs from the same matrix (t from one division, c = 1 /
    sqrt(1 + t^2), s = t c; the negligible test on every sweep), then
    updates every lower-triangle element (i, j) at once from the elements
    at (i|pi(i), j|pi(j)) in c/s form; each matrix stops after a sweep in
    which no pivot rotated or was zeroed."""
    dt = a.dtype.type
    B, n = a.shape[0], 6
    L = np.tril(a)                                # only the lower triangle lives
    active = np.ones(B, bool)
    ran = np.zeros(B, np.int64)

    def el(M, i, j):
        return M[:, max(i, j), min(i, j)]

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(sweeps):
            ran += active
            changed = np.zeros(B, bool)
            for k, pairs in enumerate(round_robin(n)):
                cs, sn, delta = {}, {}, {}
                for q, p in pairs:
                    apq, app, aqq = L[:, q, p], L[:, p, p], L[:, q, q]
                    g = dt(100) * np.abs(apq)
                    zero = (np.abs(app) + g == np.abs(app)) & (np.abs(aqq) + g == np.abs(aqq))
                    rot = active & ~zero & (apq != 0)
                    changed |= active & (apq != 0)      # zeroed or rotated
                    h = aqq - app
                    t = dt(2) * apq * np.where(h < 0, dt(-1), dt(1)) / (
                        np.abs(h) + np.hypot(h, dt(2) * apq))
                    c = dt(1) / np.sqrt(dt(1) + t * t)
                    t, c = np.where(rot, t, dt(0)), np.where(rot, c, dt(1))
                    for x in (p, q):
                        cs[x], sn[x] = c, t * c
                    delta[(q, p)] = t * apq
                new = L.copy()
                for i in range(n):
                    for j in range(i + 1):
                        pi, pj = partner(k, i), partner(k, j)
                        if i == j:
                            d = delta[(max(i, pi), min(i, pi))]
                            new[:, i, i] = L[:, i, i] - d if i < pi else L[:, i, i] + d
                        elif pi == j:                 # the pivot: zeroed or rotated
                            new[:, i, j] = 0
                        else:
                            si = sn[i] if i > pi else -sn[i]
                            sj = sn[j] if j > pj else -sn[j]
                            x1 = cs[j] * el(L, i, j) + sj * el(L, i, pj)
                            x2 = cs[j] * el(L, pi, j) + sj * el(L, pi, pj)
                            new[:, i, j] = cs[i] * x1 + si * x2
                L = np.where(active[:, None, None], new, L)
            active &= changed
    return np.sort(np.diagonal(L, axis1=-2, axis2=-1), axis=-1), ran


# ---- matrices -----------------------------------------------------------------

def adversarial(n):
    """Repeated eigenvalues (2 I; a rank-1 plus 3 I), a diagonal matrix, a
    diagonal one off diagonal by 1e-30, an off-diagonal-only 1e-30 matrix, a
    graded matrix whose entries span 12 decades, an all-zero matrix."""
    rng = np.random.default_rng(11)
    u = rng.normal(size=n)
    d = np.diag(np.arange(1.0, n + 1.0))
    off = np.full((n, n), 1e-30) - np.diag(np.full(n, 1e-30))
    scale = np.diag(10.0 ** np.linspace(-3.0, 3.0, n))
    c = np.eye(n) + 0.3 * np.ones((n, n)) / n
    return {"2I": 2.0 * np.eye(n), "rank-1 + 3I": np.outer(u, u) + 3.0 * np.eye(n),
            "diagonal": d, "diagonal + 1e-30": d + off, "1e-30 off diagonal": off,
            "graded 12 decades": scale @ c @ scale, "zero": np.zeros((n, n))}


def random_spd(batch, n, decades, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    lam = 10.0 ** (decades * rng.random((batch, n)) - decades / 2)
    return q @ (lam[..., None] * np.swapaxes(q, -1, -2))


def site_matrices(seed=0):
    """Matrices shaped like the three call sites' inputs."""
    rng = np.random.default_rng(seed)
    # ground refit: weighted covariance of ground points (a plane, noisy)
    pts = np.concatenate([rng.uniform(-15, 15, (64, 200, 2)),
                          rng.normal(-1.7, 0.02, (64, 200, 1))], -1)
    cen = pts - pts.mean(-2, keepdims=True)
    ground = np.swapaxes(cen, -1, -2) @ cen / 200
    # fit_lines: 5 neighbours of an edge point (a line, or a blob, or one point)
    dirs = rng.normal(size=(1024, 1, 3))
    along = rng.uniform(-0.3, 0.3, (1024, 5, 1))
    nb = 20 * rng.normal(size=(1024, 1, 3)) + along * dirs + rng.normal(0, 0.01, (1024, 5, 3))
    nb[::7] = nb[::7, :1]                                   # coincident neighbours
    d = nb - nb.mean(-2, keepdims=True)
    lines = np.swapaxes(d, -1, -2) @ d / 5
    # solver: J^T J of point-to-plane rows [n, p x n], points 1-60 m out
    p = rng.normal(size=(64, 300, 3)) * rng.uniform(1, 60, (64, 300, 1))
    nrm = rng.normal(size=(64, 300, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    J = np.concatenate([nrm, np.cross(p, nrm)], -1)
    w = (rng.random((64, 300, 1)) < 0.8).astype(float)
    hess = np.swapaxes(J * w, -1, -2) @ (J * w)
    hess[0] = 0.0                                           # the first frame's
    return {"ground (3, 3)": ground, "fit_lines (Q, 3, 3)": lines, "solver (6, 6)": hess}


def _rel_err(vals, a):
    ref = torch.linalg.eigvalsh(torch.from_numpy(a)).numpy()
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1e-30)
    return float((np.abs(vals - ref) / scale).max())


# ---- the tests ----------------------------------------------------------------

def test_round_robin_visits_every_pair_once_a_sweep():
    rounds = round_robin(6)
    assert len(rounds) == 5 and all(len(r) == 3 for r in rounds)
    for k, r in enumerate(rounds):
        assert sorted(x for pair in r for x in pair) == list(range(6))   # disjoint
        assert all(partner(k, q) == p and partner(k, p) == q for q, p in r)
    assert sorted(pair for r in rounds for pair in r) == sorted(
        (q, p) for q in range(6) for p in range(q))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_jacobi3_exit_equals_fixed_sweeps_bit_for_bit(dtype):
    sets = [np.stack(list(adversarial(3).values())), random_spd(256, 3, 8.0, 1),
            site_matrices()["ground (3, 3)"], site_matrices()["fit_lines (Q, 3, 3)"]]
    a = np.concatenate(sets).astype(dtype)
    vals, vecs, ran = jacobi3(a)
    fvals, fvecs, fran = jacobi3(a, early_exit=False)
    assert (fran == eigsym.SWEEPS).all() and ran.max() < eigsym.SWEEPS
    assert vals.tobytes() == fvals.tobytes() and vecs.tobytes() == fvecs.tobytes()
    assert _rel_err(vals, a) <= VAL_TOL
    # the exit is per matrix: one matrix alone takes the bits it takes in the batch
    for k in (0, 5, len(a) - 1):
        one = jacobi3(a[k:k + 1])
        assert one[0].tobytes() == vals[k:k + 1].tobytes()
        assert one[1].tobytes() == vecs[k:k + 1].tobytes() and one[2][0] == ran[k]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_jacobi6_round_robin_within_the_bar(dtype):
    adv = adversarial(6)
    a = np.concatenate([np.stack(list(adv.values())), random_spd(128, 6, 12.0, 2),
                        site_matrices()["solver (6, 6)"]]).astype(dtype)
    vals, ran = jacobi6(a)
    assert np.isfinite(vals).all() and ran.max() < eigsym.SWEEPS
    assert _rel_err(vals, a) <= VAL_TOL
    assert (vals[list(adv).index("zero")] == 0).all()
    for k in (0, 9, len(a) - 1):
        one, r1 = jacobi6(a[k:k + 1])
        assert one.tobytes() == vals[k:k + 1].tobytes() and r1[0] == ran[k]


def test_sweeps_at_the_call_sites_within_the_cap():
    for site, a in site_matrices(seed=3).items():
        for dtype in DTYPES:
            x = a.astype(dtype)
            ran = jacobi6(x)[1] if x.shape[-1] == 6 else jacobi3(x)[2]
            hist = np.bincount(ran, minlength=eigsym.SWEEPS + 1)
            print(f"{site} {dtype.__name__} x{len(x)}: sweeps run "
                  f"{ {s: int(c) for s, c in enumerate(hist) if c} }")
            assert ran.max() < eigsym.SWEEPS
