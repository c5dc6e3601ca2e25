"""The 3x3 SVD kernel (`ops/svd3.py`, `csrc/svd3.cu`) that takes the place of
`torch.linalg.svd` in the ICP's Umeyama step, against its plain version
(`svd3_plain`: `torch.linalg.svd` and the reference's reflection rule).

- On the CPU (no card): a numpy model of the kernel's arithmetic, in
  float32 and float64 (scaling, one-sided Jacobi sweeps with their skips, the descending sort,
  u2 = u0 x u1, v2 = v0 x v1) against the plain version on the matrices the
  kernel must get right: random, rank 2 (a planar overlap), reflected
  (det < 0), repeated singular values, rank 1, all zero.  Rotations are
  compared, not U and V, whose signs are free; where the rotation is not
  unique (rank 1, and a reflection across a repeated smallest value) only
  that the result is a rotation and refactors the input.
- On the card (`-m cuda`): the kernel against the plain version on the same
  sets in float32 and float64, `U diag(S) Vt` against the input, repeat
  equality bit for bit, and the kernel captured in a CUDA graph.

No JAX: `svd3_plain` is the ICP's reference arithmetic, held to the JAX ICP
by tests/test_torch_icp.py."""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch.ops import svd3

ROT_TOL = {np.float32: 2e-5, np.float64: 1e-10}     # |R - R_plain|, entrywise
FACTOR_TOL = {np.float32: 3e-6, np.float64: 1e-12}  # |U S Vt - A|, relative to max |A|


def _rotation(theta, axis):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def matrix_sets(seed: int = 0) -> dict:
    """name -> ((n, 3, 3) float64 matrices, whether the rotation is unique)."""
    rng = np.random.default_rng(seed)

    def orth(n):
        q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        return q * np.sign(np.linalg.det(q))[:, None, None]        # det +1

    def build(sv, flip=False):
        n = sv.shape[0]
        U, V = orth(n), orth(n)
        if flip:
            U[:, :, 2] *= -1                                        # det(U V^T) = -1
        return np.einsum("nij,nj,nkj->nik", U, sv, V)

    n = 64
    sets = {
        "random": (rng.normal(size=(n, 3, 3)) * 10.0 ** rng.uniform(-3, 2, (n, 1, 1)), True),
        "rank2": (build(np.stack([rng.uniform(1, 5, n), rng.uniform(0.1, 1, n),
                                  np.zeros(n)], 1)), True),
        "reflected": (build(np.stack([rng.uniform(2, 5, n), rng.uniform(1, 2, n),
                                      rng.uniform(0.01, 0.5, n)], 1), flip=True), True),
        "repeated": (build(np.stack([np.full(n, 2.0), np.ones(n), np.ones(n)], 1)), True),
        "repeated_top": (build(np.stack([np.full(n, 3.0), np.full(n, 3.0),
                                         rng.uniform(0.1, 1, n)], 1)), True),
        "rank1": (build(np.stack([rng.uniform(1, 5, n), np.zeros(n), np.zeros(n)], 1)),
                  False),
        "zero": (np.zeros((4, 3, 3)), True),
        "planar_cov": (_planar_covariances(rng, n), True),
    }
    return sets


def _planar_covariances(rng, n):
    """Umeyama covariances of points on a plane (rank 2), as the ICP of a
    flat overlap builds them."""
    out = []
    for _ in range(n):
        p = np.concatenate([rng.uniform(-5, 5, (200, 2)), np.zeros((200, 1))], 1)
        R = _rotation(rng.uniform(0, 0.5), rng.normal(size=3))
        q = p @ R.T + rng.normal(size=3)
        out.append((q - q.mean(0)).T @ (p - p.mean(0)) / 200)
    return np.stack(out)


def svd3_model(a: np.ndarray, sweeps: int = svd3.SWEEPS):
    """The kernel's arithmetic on one 3x3 matrix, in the dtype of `a`."""
    T = a.dtype.type
    eps = np.finfo(a.dtype).eps
    mx = np.max(np.abs(a))
    inv = T(1) / mx if mx > 0 else T(1)
    b = [a[:, j] * inv for j in range(3)]
    v = [np.eye(3, dtype=a.dtype)[:, j].copy() for j in range(3)]
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):   # zeta * zeta may overflow: t = 0
            alpha, beta, gamma = b[p] @ b[p], b[q] @ b[q], b[p] @ b[q]
            if not abs(gamma) > eps * np.sqrt(alpha * beta):
                continue
            zeta = (beta - alpha) / (T(2) * gamma)
            t = (T(-1) if zeta < 0 else T(1)) / (abs(zeta) + np.sqrt(T(1) + zeta * zeta))
            c = T(1) / np.sqrt(T(1) + t * t)
            s = c * t
            b[p], b[q] = c * b[p] - s * b[q], s * b[p] + c * b[q]
            v[p], v[q] = c * v[p] - s * v[q], s * v[p] + c * v[q]
    sv = [np.sqrt(x @ x) for x in b]
    for p, q in ((0, 1), (1, 2), (0, 1)):
        if sv[p] < sv[q]:
            sv[p], sv[q], b[p], b[q], v[p], v[q] = sv[q], sv[p], b[q], b[p], v[q], v[p]
    tiny = T(1e-20)
    u0 = b[0] / sv[0] if sv[0] > tiny else np.array([1, 0, 0], a.dtype)
    rest = b[1] - (u0 @ b[1]) * u0
    if not np.sqrt(rest @ rest) > tiny:
        k = int(np.argmin(np.abs(u0)))
        rest = np.eye(3, dtype=a.dtype)[k] - u0[k] * u0
    u1 = rest / np.sqrt(rest @ rest)
    U = np.stack([u0, u1, np.cross(u0, u1)], 1)
    V = np.stack([v[0], v[1], np.cross(v[0], v[1])], 1)
    S = np.array([sv[0] * mx, sv[1] * mx, U[:, 2] @ (a @ V[:, 2])], a.dtype)
    return U, S, V.T


def _plain_rotations(a: torch.Tensor) -> torch.Tensor:
    U, _, Vt = svd3.svd3_plain(a)
    return U @ Vt


def _check(name, a, U, S, Vt, R_plain, unique, dtype):
    R = U @ Vt
    assert np.all(np.isfinite(R)), name
    eye = np.broadcast_to(np.eye(3), R.shape)
    assert np.abs(R @ np.swapaxes(R, -1, -2) - eye).max() < 10 * ROT_TOL[dtype], name
    assert np.abs(np.linalg.det(R.astype(np.float64)) - 1).max() < 10 * ROT_TOL[dtype], name
    scale = np.maximum(np.abs(a).reshape(len(a), -1).max(1), 1e-30)[:, None, None]
    refac = np.einsum("nij,nj,njk->nik", U, S, Vt)
    assert (np.abs(refac - a) / scale).max() < 10 * FACTOR_TOL[dtype], name
    if unique:
        err = np.abs(R - R_plain).max()
        assert err < ROT_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(matrix_sets()))
def test_model_rotation_equals_plain(name, dtype):
    a, unique = matrix_sets()[name]
    a = a.astype(dtype)
    with np.errstate(over="ignore"):
        outs = [svd3_model(m) for m in a]
    U, S, Vt = (np.stack(x) for x in zip(*outs))
    R_plain = _plain_rotations(torch.from_numpy(a)).numpy()
    _check(name, a, U, S, Vt, R_plain, unique, dtype)
    if name == "zero":
        assert np.array_equal(U @ Vt, np.broadcast_to(np.eye(3, dtype=dtype), U.shape))


def test_plain_matches_the_umeyama_rule():
    """The plain version's rotation is the reference's U D Vt bit for bit,
    on one matrix as the ICP calls it."""
    for m in torch.from_numpy(matrix_sets()["reflected"][0].astype(np.float32)):
        U, _, Vt = torch.linalg.svd(m)
        d = torch.sign(torch.linalg.det(U @ Vt))
        assert float(d) == -1.0
        R = U @ torch.diag(torch.cat([torch.ones(2), d[None]])) @ Vt
        assert torch.equal(_plain_rotations(m), R)


# ---- on the card ------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the SVD kernel runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_cuda_kernel_against_plain(dtype):
    _need_card()
    for name, (a, unique) in matrix_sets().items():
        a = a.astype(dtype)
        x = torch.from_numpy(a).cuda()
        U, S, Vt = (t.cpu().numpy() for t in svd3.svd3(x))
        _check(name, a, U, S, Vt, _plain_rotations(x).cpu().numpy(), unique, dtype)
        again = svd3.svd3(x)
        assert all(torch.equal(t.cpu(), torch.from_numpy(o)) for t, o in zip(again, (U, S, Vt)))


@pytest.mark.cuda
def test_cuda_kernel_in_a_graph():
    _need_card()
    a, _ = matrix_sets()["random"]
    x = torch.from_numpy(a.astype(np.float32)).cuda()
    eager = svd3.svd3(x)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = svd3.svd3(x)
    b = torch.from_numpy(matrix_sets(1)["random"][0].astype(np.float32)).cuda()
    x.copy_(b)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(t, e) for t, e in zip(out, svd3.svd3(b)))
    assert not all(torch.equal(t, e) for t, e in zip(out, eager))
