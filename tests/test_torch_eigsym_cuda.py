"""The Jacobi eigensolver kernels (`intensity_slam_tpu_torch/csrc/eigsym.cu`)
against their plain PyTorch version (`torch.linalg.eigh` / `eigvalsh`), on
the card: eigenvalues within 1e-5 of the largest |eigenvalue|, eigenvectors
(3x3) with |dot| >= 1 - 1e-4 where the eigengap is above 1e-3 of it, in
float32 and float64, on random SPD sets and on adversarial ones (repeated
eigenvalues, diagonal, off diagonal by 1e-30, graded over 12 decades, zero:
zeros out); a matrix's bits the same alone and at three places in a batch
of others (1024; 8192 for the 3x3, packed 8 a warp; 8 for the 6x6: the
batched sessions' solve) and over ten launches; both kernels captured into
a CUDA graph and replayed, bit-equal to eager, each replay one launch of
`jacobi_kernel` in its trace.  Marked `cuda`: a CUDA
kernel has no CPU mode, so these skip where there is no card.  This file
imports no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_eigsym_cuda.py -m cuda -q

The CPU tests at the end hold the wrappers' CPU route (the plain version)
and their refusals.
"""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch.ops import eigsym
from kernel_trace import launched
from test_torch_eigsym_model import adversarial

torch.set_num_threads(1)


def _spd(batch, n, decades, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    lam = 10.0 ** (decades * rng.random((batch, n)) - decades / 2)
    a = q @ (lam[..., None] * np.swapaxes(q, -1, -2))
    # repeated eigenvalues and a zero matrix at the end of the batch
    a[-2] = np.eye(n) * 2.0
    a[-1] = 0.0
    return torch.from_numpy(a)


def _check(a, vectors):
    if vectors:
        (w, v), (pw, pv) = eigsym.eigh(a), eigsym.eigh_plain(a)
    else:
        w, pw = eigsym.eigvalsh(a), eigsym.eigvalsh_plain(a)
    torch.cuda.synchronize()
    scale = torch.clamp(pw.abs().amax(-1, keepdim=True), min=1e-30)
    assert float(((w - pw).abs() / scale).max()) <= 1e-5
    assert bool((w[..., 1:] >= w[..., :-1]).all())          # ascending
    if vectors:
        gap = (pw[..., :, None] - pw[..., None, :]).abs() + torch.eye(
            pw.shape[-1], device=pw.device, dtype=pw.dtype) * 1e30
        clear = gap.amin(-1) > 1e-3 * scale
        dots = (v * pv).sum(-2).abs()
        assert float(torch.where(clear, 1.0 - dots, 0.0).max()) <= 1e-4
        # orthonormal columns whatever the gaps
        eye = torch.eye(3, device=v.device, dtype=v.dtype)
        assert float((v.transpose(-1, -2) @ v - eye).abs().max()) <= 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("shape,vectors", [((3,), True), ((2048,), True),
                                           ((1,), False), ((64,), False)])
def test_cuda_kernel_matches_plain(shape, vectors, dtype):
    _need_card()
    n = 3 if vectors else 6
    a = _spd(max(shape[0], 2), n, 8.0 if vectors else 12.0)[:shape[0]]
    _check(a.to(dtype).cuda(), vectors)
    if shape == (1,):
        _check(a[0].to(dtype).cuda(), vectors)           # one unbatched matrix


@pytest.mark.cuda
def test_cuda_kernel_replays_from_a_graph():
    _need_card()
    a = _spd(256, 3, 8.0).float().cuda()
    eigsym.eigh(a)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        w, v = eigsym.eigh(a)
    assert launched(g.replay, ["jacobi_kernel"]) == {"jacobi_kernel": 1}
    a.copy_(_spd(256, 3, 8.0, seed=1).float().cuda())
    g.replay()
    torch.cuda.synchronize()
    pw, _ = eigsym.eigh_plain(a)
    assert float((w - pw).abs().max() / pw.abs().max()) <= 1e-5


def _run(a, vectors):
    return eigsym.eigh(a) if vectors else (eigsym.eigvalsh(a), None)


def _bits(t):
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _same_bits(x, y):
    return torch.equal(_bits(x[0]), _bits(y[0])) and (
        x[1] is None or torch.equal(_bits(x[1]), _bits(y[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("vectors", [True, False], ids=["3x3_vectors", "6x6_values"])
def test_cuda_kernel_adversarial_sets(vectors, dtype):
    _need_card()
    n = 3 if vectors else 6
    sets = adversarial(n)
    a = torch.from_numpy(np.stack(list(sets.values()))).to(dtype).cuda()
    w, v = _run(a, vectors)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(w).all()) and (v is None or bool(torch.isfinite(v).all()))
    assert bool((w[list(sets).index("zero")] == 0).all())
    # the plain version in float64 on the CPU: the card's may give NaN for zero
    pw, pv = torch.linalg.eigh(a.double().cpu())
    pw, pv = pw.to(a), pv.to(a)
    scale = torch.clamp(pw.abs().amax(-1, keepdim=True), min=1e-30)
    assert float(((w - pw).abs() / scale).max()) <= 1e-5
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    if vectors:
        gap = (pw[..., :, None] - pw[..., None, :]).abs() + torch.eye(
            n, device=pw.device, dtype=pw.dtype) * 1e30
        clear = gap.amin(-1) > 1e-3 * scale
        dots = (v * pv).sum(-2).abs()
        assert float(torch.where(clear, 1.0 - dots, 0.0).max()) <= 1e-4
        eye = torch.eye(3, device=v.device, dtype=v.dtype)
        assert float((v.transpose(-1, -2) @ v - eye).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("vectors,batch", [(True, 1024), (True, 8192), (False, 1024),
                                           (False, 8)],
                         ids=["3x3_1024", "3x3_8192", "6x6_1024", "6x6_8"])
def test_cuda_kernel_batch_invariant_and_repeatable(vectors, batch, dtype):
    _need_card()
    n = 3 if vectors else 6
    others = _spd(batch, n, 8.0, seed=3).to(dtype).cuda()
    one = _spd(3, n, 8.0, seed=4)[:1].to(dtype).cuda()     # a random one
    alone = _run(one, vectors)
    for pos in (0, batch // 2, batch):
        got = _run(torch.cat([others[:pos], one, others[pos:]]), vectors)
        assert _same_bits((got[0][pos:pos + 1], None if got[1] is None
                           else got[1][pos:pos + 1]), alone), pos
    first = _run(others, vectors)
    for _ in range(10):
        assert _same_bits(_run(others, vectors), first)


@pytest.mark.cuda
@pytest.mark.parametrize("vectors", [True, False], ids=["3x3_vectors", "6x6_values"])
def test_cuda_kernels_replay_bit_equal_to_eager(vectors):
    _need_card()
    n = 3 if vectors else 6
    a = _spd(256, n, 8.0).float().cuda()
    _run(a, vectors)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = _run(a, vectors)
    assert launched(g.replay, ["jacobi_kernel"]) == {"jacobi_kernel": 1}
    a.copy_(_spd(256, n, 8.0, seed=1).float().cuda())
    g.replay()
    torch.cuda.synchronize()
    assert _same_bits(out, _run(a, vectors))


def test_cpu_tensors_take_the_plain_version():
    a = _spd(16, 3, 4.0)
    w, v = eigsym.eigh(a)
    pw, pv = torch.linalg.eigh(a)
    assert torch.equal(w, pw) and torch.equal(v, pv)
    assert torch.equal(eigsym.eigvalsh(_spd(4, 6, 4.0)),
                       torch.linalg.eigvalsh(_spd(4, 6, 4.0)))


def test_kernel_route_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="shape"):
        eigsym._launch(torch.zeros(4, 4, 4), vectors=False)
    with pytest.raises(ValueError, match="shape"):
        eigsym._launch(torch.zeros(2, 6, 6), vectors=True)
    with pytest.raises(TypeError, match="float16"):
        eigsym._launch(torch.zeros(2, 3, 3, dtype=torch.float16), vectors=True)
    with pytest.raises(ValueError, match="cpu"):
        eigsym._launch(torch.zeros(2, 3, 3), vectors=True)
