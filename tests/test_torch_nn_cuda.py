"""The CUDA nearest-neighbour kernels (`intensity_slam_tpu_torch/csrc/nn.cu`)
against their plain PyTorch versions, on the card: packs, indices and
distances must be identical (every operation in the kernel rounds to nearest
on its own, and sums run in the plain version's order), and the unpacked
entry launches `pack_kernel` and `nn_packed_kernel` once each.  Marked `cuda`: a
CUDA kernel has no CPU mode, so these skip where there is no card.  This file
imports no JAX, so it also runs on the card's machine:

    python -m pytest --noconftest tests/test_torch_nn_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch.ops import pallas_nn
from kernel_trace import launched

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)


def _case(name):
    rng = np.random.RandomState(3)
    if name == "multi_tile":
        src = rng.randn(600, 3) * 5
        tgt = rng.randn(2048, 3) * 5
        mask = rng.rand(2048) < 0.9
    elif name == "unpadded":
        src = rng.randn(37, 3)
        tgt = rng.randn(513, 3)
        mask = np.ones(513, bool)
    elif name == "all_masked":
        src = np.zeros((8, 3))
        tgt = np.zeros((16, 3))
        mask = np.zeros(16, bool)
    elif name == "cross_slice_tie":
        # one point repeated through the whole cloud: every target slice of
        # every block holds an exact minimum, and index 1 (the first valid
        # copy) has to win the merge across warps and across blocks
        tgt = np.tile(np.array([[1.0, 2.0, 3.0]]), (4096, 1))
        src = rng.randn(300, 3)
        mask = np.ones(4096, bool)
        mask[0] = False
    else:  # ties: every target three times, queries on half-integers
        base = rng.randint(-4, 5, size=(500, 3))
        tgt = np.concatenate([base, base, base])
        src = rng.randint(-4, 5, size=(300, 3)) + 0.5
        mask = rng.rand(1500) < 0.8
    return (torch.from_numpy(np.asarray(src, np.float32)),
            torch.from_numpy(np.asarray(tgt, np.float32)), torch.from_numpy(mask))


CASES = ["multi_tile", "unpadded", "all_masked", "ties", "cross_slice_tie"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    src, tgt, mask = (t.cuda() for t in _case(name))
    ki, kd = pallas_nn.nearest_neighbor(src, tgt, mask)
    names = ["pack_kernel", "nn_packed_kernel"]
    assert launched(lambda: pallas_nn.nearest_neighbor(src, tgt, mask), names) == {
        "pack_kernel": 1, "nn_packed_kernel": 1}
    pi, pd = pallas_nn.nearest_neighbor_plain(src, tgt, mask)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)
    if name == "cross_slice_tie":
        assert bool((ki == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_packed_path_matches_plain(name):
    """Pack once, search twice on fresh sources: the pack equals the plain
    pack bit for bit, each search equals the plain packed search."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    src, tgt, mask = (t.cuda() for t in _case(name))
    packed = pallas_nn.pack_targets(tgt, mask)
    plain = pallas_nn.pack_targets_plain(tgt, mask)
    torch.cuda.synchronize()
    assert torch.equal(packed.count, plain.count)
    assert torch.equal(packed.data.view(torch.int32), plain.data.view(torch.int32))
    for s in (src, (src + 0.25).contiguous()):
        ki, kd = pallas_nn.nearest_neighbor_packed(s, packed)
        pi, pd = pallas_nn.nearest_neighbor_packed_plain(s, plain)
        ui, ud = pallas_nn.nearest_neighbor_plain(s, tgt, mask)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kd, pd)
        assert torch.equal(ki, ui) and torch.equal(kd, ud)


@pytest.mark.cuda
def test_cuda_argmin_takes_first_minimum():
    """`torch.argmin` on the card must take the first of equal minima, as
    `jnp.argmin` does: the dense correspondence searches of the geometric
    fallback rest on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = torch.full((64, 8192), 5.0, device="cuda")
    d[:, 4097::3] = 1.0
    assert bool((torch.argmin(d, dim=1) == 4097).all())
    assert bool((torch.argmax(-d, dim=1) == 4097).all())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src, tgt, mask = _case("unpadded")
    with pytest.raises(ValueError):
        pallas_nn.nearest_neighbor(src.cuda(), tgt, mask.cuda())
