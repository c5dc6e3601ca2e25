"""The CUDA nearest-neighbour kernel (`intensity_slam_tpu_torch/csrc/nn.cu`)
against its plain PyTorch version, on the card: indices and distances must be
identical (the kernel is built with --fmad=false and sums in the plain
version's order).  Marked `cuda`: a CUDA kernel has no CPU mode, so these
skip where there is no card.  This file imports no JAX, so it also runs on
the card's machine:

    python -m pytest --noconftest tests/test_torch_nn_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from intensity_slam_tpu_torch.ops import pallas_nn

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
    else:  # ties: every target three times, queries on half-integers
        base = rng.randint(-4, 5, size=(500, 3))
        tgt = np.concatenate([base, base, base])
        src = rng.randint(-4, 5, size=(300, 3)) + 0.5
        mask = rng.rand(1500) < 0.8
    return (torch.from_numpy(np.asarray(src, np.float32)),
            torch.from_numpy(np.asarray(tgt, np.float32)), torch.from_numpy(mask))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["multi_tile", "unpadded", "all_masked", "ties"])
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    src, tgt, mask = (t.cuda() for t in _case(name))
    before = pallas_nn.nearest_neighbor.launches
    ki, kd = pallas_nn.nearest_neighbor(src, tgt, mask)
    assert pallas_nn.nearest_neighbor.launches == before + 1
    pi, pd = pallas_nn.nearest_neighbor_plain(src, tgt, mask)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kd, pd)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src, tgt, mask = _case("unpadded")
    with pytest.raises(ValueError):
        pallas_nn.nearest_neighbor(src.cuda(), tgt, mask.cuda())
