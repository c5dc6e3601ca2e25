"""The nearest-neighbour port: the plain PyTorch version (what a CPU tensor
runs) vs the JAX package's Pallas kernel in interpret mode, as
tests/test_pallas_nn.py runs it; plus the wrapper's dispatch contract.
Indices are compared exactly (ties go to the lowest target index on both
sides); distances at rtol 1e-6, since XLA's CPU backend may fuse the
squared-difference sum into FMAs.  The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_nn_cuda.py and by
chip_smoke.py.

The port searches a PACKED target cloud (valid targets only, ascending index
order): `pack_targets` + the packed plain search must equal the unpacked
brute force `nearest_neighbor_plain` exactly, indices and distance bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intensity_slam_tpu.ops import pallas_nn as J
from intensity_slam_tpu_torch.ops import pallas_nn as T

# small CPU tensors: one intra-op thread avoids oversubscribing the cores
# that the parallel test workers share
torch.set_num_threads(1)


def _case(name):
    rng = np.random.RandomState({"multi_tile": 0, "unpadded": 1, "ties": 5}.get(name, 2))
    if name == "multi_tile":
        src = rng.randn(600, 3).astype(np.float32) * 5
        tgt = rng.randn(2048, 3).astype(np.float32) * 5
        mask = rng.rand(2048) < 0.9
    elif name == "unpadded":
        src = rng.randn(37, 3).astype(np.float32)
        tgt = rng.randn(513, 3).astype(np.float32)
        mask = np.ones(513, bool)
    elif name == "all_masked":
        src = np.zeros((8, 3), np.float32)
        tgt = np.zeros((16, 3), np.float32)
        mask = np.zeros(16, bool)
    else:  # ties: duplicated targets on a coarse grid, queries on the grid
        base = rng.randint(-4, 5, size=(500, 3)).astype(np.float32)
        tgt = np.concatenate([base, base, base])          # every point 3x
        src = rng.randint(-4, 5, size=(300, 3)).astype(np.float32) + 0.5
        mask = rng.rand(1500) < 0.8
    return src, tgt, mask


@pytest.mark.parametrize("name", ["multi_tile", "unpadded", "all_masked", "ties"])
def test_plain_matches_pallas_interpret(name):
    src, tgt, mask = _case(name)
    ji, jd = J.nearest_neighbor(jnp.asarray(src), jnp.asarray(tgt),
                                jnp.asarray(mask))
    ti, td = T.nearest_neighbor(torch.from_numpy(src), torch.from_numpy(tgt),
                                torch.from_numpy(mask))
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-6)
    if name == "all_masked":
        assert (td.numpy() >= 1e29).all() and (ti.numpy() == 0).all()


def test_wrapper_checks_inputs():
    src = torch.zeros(4, 3)
    tgt = torch.zeros(5, 3)
    mask = torch.ones(5, dtype=torch.bool)
    with pytest.raises(TypeError):
        T.nearest_neighbor(src.double(), tgt, mask)
    with pytest.raises(ValueError):
        T.nearest_neighbor(src[:, :2], tgt, mask)
    with pytest.raises(TypeError):
        T.nearest_neighbor(src, tgt, mask.float())
    with pytest.raises(ValueError):
        T.nearest_neighbor(src, tgt.t().contiguous().t(), mask)
    with pytest.raises(ValueError):
        T.nearest_neighbor(src.to("meta"), tgt.to("meta"), mask.to("meta"))


@pytest.mark.parametrize("name", ["multi_tile", "unpadded", "all_masked", "ties"])
def test_packed_search_equals_unpacked_plain(name):
    """Ties (every target three times), all targets masked and a ragged P:
    the packed route gives the unpacked brute force's indices and distance
    bits; the pack holds the valid targets in ascending index order."""
    src, tgt, mask = (torch.from_numpy(a) for a in _case(name))
    packed = T.pack_targets(tgt, mask)
    n = int(mask.sum())
    assert packed.data.shape == (tgt.shape[0], 4) and int(packed.count[0]) == n
    orig = packed.data[:, 3].view(torch.int32)
    np.testing.assert_array_equal(orig[:n].numpy(), np.nonzero(mask.numpy())[0])
    assert torch.equal(packed.data[:n, :3], tgt[mask])
    assert not packed.data[n:].view(torch.int32).any()
    pi, pd = T.nearest_neighbor_packed(src, packed)
    ui, ud = T.nearest_neighbor_plain(src, tgt, mask)
    assert pi.dtype == torch.int32 and pd.dtype == torch.float32
    assert torch.equal(pi, ui)
    assert torch.equal(pd.view(torch.int32), ud.view(torch.int32))


def test_packed_wrapper_checks_inputs():
    src = torch.zeros(4, 3)
    packed = T.pack_targets(torch.zeros(5, 3), torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError):
        T.nearest_neighbor_packed(src, packed._replace(data=packed.data[:, :3]))
    with pytest.raises(TypeError):
        T.nearest_neighbor_packed(src, packed._replace(count=packed.count.long()))
    with pytest.raises(ValueError):
        T.nearest_neighbor_packed(src.to("meta"), T.PackedTargets(
            packed.data.to("meta"), packed.count.to("meta")))
