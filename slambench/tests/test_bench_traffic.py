"""The scan generator: the same seed gives the same scans, another seed
another recording of the same drive."""

import pytest
import torch

from intensity_slam_tpu_torch import config as pconfig
from slambench import scans, spec

SENSOR = pconfig.small_test_config().sensor
MIXES = sorted(spec.load_benchmark() and
               {w["traffic"] for w in spec.load_benchmark()["workloads"]})


def _mix(name):
    cell = next(w for w in spec.load_benchmark()["workloads"] if w["traffic"] == name)
    return spec.Cell(spec.load_benchmark(), cell["name"]).traffic


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_per_seed(name):
    mix = dict(_mix(name), frames=3)
    drive = scans.Drive(mix, "cpu")
    for k in (0, 2):
        a = drive.render(SENSOR, 2 ** 31 + 7, k)
        b = scans.Drive(mix, "cpu").render(SENSOR, 2 ** 31 + 7, k)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        c = drive.render(SENSOR, 2 ** 31 + 8, k)
        assert not torch.equal(a[0], c[0])
        assert torch.equal(drive.pose(k).t, scans.Drive(mix, "cpu").pose(k).t)


def test_large_seeds():
    assert 0 <= scans.frame_seed(2 ** 33 + 5, 719) < 2 ** 63
    assert scans.frame_seed(1, 0) != scans.frame_seed(1, 1) != scans.frame_seed(2, 1)
