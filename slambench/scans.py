"""The general scan generator that every traffic mix parameterizes.

A mix names a world and a trajectory of the port's synthetic renderer
(`io.synthetic`, by function name, with their keyword arguments) and a
number of frames.  Frame k is rendered at pose k with the sensor noise
`SensorNoise` of the mix ("default": `DEFAULT_NOISE`), drawn from a
generator seeded from (seed, k) alone: each seed is another recording of
the same drive, and any frame can be rendered again, alone, bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from intensity_slam_tpu_torch.io import synthetic
from intensity_slam_tpu_torch.utils.se3 import Pose

SCAN_PERIOD = 0.1


def frame_seed(seed: int, k: int) -> int:
    """A generator seed of (seed, frame index); any whole seed, however large."""
    return (int(seed) * 1_000_003 + int(k) * 7_919 + 17) % (2 ** 63 - 1)


class Drive:
    """The drive of a traffic mix on `device`: its poses, its world and its
    noise model."""

    def __init__(self, traffic: dict, device):
        self.device = torch.device(device)
        self.frames = int(traffic["frames"])
        tr = traffic["trajectory"]
        self.poses = getattr(synthetic, tr["name"])(self.frames, device=self.device,
                                                    **tr.get("args", {}))
        wd = traffic["world"]
        self.world = getattr(synthetic, wd["name"])(device=self.device, **wd.get("args", {}))
        noise = traffic.get("noise", "default")
        self.noise = (synthetic.DEFAULT_NOISE if noise == "default"
                      else None if noise is None else synthetic.SensorNoise(**noise))

    def pose(self, k: int) -> Pose:
        return Pose(self.poses.q[k], self.poses.t[k])

    def render(self, sensor, seed: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Frame k of the recording `seed`: (xyz (H*W, 3), intensity (H*W,))
        in the sensor frame, on the drive's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(frame_seed(seed, k))
        return synthetic.render_scan(self.pose(k), self.world, sensor,
                                     frame_time=k * SCAN_PERIOD, noise=self.noise,
                                     gen=gen)

    def positions(self) -> np.ndarray:
        """(F, 3) rendered positions relative to the first."""
        t = self.poses.t
        return (t - t[0]).cpu().numpy()
