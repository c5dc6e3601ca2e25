"""SlamSystem: the host-side object that runs the fused per-frame step.

PyTorch counterpart of `intensity_slam_tpu/pipeline/system.py`.  The
reference runs its back-end as threads inside `ascanRegistration`
(factor-graph thread at 100 Hz, loop thread at 10 Hz,
`scanRegistration.cpp:734-735`) communicating through mutex-guarded deques.
Here `pipeline.fused` runs the front-end every frame and the whole back-end
on keyframes, appending everything the host might want to a device-resident
log.  This class is a thin wrapper:

- `process` runs one fused step per frame and returns the device FrameInfo
  WITHOUT reading it.  Read any field if you want to wait for the frame.
- trajectory/loops/keyframe accessors fetch device state on demand,
  typically once, at the end of a sequence.

Trajectory export follows `updatePoses` semantics
(`intensity_feature_tracker.cpp:110-145`): keyframe poses come from the
optimized graph; intermediate frames are corrected rigidly with their
governing keyframe's era->PGO correction (`fused.trajectory`).

Not ported yet, and raising `NotImplementedError` until they are: `refine`
and `cfg.parallel.refine_every_kf > 0` (they need the distributed back-end,
`parallel/dist_backend`), `save` and `load` (they need `utils/checkpoint`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import projection
from ..runtime.spill import LogSpiller, host_array
from . import fused


class SlamSystem:
    def __init__(self, cfg: SlamConfig, seed: int = 0, device="cuda"):
        if cfg.parallel.refine_every_kf > 0:
            raise NotImplementedError(
                "parallel.refine_every_kf > 0 needs parallel/dist_backend, "
                "which the PyTorch port does not have yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mask = projection.detection_mask(cfg.sensor, device=self.device)
        self.state = fused.init_state(cfg, seed, device=self.device)
        self._frames = 0
        # unbounded trajectory export: raw segments spill to the host before
        # the device ring wraps (runtime.spill.LogSpiller)
        self._spiller = LogSpiller(cfg)

    # ---- hot path ----------------------------------------------------------
    def process(self, xyz, inten, timestamp, ground_u=None) -> fused.FrameInfo:
        """Run one frame.  Returns device scalars and reads none of them."""
        xyz = torch.as_tensor(xyz, device=self.device)
        inten = torch.as_tensor(inten, device=self.device)
        self.state, info = fused.fused_step(
            self.state, xyz, inten, timestamp, self.mask, self.cfg,
            ground_u=ground_u)
        self._frames += 1
        self._spiller.maybe_spill(self.state, self._frames)
        return info

    # ---- distributed refinement -------------------------------------------
    def refine(self) -> None:
        raise NotImplementedError(
            "SlamSystem.refine needs parallel/dist_backend, which the "
            "PyTorch port does not have yet (fused.adopt_graph, its feedback "
            "half, is ported)")

    # ---- state accessors (each fetch waits; use after the hot loop) --------
    @property
    def bstate(self):
        return self.state.backend

    @property
    def num_keyframes(self) -> int:
        return int(self.state.backend.num_kf)

    @property
    def num_skips(self) -> int:
        return int(self.state.log.num_skips)

    @property
    def kf_map_pose(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Raw (era-frame) map pose per keyframe."""
        n = self.num_keyframes
        q = host_array(self.state.backend.kf_raw.q[:n])
        t = host_array(self.state.backend.kf_raw.t[:n])
        return [(q[i], t[i]) for i in range(n)]

    @property
    def loops(self) -> list[tuple[int, int, float]]:
        """Accepted loop edges as (cur_kf, loop_kf, icp_fitness)."""
        g = self.state.backend.graph
        n = int(g.num_loops)
        L = g.loop_valid.shape[0]
        out = []
        order = range(n) if n <= L else range(n - L, n)
        li, lj = host_array(g.loop_i), host_array(g.loop_j)
        si, valid = host_array(g.loop_sqrt_info), host_array(g.loop_valid)
        for e in order:
            s = e % L
            if not valid[s]:
                continue
            fit = float(1.0 / max(si[s, 0], 1e-12) ** 2)
            out.append((int(li[s]), int(lj[s]), fit))
        return out

    def _log_rows(self) -> int:
        return min(int(self.state.log.count), self.cfg.log_capacity)

    @property
    def frame_poses(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Era-frame pose per frame from the device log (pre-export)."""
        n = self._log_rows()
        q = host_array(self.state.log.q[:n])
        t = host_array(self.state.log.t[:n])
        return [(q[i], t[i]) for i in range(n)]

    def trajectory(self) -> np.ndarray:
        """(N, 3) PGO-corrected positions (updatePoses semantics) for the
        FULL run: host-spilled segments + live ring window, unbounded in
        length even though the device ring is fixed."""
        _, t = self._spiller.full_trajectory(
            self.state, self._frames,
            lambda st: fused.trajectory(st, self.cfg))
        return t

    def odom_trajectory(self) -> np.ndarray:
        """(T, 3) merged-odometry positions (pre-mapping, pre-PGO): the
        per-stage drift diagnostic."""
        return host_array(self.state.log.ot[:self._log_rows()])

    # ---- checkpoint/resume -------------------------------------------------
    def save(self, prefix: str) -> None:
        raise NotImplementedError(
            "SlamSystem.save needs utils/checkpoint, which the PyTorch port "
            "does not have yet")

    def load(self, prefix: str) -> None:
        raise NotImplementedError(
            "SlamSystem.load needs utils/checkpoint, which the PyTorch port "
            "does not have yet")
