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
- `refine` hands the live BackendState to the distributed back-end
  (`parallel.dist_backend.refine`, over `mesh`, a
  `parallel.multiproc.Mesh`, when given) and adopts the refined poses
  through the path a loop closure takes (`fused.adopt_graph`).  With
  `cfg.parallel.refine_every_kf > 0`, `process` triggers it every N
  keyframes; the keyframe count is read every 32 frames and nowhere else.

Trajectory export follows `updatePoses` semantics
(`intensity_feature_tracker.cpp:110-145`): keyframe poses come from the
optimized graph; intermediate frames are corrected rigidly with their
governing keyframe's era->PGO correction (`fused.trajectory`).

`save`/`load` checkpoint the whole fused state in the JAX package's format
(`utils.checkpoint`), so either package resumes the other's session.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import projection
from ..parallel import dist_backend
from ..runtime.spill import LogSpiller, host_array
from ..utils import checkpoint, se3
from . import fused


class SlamSystem:
    def __init__(self, cfg: SlamConfig, seed: int = 0, device="cuda", mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.mask = projection.detection_mask(cfg.sensor, device=self.device)
        self.state = fused.init_state(cfg, seed, device=self.device)
        self._frames = 0
        self._last_refine_kf = 0
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
        every = self.cfg.parallel.refine_every_kf
        if every > 0 and self._frames % 32 == 0:
            n_kf = int(info.num_kf)          # one scalar read per 32 frames
            if n_kf - self._last_refine_kf >= every:
                self.refine()
                self._last_refine_kf = n_kf
        return info

    # ---- distributed refinement -------------------------------------------
    def refine(self) -> None:
        """Run the global PGO + BA refinement on the live keyframe store
        (the store sharded over `mesh` when there is one) and feed the
        refined poses back."""
        bstate = self.state.backend
        if self.mesh is not None:
            bstate = dist_backend.shard_backend_state(bstate, self.mesh)
        res = dist_backend.refine(bstate, self.cfg, mesh=self.mesh)
        poses = res.state.graph.poses
        self.state = fused.adopt_graph(
            self.state, se3.pose_map(lambda a: a.to(self.device), poses), self.cfg)

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
        """Checkpoint the full fused state for crash-resume / multi-session
        mapping (`prefix + ".fused.npz"`)."""
        checkpoint.save(prefix + ".fused.npz", self.state)

    def load(self, prefix: str) -> None:
        """Restore a checkpoint written by either package's `save` onto this
        system's device.  A JAX checkpoint carries no generator state (its
        `rng` key is left behind), so the generator keeps its own."""
        self.state = checkpoint.restore(prefix + ".fused.npz", self.state)
        # re-align host counters with the restored device log; segments
        # spilled by the previous process are host state and are gone: the
        # export covers the ring-resident suffix until new spills
        self._frames = int(self.state.log.count)
        self._spiller.resync(self._frames)
