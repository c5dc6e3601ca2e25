"""LogSpiller: unbounded trajectory export over a bounded device ring.

The port's own copy of `intensity_slam_tpu/runtime/spill.py`, with tensors
in place of `jax.Array`.  The device FrameLog holds `cfg.log_capacity`
frames; the reference's keyframe/pose deques are unbounded
(`intensity_feature_tracker.h:242-248`).  Before a ring slot is overwritten,
the spiller exports the oldest resident chunk RAW (era-frame pose +
governing keyframe id + compaction generation, `fused.export_window`) and
hands the device tensors to a background thread, which waits for the
device-to-host copy OFF the dispatch thread.

At export, `full_trajectory` applies the FINAL graph's per-keyframe
era->PGO corrections to every spilled frame (updatePoses semantics,
`intensity_feature_tracker.cpp:110-145`): loops accepted AFTER a segment
spilled still rewrite it; keyframe ids are remapped across store decimations
by their generation delta (id //= 2 per decimation).

Device cost: one small gather per `chunk` frames.  Host cost: a (chunk, 7)
float copy on the spill thread.  The dispatch thread never waits.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ..config import SlamConfig
from ..pipeline import fused


def _quat_compose(cq: np.ndarray, ct: np.ndarray,
                  q: np.ndarray, t: np.ndarray):
    """Batched host-side pose compose: (corr) o (raw) for (N, 4/3) arrays
    (wxyz quaternions); the export-time correction runs off the device."""
    w1, x1, y1, z1 = cq[:, 0], cq[:, 1], cq[:, 2], cq[:, 3]
    w2, x2, y2, z2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    oq = np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)
    # rotate t by cq: t' = t + 2 w (u x t) + 2 u x (u x t), u = cq[1:]
    u = cq[:, 1:]
    uxt = np.cross(u, t)
    rt = t + 2.0 * cq[:, :1] * uxt + 2.0 * np.cross(u, uxt)
    return oq, rt + ct


def host_array(x) -> np.ndarray:
    """A device tensor as a numpy array (waits for the tensor)."""
    return x.detach().cpu().numpy()


class LogSpiller:
    def __init__(self, cfg: SlamConfig, chunk: int | None = None):
        cap = cfg.log_capacity
        self.chunk = int(chunk) if chunk else max(1, cap // 4)
        if cap < 2 * self.chunk:
            raise ValueError(
                f"log_capacity {cap} must be >= 2x spill chunk {self.chunk}")
        self.cfg = cfg
        # (q_raw, t_raw, kf_id, compaction_gen) per chunk
        self.segments: list[tuple] = []
        self.spilled = 0          # frames exported to host so far
        self._q: queue.Queue = queue.Queue()
        self._th: threading.Thread | None = None

    # ---- background drain --------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            q_dev, t_dev, kf_dev, gen_dev = item
            # waits until the export has run; off the dispatch thread
            self.segments.append((host_array(q_dev), host_array(t_dev), host_array(kf_dev),
                                  int(host_array(gen_dev))))

    def start(self) -> None:
        if self._th is None or not self._th.is_alive():
            self._th = threading.Thread(target=self._drain_loop,
                                        name="islam-log-spiller", daemon=True)
            self._th.start()

    def stop(self) -> None:
        if self._th is not None and self._th.is_alive():
            self._q.put(None)
            self._th.join()
            self._th = None

    # ---- dispatch-side hook ------------------------------------------------
    def maybe_spill(self, state: fused.FusedState, num_frames: int) -> None:
        """Call after each frame with the post-step state and the total
        frames processed.  Exports chunks that would otherwise be
        overwritten within the next `chunk` frames.  Stream order guarantees
        the export reads the ring before later steps write over it (and a
        step never writes into its input's tensors anyway)."""
        cap = self.cfg.log_capacity
        while num_frames - self.spilled >= cap - self.chunk:
            handles = fused.export_window(state, self.spilled, self.chunk,
                                          self.cfg)
            self.start()
            self._q.put(handles)
            self.spilled += self.chunk

    # ---- combined export ---------------------------------------------------
    def full_trajectory(self, state: fused.FusedState, num_frames: int,
                        traj_fn) -> tuple[np.ndarray, np.ndarray]:
        """(N, 4), (N, 3) for ALL N frames of the run: spilled segments
        and the live ring window, BOTH corrected by the final graph.
        `traj_fn(state) -> (q, t, n)` is `fused.trajectory`."""
        self.stop()  # join pending copies; restartable via start()
        q, t, n = traj_fn(state)
        n = int(n)
        live_q = host_array(q)[:n]
        live_t = host_array(t)[:n]
        # final per-keyframe corrections + current compaction generation
        corr = fused.keyframe_corrections(state.backend)
        corr_q, corr_t = host_array(corr.q), host_array(corr.t)
        gen_now = int(state.log.compactions)
        K = corr_q.shape[0]
        parts_q, parts_t = [], []
        for sq, st_, kf, gen in self.segments:
            kf_now = np.where(kf >= 0, kf >> max(gen_now - gen, 0), -1)
            kfc = np.clip(kf_now, 0, K - 1)
            oq, ot = _quat_compose(corr_q[kfc], corr_t[kfc], sq, st_)
            have = (kf_now >= 0)[:, None]
            parts_q.append(np.where(have, oq, sq))
            parts_t.append(np.where(have, ot, st_))
        S = self.spilled
        # live window covers [num_frames - n, num_frames); drop the part
        # already spilled
        skip = S - (num_frames - n)
        out_q = np.concatenate(parts_q + [live_q[skip:]])
        out_t = np.concatenate(parts_t + [live_t[skip:]])
        # segments spilled by a previous process are gone after a checkpoint
        # restore (host state): the export then covers the retained suffix
        have = sum(s[1].shape[0] for s in self.segments)
        assert out_t.shape[0] == num_frames - (S - have), (
            f"spill accounting: {out_t.shape[0]} != "
            f"{num_frames} - ({S} - {have})")
        return out_q, out_t

    def resync(self, num_frames: int) -> None:
        """Re-align counters to a restored device state whose host-side
        segments are unavailable (checkpoint restore into a new process):
        marks everything not resident in the ring as already spilled so no
        stale export is attempted."""
        cap = self.cfg.log_capacity
        self.segments.clear()
        self.spilled = max(0, num_frames - (cap - self.chunk))
        self.spilled -= self.spilled % self.chunk
