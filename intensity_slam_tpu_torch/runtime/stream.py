"""StreamingRunner: the native streaming executor over a scan log.

PyTorch counterpart of `intensity_slam_tpu/runtime/stream.py`.  The
reference's process/thread architecture maps onto the host runtime so:

  reference                               here
  ---------------------------------------------------------------------
  TCPROS subscriber + spinner decode      C++ Prefetcher / WirePrefetcher
                                          thread (scanlog)
  ascanRegistration front-end (10 Hz)     caller thread: `fused.fused_step`
  loop/factor threads (100 Hz / 10 Hz)    the keyframe branch of fused_step
  mutex-guarded deques + frame drop       native Channel(drop_oldest) to
                                          the pose-writer thread
  blocking debug ofstream                 C++ async TrajectoryWriter

The dispatch thread (the caller's) uploads each frame and calls
`fused.fused_step`, exactly as `SlamSystem.process` does, and reads nothing
from the device of its own: the host syncs it makes are fused_step's.

- Uploads go through a ring of `depth` pinned host slots with
  `non_blocking` copies; a CUDA event recorded after each copy guards its
  slot, which is refilled only once that copy has finished.
- Each frame's position goes to the writer thread as a non-blocking copy
  into pinned host memory plus an event; the writer waits on that event
  and nothing else, so the device-to-host transfer stays off the dispatch
  thread.

With `wire_compress` a frame ships in the sensor's native form: the native
IO thread packs it into (N+1, 2) uint16 words (row 0: run-relative
milliseconds split hi/lo; rows 1..: range quantized to 120 m / 65535, and
intensity), 3 B per point instead of 16, and the step rebuilds
`xyz = range * dir` on the device from a per-log beam-direction table.
torch's uint16 is not a full CUDA dtype, so the words travel as int16 with
the same bits and are widened on the device.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import projection
from ..pipeline import fused
from .channel import Channel
from .scanlog import ScanLog
from .spill import LogSpiller, host_array
from .traj import TrajectoryWriter

_REC_DTYPE = np.dtype([
    ("slot", np.int64),
    ("timestamp", np.float64),
])
_END = np.array((-1, 0.0), _REC_DTYPE)

_WIRE_MAX_RANGE = 120.0   # m full-scale of the uint16 range quantization
_IDENT_Q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)


def _build_dir_lut(log: ScanLog, max_frames: int = 20) -> np.ndarray:
    """Per-pixel unit beam directions from the log's first frames (a
    spinning lidar's directions are fixed per (row, col); pixels invalid in
    one frame are filled from later ones)."""
    n = log.height * log.width
    dirs = np.zeros((n, 3), np.float32)
    have = np.zeros(n, bool)
    for k in range(min(max_frames, len(log))):
        fr = log[k]
        r = np.linalg.norm(fr.xyz, axis=-1)
        ok = (r > 0.1) & ~have
        dirs[ok] = fr.xyz[ok] / r[ok, None]
        have |= ok
        if have.all():
            break
    return dirs


def wire_decode(packed: torch.Tensor, dirs: torch.Tensor):
    """(N+1, 2) int16 wire words (uint16 bits) -> (xyz (N, 3), intensity
    (N,), run-relative timestamp ()), on the words' device, with the
    reference's float32 arithmetic."""
    w = packed.to(torch.int32) & 0xFFFF
    ts = (w[0, 0].float() * 65536.0 + w[0, 1].float()) * 1e-3
    rng = w[1:, 0].float() * (_WIRE_MAX_RANGE / 65535.0)
    xyz = rng[:, None] * dirs
    inten = w[1:, 1].float()
    return xyz, inten, ts


class _UploadRing:
    """`depth` pinned host slots for the per-frame upload.  Slot k % depth
    is refilled only after the event recorded behind its last copy has
    completed, so a frame is never overwritten while its copy is in
    flight.  On the CPU the (owned) host buffer is used as it is."""

    def __init__(self, depth: int, device: torch.device):
        self.device = device
        self.depth = max(1, depth)
        self.slots: list[torch.Tensor | None] = [None] * self.depth
        self.done: list[torch.cuda.Event | None] = [None] * self.depth
        self.k = 0
        self.waits = 0          # refills that found their slot's copy in flight

    def __call__(self, buf: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(buf.view(np.int16) if buf.dtype == np.uint16 else buf)
        if self.device.type != "cuda":
            return host
        s = self.k % self.depth
        self.k += 1
        if self.done[s] is not None and not self.done[s].query():
            self.waits += 1
            self.done[s].synchronize()
        if self.slots[s] is None or self.slots[s].shape != host.shape:
            self.slots[s] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        self.slots[s].copy_(host)
        dev = self.slots[s].to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.done[s] = ev
        return dev


def _ground_u_at(ground_u, j: int, idx: int, device):
    """The RANSAC draws for the j-th frame of this run (log index idx):
    `ground_u` is None, an (F, K, 3) array indexed by j, or a callable of
    the log index."""
    if ground_u is None:
        return None
    u = ground_u(idx) if callable(ground_u) else ground_u[j]
    return torch.as_tensor(u, dtype=torch.float32, device=device)


class StreamingRunner:
    def __init__(self, cfg: SlamConfig, traj_path: str | None = None,
                 queue_capacity: int = 64, drop_policy: bool = True,
                 wire_compress: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mask = projection.detection_mask(cfg.sensor, device=self.device)
        self.state = fused.init_state(cfg, device=self.device)
        self._wire = wire_compress
        self._dirs = None         # device (N, 3) direction LUT (wire mode)
        self._cap = queue_capacity
        self._chan = Channel(queue_capacity, _REC_DTYPE)
        self._drop = drop_policy
        self._slots: dict[int, tuple] = {}
        self._slots_mu = threading.Lock()
        self._dropped_writes = 0
        # unbounded corrected-trajectory export: segments stream to the
        # host before the device ring wraps (see runtime.spill)
        self._spiller = LogSpiller(cfg)
        self._traj_path = traj_path
        self._traj: TrajectoryWriter | None = None
        self.num_frames = 0
        self.upload_waits = 0     # the last run's waits for an upload slot

    def reset(self) -> None:
        """Fresh SLAM state (keyframe store, maps, log, spiller) while
        keeping the direction LUT, so that successive passes start from
        equivalent state."""
        self.state = fused.init_state(self.cfg, device=self.device)
        self._spiller = LogSpiller(self.cfg)
        self.num_frames = 0

    def _step(self, buf: torch.Tensor, ground_u) -> fused.FrameInfo:
        if self._wire:
            xyz, inten, ts = wire_decode(buf, self._dirs)
        else:
            xyz, inten, ts = buf[1:, :3], buf[1:, 3], buf[0, 0]
        self.state, info = fused.fused_step(
            self.state, xyz, inten, ts, self.mask, self.cfg, ground_u=ground_u)
        return info

    # ---- pose-writer stream (async device->host readback + file IO) -------
    def _writer_loop(self) -> None:
        while True:
            rec = self._chan.pop(timeout_ms=-1)
            if rec is None or int(rec["slot"]) < 0:
                return
            slot = int(rec["slot"])
            with self._slots_mu:
                entry = self._slots.pop(slot, None)
            if entry is None:   # pruned by the dispatch thread (see run())
                continue
            t_host, done = entry
            if done is not None:
                done.synchronize()      # this frame's copy, on this thread
            self._traj.append(float(rec["timestamp"]), t_host.numpy(), _IDENT_Q)

    def _record_pose(self, idx: int, abs_ts: float, info) -> None:
        """Hand this frame's position to the async writer stream."""
        if not self._traj:
            return
        # live TUM stream carries positions (orientation is in the
        # corrected export, write_corrected_trajectory)
        if self.device.type == "cuda":
            t_host = torch.empty(3, dtype=torch.float32, pin_memory=True)
            t_host.copy_(info.pose_t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            t_host, done = info.pose_t, None
        with self._slots_mu:
            self._slots[idx] = (t_host, done)
        rec = np.array((idx, abs_ts), _REC_DTYPE)
        if not self._chan.push(rec, drop_oldest=self._drop):
            self._dropped_writes += 1
            with self._slots_mu:
                self._slots.pop(idx, None)
        elif self._drop:
            # drop_oldest may have evicted a record INSIDE the channel; its
            # slot entry would otherwise pin its host buffer forever.  Frame
            # indices are monotonic, so anything older than the channel
            # capacity is either consumed or dropped: prune it.  2x slack
            # keeps the prune clear of a record the writer popped from the
            # channel but hasn't claimed from _slots yet.
            floor = idx - 2 * self._cap
            with self._slots_mu:
                for k in [k for k in self._slots if k < floor]:
                    self._slots.pop(k, None)

    def _open_writer(self):
        # a closed channel/writer cannot be reopened: each run starts with
        # fresh ones (the previous run's close() is its end-of-stream marker)
        self._chan.destroy()
        self._chan = Channel(self._cap, _REC_DTYPE)
        self._traj = (TrajectoryWriter(self._traj_path)
                      if self._traj_path else None)
        self._dropped_writes = 0
        if not self._traj:
            return None
        th = threading.Thread(target=self._writer_loop, name="islam-traj-writer")
        th.start()
        return th

    def _close_writer(self, th) -> None:
        if self._traj:
            self._chan.push(_END, drop_oldest=True)
            th.join()
            self._traj.close()
        self._chan.close()
        with self._slots_mu:        # entries of records the channel dropped
            self._slots.clear()

    def _drive(self, frames, ground_u, on_frame) -> None:
        """The dispatch loop over (log index, absolute time, device buffer)."""
        writer_th = self._open_writer()
        try:
            for j, (idx, abs_ts, buf) in enumerate(frames):
                info = self._step(buf, _ground_u_at(ground_u, j, idx, self.device))
                self.num_frames += 1
                self._spiller.maybe_spill(self.state, self.num_frames)
                self._record_pose(idx, abs_ts, info)
                if on_frame is not None:
                    on_frame(idx, info)
        finally:
            self._close_writer(writer_th)

    def _ensure_dirs(self, log: ScanLog) -> None:
        """Upload the direction table once, from pinned memory without a
        host wait (the caching host allocator keeps the pinned block until
        the copy has run)."""
        if self._dirs is None:
            lut = torch.from_numpy(_build_dir_lut(log))
            if self.device.type == "cuda":
                lut = lut.pin_memory()
            self._dirs = lut.to(self.device, non_blocking=True)

    # ---- dispatch stream ---------------------------------------------------
    def run(self, log: ScanLog, start: int = 0, end: int | None = None,
            depth: int = 4,
            on_frame: Callable[[int, fused.FrameInfo], None] | None = None,
            ground_u=None) -> dict:
        """Stream frames [start, end) of `log` through the fused step.
        `ground_u` (tests): the ground RANSAC's draws per frame, an (F, K, 3)
        array over this run's frames or a callable of the log index."""
        upload = _UploadRing(depth, self.device)
        if self._wire:
            self._ensure_dirs(log)
            # the 65k-point norm/quantize/pack per frame runs on the NATIVE
            # IO thread (WirePrefetcher); the dispatch thread does one copy
            # into a pinned slot and one upload.  Timestamps on the device
            # are run-relative (epoch-safe).
            frames = ((wf.index, wf.timestamp, upload(wf.packed))
                      for wf in log.stream_wire(start, end, depth, _WIRE_MAX_RANGE))
        else:
            def float_frames():
                base = None
                for fr in log.stream(start, end, depth):
                    n = fr.xyz.shape[0]
                    if base is None:
                        base = fr.timestamp  # run-relative: float32 on the
                        # device cannot hold epoch seconds
                    buf = np.empty((n + 1, 4), np.float32)
                    buf[0] = (fr.timestamp - base, 0.0, 0.0, 0.0)
                    buf[1:, :3] = fr.xyz
                    buf[1:, 3] = fr.intensity
                    yield fr.index, fr.timestamp, upload(buf)

            frames = float_frames()
        self._drive(frames, ground_u, on_frame)
        self.upload_waits = upload.waits
        return self._stats()

    def run_preloaded(self, log: ScanLog, start: int = 0,
                      end: int | None = None,
                      on_frame: Callable[[int, fused.FrameInfo], None] | None
                      = None, ground_u=None) -> dict:
        """Transport-independent replay: pre-pack and upload every frame to
        the device once, then drive the same wire step and pose-writer
        machinery with per-frame inputs sliced from the device-resident log.
        `run()` minus `run_preloaded()` is the transport's cost."""
        if not self._wire:
            raise ValueError("run_preloaded requires wire_compress=True")
        end = len(log) if end is None else min(end, len(log))
        self._ensure_dirs(log)
        packed, stamps, indices = [], [], []
        for wf in log.stream_wire(start, end, 4, _WIRE_MAX_RANGE):
            packed.append(wf.packed)
            stamps.append(wf.timestamp)
            indices.append(wf.index)
        dev_log = torch.from_numpy(np.stack(packed).view(np.int16)).to(self.device)
        del packed
        frames = ((idx, ts, dev_log[j]) for j, (idx, ts) in enumerate(zip(indices, stamps)))
        self._drive(frames, ground_u, on_frame)
        return self._stats()

    def _stats(self) -> dict:
        backend = self.state.backend
        return {
            "frames": self.num_frames,
            "keyframes": int(backend.num_kf),
            "skips": int(self.state.log.num_skips),
            "loops": int(backend.graph.num_loops),
            "dropped_pose_writes": self._chan.dropped + self._dropped_writes,
        }

    # ---- corrected trajectory export (updatePoses semantics) ---------------
    def _traj_fn(self, st):
        return fused.trajectory(st, self.cfg)

    def trajectory(self) -> np.ndarray:
        """(N, 3) PGO-corrected positions for the FULL session: spilled
        segments (corrected as of spill time) + the live ring window
        (corrected now).  Unbounded in session length."""
        _, t = self._spiller.full_trajectory(
            self.state, self.num_frames, self._traj_fn)
        return t

    def write_corrected_trajectory(self, path: str, timestamps=None) -> None:
        """Write the PGO-corrected trajectory as TUM (the reference's
        `updatePoses`-rewritten keypose export, `intensity_feature_tracker
        .cpp:110-145,555-582`; the live TUM stream is pre-PGO).  Covers the
        FULL session: frames older than the device ring come from the host
        spill segments."""
        q, t = self._spiller.full_trajectory(
            self.state, self.num_frames, self._traj_fn)
        with TrajectoryWriter(path) as w:
            for i in range(t.shape[0]):
                ts = float(timestamps[i]) if timestamps is not None else i * 0.1
                w.append(ts, t[i], q[i])

    @property
    def loops(self) -> list[tuple[int, int]]:
        g = self.state.backend.graph
        valid = host_array(g.loop_valid)
        li, lj = host_array(g.loop_i), host_array(g.loop_j)
        return [(int(a), int(b)) for a, b, v in zip(li, lj, valid) if v]
