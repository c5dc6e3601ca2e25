"""Per-frame steps replayed from CUDA graphs over a state they update in
place: the counterparts of the JAX package's compiled per-frame programs.

PyTorch runs eagerly, and a step is thousands of small kernels whose
launches, not their work, set its time; a CUDA graph launches a captured
sequence of them in one call.  Three owners share the capture and replay
bookkeeping (`Segments`) and the state helpers (`pack_info`, `warm_up`;
`donate` and `clone_state`, from `utils.tree`):

- `FrameGraph` (here): one session's `fused_step`, the counterpart of
  `jax.jit(fused_step, donate_argnums=(0,))` (`pipeline/system.py`,
  `runtime/stream.py` of the JAX package);
- `BatchedStepGraph` (here): B sessions' `slam.slam_step_batched`, the
  counterpart of `jax.jit(jax.vmap(slam_step), donate_argnums=(0,))`
  (`tools/scaling_multisession.py` of the JAX package);
- `geometric_slam.GeoStepGraph`: the A-LOAM step, the counterpart of the
  jitted step that the reference's `run_sequence` replays under `lax.scan`.

The JAX program's decisions stay on the device, as conditional (If) nodes
(`utils.graph_cond.when`): every solve's early exit (a node an iteration,
`solver.solve_pose`), the capacity policy (`mapping.evict_policy`) and,
here, the fallback and the whole keyframe branch with the conds inside it.
`FrameGraph`'s frame, keyframe or not, is ONE graph:

    front     `slam.front`: undistortion, projection, intensity odometry,
              curvature features, the stacked flags
    if skip & has_prev:
      fallback  `slam.fallback`: the geometric solve
    back      `slam.back`: mux, geometric update, ground, scan-to-map,
              velocity EMA
    if is_keyframe:
      keyframe  `fused.keyframe_branch` (`loop.keyframe_core`), written into
                the state buffers and the `BackendOutput` buffers:
        if the store is full:     compact  `loop._compact_small`
        if a candidate is found:  verify   submap, ICP, gates, and the PCM
                                           vote's growth steps (a node each,
                                           on "the last step added a loop")
          if the loop is accepted:  accept  the loop edge and the dense PGO,
            at the bucket of the graph's nodes:  pgo.<size>  (`posegraph.optimize`)
        if the loop is accepted:  rebuild  the maps at the optimized poses
    log       `fused.append_log`: the ring-log append and the packed
              `FrameInfo`, every frame

then the flags (skip, has_prev, is_keyframe, a candidate found, the loop
accepted, the store compacted, the pose graph's node count, whose bucket
is the one the PGO ran at) come to the host, the frame's one read: it
decides nothing but `last_flags` and `FrameInfo`'s unpacking, as the
counterpart of `jax.jit(fused_step, donate_argnums=(0,))`.  The read also
brings the device stamps of the frame's regions (`utils.spans`: `frame`,
`front`, `back`, `mapping` inside it and `mapping.solve` inside that,
`log`, and each If region above),
written into the same buffer.
`BatchedStepGraph`'s step is one graph of `front`, the fallback region when
any session's flags say `skip & has_prev` (solved on all B and kept where
they say so, `slam._fallback_batched`) and `back`, then the (3, B) flags
read.

- **Static buffers.** The frame's inputs (`xyz`, `inten`, the timestamp as
  a 0-d tensor, the RANSAC draws `ground_u`) and the whole state live in
  buffers that the graph reads at fixed addresses; what a region hands on
  (the fallback's delta, the keyframe branch's `BackendOutput`, pre-filled
  with the no-keyframe values; inside the branch, `graph_cond.cond`'s
  copies) is a buffer made before it.
- **Donation.** Each segment ends by copying the state it made into the
  state buffers (`donate`), so the state is updated in place, as JAX's
  donated buffers are (the keyframe's payload row is written in place,
  `loop.write_slot_`); `adopt(state)` copies a state made outside the
  graphs (a loaded checkpoint's, a refine's) into them.  A caller that
  keeps `state` across a frame sees it change: `snapshot()` clones it.
- **Capture.** The graph is captured lazily, after a frame has run every
  part of it eagerly (the warm-up, whose result is the frame's real one):
  each owner after its first step.  A region that no step has taken yet
  runs once eagerly first and its result is dropped (`warm_up`): the
  fallback, and in `FrameGraph` the keyframe branch with its compact,
  verify, accept and rebuild regions forced (`graph_cond.forcing`), which
  is where a process pays its first ICP, PCM and PGO set-up (cuSOLVER and
  cuBLAS handles, lazy module loading, `torch.func`): `warmup_s` records
  those seconds by region, `capture_s` the capture's, `replays` the
  replays.  The warm-up runs once a process, device, configuration and
  thread (`warmups`): a later owner with the same ones only captures.
- **Draws.** The RANSAC uniforms are drawn from the state's generator (each
  session's, in a batch) outside the graphs, into the `ground_u` buffer:
  the eager step's draws.
- **Outputs.** A graph's outputs are overwritten by its next replay, so
  the step's outputs are packed into one byte tensor inside the graph and
  cloned once after it; the returned `FrameInfo` (`SlamOutput`,
  `GeoSlamOutput`) holds views of that clone and stays valid.
- **Spans.**  `FrameGraph.step` records its host phases (`graph.inputs`,
  `graph.launch`, `graph.read`, `graph.unpack`) and its device regions
  into `utils.spans.recorder`, in the frame that `begin_frame` opened (the
  streaming runner opens it before the upload, and stamps its device start
  with `start_frame` right before the upload's copy to the card);
  `BatchedStepGraph` and `GeoStepGraph` are not stamped.
- **On the CPU** the same segments run eagerly in the same order with the
  same in-place copies, each region's test read on the host.  On the card
  nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from ..config import SlamConfig
from ..ops import projection
from ..utils import graph_cond, spans
from ..utils.tree import clone_state, donate, generators, leaves, map_leaves
from ..utils.se3 import Pose
from . import fused, loop, posegraph, slam


def pack_info(info) -> tuple[torch.Tensor, tuple]:
    """The tensors of the output tree `info` as one uint8 tensor (wider
    types first, so that every one is aligned to its own size) and their
    layout: the tree with each tensor replaced by its place in leaf order,
    and (byte offset, dtype, shape) of each tensor."""
    ts = list(leaves(info))
    slots = iter(range(len(ts)))
    skeleton = map_leaves(info, lambda x: next(slots) if isinstance(x, torch.Tensor) else x)
    order = sorted(range(len(ts)), key=lambda i: -ts[i].element_size())
    parts, where, off = [], {}, 0
    for i in order:
        t = ts[i]
        parts.append(t.reshape(-1).view(torch.uint8))
        where[i] = (off, t.dtype, tuple(t.shape))
        off += t.numel() * t.element_size()
    return torch.cat(parts), (skeleton, tuple(where[i] for i in range(len(ts))))


def unpack_info(raw: torch.Tensor, layout: tuple):
    """The output tree `pack_info` packed, its tensors views of the packed
    bytes `raw`."""
    skeleton, fields = layout
    views = []
    for off, dtype, shape in fields:
        n = torch.Size(shape).numel() * dtype.itemsize
        views.append(raw[off:off + n].view(dtype).reshape(shape))
    return map_leaves(skeleton, lambda x: views[x] if isinstance(x, int) else x)


def warm_up(fn, state) -> None:
    """Run `fn()` once eagerly and drop its result: what a region that no
    step has taken yet needs before it is captured (its index constants
    made, its solver's first use done), as every other part of a graph runs
    eagerly before its capture.  Raises if `fn` drew from a generator of
    `state` or wrote one of its tensors."""
    gens = list(generators(state))
    rng = [g.get_state() for g in gens]
    versions = [t._version for t in leaves(state)]
    fn()
    if (not all(torch.equal(g.get_state(), r) for g, r in zip(gens, rng))
            or versions != [t._version for t in leaves(state)]):
        raise RuntimeError("a warm-up drew random numbers or wrote the state")


class Segments:
    """The capture and replay bookkeeping of one graph owner: its graphs
    (each captured after what it records ran eagerly once, sharing one
    memory pool), their outputs, `capture_s` and `replays` by graph."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.outs: dict = {}
        self.pool = None
        self.capture_s: dict[str, float] = {}
        self.replays: collections.Counter = collections.Counter()

    def capture(self, name: str, fn) -> None:
        """Capture `fn()` into graph `name` and keep its output."""
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with graph_cond.capture(g, self.pool):
            self.outs[name] = fn()
        torch.cuda.synchronize(self.device)
        self.graphs[name] = g
        self.capture_s[name] = time.perf_counter() - t0

    def replay(self, name: str):
        """Replay graph `name`; returns its output."""
        self.graphs[name].replay()
        self.replays[name] += 1
        return self.outs[name]

    def run(self, name: str, fn):
        """Replay graph `name`; without one, run `fn()` eagerly and (on the
        card) capture it after."""
        if name in self.graphs:
            return self.replay(name)
        out = fn()
        if self.on_card:
            self.capture(name, fn)
        return out


# the frame graph's warm-ups run in this process, by (device, configuration,
# thread): each one's seconds by region.  What a warm-up sets up is the
# process's (library handles, which are the thread's, lazy module loading,
# `torch.func`, the cached constants of these shapes), so a later owner with
# the same key captures its graph without running the regions again.
warmups: dict[tuple, dict[str, float]] = {}


class FrameGraph:
    """One session's frames through the captured graph (see the module
    docstring).  `state` is the `FusedState` of buffers, read at any time;
    `step` runs a frame and returns its `FrameInfo`."""

    # the flags of the frame's one host read, before its device stamps: the
    # last is the pose graph's node count after the frame
    FLAGS = ("skip", "has_prev", "is_keyframe", "sc_found", "loop_found", "compacted",
             "num_nodes")

    # the frame graph's conditional regions that `last_flags` reports,
    # besides the PGO's buckets
    REGIONS = ("fallback", "keyframe", "compact", "verify", "accept", "rebuild")
    # the keyframe branch's regions, run once eagerly before the capture
    KEYFRAME_REGIONS = ("compact", "verify", "accept", "rebuild")

    def __init__(self, cfg: SlamConfig, device="cuda", seed: int = 0,
                 state: fused.FusedState | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mask = projection.detection_mask(cfg.sensor, device=self.device)
        st = fused.init_state(cfg, seed, device=self.device) if state is None else state
        # every buffer its own memory (an initial state may share a tensor
        # between fields)
        self.state = clone_state(st)
        n = cfg.sensor.num_points
        f32 = dict(dtype=torch.float32, device=self.device)
        self._xyz = torch.zeros((n, 3), **f32)
        self._inten = torch.zeros((n,), **f32)
        self._ts = torch.zeros((), **f32)
        self._ground_u = torch.zeros((cfg.ground.ransac_iters, 3), **f32)
        self._fb = Pose.identity(device=self.device)      # the fallback's delta
        self._ident = Pose.identity(device=self.device)
        self._no_kf = fused.no_keyframe_output(self.device)
        self._bout = clone_state(self._no_kf)      # the keyframe region's output
        self.segments = Segments(self.device)
        # the PGO's bucket regions (none where it has one bucket)
        self._pgo_regions = posegraph.regions(cfg.loop.max_keyframes)
        self._layout: tuple | None = None      # pack_info's
        self._raw: torch.Tensor | None = None  # the frame's packed FrameInfo
        # the frame's host read: the flags, then the regions' device stamps
        self._read = torch.zeros(len(self.FLAGS) + spans.SLOTS, dtype=torch.int64,
                                 device=self.device)
        self._stamps = self._read[len(self.FLAGS):]
        self._started = False       # the open frame's start is stamped
        self._fallback_ran = False
        self.capture_s = self.segments.capture_s        # by graph
        # by region, before the capture (empty where an earlier owner's
        # warm-up served: `warmups`)
        self.warmup_s: dict[str, float] = {}
        self.replays = self.segments.replays
        self.last_output: slam.SlamOutput | None = None   # the last frame's
        # `slam.back` output (a graph's tensors: valid until the next frame)
        self.last_flags: dict[str, bool] = {}   # the last frame's flags read
        self.calibrate()

    # ---- spans -------------------------------------------------------------
    def begin_frame(self, index: int | None = None) -> bool:
        """Open this thread's frame in the span recorder (`index`: its log
        index), unless a frame is open; returns whether it opened one."""
        if not spans.recorder.begin_frame(index):
            return False
        self._started = False
        return True

    def start_frame(self) -> None:
        """Stamp the open frame's device start, once a frame: enqueued
        right before its first device work."""
        if not self._started:
            spans.stamp(self._stamps, 0)
            self._started = True

    def calibrate(self) -> dict | None:
        """Map this device's stamps onto the host clock anew
        (`spans.Recorder.calibrate`; nothing on the CPU)."""
        return spans.recorder.calibrate(self.device)

    # ---- state -----------------------------------------------------------
    def adopt(self, state: fused.FusedState) -> None:
        """Copy a state made outside the graphs into the buffers; its
        generator becomes the state's."""
        donate(self.state, state)
        self.state = self.state._replace(
            slam=self.state.slam._replace(gen=state.slam.gen))

    def snapshot(self) -> fused.FusedState:
        """A copy of the state that the next frame does not change."""
        return clone_state(self.state)

    # ---- the segments (the same functions eagerly and under capture) -----
    def _front(self) -> slam.FrontOutput:
        s = self.state.slam
        fr = slam.front(s, self._xyz, self._inten, self._ts, self.mask, self.cfg)
        donate(s.odo, fr.odo)
        donate(self._fb, self._ident)
        return fr._replace(odo=s.odo)

    def _fallback(self, fr: slam.FrontOutput) -> None:
        self._fallback_ran = True
        donate(self._fb, slam.fallback(self.state.slam, fr, self.cfg))

    def _back(self, fr: slam.FrontOutput) -> slam.SlamOutput:
        s = self.state.slam
        new, out = slam.back(s, fr, self._fb, self._ground_u, None, self.cfg)
        donate(s, new)
        return out

    def _keyframe_branch(self, fr: slam.FrontOutput, out: slam.SlamOutput,
                         era_qual: torch.Tensor):
        st = self.state
        return fused.keyframe_branch(st.backend, st.slam, out, fr.xyz, self._inten,
                                     self._ts, era_qual, self.cfg)

    def _keyframe(self, fr: slam.FrontOutput, out: slam.SlamOutput,
                  era_qual: torch.Tensor) -> None:
        """The keyframe branch, written into the state buffers (its payload
        row in place) and the `BackendOutput` buffers."""
        sstate, small, slot, bout = self._keyframe_branch(fr, out, era_qual)
        st = self.state
        donate(st.slam, sstate)
        loop.write_slot_(st.backend, small, slot)
        donate(self._bout, bout)

    def _log(self, out: slam.SlamOutput, iq: torch.Tensor) -> None:
        st = self.state
        log, info = fused.append_log(st.log, out, self._bout, st.backend.num_kf, iq, self.cfg)
        donate(st.log, log)
        raw, self._layout = pack_info(info)
        if self._raw is None:
            self._raw = raw         # eagerly, before any capture: the buffer
        else:
            self._raw.copy_(raw)

    def _frame(self) -> tuple[slam.FrontOutput, slam.SlamOutput, torch.Tensor]:
        """The whole frame: `front`, the fallback region, `back`, the
        keyframe region, the log append, each between its device stamps;
        and the buffer the host reads, the flags and the stamps."""
        with spans.recorder.stamping(self._stamps):
            with spans.region("front"):
                fr = self._front()
            skip, has_prev, is_kf = fr.flags.unbind()
            with graph_cond.when(skip & has_prev, "fallback") as taken:
                if taken:
                    self._fallback(fr)
            with spans.region("back"):
                out = self._back(fr)
            iq, era_qual = fused.frame_quality(self.state.log, out, self.cfg)
            donate(self._bout, self._no_kf)
            with graph_cond.when(is_kf, "keyframe") as taken:
                if taken:
                    self._keyframe(fr, out, era_qual)
            with spans.region("log"):
                self._log(out, iq)
            spans.mark("frame", True)
        b = self._bout
        flags = torch.stack([skip, has_prev, is_kf, b.sc_found, b.loop_found, b.compacted])
        n = len(self.FLAGS) - 1
        self._read[:n].copy_(flags)
        self._read[n].copy_(self.state.backend.graph.num_nodes)
        return fr, out, self._read

    def _warm_up(self, fr: slam.FrontOutput, out: slam.SlamOutput) -> None:
        """Run once eagerly what the capture records and no frame has run:
        the fallback, if no frame took it, and the keyframe branch with its
        regions forced (`graph_cond.forcing`, each timed into `warmup_s`),
        both on the live state, which they leave untouched: among them
        every bucket of the PGO (`posegraph.regions`), so that each size's
        solver workspaces exist before the capture."""
        cfg = self.cfg
        if not self._fallback_ran:
            t0 = time.perf_counter()
            warm_up(lambda: slam.fallback(self.state.slam, fr, cfg), self.state)
            self.warmup_s["fallback"] = time.perf_counter() - t0
        _, era_qual = fused.frame_quality(self.state.log, out, cfg)
        forced = self.KEYFRAME_REGIONS + self._pgo_regions
        with graph_cond.forcing(forced, self.warmup_s):
            t0 = time.perf_counter()
            warm_up(lambda: self._keyframe_branch(fr, out, era_qual), self.state)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.warmup_s["keyframe"] = (time.perf_counter() - t0 - sum(
            self.warmup_s.get(r, 0.0) for r in forced))

    # ---- one frame ----------------------------------------------------------
    def step(self, xyz: torch.Tensor, inten: torch.Tensor, timestamp,
             ground_u: torch.Tensor | None = None) -> fused.FrameInfo:
        """Run one frame; returns its `FrameInfo` (device scalars, none read)."""
        opened = self.begin_frame()
        try:
            return self._dispatch(xyz, inten, timestamp, ground_u)
        finally:
            if opened:
                spans.recorder.end_frame()

    def _dispatch(self, xyz, inten, timestamp, ground_u) -> fused.FrameInfo:
        rec = spans.recorder
        with rec.span("graph.inputs"):
            self.start_frame()
            self._xyz.copy_(xyz)
            self._inten.copy_(inten)
            if isinstance(timestamp, torch.Tensor):
                self._ts.copy_(timestamp)
            else:
                self._ts.fill_(timestamp)
            if ground_u is None:
                torch.rand(self._ground_u.shape, generator=self.state.slam.gen,
                           out=self._ground_u)
            else:
                self._ground_u.copy_(ground_u)

        replayed = "frame" in self.segments.graphs
        with rec.span("graph.launch"):
            fr, out, read = self.segments.replay("frame") if replayed else self._frame()
        with rec.span("graph.read"):
            read = read.tolist()        # the frame's one host read
        with rec.span("graph.unpack"):
            *flags, nodes = read[:len(self.FLAGS)]
            skip, has_prev, is_kf, found, accept, compacted = map(bool, flags)
            ran = {"fallback": skip and has_prev, "keyframe": is_kf,
                   "compact": compacted, "verify": found, "accept": accept,
                   "rebuild": accept and self.cfg.mapping.rebuild_on_loop}
            solved = accept and self.cfg.loop.online_pgo
            size = posegraph.bucket(nodes, self.cfg.loop.max_keyframes)
            ran.update({r: solved and r == f"pgo.{size}" for r in self._pgo_regions})
            self.last_flags = ran
            out = out._replace(host=slam.HostFlags(skip, has_prev, is_kf))
            self.last_output = out
            info = unpack_info(self._raw.clone(), self._layout)
        rec.device(read[len(self.FLAGS):], self.device)
        if not replayed and self.segments.on_card:
            # every part of the frame has run eagerly now, or runs here once
            # a process, device, configuration and thread (`warmups`)
            key = (self.device, self.cfg, threading.get_ident())
            if key not in warmups:
                self._warm_up(fr, out)
                warmups[key] = self.warmup_s
            self.segments.capture("frame", self._frame)
            self.calibrate()
        return info


class BatchedStepGraph:
    """B sessions' frames (`slam.slam_step_batched`) through one replayed
    graph: `front`, the fallback region when any session's flags say `skip
    & has_prev` (solved on all B and kept where they say so,
    `slam._fallback_batched`), `back`; then the (3, B) flags read, the
    step's one host read.  The
    batched step has no keyframe branch and no log.  `state` is the batched
    `SlamState` of buffers (its sessions seeded `seeds`, as
    `slam.init_batched_state` seeds them), `gen` a tuple of B generators,
    whose RANSAC draws are taken outside the graphs into the `ground_u`
    buffer; the state is updated in place.  `step` returns the frame's
    `SlamOutput` (leading B, `host` a list of B `HostFlags`), packed inside
    the graph and cloned once after it, so that it stays valid."""

    def __init__(self, cfg: SlamConfig, seeds, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mask = projection.detection_mask(cfg.sensor, device=self.device)
        # every buffer its own memory (an initial state may share a tensor
        # between fields)
        self.state = clone_state(slam.init_batched_state(cfg, seeds, self.device))
        B, n = len(self.state.gen), cfg.sensor.num_points
        f32 = dict(dtype=torch.float32, device=self.device)
        self._xyz = torch.zeros((B, n, 3), **f32)
        self._inten = torch.zeros((B, n), **f32)
        self._ts = torch.zeros((B,), **f32)
        self._ground_u = torch.zeros((B, cfg.ground.ransac_iters, 3), **f32)
        self._fb = Pose.identity((B,), device=self.device)     # the fallback's delta
        self._ident = Pose.identity((B,), device=self.device)
        self.segments = Segments(self.device)
        self.capture_s = self.segments.capture_s
        self.replays = self.segments.replays
        self._layout: tuple | None = None      # pack_info's
        self._fallback_ran = False

    def _front(self) -> slam.FrontOutput:
        s = self.state
        fr = slam.front(s, self._xyz, self._inten, self._ts, self.mask, self.cfg)
        donate(s.odo, fr.odo)
        donate(self._fb, self._ident)
        return fr._replace(odo=s.odo)

    def _fallback(self, fr: slam.FrontOutput) -> None:
        self._fallback_ran = True
        donate(self._fb, slam._fallback_batched(self.state, fr, self.cfg))

    def _back(self, fr: slam.FrontOutput) -> torch.Tensor:
        new, out = slam.back(self.state, fr, self._fb, self._ground_u, None, self.cfg)
        donate(self.state, new)
        raw, self._layout = pack_info(out)
        return raw

    def _step(self) -> tuple[slam.FrontOutput, torch.Tensor, torch.Tensor]:
        """`front`, the fallback region (when any session takes it), `back`;
        the packed output and what the host reads, the (3, B) flags."""
        fr = self._front()
        with graph_cond.when((fr.flags[0] & fr.flags[1]).any(), "fallback") as taken:
            if taken:
                self._fallback(fr)
        return fr, self._back(fr), fr.flags

    def step(self, xyz: torch.Tensor, inten: torch.Tensor, timestamps,
             ground_u: torch.Tensor | None = None) -> slam.SlamOutput:
        """One frame of the B sessions: (B, H*W, 3), (B, H*W), (B,) times or
        one time for all, (B, ransac_iters, 3) draws or None (each session's
        generator draws them)."""
        self._xyz.copy_(xyz)
        self._inten.copy_(inten)
        if isinstance(timestamps, torch.Tensor):
            self._ts.copy_(timestamps)
        else:
            self._ts.fill_(timestamps)
        if ground_u is None:
            for b, gen in enumerate(self.state.gen):
                torch.rand(self._ground_u.shape[1:], generator=gen, out=self._ground_u[b])
        else:
            self._ground_u.copy_(ground_u)

        replayed = "step" in self.segments.graphs
        fr, raw, read = self.segments.replay("step") if replayed else self._step()
        flags = read.tolist()       # the one host read
        host = [slam.HostFlags(*f) for f in zip(*flags)]
        out = unpack_info(raw.clone(), self._layout)._replace(host=host)
        if not replayed and self.segments.on_card:
            if not self._fallback_ran:
                warm_up(lambda: slam._fallback_batched(self.state, fr, self.cfg), self.state)
            self.segments.capture("step", self._step)
        return out
