"""Per-frame steps replayed from CUDA graphs over a state they update in
place: the counterparts of the JAX package's compiled per-frame programs.

PyTorch runs eagerly, and a step is thousands of small kernels whose
launches, not their work, set its time; a CUDA graph launches a captured
sequence of them in one call.  Three owners share the capture and replay
bookkeeping (`Segments`) and the state helpers (`donate`, `clone_state`,
`pack_info`, `warm_up`):

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
here, the fallback and the log append.  `FrameGraph`'s frame is ONE graph:

    front     `slam.front`: undistortion, projection, intensity odometry,
              curvature features, the stacked flags
    if skip & has_prev:
      fallback  `slam.fallback`: the geometric solve
    back      `slam.back`: mux, geometric update, ground, scan-to-map,
              velocity EMA
    if not is_keyframe:
      log       `fused.append_log` with no keyframe output: a non-keyframe's
                ring-log append and its packed `FrameInfo`

then the flags come to the host, the frame's one read.  A keyframe runs
`fused.keyframe_branch` and that frame's log append eagerly after the
replay, as `fused.fused_step` does: its branches read the device (ROADMAP
C.2).  `BatchedStepGraph`'s step is one graph of `front`, the fallback
region when any session's flags say `skip & has_prev` (solved on all B and
kept where they say so, `slam._fallback_batched`) and `back`, then the
(3, B) flags read.

- **Static buffers.** The frame's inputs (`xyz`, `inten`, the timestamp as
  a 0-d tensor, the RANSAC draws `ground_u`) and the whole state live in
  buffers that the graph reads at fixed addresses; what a region hands on
  (the fallback's delta, the log's packed `FrameInfo`) is a buffer made
  before it.
- **Donation.** Each segment ends by copying the state it made into the
  state buffers (`donate`), so the state is updated in place, as JAX's
  donated buffers are; `adopt(state)` copies a state made outside the
  graphs (the keyframe branch's, a loaded checkpoint's, a refine's) into
  them.  A caller that keeps `state` across a frame sees it change:
  `snapshot()` clones it.
- **Capture.** The graph is captured lazily, after a frame has run every
  part of it eagerly (the warm-up, whose result is the frame's real one):
  `FrameGraph` at the end of the first non-keyframe frame, the others after
  their first step; a fallback that no frame has taken yet is run once
  eagerly and dropped first (`warm_up`).  `capture_s` records the capture's
  seconds, `replays` the replays.
- **Draws.** The RANSAC uniforms are drawn from the state's generator (each
  session's, in a batch) outside the graphs, into the `ground_u` buffer:
  the eager step's draws.
- **Outputs.** A graph's outputs are overwritten by its next replay, so
  the step's outputs are packed into one byte tensor inside the graph and
  cloned once after it; the returned `FrameInfo` (`SlamOutput`,
  `GeoSlamOutput`) holds views of that clone and stays valid.
- **Kernel counts.** A capture records the hand kernels' launches without
  making them, and every replay makes them again: the counts of the
  wrappers in `KERNEL_WRAPPERS` are taken back after a capture, and each
  replay advances them by what the capture recorded outside the regions,
  and inside each region that the flags read after it say ran.
- **On the CPU** the same segments run eagerly in the same order with the
  same in-place copies, each region's test read on the host.  On the card
  nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import collections
import time

import torch

from ..config import SlamConfig
from ..ops import projection
from ..utils import graph_cond
from ..utils.graph_cond import KERNEL_WRAPPERS
from ..utils.se3 import Pose
from . import fused, slam


def leaves(tree):
    """The tensors of a NamedTuple tree, in field order (generators and
    other non-tensor leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for f in tree:
            yield from leaves(f)


def _rebuild(tree, fn):
    """The tree with every leaf `x` that is not a tuple (a tensor, a
    generator, None) replaced by `fn(x)`."""
    if isinstance(tree, tuple):
        kids = (_rebuild(f, fn) for f in tree)
        # a NamedTuple of the state, or a plain tuple (a batch's generators)
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return fn(tree)


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def donate(dst, src) -> None:
    """Copy the tensors of the tree `src` into the buffers of the tree `dst`
    (the same structure, shapes and dtypes).  A leaf that already is its
    buffer is skipped; one that shares memory with any buffer of `dst` is
    cloned before the first write, so that no copy reads what another has
    overwritten."""
    dst_l, src_l = list(leaves(dst)), list(leaves(src))
    if len(dst_l) != len(src_l):
        raise ValueError(f"state trees differ: {len(dst_l)} against {len(src_l)} tensors")
    bufs = {d.untyped_storage().data_ptr() for d in dst_l}
    pairs = []
    for d, s in zip(dst_l, src_l):
        if s.dtype != d.dtype or s.shape != d.shape:
            raise ValueError(f"state leaf changed: {s.dtype} {tuple(s.shape)} into "
                             f"{d.dtype} {tuple(d.shape)}")
        if _same_view(d, s):
            continue
        if s.device == d.device and s.untyped_storage().data_ptr() in bufs:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


def _copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.clone()
    if isinstance(leaf, torch.Generator):
        twin = torch.Generator(device=leaf.device)
        twin.set_state(leaf.get_state())
        return twin
    return leaf


def clone_state(state):
    """A copy of the state tree `state` that shares no memory with it: every
    tensor cloned, every generator (a session's, or each of a batch's)
    copied with its state."""
    return _rebuild(state, _copy)


def pack_info(info) -> tuple[torch.Tensor, tuple]:
    """The tensors of the output tree `info` as one uint8 tensor (wider
    types first, so that every one is aligned to its own size) and their
    layout: the tree with each tensor replaced by its place in leaf order,
    and (byte offset, dtype, shape) of each tensor."""
    ts = list(leaves(info))
    slots = iter(range(len(ts)))
    skeleton = _rebuild(info, lambda x: next(slots) if isinstance(x, torch.Tensor) else x)
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
    return _rebuild(skeleton, lambda x: views[x] if isinstance(x, int) else x)


def _generators(tree):
    if isinstance(tree, torch.Generator):
        yield tree
    elif isinstance(tree, tuple):
        for f in tree:
            yield from _generators(f)


def warm_up(fn, state) -> None:
    """Run `fn()` once eagerly and drop its result: what a region that no
    step has taken yet needs before it is captured (its index constants
    made, its solver's first use done), as every other part of a graph runs
    eagerly before its capture.  Raises if `fn` drew from a generator of
    `state` or wrote one of its tensors."""
    gens = list(_generators(state))
    rng = [g.get_state() for g in gens]
    versions = [t._version for t in leaves(state)]
    fn()
    if (not all(torch.equal(g.get_state(), r) for g, r in zip(gens, rng))
            or versions != [t._version for t in leaves(state)]):
        raise RuntimeError("a warm-up drew random numbers or wrote the state")


class Segments:
    """The capture and replay bookkeeping of one graph owner: its graphs
    (each captured after what it records ran eagerly once, sharing one
    memory pool), their outputs, the hand kernels' launches a replay
    outside and inside each conditional region, `capture_s` and `replays`
    by graph."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.outs: dict = {}
        self.kernels: dict[str, list[int]] = {}     # a replay's, outside its regions
        self.region_kernels: dict[str, dict[str, list[int]]] = {}   # by region
        self.pool = None
        self.capture_s: dict[str, float] = {}
        self.replays: collections.Counter = collections.Counter()

    def capture(self, name: str, fn, regions: tuple = ()) -> None:
        """Capture `fn()` into graph `name` and keep its output.  The hand
        kernels' launches it recorded are taken back from the wrappers'
        counts and kept, those inside each conditional region of `regions`
        (`graph_cond.when`) apart; a region not named may hold none."""
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = graph_cond.launch_counts()
        graph_cond.recorded.clear()
        with graph_cond.capture(g, self.pool):
            self.outs[name] = fn()
        torch.cuda.synchronize(self.device)
        total = [a - b for a, b in zip(graph_cond.launch_counts(), before)]
        for w, b in zip(KERNEL_WRAPPERS, before):
            w.launches = b
        stray = {r for r, n in graph_cond.recorded.items() if any(n) and r not in regions}
        if stray:
            raise RuntimeError(f"graph {name!r}: hand kernels captured in regions "
                               f"{sorted(stray)} whose replays are not counted")
        inside = {r: graph_cond.recorded.get(r, [0] * len(total)) for r in regions}
        self.region_kernels[name] = inside
        self.kernels[name] = [t - sum(n[i] for n in inside.values())
                              for i, t in enumerate(total)]
        self.graphs[name] = g
        self.capture_s[name] = time.perf_counter() - t0

    def replay(self, name: str):
        """Replay graph `name`, counting the launches it makes outside its
        regions; returns its output."""
        self.graphs[name].replay()
        self.replays[name] += 1
        _count(self.kernels[name])
        return self.outs[name]

    def count_regions(self, name: str, ran: dict) -> None:
        """Count the launches inside the regions of graph `name`'s last
        replay that ran (`ran`: region name -> whether it ran, from the
        flags read after the replay)."""
        for region, taken in ran.items():
            if taken:
                _count(self.region_kernels[name][region])

    def run(self, name: str, fn):
        """Replay graph `name`; without one, run `fn()` eagerly and (on the
        card) capture it after.  For a graph without regions."""
        if name in self.graphs:
            return self.replay(name)
        out = fn()
        if self.on_card:
            self.capture(name, fn)
        return out


def _count(launches: list[int]) -> None:
    for w, n in zip(KERNEL_WRAPPERS, launches):
        w.launches += n


class FrameGraph:
    """One session's frames through the captured graph (see the module
    docstring).  `state` is the `FusedState` of buffers, read at any time;
    `step` runs a frame and returns its `FrameInfo`."""

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
        self.segments = Segments(self.device)
        self._layout: tuple | None = None      # pack_info's
        self._raw: torch.Tensor | None = None  # the log region's packed FrameInfo
        self._fallback_ran = False
        self.capture_s = self.segments.capture_s        # by graph
        self.replays = self.segments.replays
        self.last_output: slam.SlamOutput | None = None   # the last frame's
        # `slam.back` output (a graph's tensors: valid until the next frame)

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

    def _log(self, out: slam.SlamOutput) -> None:
        st = self.state
        iq, _ = fused.frame_quality(st.log, out, self.cfg)
        log, info = fused.append_log(st.log, out, fused.no_keyframe_output(self.device),
                                     st.backend.num_kf, iq, self.cfg)
        donate(st.log, log)
        raw, self._layout = pack_info(info)
        if self._raw is None:
            self._raw = raw         # eagerly, before any capture: the buffer
        else:
            self._raw.copy_(raw)

    def _frame(self) -> tuple[slam.FrontOutput, slam.SlamOutput]:
        """The frame up to the keyframe branch: `front`, the fallback
        region, `back`, the log region."""
        fr = self._front()
        skip, has_prev, is_kf = fr.flags.unbind()
        with graph_cond.when(skip & has_prev, "fallback") as taken:
            if taken:
                self._fallback(fr)
        out = self._back(fr)
        with graph_cond.when(~is_kf, "log") as taken:
            if taken:
                self._log(out)
        return fr, out

    # ---- one frame ----------------------------------------------------------
    def step(self, xyz: torch.Tensor, inten: torch.Tensor, timestamp,
             ground_u: torch.Tensor | None = None) -> fused.FrameInfo:
        """Run one frame; returns its `FrameInfo` (device scalars, none read)."""
        cfg, st = self.cfg, self.state
        self._xyz.copy_(xyz)
        self._inten.copy_(inten)
        if isinstance(timestamp, torch.Tensor):
            self._ts.copy_(timestamp)
        else:
            self._ts.fill_(timestamp)
        if ground_u is None:
            torch.rand(self._ground_u.shape, generator=st.slam.gen, out=self._ground_u)
        else:
            self._ground_u.copy_(ground_u)

        replayed = "frame" in self.segments.graphs
        fr, out = self.segments.replay("frame") if replayed else self._frame()
        skip, has_prev, is_kf = fr.flags.tolist()       # the frame's one host read
        if replayed:
            self.segments.count_regions("frame", {"fallback": skip and has_prev,
                                                  "log": not is_kf})
        out = out._replace(host=slam.HostFlags(skip, has_prev, is_kf))
        self.last_output = out
        if not is_kf:
            info = unpack_info(self._raw.clone(), self._layout)
            if not replayed and self.segments.on_card:
                # every region has run eagerly now, the fallback perhaps not
                if not self._fallback_ran:
                    warm_up(lambda: slam.fallback(self.state.slam, fr, cfg), self.state)
                self.segments.capture("frame", self._frame, ("fallback", "log"))
            return info
        # the keyframe branch and its log append, eagerly (fused_step's)
        iq, era_qual = fused.frame_quality(st.log, out, cfg)
        sstate, bstate, bout = fused.keyframe_branch(
            st.backend, st.slam, out, fr.xyz, self._inten, self._ts, era_qual, cfg)
        self.adopt(fused.FusedState(sstate, bstate, st.log))
        log, info = fused.append_log(st.log, out, bout, self.state.backend.num_kf, iq, cfg)
        donate(self.state.log, log)
        raw, self._layout = pack_info(info)
        return unpack_info(raw.clone(), self._layout)


class BatchedStepGraph:
    """B sessions' frames (`slam.slam_step_batched`) through one replayed
    graph: `front`, the fallback region when any session's flags say `skip
    & has_prev` (solved on all B and kept where they say so,
    `slam._fallback_batched`), `back`; then the flags read ((3, B), the
    step's one host read).  The batched step has no keyframe branch and no
    log.  `state` is the batched
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

    def _step(self) -> tuple[slam.FrontOutput, torch.Tensor]:
        """`front`, the fallback region (when any session takes it), `back`."""
        fr = self._front()
        with graph_cond.when((fr.flags[0] & fr.flags[1]).any(), "fallback") as taken:
            if taken:
                self._fallback(fr)
        return fr, self._back(fr)

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
        fr, raw = self.segments.replay("step") if replayed else self._step()
        host = [slam.HostFlags(*f) for f in zip(*fr.flags.tolist())]   # the one host read
        fell_back = any(h.skip and h.has_prev for h in host)
        if replayed:
            self.segments.count_regions("step", {"fallback": fell_back})
        out = unpack_info(raw.clone(), self._layout)._replace(host=host)
        if not replayed and self.segments.on_card:
            if not self._fallback_ran:
                warm_up(lambda: slam._fallback_batched(self.state, fr, self.cfg), self.state)
            self.segments.capture("step", self._step, ("fallback",))
        return out
