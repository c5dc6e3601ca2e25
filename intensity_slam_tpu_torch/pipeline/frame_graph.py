"""Per-frame steps replayed from CUDA graphs over a state they update in
place: the counterparts of the JAX package's compiled per-frame programs.

PyTorch runs eagerly, and a step is thousands of small kernels whose
launches, not their work, set its time; a CUDA graph launches a captured
sequence of them in one call.  Three owners share the capture and replay
bookkeeping (`Segments`) and the state helpers (`donate`, `clone_state`,
`pack_info`):

- `FrameGraph` (here): one session's `fused_step`, the counterpart of
  `jax.jit(fused_step, donate_argnums=(0,))` (`pipeline/system.py`,
  `runtime/stream.py` of the JAX package);
- `BatchedStepGraph` (here): B sessions' `slam.slam_step_batched`, the
  counterpart of `jax.jit(jax.vmap(slam_step), donate_argnums=(0,))`
  (`tools/scaling_multisession.py` of the JAX package);
- `geometric_slam.GeoStepGraph`: the A-LOAM step, one segment, the
  counterpart of the jitted step that the reference's `run_sequence`
  replays under `lax.scan`.

`FrameGraph`'s frame is cut at its one host read (the flags that choose
the fallback and keyframe branches, `slam.front`'s stack), so it is up to
four graphs:

    front     `slam.front`: undistortion, projection, intensity odometry,
              curvature features, the stacked flags
    fallback  `slam.fallback`: the geometric solve, when `skip & has_prev`
    back      `slam.back`: mux, geometric update, ground, scan-to-map,
              velocity EMA
    log       `fused.append_log` with no keyframe output: a non-keyframe's
              ring-log append and its `FrameInfo`

A keyframe runs `fused.keyframe_branch` and that frame's log append eagerly
between `back` and the end of the frame, as `fused.fused_step` does: its
branches read the device (ROADMAP C.2).  `BatchedStepGraph` has the same
`front`, `fallback` and `back` over a leading session axis, the flags read
as one (3, B) read; its fallback runs on all B sessions when any needs it
(`slam._fallback_batched`), so one graph serves every subset.

- **Static buffers.** The frame's inputs (`xyz`, `inten`, the timestamp as
  a 0-d tensor, the RANSAC draws `ground_u`) and the whole state live in
  buffers that every graph reads at fixed addresses.
- **Donation.** Each segment ends by copying the state it made into the
  state buffers (`donate`), so the state is updated in place, as JAX's
  donated buffers are; `adopt(state)` copies a state made outside the
  graphs (the keyframe branch's, a loaded checkpoint's, a refine's) into
  them.  A caller that keeps `state` across a frame sees it change:
  `snapshot()` clones it.
- **Capture.** Each graph is captured lazily, right after the first frame
  that takes its branch has run that segment eagerly (the warm-up, whose
  result is the frame's real one); the graphs share one memory pool (they
  never run at once, and every tensor one hands to the next is held here).
  While a graph is captured the solver runs its fixed-iteration form
  (`solver.solve_pose`); `capture_s` records each capture's seconds.
- **Draws.** The RANSAC uniforms are drawn from the state's generator (each
  session's, in a batch) outside the graphs, into the `ground_u` buffer:
  the eager step's draws.
- **Outputs.** A graph's outputs are overwritten by its next replay, so
  the step's outputs are packed into one byte tensor inside the graph and
  cloned once after it; the returned `FrameInfo` (`SlamOutput`,
  `GeoSlamOutput`) holds views of that clone and stays valid.
- **Kernel counts.** A capture records the hand kernels' launches without
  making them, and every replay makes them again: the counts of the
  wrappers in `KERNEL_WRAPPERS` are taken back after a capture and advanced
  by each replay, so that they count the launches the card runs.
- **On the CPU** the same segments run eagerly in the same order with the
  same in-place copies.  On the card nothing falls back: a capture or a
  replay that fails raises.
"""

from __future__ import annotations

import collections
import time

import torch

from ..config import SlamConfig
from ..ops import eigsym, pallas_nn, projection
from ..utils.se3 import Pose
from . import fused, slam

# the hand kernels' wrappers, each with its `launches` count
KERNEL_WRAPPERS = (eigsym.eigh, eigsym.eigvalsh, pallas_nn.pack_targets,
                   pallas_nn.nearest_neighbor_packed)


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


class Segments:
    """The capture and replay bookkeeping of one graph owner: its segments'
    graphs, captured lazily and sharing one memory pool, their outputs, the
    hand kernels' launches a replay, `capture_s` and `replays` by segment."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.outs: dict = {}
        self.kernels: dict[str, list[int]] = {}     # hand-kernel launches a replay
        self.pool = None
        self.capture_s: dict[str, float] = {}
        self.replays: collections.Counter = collections.Counter()

    def run(self, name: str, fn, cur: dict, *deps: str):
        """Replay segment `name`'s graph; without one, run it eagerly on this
        step's outputs of the segments `deps` and (on the card) capture it
        after, on their graphs' outputs, fixed tensors.  Records the
        segment's output in `cur`."""
        g = self.graphs.get(name)
        if g is not None:
            g.replay()
            self.replays[name] += 1
            for w, n in zip(KERNEL_WRAPPERS, self.kernels[name]):
                w.launches += n
            cur[name] = self.outs[name]
            return cur[name]
        cur[name] = fn(*(cur[d] for d in deps))
        if self.capture:
            t0 = time.perf_counter()
            g = torch.cuda.CUDAGraph()
            before = [w.launches for w in KERNEL_WRAPPERS]
            with torch.cuda.graph(g, pool=self.pool, capture_error_mode="thread_local"):
                self.outs[name] = fn(*(self.outs[d] for d in deps))
            torch.cuda.synchronize(self.device)
            self.kernels[name] = [w.launches - b for w, b in zip(KERNEL_WRAPPERS, before)]
            for w, b in zip(KERNEL_WRAPPERS, before):
                w.launches = b
            if self.pool is None:
                self.pool = g.pool()
            self.graphs[name] = g
            self.capture_s[name] = time.perf_counter() - t0
        return cur[name]


class FrameGraph:
    """One session's frames through the captured segments (see the module
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
        self.capture_s = self.segments.capture_s        # by segment
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
        donate(self._fb, slam.fallback(self.state.slam, fr, self.cfg))

    def _back(self, fr: slam.FrontOutput) -> slam.SlamOutput:
        s = self.state.slam
        new, out = slam.back(s, fr, self._fb, self._ground_u, None, self.cfg)
        donate(s, new)
        return out

    def _log(self, out: slam.SlamOutput) -> torch.Tensor:
        st = self.state
        iq, _ = fused.frame_quality(st.log, out, self.cfg)
        log, info = fused.append_log(st.log, out, fused.no_keyframe_output(self.device),
                                     st.backend.num_kf, iq, self.cfg)
        donate(st.log, log)
        raw, self._layout = pack_info(info)
        return raw

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

        cur: dict = {}
        fr = self.segments.run("front", self._front, cur)
        skip, has_prev, is_kf = fr.flags.tolist()       # the frame's one host read
        if skip and has_prev:
            self.segments.run("fallback", self._fallback, cur, "front")
        out = self.segments.run("back", self._back, cur, "front")._replace(
            host=slam.HostFlags(skip, has_prev, is_kf))
        self.last_output = out
        if not is_kf:
            raw = self.segments.run("log", self._log, cur, "back")
        else:
            # the keyframe branch and its log append, eagerly (fused_step's)
            iq, era_qual = fused.frame_quality(st.log, out, cfg)
            sstate, bstate, bout = fused.keyframe_branch(
                st.backend, st.slam, out, fr.xyz, self._inten, self._ts, era_qual, cfg)
            self.adopt(fused.FusedState(sstate, bstate, st.log))
            log, info = fused.append_log(st.log, out, bout, self.state.backend.num_kf,
                                         iq, cfg)
            donate(self.state.log, log)
            raw, self._layout = pack_info(info)
        return unpack_info(raw.clone(), self._layout)


class BatchedStepGraph:
    """B sessions' frames (`slam.slam_step_batched`) through replayed
    graphs: `front`, the flags read ((3, B), the step's one host read),
    `fallback` when any session's flags say `skip & has_prev` (solved on all
    B and kept where they say so, `slam._fallback_batched`), `back`.  The
    batched step has no keyframe branch and no log.  `state` is the batched
    `SlamState` of buffers (its sessions seeded `seeds`, as
    `slam.init_batched_state` seeds them), `gen` a tuple of B generators,
    whose RANSAC draws are taken outside the graphs into the `ground_u`
    buffer; the state is updated in place.  `step` returns the frame's
    `SlamOutput` (leading B, `host` a list of B `HostFlags`), packed inside
    the `back` graph and cloned once after it, so that it stays valid."""

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

    def _front(self) -> slam.FrontOutput:
        s = self.state
        fr = slam.front(s, self._xyz, self._inten, self._ts, self.mask, self.cfg)
        donate(s.odo, fr.odo)
        donate(self._fb, self._ident)
        return fr._replace(odo=s.odo)

    def _fallback(self, fr: slam.FrontOutput) -> None:
        donate(self._fb, slam._fallback_batched(self.state, fr, self.cfg))

    def _back(self, fr: slam.FrontOutput) -> torch.Tensor:
        new, out = slam.back(self.state, fr, self._fb, self._ground_u, None, self.cfg)
        donate(self.state, new)
        raw, self._layout = pack_info(out)
        return raw

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

        cur: dict = {}
        fr = self.segments.run("front", self._front, cur)
        host = [slam.HostFlags(*f) for f in zip(*fr.flags.tolist())]   # the one host read
        if any(h.skip and h.has_prev for h in host):
            self.segments.run("fallback", self._fallback, cur, "front")
        raw = self.segments.run("back", self._back, cur, "front")
        return unpack_info(raw.clone(), self._layout)._replace(host=host)
