"""Branches decided on the device inside a captured CUDA graph: the
counterpart of the JAX package's `lax.cond` and `lax.while_loop` under
`jax.jit`.

`when(pred, name)` guards a block by the 0-d bool tensor `pred`:

    with graph_cond.when(pred, "fallback") as taken:
        if taken:
            ...

- While the current CUDA stream is being captured into a graph (through
  `capture`), the block is captured into the body of a conditional (If)
  node, which every replay runs only where `pred` is true: `taken` is True
  and the block runs in Python, as the capture records it.  The node is
  opened by `csrc/graph_cond.cu` (a one-thread kernel sets the node's
  handle from `pred`, and a second stream captures the body straight into
  the node's body graph, as torch's own `CUDAGraph.begin_capture_to_if_node`
  does, which the torch on the card, 2.11, does not expose to Python); the
  body's allocations go to a memory pool that lives as long as the graph.
  Nodes nest, one body stream and pool a depth.  Nothing falls back to a graph without the node: a node
  that cannot be opened raises.
- Otherwise `pred` is read on the host and the block runs where it is true:
  on the CPU, where the tests run the conditional forms eagerly, and in a
  graph owner's eager frames before its capture on the card.  This read
  stands for the node's own test on the card, so it goes through
  `Tensor.__bool__` as it was when this module was imported: a test that
  patches the tensor's host reads to find those of a captured segment does
  not see it.  `ran` counts the blocks run this way, by region name.

A block hands its results to the code after it only through buffers made
before the node, written with `copy_`: a tensor that a body allocates holds
garbage after a replay that skipped the body.  `cond(pred, name, fn,
default)` is the functional form, the counterpart of `lax.cond(pred, fn,
lambda: default)`: a copy of `default` made before the node, overwritten by
`fn()`'s result inside it.

`forcing(names, seconds)` makes the regions `names` run eagerly whatever
their predicates say, each timed (its own seconds, those of the regions
nested in it apart): the warm-up of a region that no step has taken before
its capture (`pipeline.frame_graph.FrameGraph`).

**Stamps.**  A block that runs, on a host read or as a node's body, starts
and ends with the device stamps of its region (`utils.spans.mark`), the
first and last nodes of the body: a no-op unless a frame graph is stamping
and the region is one of `spans.DEVICE` (the solvers' iterations, the PCM
vote's steps and the eviction are not).

The library is compiled from `csrc/graph_cond.cu` at first use
(`utils.nvcc`) into `intensity_slam_tpu_torch/_build/libisl_graph_cond.so`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import time
import weakref

import torch

from . import nvcc, spans
from .tree import clone_state, donate

SOURCE = os.path.join(nvcc.CSRC_DIR, "graph_cond.cu")
LIBRARY = os.path.join(nvcc.BUILD_DIR, "libisl_graph_cond.so")
THREAD_LOCAL = 1        # cudaStreamCaptureModeThreadLocal, torch's capture mode here
# nodes nested, a stream and a pool a depth: the PGO's buckets lie inside
# accept, inside verify, inside the keyframe branch
MAX_DEPTH = 4

_host_bool = torch.Tensor.__bool__
_lib = None
_captures: list = []    # the graphs being captured through `capture`
_body_streams: list = []    # one a nesting depth
_depth = 0
_forced: dict = {}      # region name -> its seconds' dict, while `forcing`
_timing: list = []      # seconds of the regions nested in each forced one

ran: collections.Counter = collections.Counter()     # blocks run on a host read


def build(verbose: bool = False) -> str:
    """Compile `csrc/graph_cond.cu` unless the library is newer than its
    source.  Returns nvcc's output (empty when up to date)."""
    return nvcc.build(SOURCE, LIBRARY, (), verbose)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.isl_cond_open.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        lib.isl_cond_open.restype = ctypes.c_int
        lib.isl_cond_close.argtypes = [ctypes.c_void_p]
        lib.isl_cond_close.restype = ctypes.c_int
        lib.isl_cond_error_string.argtypes = [ctypes.c_int]
        lib.isl_cond_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def set_handle(pred: torch.Tensor, body_stream: torch.cuda.Stream) -> None:
    """Open an If node on `pred` in the graph the current stream captures
    (`set_handle_kernel` launched on that stream) and begin capturing
    `body_stream` into its body."""
    lib = _library()
    rc = lib.isl_cond_open(pred.data_ptr(), torch.cuda.current_stream(pred.device).cuda_stream,
                           body_stream.cuda_stream, THREAD_LOCAL)
    if rc != 0:
        raise RuntimeError("opening a conditional node failed: "
                           + lib.isl_cond_error_string(rc).decode())


def capturing(device) -> bool:
    """Whether the current stream of `device` is being captured."""
    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, pool):
    """`torch.cuda.graph(graph, pool)` in thread-local mode, in which `when`
    can open nodes.  A body allocates on its depth's stream, from a pool of
    that depth made for this capture (torch records one pool to one filter
    at a time, and `pool` is the capture stream's); those pools live as
    long as `graph`."""
    dev = torch.cuda.current_device()
    while len(_body_streams) < MAX_DEPTH:
        _body_streams.append(torch.cuda.Stream(dev))
    body_pools = [torch.cuda.graph_pool_handle() for _ in range(MAX_DEPTH)]
    for stream, body_pool in zip(_body_streams, body_pools):
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, body_pool)
    weakref.finalize(graph, _release, dev, body_pools)
    _captures.append(graph)
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            yield
    finally:
        _captures.pop()
        for body_pool in body_pools:
            torch._C._cuda_endAllocateToPool(dev, body_pool)


def _release(dev: int, body_pools) -> None:
    for body_pool in body_pools:
        torch._C._cuda_releasePool(dev, body_pool)


@contextlib.contextmanager
def _body(pred: torch.Tensor):
    """Open the node on `pred`, run the block on the body stream of this
    depth, close the node."""
    global _depth
    if not _captures:
        raise RuntimeError("a conditional node needs a capture made through "
                           "graph_cond.capture (its bodies' streams and pools)")
    if _depth >= MAX_DEPTH:
        raise RuntimeError(f"conditional nodes nested deeper than {MAX_DEPTH}")
    stream = _body_streams[_depth]
    set_handle(pred, stream)
    _depth += 1
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        _depth -= 1
        rc = _library().isl_cond_close(stream.cuda_stream)
        if rc != 0:
            raise RuntimeError("closing a conditional node failed: "
                               + _library().isl_cond_error_string(rc).decode())


@contextlib.contextmanager
def when(pred: torch.Tensor, name: str):
    """Guard the block by the 0-d bool `pred` (see the module docstring);
    yields whether the block is to run."""
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"a condition is a 0-d bool tensor, not {pred.dtype} "
                         f"{tuple(pred.shape)}")
    if not capturing(pred.device):
        if name in _forced:
            with _timed(name, pred.device):
                yield True
            return
        taken = _host_bool(pred)
        if taken:
            ran[name] += 1
            spans.mark(name, False)
        yield taken
        if taken:
            spans.mark(name, True)
        return
    with _body(pred):
        spans.mark(name, False)
        yield True
        spans.mark(name, True)


def cond(pred: torch.Tensor, name: str, fn, default):
    """`lax.cond(pred, fn, lambda: default)`: a copy of the tree `default`,
    made before the region, overwritten by the tree `fn()` (the same
    structure, shapes and dtypes) inside `when(pred, name)`.  The inputs are
    left untouched."""
    out = clone_state(default)
    with when(pred, name) as taken:
        if taken:
            donate(out, fn())
    return out


@contextlib.contextmanager
def forcing(names, seconds: dict):
    """Run the regions `names` eagerly for the length of the block whatever
    their predicates, adding each one's own seconds (the device synchronized
    around it, the regions nested in it apart) into `seconds`."""
    saved = dict(_forced)
    _forced.update({n: seconds for n in names})
    try:
        yield
    finally:
        _forced.clear()
        _forced.update(saved)


@contextlib.contextmanager
def _timed(name: str, device: torch.device):
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    _timing.append(0.0)
    try:
        yield
    finally:
        sync()
        nested = _timing.pop()
        dt = time.perf_counter() - t0
        if _timing:
            _timing[-1] += dt
        seconds = _forced[name]
        seconds[name] = seconds.get(name, 0.0) + dt - nested
