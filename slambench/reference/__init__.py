"""The plain reference the benchmark holds the program to.

`islam/` is a frozen copy of the eager per-frame functions of the PyTorch
port as they stood when the benchmark was defined (`fused.fused_step` and
everything under it), with the hand-written CUDA kernels replaced by their
plain torch forms and the conditional graph nodes by host branches.  It
imports nothing of the program, so a later change to the program does not
move it; but it shares the port's algorithm, so it checks the replayed
graphs and the hand kernels, and a fault of the algorithm common to both
passes it.  The exported trajectory against the rendered poses
(`check.trajectory_errors`) is the witness independent of the algorithm.

The reference runs float32 with TF32 off, as the configurations state;
`precision(tf32=True)` switches on the nearest precision below: around a
whole run of the program it makes the control, around the reference a
second reading.

A SLAM step is ill-conditioned in scan-to-map (rounding grows over
frames), so the reference follows the program step by step: it takes the
program's state before a sampled frame, works out the frame's input from
the raw scan itself (the stream's wire quantization included), and
compares its own step's result with the program's."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .islam import config as rconfig

WIRE_MAX_RANGE = 120.0


def build_config(d: dict) -> rconfig.SlamConfig:
    """The reference's `SlamConfig` from the nested dict of a
    configuration file."""
    def build(cls, dd):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in dd:
                continue
            v, sub = dd[f.name], getattr(rconfig, str(f.type), None)
            if isinstance(v, dict) and dataclasses.is_dataclass(sub):
                v = build(sub, v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)
    return build(rconfig.SlamConfig, d)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 matrix products with TF32 off (the reference), or on (the
    control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---- the stream's wire form, worked out from the raw scans -----------------

def beam_directions(first_scans) -> np.ndarray:
    """Per-pixel unit beam directions from a log's first scans (the first
    valid return of each pixel), as the stream builds its table."""
    dirs, have = None, None
    for xyz in first_scans:
        if dirs is None:
            dirs = np.zeros(xyz.shape, np.float32)
            have = np.zeros(xyz.shape[0], bool)
        r = np.linalg.norm(xyz, axis=-1)
        ok = (r > 0.1) & ~have
        dirs[ok] = xyz[ok] / r[ok, None]
        have |= ok
        if have.all():
            break
    return dirs


def wire_words(xyz: np.ndarray, inten: np.ndarray, rel_s: float,
               max_range: float = WIRE_MAX_RANGE) -> np.ndarray:
    """The (N+1, 2) uint16 words a frame travels as: row 0 the run-relative
    milliseconds (hi, lo), then each point's range quantized to max_range /
    65535 and its intensity, in float32 arithmetic."""
    rel_ms = int(max(rel_s * 1e3, 0.0) + 0.5) & 0xFFFFFFFF
    x, y, z = (xyz[:, i].astype(np.float32) for i in range(3))
    r = np.sqrt(x * x + y * y + z * z)
    r = np.minimum(r, np.float32(max_range))
    scale = np.float32(65535.0) / np.float32(max_range)
    q = np.floor(r * scale + np.float32(0.5)).astype(np.uint16)
    v = np.clip(inten.astype(np.float32), 0.0, 65535.0).astype(np.uint16)
    words = np.empty((xyz.shape[0] + 1, 2), np.uint16)
    words[0] = (rel_ms >> 16, rel_ms & 0xFFFF)
    words[1:, 0] = q
    words[1:, 1] = v
    return words


def wire_frame(words: np.ndarray, dirs: torch.Tensor, max_range: float = WIRE_MAX_RANGE):
    """(xyz (N, 3), intensity (N,), timestamp ()) on `dirs`' device from the
    wire words, in float32."""
    w = torch.from_numpy(words.astype(np.int32)).to(dirs.device)
    ts = (w[0, 0].float() * 65536.0 + w[0, 1].float()) * 1e-3
    rng = w[1:, 0].float() * (max_range / 65535.0)
    return rng[:, None] * dirs, w[1:, 1].float(), ts
