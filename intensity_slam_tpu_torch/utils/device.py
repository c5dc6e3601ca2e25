"""The device an entry point runs on, and how a result names it.

Entry points and tools take `device=` (default "cuda").  One asked for the
card on a machine without one raises; nothing falls back to the CPU.
Results name the card by its name and power limit, because a card set below
its maximum runs slower under load."""

from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import threading
import warnings
from typing import NamedTuple

import torch


class Peaks(NamedTuple):
    """A card's published peak rates: FP32 outside the tensor cores and the
    device memory's bandwidth."""

    fp32_flops: float       # FLOP/s
    bytes_per_s: float


# NVIDIA's H100 SXM data sheet (dense rates, at the full 700 W power limit)
H100_SXM = Peaks(fp32_flops=67e12, bytes_per_s=3.35e12)

# published peaks by the card's name as torch gives it
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def resolve(name) -> torch.device:
    """`torch.device(name)`, or a RuntimeError when it names a CUDA device
    and torch sees none."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(name)!r} was asked for, but "
                           "torch.cuda.is_available() is false")
    return dev


def describe(dev) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them ("NVIDIA H100 80GB HBM3,
    700.00 W"); torch's name for the card where nvidia-smi is missing;
    "cpu" on the CPU."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def peaks(dev) -> Peaks | None:
    """The published peaks of the card `dev` names; None on the CPU and
    for a card that `PEAKS` lacks."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    return PEAKS.get(torch.cuda.get_device_name(dev))


def synchronize(dev) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def count_syncs(enabled: bool):
    """Count host syncs by call site for the length of the block (CUDA's
    sync debug mode warns on each one); yields a Counter filled as they
    come.  A sync made on another thread than the caller's is keyed with
    that thread's name in brackets.  With `enabled` false (or on the CPU)
    nothing is counted."""
    sites = collections.Counter()
    caller = threading.current_thread()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            site = f"{os.path.basename(filename)}:{lineno}"
            th = threading.current_thread()
            sites[site if th is caller else f"[{th.name}] {site}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        if enabled:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            if enabled:
                torch.cuda.set_sync_debug_mode(0)
