"""The device an entry point runs on, and how a result names it.

Entry points and tools take `device=` (default "cuda").  One asked for the
card on a machine without one raises; nothing falls back to the CPU.
Results name the card by its name and power limit, because a card set below
its maximum runs slower under load."""

from __future__ import annotations

import subprocess

import torch


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


def synchronize(dev) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
