"""Branches on a device flag, taken eagerly: the predicate is read on the
host and the block runs where it is true (the program captures the same
blocks into conditional graph nodes)."""

from __future__ import annotations

import contextlib

import torch

from .tree import clone_state, donate


def capturing(device) -> bool:
    return False


@contextlib.contextmanager
def when(pred: torch.Tensor, name: str, kernels: bool = True):
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"a condition is a 0-d bool tensor, not {pred.dtype} "
                         f"{tuple(pred.shape)}")
    yield bool(pred)


def cond(pred: torch.Tensor, name: str, fn, default):
    """`lax.cond(pred, fn, lambda: default)` on a copy of `default`."""
    out = clone_state(default)
    with when(pred, name) as taken:
        if taken:
            donate(out, fn())
    return out
