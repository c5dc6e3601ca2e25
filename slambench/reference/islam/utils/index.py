"""Reads and writes at an index that lives on the device, without a host
read.

`arr[k]` and `arr[k] = v` with a 0-d integer tensor `k` make PyTorch fetch
`k` to the host (`k.item()`), which stalls the CPU until the card drains.
The helpers here do the same read or write with device-side indexing, and
`scalar` builds a 0-d constant on the device with a fill instead of a
host-to-device copy.  Index rules follow `jnp` (`arr[k]`, `arr.at[k].set`):
a negative index counts from the end, an out-of-range read clamps, an
out-of-range write is dropped.

Batched sessions: `take`/`put` with a (B,) index read or write one row of
each session's (B, n, ...) array, and `at(arr, *idx, batch=1)` is `arr[idx]`
taken session by session (what `jax.vmap` makes of `arr[idx]`).
"""

from __future__ import annotations

import torch


def scalar(value, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """0-d tensor holding the Python number `value`, built on `device`."""
    return torch.full((), value, dtype=dtype, device=device)


_constants: dict = {}


def constant(values: tuple, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A tuple of Python numbers as a 1-D tensor on `device`, copied over
    once and kept (callers must not write into it)."""
    key = (tuple(values), dtype, str(device))
    if key not in _constants:
        _constants[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return _constants[key]


def as_scalar(value, dtype, device) -> torch.Tensor:
    """`value` as a 0-d tensor of `dtype` on `device`: a tensor is converted,
    a Python number is filled on the device."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return scalar(value, dtype, device)


def batch_arange(n: int, device) -> torch.Tensor:
    """(n,) int64 session indices 0..n-1 on `device`, built once."""
    return constant(tuple(range(n)), torch.int64, device)


def at(arr: torch.Tensor, *idx: torch.Tensor, batch: int = 0) -> torch.Tensor:
    """`arr[idx]` (advanced indexing by the integer tensors `idx`).  With
    `batch=1`, `arr` and every index carry a leading session axis, and
    session b reads arr[b][idx[b]]."""
    if batch == 0:
        return arr[idx]
    b = batch_arange(arr.shape[0], arr.device)
    return arr[(b.reshape((-1,) + (1,) * (idx[0].dim() - 1)),) + idx]


def take(arr: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """`arr[k]` along the first axis for a 0-d integer tensor `k`; for a
    (B,) `k`, row k[b] of each session's arr[b] (axis 1)."""
    lead = k.dim()
    n = arr.shape[lead]
    k = k.long()
    k = torch.clamp(torch.where(k < 0, k + n, k), 0, n - 1)
    if lead == 0:
        return torch.index_select(arr, 0, k.reshape(1))[0]
    rows = k.reshape(k.shape + (1,) * (arr.dim() - lead)).expand(
        k.shape + (1,) + arr.shape[lead + 1:])
    return torch.gather(arr, lead, rows).squeeze(lead)


def put(arr: torch.Tensor, k: torch.Tensor, v) -> torch.Tensor:
    """A copy of `arr` with row `k` (0-d integer tensor) set to `v`, a tensor
    that broadcasts to a row or a Python number.  For a (B,) `k`, session b
    sets row k[b] of arr[b] to v[b]."""
    lead = k.dim()
    n = arr.shape[lead]
    k = k.long()
    k = torch.where(k < 0, k + n, k)
    hit = (torch.arange(n, device=arr.device) == k[(...,) + (None,) * bool(lead)]
           ).reshape(k.shape + (n,) + (1,) * (arr.dim() - lead - 1))
    if isinstance(v, torch.Tensor):
        v = v.to(arr.dtype)
        if lead:
            v = v.unsqueeze(lead)
    return torch.where(hit, v, arr)
