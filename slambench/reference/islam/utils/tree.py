"""Trees of tensors (the state and output NamedTuples of the port) copied
into buffers and cloned: what a captured CUDA graph needs to update a state
in place and to hand a conditional region's results on (`graph_cond.cond`,
`pipeline.frame_graph`)."""

from __future__ import annotations

import torch


def leaves(tree):
    """The tensors of a NamedTuple tree, in field order (generators and
    other non-tensor leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for f in tree:
            yield from leaves(f)


def map_leaves(tree, fn):
    """The tree with every leaf `x` that is not a tuple (a tensor, a
    generator, None) replaced by `fn(x)`."""
    if isinstance(tree, tuple):
        kids = (map_leaves(f, fn) for f in tree)
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


def _copy_leaf(leaf):
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
    return map_leaves(state, _copy_leaf)


def generators(tree):
    if isinstance(tree, torch.Generator):
        yield tree
    elif isinstance(tree, tuple):
        for f in tree:
            yield from generators(f)
