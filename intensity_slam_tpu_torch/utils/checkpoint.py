"""Checkpoint/resume for SLAM state.

The port's counterpart of `intensity_slam_tpu/utils/checkpoint.py`, with the
same on-disk format, so a checkpoint written by either package loads in the
other: one `.npz` whose keys are `"{i:04d}|{path}"`, `path` being the
NamedTuple field names from the root to the leaf joined by "/" (the
reference's `_path_str` of a key path), written to a temporary file and
moved into place with an atomic `os.replace`.  Words that the JAX package
keeps as uint32 (`interop.UINT32_FIELDS`) are written as uint32.

`restore` matches leaves BY PATH: shapes must agree; a template leaf the
file lacks keeps its template value, and a file leaf the template lacks is
unused (a warning for either; `strict=True` raises instead).

The one leaf the packages do not share is the random state: the port's
`SlamState.gen` (a `torch.Generator`) is written as its `get_state()`
bytes under its own path, `.../gen`; the reference's `.../rng` key is an
unused path on the way in, and the generator of a template keeps its state
when the file has none for it, or one of another kind of generator (a CPU
generator's state does not fit a CUDA generator).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

# the fields stored as uint32 words in the JAX package (int32 tensors with
# the same bits here)
UINT32_FIELDS = frozenset({"desc", "prev_desc", "kf_sig", "kf_feat_desc",
                           "feat_desc", "win_desc"})


def _leaves(tree, path=()):
    """(path tuple, leaf) in NamedTuple field order; None is no leaf, as in
    a JAX pytree."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f,))
    elif isinstance(tree, (torch.Tensor, torch.Generator)):
        yield path, tree
    else:
        raise TypeError(f"checkpoint: unsupported leaf {type(tree).__name__} "
                        f"at {'/'.join(path)}")


def _to_numpy(path, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    a = leaf.detach().cpu().numpy()
    return a.view(np.uint32) if path[-1] in UINT32_FIELDS else a


def save(path: str, state) -> None:
    """Serialize a NamedTuple tree of tensors (and generators) to `path`."""
    payload = {f"{i:04d}|{'/'.join(p)}": _to_numpy(p, leaf)
               for i, (p, leaf) in enumerate(_leaves(state))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
    os.replace(tmp, path)  # atomic


def _restore_leaf(key: str, a: np.ndarray, leaf):
    if isinstance(leaf, torch.Generator):
        if a.dtype != np.uint8 or a.shape != tuple(leaf.get_state().shape):
            warnings.warn(f"checkpoint: the generator state at {key} is of "
                          f"another kind of generator; kept the template's",
                          stacklevel=3)
            return leaf
        gen = torch.Generator(device=leaf.device)
        gen.set_state(torch.from_numpy(a.copy()))
        return gen
    if tuple(a.shape) != tuple(leaf.shape):
        raise ValueError(f"shape mismatch at {key}: ckpt {a.shape} vs "
                         f"template {tuple(leaf.shape)}")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device=leaf.device, dtype=leaf.dtype)


def _rebuild(tree, values, path=()):
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(**{f: _rebuild(getattr(tree, f), values, path + (f,))
                             for f in tree._fields})
    return values["/".join(path)]


def restore(path: str, template, strict: bool = False):
    """Load a checkpoint written by `save` (or by the JAX package's) into
    the structure of `template`, on the template's devices and dtypes."""
    with np.load(path) as data:
        by_path = {k.split("|", 1)[1]: data[k] for k in data.files}
    values, missing = {}, []
    for p, leaf in _leaves(template):
        key = "/".join(p)
        a = by_path.pop(key, None)
        if a is None:
            missing.append(key)
            values[key] = leaf
        else:
            values[key] = _restore_leaf(key, a, leaf)
    if missing or by_path:
        msg = (f"checkpoint {path}: {len(missing)} template leaves not in "
               f"checkpoint (kept template values): {missing[:4]}...; "
               f"{len(by_path)} checkpoint leaves unused: "
               f"{list(by_path)[:4]}...")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    return _rebuild(template, values)
