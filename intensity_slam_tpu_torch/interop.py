"""Carry state between the JAX package and the port as numpy arrays.

`state_from_numpy` turns a nested NamedTuple of numpy arrays (a JAX state
after `jax.tree.map(np.asarray, st)`) into the port's state, field by field;
`state_to_numpy` goes the other way; `config_from_dict` rebuilds the port's
`SlamConfig` from `dataclasses.asdict` of a JAX config.  Neither side's
package is imported: the types are matched by their class names.

uint32 words (descriptors, signatures) live in the port as int32 tensors with
the same bit pattern; `state_to_numpy` returns them as uint32 again for the
fields listed in `UINT32_FIELDS`.

`slam_state_from_numpy` and `slam_state_to_numpy` carry the per-frame
`SlamState`: only the JAX state's `rng` (a `jax.random` key) has no
counterpart, so the port's state gets a fresh `torch.Generator` and the way
back returns a dict of the shared fields.  `state_from_numpy` takes a whole
JAX `FusedState` the same way, so the port can start in the middle of a
reference run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as C
from .ops import curvature, features, grid_hash, ground
from .pipeline import (fused, geometric, loop, mapping, odometry, posegraph,
                       slam)
from .utils import se3

UINT32_FIELDS = frozenset({"desc", "prev_desc", "kf_sig", "kf_feat_desc",
                           "feat_desc", "win_desc"})

_TYPES = {t.__name__: t for t in (
    se3.Pose, features.Features, odometry.OdometryState, posegraph.PoseGraph,
    loop.BackendState, geometric.GeometricState, curvature.FeatureClouds,
    ground.GroundResult, grid_hash.VoxelHashMap, mapping.MappingState,
    fused.FrameLog, fused.FusedState)}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)           # a writable C-ordered copy; keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def state_from_numpy(tree, device="cuda", seed: int = 0):
    """Nested NamedTuple of numpy arrays -> the port's NamedTuple of tensors
    (same class names and fields).  A `SlamState` inside (or the dict that
    `slam_state_to_numpy` makes of one) goes through
    `slam_state_from_numpy`, its generator seeded with `seed`."""
    if isinstance(tree, dict) or type(tree).__name__ == "SlamState":
        return slam_state_from_numpy(tree, seed=seed, device=device)
    if hasattr(tree, "_fields"):
        cls = _TYPES[type(tree).__name__]
        return cls(**{f: state_from_numpy(getattr(tree, f), device, seed)
                      for f in tree._fields})
    if tree is None:
        return None
    return _to_tensor(tree, device)


def state_to_numpy(state, _name: str = ""):
    """The port's NamedTuple of tensors -> the same structure of numpy
    arrays (uint32 words restored for `UINT32_FIELDS`)."""
    if isinstance(state, slam.SlamState):
        return slam_state_to_numpy(state)
    if hasattr(state, "_fields"):
        return type(state)(**{f: state_to_numpy(getattr(state, f), f)
                              for f in state._fields})
    if state is None:
        return None
    a = state.detach().cpu().numpy()
    return a.view(np.uint32) if _name in UINT32_FIELDS else a


def _build(cls, d: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default_factory if f.default_factory
                                    is not dataclasses.MISSING else None):
            v = _build(f.default_factory, v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    return cls(**kw)


def config_from_dict(d: dict) -> C.SlamConfig:
    """`SlamConfig` from `dataclasses.asdict` of either package's config."""
    return _build(C.SlamConfig, d)


_SLAM_SHARED = ("odo", "geo", "mapping", "merged_pose", "last_delta")


def slam_state_from_numpy(tree, seed: int = 0, device="cuda") -> slam.SlamState:
    """The JAX package's `SlamState` as numpy (any object with `odo`, `geo`,
    `mapping`, `merged_pose`, `last_delta`, or a dict of them) -> the port's
    `SlamState`.  `rng` is left behind; the generator is seeded with `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    get = tree.get if isinstance(tree, dict) else lambda f: getattr(tree, f)
    return slam.SlamState(
        gen=gen, **{f: state_from_numpy(get(f), device) for f in _SLAM_SHARED})


def slam_state_to_numpy(state: slam.SlamState) -> dict:
    """The fields the two packages' `SlamState`s share, as numpy (ring ids
    int32, descriptor words uint32), keyed by field name."""
    return {f: state_to_numpy(getattr(state, f), f) for f in _SLAM_SHARED}
