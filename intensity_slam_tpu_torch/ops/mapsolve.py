"""The scan-to-map pose solve: `pipeline/mapping.py::mapping_step`'s robust
Gauss-Newton / Levenberg-Marquardt solve over its point-to-plane rows, its
6-dim pose prior, its point-to-line rows and (with the sliding window) its
point-to-point rows.

Counterpart of the JAX package's `solve_pose` call in its `mapping_step`
(a `lax.while_loop`, `intensity_slam_tpu/ops/solver.py:177`); there is no
Pallas source.  Each iteration of `solver.solve_pose` over that stack is
some 730 small PyTorch kernels (the rotation, the skew matrices, the three
residual sets and their Jacobians, the Huber weights, the prior's float64
central difference, the einsums, the damped solve, the trial cost), so CUDA
tensors launch the two hand-written kernels of `csrc/mapsolve.cu` instead,
or raise:

- the initial evaluation at the prior and the first step kernel (the
  initial cost, the loop's state, its test, the first candidate);
- a step an iteration: the evaluation at the candidate (residuals, Huber
  weights, Jacobians and the normal equations' partial sums, a block a few
  rows) and the step kernel (the sums in a fixed order, the prior block,
  accept or reject, the loop's test, the next candidate), under a
  conditional node on the test while the stream is captured
  (`utils.graph_cond.when`, region `REGION`), after a host read of it
  otherwise, as `solve_pose` iterates;
- the smallest eigenvalue of the final normal matrix from `ops.eigsym`.

CPU tensors run `solve_plain`: `solver.solve_pose` over
`solver.concat_residuals` of the residual closures, which is also the
kernels' reference on the card.  Every field of the returned `solver.SolveResult` means what it
means there; on the card the sums run in another order, so the numbers
agree to float32 rounding, not bit for bit.

`solve(...)` takes float32 tensors on one device: `prior` a `Pose` with
leading dims `lead` (none for one session, (B,) for B sessions, B <= 32),
`prior_sqrt_info` lead + (6,), `planes` = (points, normals, offsets,
weights) of shapes lead + (Gp, 3), lead + (Gp, 3), lead + (Gp,),
lead + (Gp,); `lines` = (points, a, b, weights), lead + (Gl, 3) and
lead + (Gl,), or None; `points` = (src, dst, weights), lead + (Gw, 3) and
lead + (Gw,), or None.  The kernels are compiled from the repository's source at first use (`utils.nvcc`) into
`intensity_slam_tpu_torch/_build/libisl_mapsolve.so`.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from ..utils import graph_cond, nvcc, se3
from ..utils.se3 import Pose
from . import eigsym, solver

SOURCE = os.path.join(nvcc.CSRC_DIR, "mapsolve.cu")
LIBRARY = os.path.join(nvcc.BUILD_DIR, "libisl_mapsolve.so")
REGION = "mapsolve"     # the conditional region of an iteration under capture
THREADS = 128           # rows a block takes at a time (`kThreads`)
SUMS = 28               # a block's partial sums: 21 of H, 6 of b, the cost
STATE = 64              # floats of a session's state row (`kStateSize`)
MAX_BLOCKS = 256
MAX_SESSIONS = 32
LM_LAMBDA0 = 1e-4       # solve_pose's defaults
GRAD_TOL = 1e-8

# the state row's fields (`csrc/mapsolve.cu`)
_Q, _T, _COST, _COST0, _LAM, _REL, _GNORM = 0, 4, 7, 8, 9, 10, 11

_lib = None


def build(verbose: bool = False) -> str:
    """Compile `csrc/mapsolve.cu` unless the library is newer than its
    source.  Returns nvcc's output (empty when up to date)."""
    return nvcc.build(SOURCE, LIBRARY, (), verbose)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.isl_mapsolve_eval.argtypes = ([p] * 4 + [i] + [p] * 4 + [i] + [p] * 3 + [i]
                                          + [p] * 4 + [i, f, p, i, i, p])
        lib.isl_mapsolve_eval.restype = i
        lib.isl_mapsolve_step.argtypes = [p, i] + [p] * 10 + [i, i, f, f, f, p]
        lib.isl_mapsolve_step.restype = i
        lib.isl_mapsolve_error_string.argtypes = [i]
        lib.isl_mapsolve_error_string.restype = ctypes.c_char_p
        lib.isl_mapsolve_state_size.restype = i
        if lib.isl_mapsolve_state_size() != STATE:
            raise RuntimeError("csrc/mapsolve.cu's state row does not match ops/mapsolve.py")
        _lib = lib
    return _lib


def pose_prior(prior: Pose, sqrt_info: torch.Tensor) -> solver.ResidualFn:
    """`solver.pose_prior` with a `jacobian`, so that the stack it joins
    keeps the analytic Jacobians of its thousands of point residuals (a
    stack with a part that has none is differentiated as a whole, in forward
    mode).

    The Jacobian of the one 6-dim block, d log(prior^-1 o p o exp(xi)) / d xi
    at 0, is a central difference in float64 over a batch of 12 poses (step
    1e-6: truncation ~1e-12, rounding ~1e-10, both far below float32's
    resolution; tests/test_torch_mapping.py holds it to `jacfwd`).
    `torch.func.jacfwd` gives the same numbers, but its per-operation host
    overhead made this one block the largest cost of the whole step
    (PERF.md)."""
    fn = solver.pose_prior(prior, sqrt_info)
    inv_prior = se3.pose_map(lambda a: a[..., None, :],
                             se3.inverse(Pose(prior.q.double(), prior.t.double())))
    h = 1e-6

    def jacobian(p: Pose) -> torch.Tensor:
        eye = torch.eye(6, dtype=torch.float64, device=p.t.device) * h
        moved = se3.retract(se3.pose_map(lambda a: a.double()[..., None, :], p),
                            torch.cat([eye, -eye]))
        r = se3.se3_log(se3.compose(inv_prior, moved))           # (12, 6)
        J = ((r[..., :6, :] - r[..., 6:, :]) / (2.0 * h)).transpose(-1, -2).to(
            p.t.dtype)                                           # (6, 6)
        return (sqrt_info[..., :, None] * J)[..., None, :, :]

    fn.jacobian = jacobian
    return fn


def solve_plain(prior: Pose, prior_sqrt_info: torch.Tensor, planes, lines=None, points=None,
                iters: int = 10, robust_scale: float = 0.2) -> solver.SolveResult:
    """`solver.solve_pose` from `prior` over the stacked residual closures
    (planes, the prior, lines, points): the CPU path and the kernels'
    reference."""
    sets = [(solver.point_to_plane_nd(*planes), 1), (pose_prior(prior, prior_sqrt_info), 6)]
    if lines is not None:
        sets.append((solver.point_to_line(*lines), 3))
    if points is not None:
        sets.append((solver.point_to_point(*points), 3))
    return solver.solve_pose(prior, solver.concat_residuals(*sets), iters=iters,
                             robust="huber", robust_scale=robust_scale)


def _check(prior: Pose, prior_sqrt_info, planes, lines, points) -> tuple:
    """The leading dims of a valid call; raises on a wrong dtype, shape or
    device."""
    lead = tuple(prior.q.shape[:-1])
    dev = prior.q.device
    parts = [("prior.q", prior.q, lead + (4,)), ("prior.t", prior.t, lead + (3,)),
             ("prior_sqrt_info", prior_sqrt_info, lead + (6,))]
    if planes is None:
        raise ValueError("mapsolve: the plane rows are missing")
    for name, group, widths in (("planes", planes, (3, 3, None, None)),
                                ("lines", lines, (3, 3, 3, None)),
                                ("points", points, (3, 3, None))):
        if group is None:
            continue
        if len(group) != len(widths):
            raise ValueError(f"mapsolve: {name} holds {len(widths)} tensors, not {len(group)}")
        first = group[0]
        rows = first.shape[len(lead)] if isinstance(first, torch.Tensor) \
            and first.dim() > len(lead) else 0
        parts += [(f"{name}[{k}]", x, lead + (rows,) + ((w,) if w else ()))
                  for k, (x, w) in enumerate(zip(group, widths))]
    for name, x, shape in parts:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"mapsolve: {name} is not a tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"mapsolve: {name} is {x.dtype}, not float32")
        if x.device != dev:
            raise ValueError(f"mapsolve: {name} is on {x.device}, the prior on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"mapsolve: {name} has shape {tuple(x.shape)}, not {shape}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"mapsolve: no solve on {dev}")
    if len(lead) > 1 or (lead and not 1 <= lead[0] <= MAX_SESSIONS):
        raise ValueError(f"mapsolve: leading dims {lead}: one session, or (B,) with "
                         f"1 <= B <= {MAX_SESSIONS}")
    return lead


def solve(prior: Pose, prior_sqrt_info: torch.Tensor, planes, lines=None, points=None,
          iters: int = 10, robust_scale: float = 0.2) -> solver.SolveResult:
    """The solve from `prior` (see the module docstring): CPU tensors run
    `solve_plain`, CUDA tensors the kernels."""
    lead = _check(prior, prior_sqrt_info, planes, lines, points)
    if prior.q.device.type == "cpu":
        return solve_plain(prior, prior_sqrt_info, planes, lines, points, iters, robust_scale)
    return _solve_kernels(lead, prior, prior_sqrt_info, planes, lines, points, iters,
                          robust_scale)


def _solve_kernels(lead, prior, prior_sqrt_info, planes, lines, points, iters,
                   robust_scale) -> solver.SolveResult:
    dev = prior.q.device
    B = lead[0] if lead else 1
    flat = lambda x: x.reshape((B,) + tuple(x.shape[len(lead):])).contiguous()
    pq, pt, si = flat(prior.q), flat(prior.t), flat(prior_sqrt_info)
    none = torch.zeros((B, 0, 3), dtype=torch.float32, device=dev)
    P = [flat(x) for x in planes]
    L = [flat(x) for x in lines] if lines is not None else [none, none, none, none[..., 0]]
    W = [flat(x) for x in points] if points is not None else [none, none, none[..., 0]]
    gp, gl, gw = P[0].shape[1], L[0].shape[1], W[0].shape[1]
    blocks = min(max(1, math.ceil((gp + gl + gw) / THREADS)), MAX_BLOCKS)

    f32 = dict(dtype=torch.float32, device=dev)
    partials = torch.empty((B, blocks, SUMS), **f32)
    state = torch.empty((B, STATE), **f32)       # the step kernel fills what is read
    hfull = torch.empty((B, 6, 6), **f32)
    its = torch.empty((B,), dtype=torch.int32, device=dev)
    rej = torch.empty((B,), dtype=torch.int32, device=dev)
    active = torch.empty((B,), dtype=torch.bool, device=dev)
    converged = torch.empty((B,), dtype=torch.bool, device=dev)
    any_active = torch.empty((), dtype=torch.bool, device=dev)
    lib = _library()
    rows = [x.data_ptr() for x in P[:4]] + [gp] + [x.data_ptr() for x in L] + [gl] \
        + [x.data_ptr() for x in W] + [gw]

    def pair(init: bool) -> None:
        """The evaluation (at the prior, else at the candidate) and the step
        kernel on the current stream (a node's body stream under capture)."""
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.isl_mapsolve_eval(*rows, pq.data_ptr(), pt.data_ptr(), state.data_ptr(),
                                   active.data_ptr(), int(init), robust_scale,
                                   partials.data_ptr(), blocks, B, stream)
        if rc == 0:
            rc = lib.isl_mapsolve_step(
                partials.data_ptr(), blocks, pq.data_ptr(), pt.data_ptr(), si.data_ptr(),
                state.data_ptr(), hfull.data_ptr(), its.data_ptr(), rej.data_ptr(),
                active.data_ptr(), converged.data_ptr(), any_active.data_ptr(), B, int(init),
                robust_scale, LM_LAMBDA0, GRAD_TOL, stream)
        if rc != 0:
            raise RuntimeError("mapsolve kernel launch failed: "
                               + lib.isl_mapsolve_error_string(rc).decode())

    pair(True)
    captured = graph_cond.capturing(dev)
    for _ in range(iters):
        if captured:
            with graph_cond.when(any_active, REGION) as taken:
                if taken:
                    pair(False)
        elif bool(any_active):
            pair(False)
        else:
            break
    shape = lambda x, *tail: x.reshape(tuple(lead) + tail)
    return solver.SolveResult(
        pose=Pose(shape(state[:, _Q:_Q + 4], 4), shape(state[:, _T:_T + 3], 3)),
        final_cost=shape(state[:, _COST]),
        initial_cost=shape(state[:, _COST0]),
        iterations=shape(its),
        converged=shape(converged),
        min_hessian_eig=eigsym.eigvalsh(shape(hfull, 6, 6))[..., 0],
        damping=shape(state[:, _LAM]),
        rel_decrease=shape(state[:, _REL]),
        rejections=shape(rej),
        grad_norm=shape(state[:, _GNORM]),
    )
