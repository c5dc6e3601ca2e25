"""Batched 3x3 singular value decomposition with the reflection fixed, without
a host read: the rotation of the ICP's closed-form update.

Counterpart of XLA's `jnp.linalg.svd` and the reflection rule after it in
the JAX package's `_umeyama_step` (`intensity_slam_tpu/ops/icp.py:58-61`);
there is no Pallas source.  `torch.linalg.svd` on the card reads a status
back to the host after every call, which stalls the host and cannot be
captured into a CUDA graph, so CUDA tensors launch the hand-written kernel
of `csrc/svd3.cu` (one thread a matrix, a fixed number of one-sided Jacobi
sweeps) or raise; CPU tensors run the plain version `svd3_plain`
(`torch.linalg.svd` and the reference's rule), which is also the kernel's
reference on the card.

`svd3(a)`: a (..., 3, 3) -> (U, S, Vt) with U diag(S) Vt = a and the
reflection fixed, so that `U @ Vt` is the reference's rotation
U diag(1, 1, sign det(U V^T)) V^T: the last column of U and the last value
of S carry the sign.  The singular vectors' signs are free (as LAPACK's
are), so compare rotations, not U and V.  Takes float32 or float64.  The
kernel is compiled from the repository's source at first use (`utils.nvcc`) into
`intensity_slam_tpu_torch/_build/libisl_svd3.so`.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..utils import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "svd3.cu")
LIBRARY = os.path.join(nvcc.BUILD_DIR, "libisl_svd3.so")
SWEEPS = 8             # a 3x3 meets float32 precision in 3-5

_lib = None


def build(verbose: bool = False) -> str:
    """Compile `csrc/svd3.cu` unless the library is newer than its source.
    Returns nvcc's output (empty when up to date)."""
    return nvcc.build(SOURCE, LIBRARY, (), verbose)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.isl_svd3_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.isl_svd3_launch.restype = ctypes.c_int
        lib.isl_svd3_error_string.argtypes = [ctypes.c_int]
        lib.isl_svd3_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def svd3_plain(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`torch.linalg.svd` with the reference's reflection rule folded into U
    and S: U <- U diag(1, 1, d), S <- S diag(1, 1, d), d = sign det(U Vt)."""
    U, S, Vt = torch.linalg.svd(a)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.cat([torch.ones_like(S[..., :2]), d[..., None]], dim=-1))
    return U @ D, S * torch.diagonal(D, dim1=-2, dim2=-1), Vt


def svd3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, S, Vt) of the 3x3 matrices `a` (..., 3, 3), the reflection fixed
    (`U @ Vt` a rotation).  CUDA tensors launch the kernel, CPU tensors run
    `svd3_plain`."""
    if a.device.type == "cpu":
        return svd3_plain(a)
    if a.dim() < 2 or a.shape[-2:] != (3, 3):
        raise ValueError(f"no 3x3 SVD kernel for shape {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"no 3x3 SVD kernel for {a.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"no 3x3 SVD kernel for {a.device}")
    lead = a.shape[:-2]
    flat = a.reshape((-1, 3, 3)).contiguous()
    U = torch.empty(lead + (3, 3), dtype=a.dtype, device=a.device)
    S = torch.empty(lead + (3,), dtype=a.dtype, device=a.device)
    Vt = torch.empty(lead + (3, 3), dtype=a.dtype, device=a.device)
    lib = _library()
    rc = lib.isl_svd3_launch(flat.data_ptr(), U.data_ptr(), S.data_ptr(), Vt.data_ptr(),
                             flat.shape[0], int(a.dtype == torch.float64), SWEEPS,
                             torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("svd3_kernel launch failed: "
                           + lib.isl_svd3_error_string(rc).decode())
    return U, S, Vt
