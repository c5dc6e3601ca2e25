"""Batched symmetric eigendecomposition of 3x3 and 6x6 matrices without a
host read.

Counterpart of XLA's `jnp.linalg.eigh` and `jnp.linalg.eigvalsh` as the JAX
package calls them (`intensity_slam_tpu/ops/ground.py:56`,
`pipeline/mapping.py:167`, `ops/solver.py:185`); there is no Pallas source.
`torch.linalg.eigh` on the card reads a status back to the host after every
call, which stalls the host and cannot be captured into a CUDA graph, so
CUDA tensors launch the hand-written Jacobi kernels of `csrc/eigsym.cu` (a
3x3 on one thread, a 6x6 on one warp in round-robin rounds; each matrix
stops after a sweep that changed nothing, no status) or raise; CPU tensors
run the plain versions `eigh_plain` / `eigvalsh_plain`
(`torch.linalg.eigh` / `eigvalsh`), which are also the kernels' references
on the card.

- `eigh(a)`: a (..., 3, 3) -> eigenvalues (..., 3) ascending, eigenvectors
  (..., 3, 3) as columns (`vecs[..., :, i]`), the layout of
  `torch.linalg.eigh`.  An eigenvector's sign is free (as LAPACK's is);
  every caller is sign-invariant.
- `eigvalsh(a)`: a (..., n, n), n = 3 or 6 -> eigenvalues ascending.

Both read the lower triangle, take float32 or float64 and give zeros for
an all-zero matrix.  The kernels are compiled from the repository's
source at first use (`utils.nvcc`) into
`intensity_slam_tpu_torch/_build/libisl_eigsym.so`.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..utils import nvcc

SOURCE = os.path.join(nvcc.CSRC_DIR, "eigsym.cu")
LIBRARY = os.path.join(nvcc.BUILD_DIR, "libisl_eigsym.so")
SWEEPS = 12            # the most sweeps a matrix may take; 3x3 and 6x6 take 2-7

_lib = None


def build(verbose: bool = False) -> str:
    """Compile `csrc/eigsym.cu` unless the library is newer than its source.
    Returns nvcc's output (empty when up to date)."""
    return nvcc.build(SOURCE, LIBRARY, (), verbose)


def load(path: str) -> ctypes.CDLL:
    """The kernels' shared library at `path`, its C functions typed."""
    lib = ctypes.CDLL(path)
    lib.isl_eigsym_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.isl_eigsym_launch.restype = ctypes.c_int
    lib.isl_eigsym_error_string.argtypes = [ctypes.c_int]
    lib.isl_eigsym_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _lib
    if _lib is None:
        build()
        _lib = load(LIBRARY)
    return _lib


def eigh_plain(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.linalg.eigh(a)


def eigvalsh_plain(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.eigvalsh(a)


def _launch(a: torch.Tensor, vectors: bool, lib: ctypes.CDLL | None = None):
    """One launch of the kernels of `lib` (by default the build of
    `SOURCE`) on `a`: (vals, vecs or None)."""
    n = a.shape[-1]
    if a.dim() < 2 or a.shape[-2] != n or n not in ((3,) if vectors else (3, 6)):
        raise ValueError(f"no eigensolver kernel for shape {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"no eigensolver kernel for {a.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"no eigensolver kernel for {a.device}")
    lead = a.shape[:-2]
    flat = a.reshape((-1, n, n)).contiguous()
    batch = flat.shape[0]
    vals = torch.empty(lead + (n,), dtype=a.dtype, device=a.device)
    vecs = torch.empty(lead + (n, n), dtype=a.dtype, device=a.device) if vectors else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = lib or _library()
    rc = lib.isl_eigsym_launch(
        flat.data_ptr(), vals.data_ptr(), vecs.data_ptr() if vectors else None,
        batch, n, int(a.dtype == torch.float64), SWEEPS, stream)
    if rc != 0:
        raise RuntimeError("jacobi_kernel launch failed: "
                           + lib.isl_eigsym_error_string(rc).decode())
    return vals, vecs


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending, eigenvectors as columns) of the symmetric
    3x3 matrices `a` (..., 3, 3).  CUDA tensors launch the 3x3 Jacobi
    kernel, CPU tensors run `torch.linalg.eigh`."""
    if a.device.type == "cpu":
        return eigh_plain(a)
    return _launch(a, vectors=True)


def eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues ascending of the symmetric matrices `a` (..., n, n),
    n = 3 or 6.  CUDA tensors launch the Jacobi kernel of their size, CPU
    tensors run `torch.linalg.eigvalsh`."""
    if a.device.type == "cpu":
        return eigvalsh_plain(a)
    vals, _ = _launch(a, vectors=False)
    return vals
