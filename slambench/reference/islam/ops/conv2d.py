"""Separable image filtering over the (H, W) scan image.

PyTorch counterpart of `intensity_slam_tpu/ops/conv2d.py`.  The JAX package
writes the row pass as a banded-matrix product because that is what the TPU's
matrix unit eats; here both passes are plain sums of shifted copies, taken in
ascending tap order with zero taps skipped — elementwise work with no matrix
and no convolution library call, so the arithmetic is the same on the CPU and
on the card and no TF32 path can touch it.

Boundary semantics match the JAX package: rows (elevation) edge-clamp,
columns (azimuth) wrap.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tuple(kernel) -> tuple[float, ...]:
    return tuple(float(v) for v in np.asarray(kernel, np.float64).ravel())


def _taps(kernel):
    ker = _as_tuple(kernel)
    r = len(ker) // 2
    return [(d, np.float32(kv).item()) for d, kv in zip(range(-r, r + 1), ker)
            if kv != 0.0]


def _shift_index(n: int, d: int, mode: str, device) -> torch.Tensor:
    i = torch.arange(n, device=device) + d
    return i % n if mode == "wrap" else torch.clamp(i, 0, n - 1)


def filter_rows(img: torch.Tensor, kernel, mode: str = "edge") -> torch.Tensor:
    """Correlate along axis -2 (image rows / elevation). img: (..., H, W)."""
    H = img.shape[-2]
    out = torch.zeros_like(img, dtype=torch.float32)
    for d, kv in _taps(kernel):
        out = out + kv * img[..., _shift_index(H, d, mode, img.device), :]
    return out


def filter_cols(img: torch.Tensor, kernel, mode: str = "wrap") -> torch.Tensor:
    """Correlate along axis -1 (image columns / azimuth). img: (..., H, W)."""
    W = img.shape[-1]
    out = torch.zeros_like(img, dtype=torch.float32)
    for d, kv in _taps(kernel):
        out = out + kv * img[..., _shift_index(W, d, mode, img.device)]
    return out


def sep_filter(img: torch.Tensor, col_kernel, row_kernel,
               row_mode: str = "edge", col_mode: str = "wrap") -> torch.Tensor:
    """Separable correlation: `col_kernel` down rows, `row_kernel` across
    columns (col_kernel has one weight per row offset)."""
    return filter_cols(filter_rows(img, col_kernel, row_mode),
                       row_kernel, col_mode)


def box_filter(img: torch.Tensor, k: int, normalize: bool = True,
               row_mode: str = "edge", col_mode: str = "wrap") -> torch.Tensor:
    """k x k box filter (the BRIEF blur / structure-tensor window)."""
    w = (1.0 / k) if normalize else 1.0
    ker = np.full(k, w, np.float32)
    return sep_filter(img, ker, ker, row_mode, col_mode)


_SOBEL_D = np.array([1.0, 0.0, -1.0], np.float32) / 8.0 * -1.0  # d/dx = [-1,0,1]/8
_SOBEL_S = np.array([1.0, 2.0, 1.0], np.float32)


def sobel(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel gradients (gx across columns, gy down rows), edge rows / wrap
    columns, matching the original 3x3 kernels (/8 normalization)."""
    gx = sep_filter(img, _SOBEL_S, _SOBEL_D, "edge", "wrap")
    gy = sep_filter(img, _SOBEL_D, _SOBEL_S, "edge", "wrap")
    return gx, gy
