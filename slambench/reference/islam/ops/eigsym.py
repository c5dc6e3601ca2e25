"""Symmetric eigenproblems through `torch.linalg` (the program runs hand
kernels for them)."""

from __future__ import annotations

import torch


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending, eigenvectors as columns) of `a` (..., 3, 3)."""
    return torch.linalg.eigh(a)


def eigvalsh(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues ascending of `a` (..., n, n)."""
    return torch.linalg.eigvalsh(a)
