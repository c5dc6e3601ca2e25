"""The 3x3 SVD with the reflection rule, through `torch.linalg` (the
program runs a hand kernel for it)."""

from __future__ import annotations

import torch


def svd3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, S, Vt) of `a` (..., 3, 3) with U <- U diag(1, 1, d) and
    S <- S diag(1, 1, d), d = sign det(U Vt), so that U Vt is a rotation."""
    U, S, Vt = torch.linalg.svd(a)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.cat([torch.ones_like(S[..., :2]), d[..., None]], dim=-1))
    return U @ D, S * torch.diagonal(D, dim1=-2, dim2=-1), Vt
