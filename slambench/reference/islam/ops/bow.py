"""Appearance loop detection from binary descriptors — the DBoW3
replacement (C8).

PyTorch counterpart of `intensity_slam_tpu/ops/bow.py`: a keyframe's
signature is its S strongest descriptors plus a validity word; the score of
a history keyframe is the fraction of the current keyframe's descriptors
with a MUTUAL nearest neighbour there at Hamming <= MUT_HAMMING bits.
"""

from __future__ import annotations

import torch

from ..config import LoopConfig
from ..utils import index
from .features import hamming_matrix

SIG_FEATURES = 256    # strongest descriptors kept per keyframe
MUT_HAMMING = 24      # max bits (of 256) for a mutual match to count
_CHUNK = 128          # history keyframes per Hamming pass (bounds the
# (C, S, S) transient as the JAX package's chunked map does; a chunk's +-1
# history is C x S x 256 float32, 33.5 MB)


def signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, 8) int32 descriptor words + (F,) mask -> (S, 9) int32 signature:
    the S strongest descriptors (detection order is strength order) with
    their validity as a 9th word."""
    F = desc.shape[0]
    S = SIG_FEATURES
    if F >= S:
        d, v = desc[:S], valid[:S]
    else:
        d = torch.zeros((S, 8), dtype=torch.int32, device=desc.device)
        d[:F] = desc
        v = torch.zeros((S,), dtype=torch.bool, device=desc.device)
        v[:F] = valid
    return torch.cat([d, v.to(torch.int32)[:, None]], dim=-1)


def _chunk_scores(cd, cv, hd, hv):
    """cur (S,8)+(S,) vs hist chunk (C,S,8)+(C,S) -> (C,) mutual-match
    fraction.  The (C, S, S) Hamming tensor is one batched float32 product
    of the descriptors' bits as +-1 (`features.hamming_matrix`): the
    reference's popcount sums exactly, whatever the summation order."""
    S = cd.shape[0]
    h = hamming_matrix(cd[None], hd)
    h = torch.where(hv[:, None, :], h, 4096)
    h = torch.where(cv[None, :, None], h, 4096)
    best = torch.amin(h, dim=2)                     # (C, S)
    fwd = torch.argmin(h, dim=2)
    bwd = torch.argmin(h, dim=1)                    # (C, S)
    mutual = torch.gather(bwd, 1, fwd) == torch.arange(S, device=cd.device)[None, :]
    ok = cv[None, :] & (best <= MUT_HAMMING) & mutual
    return torch.sum(ok, dim=1) / torch.clamp(torch.sum(cv), min=1)


def detect_loop(
    cur_sig: torch.Tensor,      # (S, 9) int32
    hist_sig: torch.Tensor,     # (K, S, 9)
    hist_valid: torch.Tensor,   # (K,)
    cur_idx: torch.Tensor,      # ()
    cfg: LoopConfig,
):
    """Returns (loop_idx (), score (), found ()).

    Candidates exclude the most recent `min_loop_search_gap` keyframes
    (`spot.yaml:39`); accept when the best mutual-match fraction exceeds
    `bow_score_threshold`."""
    K = hist_sig.shape[0]
    cd, cv = cur_sig[:, :8], cur_sig[:, 8] > 0
    hd, hv = hist_sig[:, :, :8], hist_sig[:, :, 8] > 0
    s = torch.cat([_chunk_scores(cd, cv, hd[i:i + _CHUNK], hv[i:i + _CHUNK])
                   for i in range(0, K, _CHUNK)])
    eligible = hist_valid & (
        torch.arange(K, device=hist_valid.device) < cur_idx - cfg.min_loop_search_gap
    )
    s = torch.where(eligible, s, -torch.inf)
    best = torch.argmax(s)
    best_score = index.take(s, best)
    found = best_score > cfg.bow_score_threshold
    return best.to(torch.int32), best_score, found
