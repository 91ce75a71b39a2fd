"""Column-row pair scoring and top-k selection (paper §2.2, Eq. 2–3).

The port of ``repro.core.sampling``. The device half (``row_norms``,
``pair_scores``, ``sampling_probs``) works on torch tensors; the host
selection (``topk_pairs``, ``block_scores``, ``topk_sample_indices``,
``topk_overlap_auc``) is a copy of the reference's numpy, so one input
gives bit-identical scores and selections in both packages.
"""
from __future__ import annotations

import numpy as np
import torch


# ----------------------------- device helpers -----------------------------

def row_norms(x: torch.Tensor) -> torch.Tensor:
    """‖X_{i,:}‖₂ per row, f32 accumulation."""
    x32 = x.float()
    return torch.sqrt(torch.sum(x32 * x32, dim=-1))


def pair_scores(col_norm: torch.Tensor,
                grad_row_norm: torch.Tensor) -> torch.Tensor:
    """Eq. 3 numerator: ‖Ã^T_{:,i}‖₂ · ‖∇H_{i,:}‖₂ per pair i."""
    return col_norm * grad_row_norm


def sampling_probs(col_norm: torch.Tensor,
                   grad_row_norm: torch.Tensor) -> torch.Tensor:
    """Eq. 3: normalized sampling distribution over column-row pairs."""
    s = pair_scores(col_norm, grad_row_norm)
    return s / torch.clamp(torch.sum(s), min=1e-30)


# ----------------------------- host selection ------------------------------

def topk_pairs(scores: np.ndarray, k: int) -> np.ndarray:
    """Deterministic top-k (Adelman-style §2.2.1): boolean keep mask."""
    k = int(np.clip(k, 0, scores.shape[0]))
    mask = np.zeros(scores.shape[0], dtype=bool)
    if k:
        idx = np.argpartition(-scores, k - 1)[:k]
        mask[idx] = True
    return mask


def block_scores(
    col_norm: np.ndarray,
    grad_row_norm: np.ndarray,
    bk: int,
    n_col_blocks: int,
) -> np.ndarray:
    """Aggregate pair scores per ``bk``-wide column block."""
    s = (col_norm.astype(np.float64) * grad_row_norm.astype(np.float64))
    out = np.zeros(n_col_blocks, dtype=np.float64)
    cb = np.arange(s.shape[0]) // bk
    np.add.at(out, cb, s)
    return out


def topk_sample_indices(
    probs: np.ndarray, k: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Drineas et al. randomized sampling (Eq. 2): indices + 1/(k·p) scales.

    Kept as the stochastic baseline the paper compares against; RSC itself
    uses deterministic top-k without scaling.
    """
    idx = rng.choice(probs.shape[0], size=k, replace=True, p=probs)
    scale = 1.0 / (k * probs[idx])
    return idx.astype(np.int64), scale.astype(np.float32)


def topk_overlap_auc(prev_scores: np.ndarray, new_keep: np.ndarray) -> float:
    """Fig. 4 metric: AUC of old scores ranking the new keep set.

    1.0 means the ranking is unchanged between refreshes — the stability that
    justifies the caching mechanism.
    """
    pos = prev_scores[new_keep]
    neg = prev_scores[~new_keep]
    if pos.size == 0 or neg.size == 0:
        return 1.0
    # Mann-Whitney U via rank sums.
    allv = np.concatenate([pos, neg])
    ranks = allv.argsort().argsort().astype(np.float64) + 1
    r_pos = ranks[: pos.size].sum()
    u = r_pos - pos.size * (pos.size + 1) / 2
    return float(u / (pos.size * neg.size))
