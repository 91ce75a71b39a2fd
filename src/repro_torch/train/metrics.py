"""Evaluation metrics matching the paper's Table 3 columns.

A copy of ``repro.train.metrics`` (host numpy)."""
from __future__ import annotations

import numpy as np


def accuracy(logits: np.ndarray, labels: np.ndarray,
             mask: np.ndarray) -> float:
    pred = logits.argmax(-1)
    m = mask.astype(bool)
    return float((pred[m] == labels[m]).mean())


def f1_micro(logits: np.ndarray, labels: np.ndarray,
             mask: np.ndarray, thresh: float = 0.0) -> float:
    """Micro-F1 for multilabel (Yelp). logits > 0 ⇔ sigmoid > 0.5."""
    m = mask.astype(bool)
    pred = (logits[m] > thresh)
    true = labels[m] > 0.5
    tp = float(np.sum(pred & true))
    fp = float(np.sum(pred & ~true))
    fn = float(np.sum(~pred & true))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def auc_score(logits: np.ndarray, labels: np.ndarray,
              mask: np.ndarray) -> float:
    """Mean ROC-AUC over label columns (ogbn-proteins metric)."""
    m = mask.astype(bool)
    s, t = logits[m], labels[m] > 0.5
    aucs = []
    for c in range(s.shape[1]):
        pos, neg = s[t[:, c], c], s[~t[:, c], c]
        if pos.size == 0 or neg.size == 0:
            continue
        ranks = np.concatenate([pos, neg]).argsort().argsort() + 1.0
        u = ranks[: pos.size].sum() - pos.size * (pos.size + 1) / 2
        aucs.append(u / (pos.size * neg.size))
    return float(np.mean(aucs)) if aucs else 0.5


def metric_fn(name: str):
    return {"accuracy": accuracy, "f1_micro": f1_micro, "auc": auc_score}[name]
