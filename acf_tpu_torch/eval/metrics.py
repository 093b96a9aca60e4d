"""Closed-form leave-one-out ranking metrics (counterpart of
``acf_tpu/eval/metrics.py``; numpy on the host, as there).

Given the rank position of the held-out item (the number of candidates
scoring >= it):

    hr[k]   = position < k
    ndcg[k] = log(2) / log(position + 2)   if position < k else 0
    auc     = 1 - position / num_negatives
"""

from __future__ import annotations

import numpy as np


def metrics_from_position(position, num_negatives, K: int = 100):
    """Vectorized HR@1..K, NDCG@1..K, AUC from rank positions.

    Args:
      position: [U] int — number of candidates scoring >= the held-out item
        (0 = ranked first).
      num_negatives: [U] int — per-user candidate-set size (excluding the gt).
      K: max cutoff.

    Returns:
      (hr, ndcg, auc): hr/ndcg are [U, K] float32, auc is [U] float32.
    """
    position = np.asarray(position)
    num_negatives = np.asarray(num_negatives)
    ks = np.arange(1, K + 1)  # [K]
    hit = position[:, None] < ks[None, :]  # [U, K]
    with np.errstate(divide="ignore"):
        # all-f32 arithmetic: np.log(2.0) is a float64 scalar that would
        # promote the quotient under NEP 50 and shift NDCG by an ulp
        dcg = (np.float32(np.log(2.0))
               / np.log(position.astype(np.float32) + np.float32(2.0)))  # [U]
    hr = hit.astype(np.float32)
    ndcg = np.where(hit, dcg[:, None], 0.0).astype(np.float32)
    auc = (1.0 - position.astype(np.float32) / np.maximum(
        num_negatives.astype(np.float32), 1.0)).astype(np.float32)
    return hr, ndcg, auc


def mean_metrics(hr, ndcg, auc, k: int = 10):
    """Mean HR@k / NDCG@k / AUC over users as python floats."""
    hr = np.asarray(hr)
    ndcg = np.asarray(ndcg)
    auc = np.asarray(auc)
    return float(hr[:, k - 1].mean()), float(ndcg[:, k - 1].mean()), float(auc.mean())
