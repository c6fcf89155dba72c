"""Rank + set metrics: the port's own copy of ``unimp_tpu/evals/metrics.py``
(UniMP's ``pipeline/eval/rec_metrics.py`` semantics, in numpy).

Inputs are binary relevance vectors r (1 at ranks where the generated
beam exactly matched the target).
"""

from __future__ import annotations

import numpy as np


def mrr_at_k(r, k: int) -> float:
    """1/rank of the first hit within the top k, else 0."""
    hits = np.flatnonzero(np.asarray(r)[:k])
    return 1.0 / (hits[0] + 1) if hits.size else 0.0


def hit_at_k(r, k: int) -> float:
    return 1.0 if np.asarray(r)[:k].sum() > 0 else 0.0


def dcg_at_k(r, k: int) -> float:
    r = np.asarray(r, np.float64)[:k]
    if r.size == 0:
        return 0.0
    return float(np.sum(r / np.log2(np.arange(2, r.size + 2))))


def ndcg_at_k(r, k: int, len_gt: int) -> float:
    """DCG normalized by the ideal DCG for len_gt relevant items."""
    ideal = [1.0] * min(len_gt, k) + [0.0] * max(0, k - len_gt)
    dcg_max = dcg_at_k(ideal, k)
    if dcg_max == 0.0:
        return 0.0
    return dcg_at_k(r, k) / dcg_max


def precision_at_k(r, k: int) -> float:
    return float(np.mean(np.asarray(r)[:k]))


def recall_at_k(r, k: int, n_relevant: int) -> float:
    return float(np.asarray(r, np.float64)[:k].sum() / n_relevant)


def f1_score(precision: float, recall: float) -> float:
    if precision + recall > 0:
        return 2.0 * precision * recall / (precision + recall)
    return 0.0


def rank_metrics_for_hits(hits, ks=(3, 5, 10), len_gt: int = 1) -> dict:
    """hits: binary vector over returned beams (exact-match per rank)."""
    out = {}
    for k in ks:
        out[f"hr@{k}"] = hit_at_k(hits, k)
        out[f"ndcg@{k}"] = ndcg_at_k(hits, k, len_gt)
        out[f"mrr@{k}"] = mrr_at_k(hits, k)
    return out
