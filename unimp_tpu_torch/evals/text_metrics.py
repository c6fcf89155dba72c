"""Hermetic text-generation metrics: BLEU, ROUGE-1/2/L, METEOR.

The port's own copy of ``unimp_tpu/evals/text_metrics.py``. The reference
pulls these from HF ``evaluate`` (downloads at run time, UniMP's
pipeline/eval/eval_exp.py:63-67); here they are pure Python, so the
evaluation runs offline:

  * bleu(): corpus-level BLEU with clipped n-gram precisions and brevity
    penalty; the reference reports precisions[0] (clipped unigram
    precision), exposed here as "precision1".
  * rouge_n()/rouge_l(): F-measure of n-gram overlap / LCS.
  * meteor(): exact-match METEOR (F_mean with alpha=0.9 and the
    standard chunk-fragmentation penalty gamma=0.5, beta=3) — no WordNet
    synonym/stem stage, which requires corpus downloads.

BERTScore (the reference's eval_embed flag) is ``evals/bertscore.py``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(predictions: List[str], references: List[str], max_n: int = 4) -> dict:
    """Corpus BLEU. references: one reference per prediction."""
    clipped = [0] * max_n
    total = [0] * max_n
    pred_len = ref_len = 0
    for pred, ref in zip(predictions, references):
        p_toks, r_toks = pred.split(), ref.split()
        pred_len += len(p_toks)
        ref_len += len(r_toks)
        for n in range(1, max_n + 1):
            p_ng = _ngrams(p_toks, n)
            r_ng = _ngrams(r_toks, n)
            clipped[n - 1] += sum(min(c, r_ng[g]) for g, c in p_ng.items())
            total[n - 1] += max(sum(p_ng.values()), 0)
    precisions = [
        (clipped[i] / total[i]) if total[i] > 0 else 0.0 for i in range(max_n)
    ]
    if min(precisions) > 0:
        log_avg = sum(math.log(p) for p in precisions) / max_n
        geo = math.exp(log_avg)
    else:
        geo = 0.0
    bp = 1.0 if pred_len > ref_len else (
        math.exp(1 - ref_len / pred_len) if pred_len > 0 else 0.0
    )
    return {
        "bleu": bp * geo,
        "precisions": precisions,
        "precision1": precisions[0],
        "brevity_penalty": bp,
    }


def _fmeasure(p: float, r: float) -> float:
    return 2 * p * r / (p + r) if p + r > 0 else 0.0


def rouge_n(predictions: List[str], references: List[str], n: int) -> float:
    scores = []
    for pred, ref in zip(predictions, references):
        p_ng = _ngrams(pred.split(), n)
        r_ng = _ngrams(ref.split(), n)
        overlap = sum(min(c, r_ng[g]) for g, c in p_ng.items())
        p = overlap / max(sum(p_ng.values()), 1)
        r = overlap / max(sum(r_ng.values()), 1)
        scores.append(_fmeasure(p, r))
    return float(sum(scores) / max(len(scores), 1))


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(predictions: List[str], references: List[str]) -> float:
    scores = []
    for pred, ref in zip(predictions, references):
        p_toks, r_toks = pred.split(), ref.split()
        lcs = _lcs_len(p_toks, r_toks)
        p = lcs / max(len(p_toks), 1)
        r = lcs / max(len(r_toks), 1)
        scores.append(_fmeasure(p, r))
    return float(sum(scores) / max(len(scores), 1))


def _meteor_single(pred: str, ref: str, alpha=0.9, beta=3.0, gamma=0.5) -> float:
    p_toks, r_toks = pred.split(), ref.split()
    if not p_toks or not r_toks:
        return 0.0
    # greedy exact alignment preserving order for chunk counting
    used = [False] * len(r_toks)
    align = []  # (pred_idx, ref_idx)
    for i, tok in enumerate(p_toks):
        for j, rtok in enumerate(r_toks):
            if not used[j] and tok == rtok:
                used[j] = True
                align.append((i, j))
                break
    m = len(align)
    if m == 0:
        return 0.0
    precision = m / len(p_toks)
    recall = m / len(r_toks)
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    # chunks: maximal runs contiguous in both strings
    align.sort()
    chunks = 1
    for (pi, ri), (pj, rj) in zip(align, align[1:]):
        if pj != pi + 1 or rj != ri + 1:
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return fmean * (1 - penalty)


def meteor(predictions: List[str], references: List[str]) -> float:
    scores = [_meteor_single(p, r) for p, r in zip(predictions, references)]
    return float(sum(scores) / max(len(scores), 1))
