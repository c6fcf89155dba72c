"""Hermetic BERTScore: embedding-based P/R/F1 without hub access.

Counterpart of ``unimp_tpu/evals/bertscore.py``. The reference's
``--eval_embed`` path loads HF ``evaluate``'s bertscore (a downloaded
RoBERTa) and reports per-pair F1 (UniMP's pipeline/eval/eval_exp.py:63-67,
143-171). This module keeps the *score definition* — greedy token
matching by cosine similarity between contextual embeddings —

    P = mean over candidate tokens of max_j cos(c_i, r_j)
    R = mean over reference tokens of max_i cos(c_i, r_j)
    F1 = 2PR / (P + R)

— over an encoder at hand: the UniMP model's own text tower (final-norm
hidden states, ``return_hidden=True``). The embeddings are causal rather
than bidirectional, which keeps the metric's ordering (identical texts
score 1.0, paraphrases high, unrelated low) with no network. IDF
weighting is off, as in the reference's ``metric_3.compute(lang="en")``.
"""

from __future__ import annotations

import numpy as np
import torch

from unimp_tpu_torch.parallel.mesh import lockstep_calls


def greedy_match_scores(cand_emb, cand_mask, ref_emb, ref_mask):
    """Batched greedy-matching P/R/F1.

    cand_emb [N, Tc, D], ref_emb [N, Tr, D], masks [N, T] (1 = real
    token). Returns (P, R, F1) arrays [N] in float64.
    """
    c = np.asarray(cand_emb, np.float64)
    r = np.asarray(ref_emb, np.float64)
    cm = np.asarray(cand_mask, bool)
    rm = np.asarray(ref_mask, bool)
    c /= np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)
    r /= np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
    sim = np.einsum("ncd,nrd->ncr", c, r)
    valid = cm[:, :, None] & rm[:, None, :]
    sim = np.where(valid, sim, -1.0)
    n_c = np.maximum(cm.sum(-1), 1)
    n_r = np.maximum(rm.sum(-1), 1)
    p = np.where(cm, sim.max(-1), 0.0).sum(-1) / n_c
    rr = np.where(rm, sim.max(1), 0.0).sum(-1) / n_r
    f1 = np.where(p + rr > 0, 2 * p * rr / np.maximum(p + rr, 1e-12), 0.0)
    return p, rr, f1


def make_model_bertscore(model, tokenizer, *, max_len: int = 64, batch_size: int = 16):
    """Scorer ``f(cands, refs) -> F1 [N]`` over the model's text tower, on
    the model's device.

    Texts are tokenized and right-padded to a fixed window of ``max_len``,
    and encoded in batches of ``batch_size`` (the last one padded with
    empty rows, as the JAX package keeps one compiled shape); pad
    positions are masked out of the matching. Drop-in for
    ``evaluate_exp(bertscore_fn=...)``.
    """
    device = next(model.parameters()).device
    pad_id = tokenizer.pad_token_id

    @torch.no_grad()
    def encode(ids, lens):
        h, _ = model(torch.from_numpy(ids).long().to(device),
                     kv_len=torch.from_numpy(lens).long().to(device), return_hidden=True)
        return h.float().cpu().numpy()

    def embed_texts(texts):
        ids = np.full((len(texts), max_len), pad_id, np.int32)
        lens = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            e = tokenizer.encode(t or "Empty")[:max_len]
            ids[i, : len(e)] = e
            lens[i] = len(e)
        embs = []
        # a ZeRO-3 model's forwards gather over fsdp: every rank encodes as
        # many batches as the rank with the most (the extra ones dropped)
        n = -(-len(texts) // batch_size)
        for _ in range(lockstep_calls(model, n) - n):
            encode(np.full((batch_size, max_len), pad_id, np.int32),
                   np.ones((batch_size,), np.int32))
        for s in range(0, len(texts), batch_size):
            chunk = slice(s, s + batch_size)
            n = ids[chunk].shape[0]
            pad = batch_size - n
            embs.append(encode(
                np.concatenate([ids[chunk], np.full((pad, max_len), pad_id, np.int32)]),
                np.concatenate([lens[chunk], np.zeros((pad,), np.int32)]))[:n])
        emb = np.concatenate(embs) if embs else np.zeros((0, max_len, 1))
        mask = np.arange(max_len)[None, :] < lens[:, None]
        return emb, mask

    def score(cands, refs):
        assert len(cands) == len(refs)
        if not cands:
            if getattr(model, "zero", None) is not None:
                embed_texts([]), embed_texts([])  # keep step with the other ranks
            return np.zeros((0,))
        c_emb, c_mask = embed_texts(list(cands))
        r_emb, r_mask = embed_texts(list(refs))
        return greedy_match_scores(c_emb, c_mask, r_emb, r_mask)[2]

    return score
