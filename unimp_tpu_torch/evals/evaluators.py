"""Rank evaluation: batched beam generation -> HR/NDCG/MRR.

Counterpart of the rec evaluator of ``unimp_tpu/evals/evaluators.py``
(protocol of UniMP's pipeline/eval/eval_rec.py:100-157): 10 beams, 10
returned sequences, at most 50 new tokens; the text after the last
question mark of each returned sequence is an answer, matched exactly
(whitespace removed) against the target item token; HR/NDCG/MRR @ {3, 5,
10}.

Generation is batched: prompts are left-aligned into one window and
decoded together. Batches that carry ``image_ids`` are served by one
``ItemLatentCache`` shared across the evaluator calls of a run, so each
catalogue image is encoded once; batches that carry pixels go through
``encode_vision``.

One generation is in flight at a time. The port's ``Generator`` runs its
decode loop on the host and returns once the batch is decoded, so a
batch is timed from its fetch to its tokens on the host; the loader's
worker threads build the next batches meanwhile. ``items_per_sec`` is the
mean of the per-batch rows per second, the first batch including its
catalogue misses, as in the JAX package.

The other tasks' evaluators (search, exp, img_sel, img_gen) are not
ported yet (ROADMAP.md §1, item 5).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.evals.dist import gather_metric_lists
from unimp_tpu_torch.evals.latent_cache import ItemLatentCache
from unimp_tpu_torch.evals.metrics import rank_metrics_for_hits


def _norm(s: str) -> str:
    return "".join(s.split())


def _answers(tokenizer, tokens: np.ndarray):
    """[B, R, L] generated tokens -> list (per row) of R answer strings."""
    out = []
    for row in tokens:
        texts = tokenizer.batch_decode(row, skip_special_tokens=True)
        out.append([t.split("?")[-1].strip() for t in texts])
    return out


def _generate_batches(model, loader, tokenizer, gen_cfg, cache_holder=None):
    """Yield (answers, batch, items_per_sec) over the eval loader, on the
    model's device."""
    device = next(model.parameters()).device
    gen = Generator(model, gen_cfg, media_id=tokenizer.media_token_id)
    # shared across evaluator calls of one run (same weights): the
    # catalogue is encoded once, not once per task x split
    holder = cache_holder if cache_holder is not None else {}

    def batch_latents(batch):
        if "image_ids" in batch:
            cache = holder.get("latent_cache")
            if cache is None:
                ds = loader.dataset
                cache = ItemLatentCache(model, ds.item_image, ds.n_items, device=device)
                holder["latent_cache"] = cache
            return cache.gather(batch["image_ids"])
        if "images" in batch:
            with torch.no_grad():
                pixels = torch.from_numpy(batch["images"]).to(device)
                return model.encode_vision(normalize_on_device(pixels))
        return None  # text-only batch: the vision path is skipped

    t0 = time.perf_counter()
    for batch in loader:
        latents = batch_latents(batch)
        tokens, _ = gen.generate(
            torch.from_numpy(batch["input_ids"]).long().to(device),
            torch.from_numpy(batch["seq_len"]).long().to(device),
            latents,
        )
        tokens = tokens.cpu().numpy()
        dt = time.perf_counter() - t0
        yield _answers(tokenizer, tokens), batch, len(tokens) / dt
        t0 = time.perf_counter()


def _rank_eval(model, loader, tokenizer, *, max_new_tokens, ks=(3, 5, 10), num_beams=10,
               dump_path: Optional[str] = None, kv_int8=False, cache_holder=None,
               length_norm="full"):
    gen_cfg = GenerationConfig(
        max_new_tokens=max_new_tokens, eos_id=tokenizer.eos_token_id,
        pad_id=tokenizer.eos_token_id, num_beams=num_beams,
        num_return_sequences=num_beams, kv_int8=kv_int8, length_norm=length_norm,
    )
    per_user = []
    throughput = []
    for answers, batch, ips in _generate_batches(model, loader, tokenizer, gen_cfg,
                                                 cache_holder=cache_holder):
        throughput.append(ips)
        for row, target in zip(answers, batch["targets"]):
            hits = np.array([_norm(a) == _norm(target) for a in row], dtype=int)
            per_user.append(rank_metrics_for_hits(hits, ks=ks, len_gt=1))
    keys = per_user[0].keys() if per_user else []
    metrics = {k: float(np.mean(gather_metric_lists([u[k] for u in per_user]))) for k in keys}
    metrics["items_per_sec"] = float(np.mean(throughput)) if throughput else 0.0
    metrics["n_users"] = int(gather_metric_lists([float(len(per_user))]).sum())
    if dump_path:
        os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
        with open(dump_path, "w") as f:
            json.dump(per_user, f)
    return metrics


def evaluate_rec(model, loader, tokenizer, **kw):
    kw.setdefault("max_new_tokens", 50)
    return _rank_eval(model, loader, tokenizer, **kw)


# task -> evaluator, as ``unimp_tpu.evals.EVALUATORS`` (the rec task only)
EVALUATORS = {"rec": evaluate_rec}
