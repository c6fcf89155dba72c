"""Per-task evaluators: batched generation -> task metrics.

Counterpart of ``unimp_tpu/evals/evaluators.py`` (the protocols of UniMP's
pipeline/eval/):

  rec      eval_rec.py:100-157   — 10 beams, 10 returns, max 50 new,
           exact match of the text after the last question mark against
           the target item token; HR/NDCG/MRR @ {3, 5, 10}
  search   eval_search.py:98-155 — the same, max 20 new
  exp      eval_exp.py:103-171   — 5 beams / 1 return, max 256; rating
           parsed from the leading "rate_k" (fallback 3.0); MAE/RMSE +
           BLEU/ROUGE/METEOR (+BERTScore when a scorer is given)
  img_sel  eval_img_sel.py:94-136 — 2 beams / 1 return, max 40; the
           generated s_i token set against the ground truth;
           recall/precision/F1
  img_gen  eval_img_gen.py:102-144 — greedy, max 600; dumps the
           generated VQGAN token strings for offline decoding

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

Several ranks (``parallel/mesh.py``): each evaluates the users of its
data-axis shard (the loader's) and ``evals/dist.py`` joins the per-user
metrics; ``n_users`` counts every real user once. The ranks of one tp
group read the same users, so their decode steps pair up (the decode
loop's exit is one decision over the group); the data-axis ranks hold
whole parameters (fsdp shards only gradients and optimizer state), so a
forward of theirs holds no collective and their batch counts may differ:
no rows are padded (the JAX evaluator pads its global batch to the mesh's
shard multiple, ``unimp_tpu/evals/evaluators.py:68-91``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.evals import text_metrics
from unimp_tpu_torch.evals.dist import gather_metric_lists
from unimp_tpu_torch.evals.latent_cache import ItemLatentCache
from unimp_tpu_torch.evals.metrics import f1_score, rank_metrics_for_hits


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


def evaluate_search(model, loader, tokenizer, **kw):
    kw.setdefault("max_new_tokens", 20)
    return _rank_eval(model, loader, tokenizer, **kw)


def _one_return_config(tokenizer, max_new_tokens, num_beams, kv_int8):
    return GenerationConfig(
        max_new_tokens=max_new_tokens, eos_id=tokenizer.eos_token_id,
        pad_id=tokenizer.eos_token_id, num_beams=num_beams, num_return_sequences=1,
        kv_int8=kv_int8,
    )


def evaluate_exp(model, loader, tokenizer, *, max_new_tokens=256, num_beams=5,
                 bertscore_fn: Optional[Callable] = None, dump_dir: Optional[str] = None,
                 rank: int = 0, kv_int8=False, cache_holder=None):
    gen_cfg = _one_return_config(tokenizer, max_new_tokens, num_beams, kv_int8)
    abs_err, sq_err = [], []
    gen_exps, real_exps = [], []
    throughput = []
    for answers, batch, ips in _generate_batches(model, loader, tokenizer, gen_cfg,
                                                 cache_holder=cache_holder):
        throughput.append(ips)
        for row, target in zip(answers, batch["targets"]):
            words = row[0].split()
            try:
                rate = float(words[0].split("_")[-1])
            except (IndexError, ValueError):
                rate = 3.0  # reference fallback (eval_exp.py:122-124)
            exp = " ".join(words[1:]) or "Empty"
            abs_err.append(abs(rate - target["rating"]))
            sq_err.append((rate - target["rating"]) ** 2)
            gen_exps.append(exp)
            real_exps.append(target["explanation"])
    metrics = {
        "mae": float(np.mean(abs_err)),
        "rmse": float(np.sqrt(np.mean(sq_err))),
        "bleu": text_metrics.bleu(gen_exps, real_exps)["precision1"],
        "rouge1": text_metrics.rouge_n(gen_exps, real_exps, 1),
        "rouge2": text_metrics.rouge_n(gen_exps, real_exps, 2),
        "rougeL": text_metrics.rouge_l(gen_exps, real_exps),
        "meteor": text_metrics.meteor(gen_exps, real_exps),
        "items_per_sec": float(np.mean(throughput)) if throughput else 0.0,
        "n_users": len(gen_exps),
    }
    if bertscore_fn is not None:
        metrics["bertscore"] = float(np.mean(bertscore_fn(gen_exps, real_exps)))
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        with open(os.path.join(dump_dir, f"gen_exps_{rank}.json"), "w") as f:
            json.dump(gen_exps, f)
        with open(os.path.join(dump_dir, f"real_exps_{rank}.json"), "w") as f:
            json.dump(real_exps, f)
    return metrics


def evaluate_img_sel(model, loader, tokenizer, *, max_new_tokens=40, num_beams=2,
                     kv_int8=False, cache_holder=None):
    gen_cfg = _one_return_config(tokenizer, max_new_tokens, num_beams, kv_int8)
    recalls, precisions, f1s = [], [], []
    throughput = []
    for answers, batch, ips in _generate_batches(model, loader, tokenizer, gen_cfg,
                                                 cache_holder=cache_holder):
        throughput.append(ips)
        for row, target in zip(answers, batch["targets"]):
            gen_ids = set(row[0].split())
            gts = [f"s_{i}" for i in target]
            r = sum(1 for g in gen_ids if g in gts)
            recall = r / len(gts)
            precision = r / len(gen_ids) if gen_ids else 0.0
            recalls.append(recall)
            precisions.append(precision)
            f1s.append(f1_score(precision, recall))
    return {
        "recall": float(np.mean(recalls)),
        "precision": float(np.mean(precisions)),
        "f1": float(np.mean(f1s)),
        "items_per_sec": float(np.mean(throughput)) if throughput else 0.0,
        "n_users": len(recalls),
    }


def evaluate_img_gen(model, loader, tokenizer, *, max_new_tokens=600,
                     dump_path: Optional[str] = None, rank: int = 0, epoch: int = 0,
                     run_name: str = "run", kv_int8=False, cache_holder=None):
    gen_cfg = _one_return_config(tokenizer, max_new_tokens, 1, kv_int8)
    generations = []
    throughput = []
    for answers, batch, ips in _generate_batches(model, loader, tokenizer, gen_cfg,
                                                 cache_holder=cache_holder):
        throughput.append(ips)
        for row, target, extra in zip(answers, batch["targets"],
                                      batch.get("extras", [None] * len(answers))):
            generations.append({"generated": row[0], "target": target,
                                "item": None if extra is None else extra.get("item")})
    if dump_path is None:
        dump_path = f"save_img_gen/img_gen_{rank}_epoch_{epoch}_name_{run_name}.json"
    if dump_path:  # "": no file (a tp rank other than its group's first)
        os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
        with open(dump_path, "w") as f:
            json.dump(generations, f)
    return {
        "n_generated": len(generations),
        "dump_path": dump_path,
        "items_per_sec": float(np.mean(throughput)) if throughput else 0.0,
    }


# task -> evaluator, as ``unimp_tpu.evals.EVALUATORS``
EVALUATORS = {
    "rec": evaluate_rec,
    "search": evaluate_search,
    "exp": evaluate_exp,
    "img_sel": evaluate_img_sel,
    "img_gen": evaluate_img_gen,
}
