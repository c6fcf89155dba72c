"""Few-shot vision-language benchmark harness (COCO / VQA / ImageNet).

Counterpart of ``unimp_tpu/evals/benchmark_harness.py`` (the inherited
OpenFlamingo harness of UniMP's pipeline/eval/evaluate.py:168-780).
Datasets are JSON manifests (a list of {image, captions / question +
answers / label}); the metrics are pure Python:

  * CIDEr-D for captioning (tf-idf weighted n-gram cosine with the
    Gaussian length penalty, as pycocoevalcap computes it)
  * VQA accuracy: the official normalization and min(#matches / 3, 1)
    (``evals/vqa_normalize.py``), the OK-VQA stemmer for OK-VQA
  * top-1 classification: class names ranked by the summed LM
    log-probability of "<image> A photo of {name}"

The prompt images go through ``load_resized_uint8`` on the host, then
``normalize_on_device`` and ``encode_vision`` on the model's device;
captions decode with 3 beams, VQA answers greedily, and classification
scores every class prompt of an image in one forward.
"""

from __future__ import annotations

import json
import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from unimp_tpu_torch.data.transforms import load_resized_uint8, normalize_on_device
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.decode.sampler import log_softmax_like_jax
from unimp_tpu_torch.evals.vqa_normalize import (  # noqa: F401  (re-exports)
    postprocess_ok_vqa_generation,
    postprocess_vqa_generation,
    vqa_accuracy,
)
from unimp_tpu_torch.models.flamingo import compute_q_media

# ----------------------------- CIDEr-D -----------------------------


def _caption_tokens(s: str) -> List[str]:
    return re.findall(r"\w+", s.lower())


def _ngram_counts(tokens: List[str], n_max: int = 4):
    out = []
    for n in range(1, n_max + 1):
        out.append(Counter(
            tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1)
        ))
    return out


def cider_d(predictions: List[str], references: List[List[str]],
            n_max: int = 4, sigma: float = 6.0) -> float:
    """Corpus CIDEr-D: tf-idf n-gram cosine with length penalty."""
    # document frequencies over reference sets
    df = [defaultdict(float) for _ in range(n_max)]
    for refs in references:
        seen = [set() for _ in range(n_max)]
        for ref in refs:
            for n, counts in enumerate(_ngram_counts(_caption_tokens(ref), n_max)):
                seen[n].update(counts.keys())
        for n in range(n_max):
            for g in seen[n]:
                df[n][g] += 1.0
    log_m = math.log(max(len(references), 1))

    def tfidf(counts, n):
        vec = {}
        norm = 0.0
        total = max(sum(counts.values()), 1)
        for g, c in counts.items():
            idf = log_m - math.log(max(df[n][g], 1.0))
            v = (c / total) * idf
            vec[g] = v
            norm += v * v
        return vec, math.sqrt(norm)

    scores = []
    for pred, refs in zip(predictions, references):
        p_toks = _caption_tokens(pred)
        p_counts = _ngram_counts(p_toks, n_max)
        score_n = np.zeros(n_max)
        for ref in refs:
            r_toks = _caption_tokens(ref)
            r_counts = _ngram_counts(r_toks, n_max)
            delta = len(p_toks) - len(r_toks)
            for n in range(n_max):
                pv, pn = tfidf(p_counts[n], n)
                rv, rn = tfidf(r_counts[n], n)
                num = sum(min(pv[g], rv.get(g, 0.0)) * rv[g]
                          for g in pv if g in rv)
                sim = num / (pn * rn) if pn > 0 and rn > 0 else 0.0
                sim *= math.exp(-(delta**2) / (2 * sigma**2))
                score_n[n] += sim
        scores.append(10.0 * float(np.mean(score_n / max(len(refs), 1))))
    return float(np.mean(scores)) if scores else 0.0


# ----------------------------- harness loops -----------------------------


def _load_manifest(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def _device(model) -> torch.device:
    return model.embed.embedding.device


def _encode_prompt_images(model, tokenizer, image_paths, image_size):
    """The prompt's images, in order -> latents [1, M, L, D]."""
    imgs = np.stack([load_resized_uint8(p, image_size) for p in image_paths])
    vision = normalize_on_device(torch.from_numpy(imgs[None]).to(_device(model)))
    return model.encode_vision(vision)


def _generate_one(gen, model, tokenizer, prompt, paths, image_size) -> str:
    latents = _encode_prompt_images(model, tokenizer, paths, image_size)
    ids = tokenizer.encode(prompt)
    dev = _device(model)
    toks, _ = gen.generate(torch.tensor([ids], device=dev),
                           torch.tensor([len(ids)], device=dev), latents)
    return tokenizer.decode(toks[0, 0].tolist())


@torch.no_grad()
def evaluate_captioning(
    model, tokenizer, manifest_path: str, *,
    num_shots: int = 0, image_size: int = 224, max_new_tokens: int = 24,
    limit: Optional[int] = None, seed: int = 0,
) -> Dict[str, float]:
    """manifest: [{"image": path, "captions": [str, ...]}, ...]."""
    data = _load_manifest(manifest_path)
    rng = np.random.default_rng(seed)
    gen = Generator(
        model,
        GenerationConfig(max_new_tokens=max_new_tokens,
                         eos_id=tokenizer.eos_token_id,
                         pad_id=tokenizer.eos_token_id, num_beams=3,
                         num_return_sequences=1),
        media_id=tokenizer.media_token_id,
    )
    preds, refs = [], []
    for rec in data[:limit]:
        shots = [data[i] for i in rng.choice(len(data), num_shots, replace=False)]
        prompt = ""
        paths = []
        for s in shots:
            prompt += f"<image> Caption: {s['captions'][0]} <|endofchunk|> "
            paths.append(s["image"])
        prompt += "<image> Caption:"
        paths.append(rec["image"])
        preds.append(_generate_one(gen, model, tokenizer, prompt, paths, image_size))
        refs.append(rec["captions"])
    return {"cider": cider_d(preds, refs), "n": len(preds)}


@torch.no_grad()
def evaluate_vqa(
    model, tokenizer, manifest_path: str, *,
    num_shots: int = 0, image_size: int = 224, max_new_tokens: int = 8,
    limit: Optional[int] = None, seed: int = 0, ok_vqa: bool = False,
) -> Dict[str, float]:
    """manifest: [{"image", "question", "answers": [str, ...]}, ...].

    ``ok_vqa``: the OK-VQA stemmer post-processes the prediction (the
    reference routes OK-VQA generations through
    ``postprocess_ok_vqa_generation``)."""
    data = _load_manifest(manifest_path)
    rng = np.random.default_rng(seed)
    gen = Generator(
        model,
        GenerationConfig(max_new_tokens=max_new_tokens,
                         eos_id=tokenizer.eos_token_id,
                         pad_id=tokenizer.eos_token_id),
        media_id=tokenizer.media_token_id,
    )
    accs = []
    for rec in data[:limit]:
        shots = [data[i] for i in rng.choice(len(data), num_shots, replace=False)]
        prompt = ""
        paths = []
        for s in shots:
            prompt += (f"<image> Question: {s['question']} "
                       f"Answer: {s['answers'][0]} <|endofchunk|> ")
            paths.append(s["image"])
        prompt += f"<image> Question: {rec['question']} Answer:"
        paths.append(rec["image"])
        pred = _generate_one(gen, model, tokenizer, prompt, paths, image_size)
        pred = (postprocess_ok_vqa_generation(pred) if ok_vqa
                else postprocess_vqa_generation(pred))
        accs.append(vqa_accuracy(pred, rec["answers"]))
    return {"vqa_accuracy": float(np.mean(accs)) if accs else 0.0, "n": len(accs)}


def class_prompt_ids(tokenizer, class_names: List[str]) -> np.ndarray:
    """[C, width] int64: "<image> A photo of {name}" a row, right-padded
    with ``pad_token_id``."""
    enc = [tokenizer.encode(f"<image> A photo of {name}") for name in class_names]
    width = max(len(e) for e in enc)
    ids = np.full((len(enc), width), tokenizer.pad_token_id, np.int64)
    for i, e in enumerate(enc):
        ids[i, : len(e)] = e
    return ids


@torch.no_grad()
def evaluate_classification(
    model, tokenizer, manifest_path: str, class_names: List[str], *,
    image_size: int = 224, limit: Optional[int] = None,
    predictions: Optional[list] = None,
) -> Dict[str, float]:
    """Rank class names by the summed LM log-probability of "<image> A
    photo of {name}" (the reference's ImageNet protocol): every class
    prompt of an image in one forward, padding masked out of the sum.
    ``predictions``: a list the argmax classes are appended to."""
    data = _load_manifest(manifest_path)
    dev = _device(model)
    ids = torch.from_numpy(class_prompt_ids(tokenizer, class_names)).to(dev)
    q_media = compute_q_media(ids, tokenizer.media_token_id)
    tgt = ids[:, 1:]
    mask = (tgt != tokenizer.pad_token_id).float()

    correct = 0
    total = 0
    for rec in data[:limit]:
        latents = _encode_prompt_images(model, tokenizer, [rec["image"]], image_size)
        lat = latents.expand(len(class_names), *latents.shape[1:])
        logits, _ = model(ids, latents=lat, q_media=q_media)
        logp = log_softmax_like_jax(logits[:, :-1])
        tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
        s = (tok_lp.float() * mask).sum(dim=1)
        best = int(torch.argmax(s))
        if predictions is not None:
            predictions.append(best)
        if best == int(rec["label"]):
            correct += 1
        total += 1
    return {"top1": correct / max(total, 1), "n": total}
