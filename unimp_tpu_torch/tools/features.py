"""Item features, retrieval neighbours and semantic IDs.

Counterpart of ``unimp_tpu/tools/features.py`` (the reference's
``pipeline/utils`` feature extractors, similarity and semantic-ID
scripts): per-item image and text embeddings, cosine-similarity
neighbours (the ``retrieval`` field of ``meta_{subset}.json``) and the
residual-quantization semantic IDs of ``--use_semantic``
(``id2semantic.json``: three levels of 512 codes and a 32-way last one,
the token budget of the vocabulary).

The image features are the port's vision tower (its attention is K1 on
the card) on each item image, read and CLIP-normalized as the JAX package
reads them (``load_image_rgb`` -> ``preprocess_image``), mean-pooled over
the patches; the text features the mean of the model's token embeddings
over each text's tokens. Both run on the model's device under
``torch.no_grad``; the rest is host numpy, seeded as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from unimp_tpu_torch.data.transforms import load_image_rgb, preprocess_image


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def extract_image_features(model, data_dir, subset, item_ids, image_size=224, batch_size=64):
    """Mean-pooled vision-tower features of each item image -> [N, D]
    float32 (the mean in the tower's dtype, as the JAX package takes it)."""
    out = []
    for i in range(0, len(item_ids), batch_size):
        chunk = item_ids[i : i + batch_size]
        imgs = np.stack([preprocess_image(load_image_rgb(os.path.join(data_dir, subset,
                                                                      f"{it}.jpg")), image_size)
                         for it in chunk])
        feats = model.vision(torch.from_numpy(imgs).to(_device(model)))
        out.append(feats.mean(dim=1).float().cpu().numpy())
    return np.concatenate(out, axis=0)


@torch.no_grad()
def extract_text_features(model, tokenizer, texts, batch_size=64):
    """Mean of the token embeddings of each text -> [N, D] float32."""
    max_len = max(len(tokenizer.encode(t)) for t in texts)
    device = _device(model)
    out = []
    for i in range(0, len(texts), batch_size):
        chunk = texts[i : i + batch_size]
        ids = np.zeros((len(chunk), max_len), np.int64)
        mask = np.zeros((len(chunk), max_len), np.float32)
        for j, t in enumerate(chunk):
            row = tokenizer.encode(t)[:max_len]
            ids[j, : len(row)] = row
            mask[j, : len(row)] = 1.0
        e = model.embed(torch.from_numpy(ids).to(device)).float()
        m = torch.from_numpy(mask).to(device)
        denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1)
        out.append(((e * m[:, :, None]).sum(dim=1) / denom).cpu().numpy())
    return np.concatenate(out, axis=0)


def cosine_topk(features: np.ndarray, k: int = 10) -> np.ndarray:
    """[N, D] -> [N, k] nearest-neighbour indices (self excluded)."""
    f = features / np.maximum(np.linalg.norm(features, axis=1, keepdims=True), 1e-8)
    sims = f @ f.T
    np.fill_diagonal(sims, -np.inf)
    return np.argsort(-sims, axis=1)[:, :k]


def add_retrieval_neighbors(data_dir: str, subset: str, features: np.ndarray,
                            item_ids: List[int], k: int = 10):
    """Write the top-k neighbours into ``meta_{subset}.json``'s "retrieval"."""
    path = os.path.join(data_dir, f"meta_{subset}.json")
    with open(path) as f:
        meta = json.load(f)
    nbrs = cosine_topk(features, k)
    for row, item in zip(nbrs, item_ids):
        entry = meta[str(item)]
        if isinstance(entry, dict):
            entry["retrieval"] = [int(item_ids[j]) for j in row]
    with open(path, "w") as f:
        json.dump(meta, f)


def _nearest(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """``((x[:, None] - centers[None]) ** 2).sum(-1).argmin(1)``, the JAX
    package's assignment, without its [N, k, D] temporary (2.7 GB an
    iteration at 640 items, 512 codes, 1,024 dims). The expanded distances
    |x|^2 - 2 x.c + |c|^2 (one matrix product) pick, for each row, the
    centres within a margin far above their rounding error of the nearest;
    those alone get the JAX package's distance, summed as it sums it over
    the last axis, and the first minimal index wins, as ``argmin``'s does.
    Identical centres (empty clusters keep their start, often a zero
    residual) are one candidate, their first index."""
    first = {}
    for j, row in enumerate(centers):
        first.setdefault(row.tobytes(), j)
    first = np.fromiter(first.values(), np.int64, len(first))
    uniq = centers[first]
    x64, u64 = x.astype(np.float64), uniq.astype(np.float64)
    xx = (x64 * x64).sum(1)
    cc = (u64 * u64).sum(1)
    approx = xx[:, None] - 2.0 * (x64 @ u64.T) + cc[None]
    margin = 1e-9 * (xx + cc.max())
    near = approx <= (approx.min(1) + 2.0 * margin)[:, None]
    assign = first[near.argmax(1)]
    for i in np.flatnonzero(near.sum(1) > 1):
        cand = np.flatnonzero(near[i])
        exact = ((x[i][None] - uniq[cand]) ** 2).sum(-1)
        assign[i] = first[cand[exact.argmin()]]
    return assign


def _kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0):
    rng = np.random.default_rng(seed)
    k = min(k, len(x))
    centers = x[rng.choice(len(x), k, replace=False)].copy()
    for _ in range(iters):
        assign = _nearest(x, centers)
        for j in range(k):
            pts = x[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return centers, _nearest(x, centers)


def build_semantic_ids(features: np.ndarray, item_ids: List[int], out_path: str,
                       levels: int = 3, codes_per_level: int = 512, last_codes: int = 32,
                       seed: int = 0) -> Dict[str, str]:
    """Residual-quantization semantic IDs: ``levels`` k-means stages of
    ``codes_per_level`` codes, then a ``last_codes`` stage that numbers
    the items sharing a prefix (``item_{i}`` / ``item_last_{i}`` tokens).
    Writes ``id2semantic.json``."""
    x = features.astype(np.float64).copy()
    codes = []
    for lvl in range(levels):
        centers, assign = _kmeans(x, codes_per_level, seed=seed + lvl)
        codes.append(assign)
        x = x - centers[assign]
    prefix: dict = {}
    last = np.zeros(len(features), np.int64)
    for i in range(len(features)):
        key = tuple(c[i] for c in codes)
        last[i] = prefix.get(key, -1) + 1
        prefix[key] = last[i]
    last = last % last_codes
    mapping = {str(item): ",".join(str(int(c[i])) for c in codes) + f",{int(last[i])}"
               for i, item in enumerate(item_ids)}
    with open(out_path, "w") as f:
        json.dump(mapping, f)
    return mapping
