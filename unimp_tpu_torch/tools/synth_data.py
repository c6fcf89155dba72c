"""Synthetic dataset generator in the reference's on-disk format.

Counterpart of ``unimp_tpu/tools/synth_data.py``: the same seeded draws
in the same order, so the JSON files and ``corpus.txt`` are byte for byte
the JAX writer's, and JPEGs written by the port's encoder
(``data/jpeg.py``: libjpeg's baseline at quality 85, as PIL saves them).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from unimp_tpu_torch.data.jpeg import encode_jpeg

_ADJ = "soft bright vintage modern sleek cozy rugged floral classic bold".split()
_NOUN = "lipstick serum cream brush mascara lotion polish shampoo oil mask".split()
_BRAND = "lumera vexa orchid nova kelo prisma aurel zenith mira sol".split()
_CAT = "makeup skincare haircare fragrance tools bath nails sets".split()


def _title(rng, i):
    return f"{_ADJ[rng.integers(len(_ADJ))]} {_NOUN[rng.integers(len(_NOUN))]} {i}"


def generate(
    out_dir: str,
    *,
    subset: str = "beauty",
    n_items: int = 64,
    n_users: int = 48,
    seq_len: int = 9,
    image_size: int = 32,
    seed: int = 0,
    write_images: bool = True,
) -> dict:
    """Write the dataset under out_dir; returns summary info."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, subset), exist_ok=True)

    meta = {}
    for i in range(n_items):
        meta[str(i)] = {
            "category": f"{_CAT[rng.integers(len(_CAT))]} {_NOUN[rng.integers(len(_NOUN))]}",
            "brand": _BRAND[rng.integers(len(_BRAND))],
            "title": _title(rng, i),
            "price": f"{rng.integers(3, 80)}.{rng.integers(10, 99)}",
            "keywords": f"{_ADJ[rng.integers(len(_ADJ))]} {_NOUN[rng.integers(len(_NOUN))]}",
            "retrieval": [int(rng.integers(n_items))],
        }
    with open(os.path.join(out_dir, f"meta_{subset}.json"), "w") as f:
        json.dump(meta, f)

    if write_images:
        for i in range(n_items):
            arr = rng.integers(0, 255, (image_size, image_size, 3), dtype=np.uint8)
            with open(os.path.join(out_dir, subset, f"{i}.jpg"), "wb") as f:
                f.write(encode_jpeg(arr, quality=85))

    exps = [
        "really love the texture and the finish lasts all day",
        "too greasy for my skin but the smell is nice",
        "great value for the price would buy again",
        "broke after one week very disappointed",
        "perfect shade exactly as pictured",
    ]

    def make_users(n, start_uid):
        users = {}
        for u in range(n):
            ln = int(rng.integers(seq_len, seq_len + 3))
            items = rng.choice(n_items, size=ln, replace=False)
            users[str(start_uid + u)] = [
                [int(it), exps[int(rng.integers(len(exps)))], int(rng.integers(1, 6))]
                for it in items
            ]
        return users

    splits = {"train": n_users, "eval": max(4, n_users // 6), "test": max(4, n_users // 6)}
    uid = 0
    per_split = {}
    for split, n in splits.items():
        users = make_users(n, uid)
        uid += n
        per_split[split] = users
        with open(os.path.join(out_dir, f"{split}_users.json"), "w") as f:
            json.dump(users, f)
        # exp subset = same records (all users have ratings/explanations)
        with open(os.path.join(out_dir, f"{split}_{subset}_exp.json"), "w") as f:
            json.dump(users, f)
        # img_sel: history + final [item_set, gt_indices] element
        sel = {}
        for uname, seq in users.items():
            gt = seq[-1][0]
            negs = rng.choice(
                sorted(set(range(n_items)) - {rec[0] for rec in seq}),
                size=4, replace=False,
            )
            item_set = [int(gt)] + [int(x) for x in negs]
            order = rng.permutation(len(item_set))
            item_set = [item_set[j] for j in order]
            gt_idx = [int(np.where(order == 0)[0][0])]
            sel[uname] = seq[:-1] + [[item_set, gt_idx]]
        with open(os.path.join(out_dir, f"{split}_{subset}_img_sel.json"), "w") as f:
            json.dump(sel, f)
        # img_gen retrieval sequences
        seqs = [[rec[0] for rec in seq] for seq in users.values()]
        with open(os.path.join(out_dir, f"search_merge_{split}.txt"), "w") as f:
            json.dump(seqs, f)

    with open(os.path.join(out_dir, "img_id2semantic.json"), "w") as f:
        json.dump({str(i): [int(x) for x in rng.integers(0, 1024, 4)]
                   for i in range(n_items)}, f)
    with open(os.path.join(out_dir, "id2semantic.json"), "w") as f:
        json.dump({str(i): ",".join(str(int(x)) for x in
                                    list(rng.integers(0, 512, 3)) +
                                    [rng.integers(0, 32)])
                   for i in range(n_items)}, f)

    corpus = [m["category"] + " " + m["brand"] + " " + m["title"] for m in meta.values()]
    corpus += exps
    corpus += [
        "What is the next item recommended to the user?",
        "Query: What is the related item ID to the query based on the history?",
        "User history: Select from: Selection",
        "Can you select the suitable item from above for the user?",
        "What is the rating and explanation for the item?",
        "What is the generated image Image ID to the query based on the history?",
        "Category Price Brand Title Name Appearance Color Section Release Date Unknown ID",
    ]
    with open(os.path.join(out_dir, "corpus.txt"), "w") as f:
        f.write("\n".join(corpus))

    return {"n_items": n_items, "subset": subset, "splits": splits}


def build_tokenizer(data_dir: str, subset: str = "beauty", n_items: Optional[int] = None,
                    use_semantic: bool = False, task: Optional[str] = None):
    """Corpus tokenizer + task vocabulary for a generated dataset."""
    from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
    from unimp_tpu_torch.data.vocab import extend_vocabulary

    with open(os.path.join(data_dir, "corpus.txt")) as f:
        corpus = f.read().splitlines()
    tok = UniMPTokenizer.from_corpus(corpus)
    extend_vocabulary(
        tok, subset=subset, use_semantic=use_semantic, task=task, n_items=n_items
    )
    return tok
