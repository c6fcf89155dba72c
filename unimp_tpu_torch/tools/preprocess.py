"""Offline dataset preprocessing: raw dumps -> the framework's file layout.

Counterpart of ``unimp_tpu/tools/preprocess.py`` (host code: the standard
library only), for the reference's preprocessing scripts (its ``data/``):
  * Amazon Reviews 2014      data_preprocess_multimodal_full.py
    (meta extraction :29-78, interactions+explanations :85-132,
     iterative K-core :151-183, first-seen asin ids shuffled with
     seed 42 :195-212, user-level 80/10/10 split :234-242)
  * new-domain variants      data_preprocess_multimodal_new_domain.py
    (office K-core 6/5, tool)
  * H&M                      data_preprocess_hm.py (transactions ->
    per-customer sequences, consecutive dedup, 30k users)
  * Netflix                  data_preprocess_netflix.py (LLMRec format)

All functions are importable and covered by tests on synthetic raw data;
the __main__ CLI mirrors the reference's script usage:

    python -m unimp_tpu_torch.tools.preprocess amazon --reviews R.json.gz \
        --meta M.json.gz --out DIR [--subset beauty]

``download_images`` fetches through ``urllib`` (any URL scheme it opens).
"""

from __future__ import annotations

import copy
import gzip
import json
import os
import random
from collections import defaultdict
from typing import Dict, Optional, Tuple


# ---------------------------------------------------------------- K-core


def check_kcore(user_items: Dict, user_core: int, item_core: int):
    user_count: Dict = defaultdict(int)
    item_count: Dict = defaultdict(int)
    for user, items in user_items.items():
        user_count[user] = len(items)
        for it in items:
            item_count[it[0]] += 1
    ok = all(n >= user_core for n in user_count.values()) and all(
        n >= item_core for n in item_count.values()
    )
    return user_count, item_count, ok


def filter_kcore(user_items: Dict, user_core: int, item_core: int) -> Dict:
    """Iteratively drop users with < user_core interactions and item
    occurrences with < item_core users until the K-core holds."""
    user_items = dict(user_items)
    user_count, item_count, ok = check_kcore(user_items, user_core, item_core)
    while not ok:
        for user in list(user_items):
            if user_count[user] < user_core:
                user_items.pop(user)
            else:
                user_items[user] = [
                    it for it in user_items[user]
                    if item_count[it[0]] >= item_core
                ]
        user_items = {u: seq for u, seq in user_items.items() if seq}
        user_count, item_count, ok = check_kcore(user_items, user_core, item_core)
    return user_items


# ------------------------------------------------------------ id mapping


def reindex_items(sequences: Dict, seed: int = 42) -> Tuple[Dict, Dict]:
    """First-seen ordering of raw ids, then shuffle the integer ids with
    the reference's fixed seed (data_preprocess_multimodal_full.py:195-212).
    Returns (sequences with int ids, raw_id -> int id)."""
    raw2id: Dict = {}
    for seq in sequences.values():
        for it in seq:
            raw2id.setdefault(it[0], len(raw2id))
    values = list(raw2id.values())
    random.seed(seed)
    random.shuffle(values)
    raw2id = {k: v for k, v in zip(raw2id.keys(), values)}
    out = copy.deepcopy(sequences)
    for user, seq in out.items():
        for it in seq:
            it[0] = raw2id[it[0]]
    return out, raw2id


def split_users(data: Dict, seed: int = 42,
                fractions=(0.8, 0.9)) -> Tuple[Dict, Dict, Dict]:
    """User-level 80/10/10 split (reference :234-242)."""
    keys = list(data.keys())
    random.seed(seed)
    random.shuffle(keys)
    n1 = int(len(keys) * fractions[0])
    n2 = int(len(keys) * fractions[1])
    pick = lambda ks: {k: data[k] for k in ks}  # noqa: E731
    return pick(keys[:n1]), pick(keys[n1:n2]), pick(keys[n2:])


def _dump(out_dir: str, subset: str, train, eval_, test, meta):
    os.makedirs(out_dir, exist_ok=True)
    for name, payload in (("train", train), ("eval", eval_), ("test", test)):
        with open(os.path.join(out_dir, f"{name}_users.json"), "w") as f:
            json.dump(payload, f)
        # reference also writes {split}_{subset}.json (img_gen path)
        with open(os.path.join(out_dir, f"{name}_{subset}.json"), "w") as f:
            json.dump(payload, f)
    with open(os.path.join(out_dir, f"meta_{subset}.json"), "w") as f:
        json.dump(meta, f)


# ---------------------------------------------------------------- Amazon


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _iter_json_lines(path: str):
    with _open_maybe_gz(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                yield eval(line)  # Amazon 2014 dumps use python literals


def extract_amazon_meta(meta_path: str) -> Dict[str, dict]:
    """asin -> {category, price, brand, title, imUrl}
    (reference :29-78 field handling)."""
    meta = {}
    for rec in _iter_json_lines(meta_path):
        asin = rec.get("asin")
        if not asin:
            continue
        cats = rec.get("categories") or [[]]
        category = " ".join(cats[0]) if cats and cats[0] else ""
        meta[asin] = {
            "category": category,
            "price": str(rec.get("price", "") or ""),
            "brand": rec.get("brand", "") or "",
            "title": rec.get("title", "") or "",
            "imUrl": rec.get("imUrl", "") or "",
        }
    return meta


def extract_amazon_interactions(reviews_path: str, meta: Dict) -> Dict:
    """user -> time-sorted [item, explanation, rating] triples
    (reference :85-148)."""
    sequences: Dict = defaultdict(list)
    for rec in _iter_json_lines(reviews_path):
        asin = rec.get("asin")
        user = rec.get("reviewerID")
        if not asin or not user or asin not in meta:
            continue
        ts = rec.get("unixReviewTime", 0)
        exp = (rec.get("summary") or rec.get("reviewText") or "").strip()
        rating = int(float(rec.get("overall", 3)))
        sequences[user].append((ts, asin, exp, rating))
    return {
        u: [[asin, exp, rating] for _, asin, exp, rating in sorted(seq)]
        for u, seq in sequences.items()
    }


def preprocess_amazon(
    reviews_path: str,
    meta_path: str,
    out_dir: str,
    subset: str = "all",
    user_core: int = 8,
    item_core: int = 5,
    seed: int = 42,
) -> dict:
    """Full Amazon pipeline; new-domain variants pass user_core=6
    (office) / 5 per data_preprocess_multimodal_new_domain.py:185."""
    meta = extract_amazon_meta(meta_path)
    sequences = extract_amazon_interactions(reviews_path, meta)
    sequences = filter_kcore(sequences, user_core, item_core)
    sequences, raw2id = reindex_items(sequences, seed)
    new_meta = {
        str(raw2id[asin]): attrs for asin, attrs in meta.items()
        if asin in raw2id
    }
    train, eval_, test = split_users(sequences, seed)
    _dump(out_dir, subset, train, eval_, test, new_meta)
    with open(os.path.join(out_dir, "asin2id.json"), "w") as f:
        json.dump(raw2id, f)
    return {"users": len(sequences), "items": len(raw2id)}


# ------------------------------------------------------------------ H&M


def preprocess_hm(
    transactions_csv: str,
    articles_csv: str,
    out_dir: str,
    max_users: int = 30_000,
    min_len: int = 9,
    seed: int = 42,
) -> dict:
    """H&M: per-customer date-sorted sequences with consecutive-duplicate
    removal, truncated user count (reference data_preprocess_hm.py)."""
    import csv

    articles = {}
    with open(articles_csv) as f:
        for row in csv.DictReader(f):
            articles[row["article_id"]] = [
                row.get("prod_name", ""),
                row.get("graphical_appearance_name", ""),
                row.get("colour_group_name", ""),
                row.get("section_name", ""),
                row.get("detail_desc", ""),
            ]
    sequences: Dict = defaultdict(list)
    with open(transactions_csv) as f:
        for row in csv.DictReader(f):
            if row["article_id"] in articles:
                sequences[row["customer_id"]].append(
                    (row["t_dat"], row["article_id"])
                )
    out: Dict = {}
    for user, seq in sequences.items():
        seq = [a for _, a in sorted(seq)]
        dedup = [a for i, a in enumerate(seq) if i == 0 or a != seq[i - 1]]
        if len(dedup) >= min_len:
            out[user] = [[a, "", 3] for a in dedup]
        if len(out) >= max_users:
            break
    out, raw2id = reindex_items(out, seed)
    meta = {str(raw2id[a]): attrs for a, attrs in articles.items() if a in raw2id}
    train, eval_, test = split_users(out, seed)
    _dump(out_dir, "hm", train, eval_, test, meta)
    return {"users": len(out), "items": len(raw2id)}


# -------------------------------------------------------------- Netflix


def preprocess_netflix(
    llmrec_dir: str, out_dir: str, titles_path: Optional[str] = None,
    seed: int = 42,
) -> dict:
    """Netflix in LLMRec format: {split}.json user->item-id lists plus a
    titles table (reference data_preprocess_netflix.py)."""
    splits = {}
    for name in ("train", "val", "test"):
        with open(os.path.join(llmrec_dir, f"{name}.json")) as f:
            splits[name] = json.load(f)
    meta = {}
    if titles_path:
        with open(titles_path) as f:
            for line in f:
                parts = line.rstrip("\n").split(",", 2)
                if len(parts) == 3:
                    meta[parts[0]] = [parts[1], parts[2]]  # [year, title]
    to_seq = lambda d: {  # noqa: E731
        u: [[int(i), "", 3] for i in items] for u, items in d.items()
    }
    _dump(out_dir, "netflix", to_seq(splits["train"]), to_seq(splits["val"]),
          to_seq(splits["test"]), meta)
    return {"users": sum(len(s) for s in splits.values()), "items": len(meta)}


# -------------------------------------------------------------- images


def download_images(meta: Dict, out_dir: str, timeout: int = 10) -> int:
    """Fetch item images by id (the reference's download step, through
    ``urllib``); failures are skipped."""
    import urllib.request

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for item_id, attrs in meta.items():
        url = attrs.get("imUrl")
        if not url:
            continue
        path = os.path.join(out_dir, f"{item_id}.jpg")
        if os.path.exists(path):
            continue
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                content = r.read()
            with open(path, "wb") as f:
                f.write(content)
            n += 1
        except Exception:
            continue
    return n


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("amazon")
    a.add_argument("--reviews", required=True)
    a.add_argument("--meta", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--subset", default="all")
    a.add_argument("--user-core", type=int, default=8)
    a.add_argument("--item-core", type=int, default=5)
    h = sub.add_parser("hm")
    h.add_argument("--transactions", required=True)
    h.add_argument("--articles", required=True)
    h.add_argument("--out", required=True)
    n = sub.add_parser("netflix")
    n.add_argument("--llmrec-dir", required=True)
    n.add_argument("--titles", default=None)
    n.add_argument("--out", required=True)
    args = p.parse_args()
    if args.cmd == "amazon":
        print(preprocess_amazon(args.reviews, args.meta, args.out,
                                args.subset, args.user_core, args.item_core))
    elif args.cmd == "hm":
        print(preprocess_hm(args.transactions, args.articles, args.out))
    else:
        print(preprocess_netflix(args.llmrec_dir, args.out, args.titles))
