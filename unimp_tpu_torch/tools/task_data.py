"""Task-data derivation: img_sel candidates, exp subsets, image denoise.

Counterpart of ``unimp_tpu/tools/task_data.py``, for the reference's
``data/`` scripts:
  * gen_img_sel.py   — per user: with p<0.6 one positive (the last item)
    else two positives (last two); negatives sampled outside the user's
    sequence; final element becomes [..positives.., item_set, labels]
  * keep_exp.py      — keep users whose non-empty-explanation count is
    >= 6/7/8 for train/eval/test
  * filter_img_noise.py — drop items whose image fails to decode, then
    re-run the K-core filter

An image is ok when the port's decoders read it whole (JPEG, PNG, GIF,
BMP; ``data/transforms.py``). The JAX package asks PIL, whose verdict on
a file cut short depends on the process-wide
``ImageFile.LOAD_TRUNCATED_IMAGES`` (set by its image loader once any
image was loaded); a fresh process drops such a file, and so does this.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Set

import numpy as np

from unimp_tpu_torch.data.transforms import image_ok
from unimp_tpu_torch.tools.preprocess import filter_kcore

NUM_ITEMS = 3  # reference gen_img_sel.py NUM_ITEMS


def gen_img_sel(
    data: Dict, item_set: Set[int], rng: Optional[np.random.Generator] = None,
    num_items: int = NUM_ITEMS,
) -> Dict:
    rng = rng or np.random.default_rng(0)
    out = {}
    for key, full_seq in data.items():
        p = rng.random()
        if p < 0.6:
            new_seq = list(full_seq[:-1])
            cur = {it[0] for it in full_seq}
            negs = list(rng.choice(sorted(item_set - cur), num_items - 1,
                                   replace=False))
            positives = [full_seq[-1][0]]
            cands = negs + positives
            rng.shuffle(cands)
            labels = [i for i, it in enumerate(cands) if it in positives]
            new_seq.append([full_seq[-1], [int(c) for c in cands], labels])
        else:
            new_seq = list(full_seq[:-2])
            cur = {it[0] for it in full_seq}
            negs = list(rng.choice(sorted(item_set - cur), num_items - 2,
                                   replace=False))
            positives = [full_seq[-2][0], full_seq[-1][0]]
            cands = negs + positives
            rng.shuffle(cands)
            labels = [i for i, it in enumerate(cands) if it in positives]
            new_seq.append(
                [full_seq[-2], full_seq[-1], [int(c) for c in cands], labels]
            )
        out[key] = new_seq
    return out


EXP_THRESHOLDS = {"train": 6, "eval": 7, "test": 8}  # keep_exp.py:9-14


def keep_exp(data: Dict, split: str) -> Dict:
    thresh = EXP_THRESHOLDS[split]
    out = {}
    for key, full_seq in data.items():
        kept = [it for it in full_seq if it[1] != ""]
        if len(kept) >= thresh:
            out[key] = kept
    return out


def filter_img_noise(
    data: Dict, img_dir: str, user_core: int = 8, item_core: int = 5,
) -> Dict:
    """Drop interactions whose item image is missing/corrupt, then
    re-enforce the K-core (reference filter_img_noise.py)."""
    ok: Dict[int, bool] = {}

    def item_ok(item: int) -> bool:
        if item not in ok:
            ok[item] = image_ok(os.path.join(img_dir, f"{item}.jpg"))
        return ok[item]

    cleaned = {
        u: [it for it in seq if item_ok(it[0])] for u, seq in data.items()
    }
    cleaned = {u: s for u, s in cleaned.items() if s}
    return filter_kcore(cleaned, user_core, item_core)


def derive_all(data_dir: str, subset: str, n_items: int, seed: int = 0):
    """Run gen_img_sel + keep_exp over every split in a dataset dir."""
    rng = np.random.default_rng(seed)
    item_set = set(range(n_items))
    for split in ("train", "eval", "test"):
        with open(os.path.join(data_dir, f"{split}_users.json")) as f:
            data = json.load(f)
        with open(os.path.join(data_dir, f"{split}_{subset}_img_sel.json"), "w") as f:
            json.dump(gen_img_sel(data, item_set, rng), f)
        with open(os.path.join(data_dir, f"{split}_{subset}_exp.json"), "w") as f:
            json.dump(keep_exp(data, split), f)


if __name__ == "__main__":
    import argparse

    # python -m unimp_tpu_torch.tools.task_data --data-dir DIR --n-items N
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", required=True)
    p.add_argument("--subset", default="all")
    p.add_argument("--n-items", type=int, required=True)
    args = p.parse_args()
    derive_all(args.data_dir, args.subset, args.n_items)
