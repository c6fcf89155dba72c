"""Task prompt builders: the port's copy of ``unimp_tpu/data/prompts.py``
(string-exact parity with the reference RecDataset).

Pure functions (all randomness via an injected numpy Generator; all I/O —
image loading, tokenization — done by the caller), mirroring
UniMP's pipeline/mm_utils/rec_dataset.py:

  meta extractors      rec_dataset.py:301-370
  rec train/eval       rec_dataset.py:372-456 / :458-535
  search train/eval    rec_dataset.py:842-915 / :917-979
  img_sel train/eval   rec_dataset.py:981-1046 / :1048-1098
  exp train/eval       rec_dataset.py:1100-1156 / :1158-1215
  img_gen train/eval   rec_dataset.py:613-664 / :666-720 (retrieve variant)

Each builder returns a Sample: the prompt text (with <image>/<answer>/
<|endofchunk|> markers), the ordered image ids to load, the loss weight
(rec=2.0, others=1.0 — rec_dataset.py:455,911,1043,1153), and for eval
the generation target(s).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Sample:
    text: str
    image_ids: List[int]
    weight: float = 1.0
    target: Any = None  # eval only: target string / label indices / ratings
    extra: Optional[dict] = None


def _truncate_words(s: str, n: int) -> str:
    return " ".join(str(s).split()[:n])


@dataclasses.dataclass
class PromptBuilder:
    """Holds per-dataset metadata and emits per-task prompts."""

    subset: str  # "all" | "netflix" | "hm" | custom
    meta_data: Dict[str, Any]
    history_len: int
    n_items: int
    use_semantic: bool = False
    id2semantic: Optional[Dict[str, str]] = None
    img_id2semantic: Optional[Dict[str, Sequence[int]]] = None
    len_semanticid: int = 3  # rec_dataset.py:127

    # ------------- meta extractors -------------

    def extract_meta(self, item) -> str:
        if self.subset == "netflix":
            year, title = self.meta_data[str(item)][0], self.meta_data[str(item)][1]
            return f"Title {_truncate_words(title, 20)} Release Date {year}"
        if self.subset == "hm":
            prod, app, color, section = self.meta_data[str(item)][:4]
            return (
                f"Name {_truncate_words(prod, 20)} "
                f"Appearance {_truncate_words(app, 20)} "
                f"Color {_truncate_words(color, 20)} "
                f"Section {_truncate_words(section, 20)}"
            )
        m = self.meta_data[str(item)]
        cat = _truncate_words(m["category"] or "Unknown", 20)
        brand = _truncate_words(m.get("brand", "") or "Unknown", 20)
        title = _truncate_words(m.get("title", "") or "Unknown", 20)
        price = m.get("price", "") or "Unknown"
        return f"Category {cat} Price {price} Brand {brand} Title {title}"

    def extract_meta_gen(self, item) -> str:
        m = self.meta_data[str(item)]
        title = _truncate_words(m.get("title", "") or "Unknown", 20)
        img_id = "".join(
            f"img_{i}," for i in self.img_id2semantic[str(item)]
        )
        return f"Title {title} ID {img_id}"

    def _item_token(self, item, joiner: str = "") -> str:
        """Answer token(s) for an item: atomic or semantic-ID tuple."""
        if not self.use_semantic:
            return f"item_{item}"
        sid = self.id2semantic[str(item)].split(",")
        parts = [
            f"item_{s}" if i < self.len_semanticid else f"item_last_{s}"
            for i, s in enumerate(sid)
        ]
        return joiner.join(parts)

    # ------------- rec -------------

    def train_rec(self, full_seq, rng: np.random.Generator) -> Sample:
        seq = [it[0] for it in full_seq]
        start = int(rng.integers(0, len(seq) - self.history_len))
        end = start + self.history_len
        text, imgs = "", []
        for item in seq[start:end]:
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} <answer> {self._item_token(item)} <|endofchunk|> "
        text += (
            "What is the next item recommended to the user? "
            f"<answer> {self._item_token(seq[end])}"
        )
        return Sample(text, imgs, weight=2.0)

    def eval_rec(self, full_seq) -> Sample:
        seq = [it[0] for it in full_seq]
        test_len = 20 if self.subset == "hm" else 5  # rec_dataset.py:463-466
        text, imgs = "", []
        for item in seq[-test_len:-1]:
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} {self._item_token(item)} <|endofchunk|> "
        text += "What is the next item recommended to the user? <answer>"
        return Sample(text, imgs, target=self._item_token(seq[-1]))

    # ------------- search -------------

    def _query(self, item) -> str:
        m = self.meta_data[str(item)]
        if self.subset == "cloth":
            return m["keywords"]
        return m["category"]

    def train_search(self, full_seq, rng: np.random.Generator) -> Sample:
        seq = [it[0] for it in full_seq]
        start = int(rng.integers(0, len(seq) - self.history_len))
        end = start + self.history_len
        text, imgs = "", []
        for item in seq[start:end]:
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} <answer> {self._item_token(item, ' ')} <|endofchunk|> "
        item = seq[end]
        text += (
            f"Query: {self._query(item)} What is the related item ID to the "
            f"query based on the history? <answer> {self._item_token(item, ' ')}"
        )
        return Sample(text, imgs, weight=1.0)

    def eval_search(self, full_seq) -> Sample:
        seq = [it[0] for it in full_seq]
        text, imgs = "", []
        for item in seq[-5:-1]:
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} {self._item_token(item, ' ')} <|endofchunk|> "
        item = seq[-1]
        text += (
            f"Query: {self._query(item)} What is the related item ID to the "
            "query based on the history? <answer>"
        )
        return Sample(text, imgs, target=self._item_token(item, " "))

    # ------------- img_sel -------------

    NUM_SEL = 3  # rec_dataset.py:988 (num_items)

    def train_img_sel(self, full_seq, rng: np.random.Generator) -> Sample:
        text, imgs = "User history: ", []
        start = -(self.history_len - self.NUM_SEL + 1)
        cur_items = []
        for full_item in full_seq[start:-1]:
            item = full_item[0]
            cur_items.append(item)
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} <|endofchunk|> "
        text += "Select from: "
        item_set = full_seq[-1][-2]
        gt_index = full_seq[-1][-1]
        gt_items = [item_set[i] for i in gt_index]
        cur_items.extend(gt_items)
        len_gt = len(gt_items)
        labels = rng.choice(self.NUM_SEL, size=len_gt, replace=False)
        neg_index = sorted(set(range(self.NUM_SEL)) - set(labels.tolist()))
        pool = sorted(set(range(self.n_items)) - set(cur_items))
        negs = rng.choice(pool, size=self.NUM_SEL - len_gt, replace=False)
        slots = [0] * self.NUM_SEL
        for i, it in enumerate(gt_items):
            slots[int(labels[i])] = it
        for i, it in enumerate(negs):
            slots[neg_index[i]] = int(it)
        for i, it in enumerate(slots):
            imgs.append(it)
            text += f"<image> Selection s_{i} {self.extract_meta(it)} <|endofchunk|> "
        text += "Can you select the suitable item from above for the user? <answer> "
        for lab in labels:
            text += f"s_{lab} "
        return Sample(text, imgs, weight=1.0)

    def eval_img_sel(self, full_seq) -> Sample:
        text, imgs = "User history: ", []
        for full_item in full_seq[-5:-1]:
            item = full_item[0]
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} <|endofchunk|> "
        text += "Select from: "
        item_set = full_seq[-1][-2]
        for i, it in enumerate(item_set):
            imgs.append(it)
            text += f"<image> Selection s_{i} {self.extract_meta(it)} <|endofchunk|> "
        text += "Can you select the suitable item from above for the user? <answer>"
        return Sample(text, imgs, target=list(full_seq[-1][-1]))

    # ------------- exp (rating + explanation) -------------

    def train_exp(self, full_seq, rng: np.random.Generator) -> Sample:
        start = int(rng.integers(0, len(full_seq) - self.history_len + 1))
        end = start + self.history_len - 1
        text, imgs = "", []
        for full_item in full_seq[start:end]:
            item, exp, rate = full_item[0], full_item[1], int(full_item[2])
            exp = _truncate_words(exp, 30)
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} <answer> rate_{rate} {exp} <|endofchunk|> "
        full_item = full_seq[end]
        item, exp, rate = full_item[0], full_item[1], int(full_item[2])
        exp = _truncate_words(exp, 30)
        imgs.append(item)
        text += (
            f"<image> {self.extract_meta(item)} What is the rating and "
            f"explanation for the item? <answer> rate_{rate} {exp}"
        )
        return Sample(text, imgs, weight=1.0)

    def eval_exp(self, full_seq) -> Sample:
        text, imgs = "", []
        for full_item in full_seq[-5:-1]:
            item, exp, rate = full_item[0], full_item[1], int(full_item[2])
            imgs.append(item)
            text += f"<image> {self.extract_meta(item)} <answer> rate_{rate} {exp} <|endofchunk|> "
        full_item = full_seq[-1]
        item, exp, rate = full_item[0], full_item[1], int(full_item[2])
        imgs.append(item)
        text += (
            f"<image> {self.extract_meta(item)} What is the rating and "
            "explanation for the item? <answer>"
        )
        return Sample(text, imgs, target={"rating": rate, "explanation": exp})

    # ------------- img_gen (retrieval variant) -------------

    def train_img_gen(self, seq, rng: np.random.Generator) -> Sample:
        end = -1
        start = end - self.history_len
        text, imgs = "", []
        for item in seq[start:end]:
            imgs.append(item)
            text += f"<image> {self.extract_meta_gen(item)} <|endofchunk|> "
        item = seq[end]
        img_id = "".join(f"img_{i}," for i in self.img_id2semantic[str(item)])
        query = _truncate_words(self.meta_data[str(item)]["keywords"], 30)
        text += (
            f"Query: {query} What is the generated image ID to the query "
            f"based on the history? <answer> {img_id}"
        )
        return Sample(text, imgs, weight=1.0)

    def eval_img_gen(self, seq) -> Sample:
        end = -1
        start = end - self.history_len
        text, imgs = "", []
        for item in seq[start:end]:
            imgs.append(item)
            text += f"<image> {self.extract_meta_gen(item)} <|endofchunk|> "
        item = seq[end]
        img_id = "".join(f"img_{i}," for i in self.img_id2semantic[str(item)])
        query = _truncate_words(self.meta_data[str(item)]["keywords"], 30)
        text += (
            f"Query: {query} What is the generated Image ID to the query "
            "based on the history? <answer>"
        )
        return Sample(text, imgs, target=img_id, extra={"item": item})

    # ------------- img_gen (pretrain variant) -------------
    # rec_dataset.py:536-571 (train) / :573-611 (eval): single-item
    # query->image-ID pairs over the catalog. Quirks kept verbatim: the
    # train prompt says "image ID", the eval prompt "Image ID"; neither
    # contains an <image> marker (the reference loads the item's image
    # but the prompt never references it), and the semantic image IDs
    # are SPACE-joined (the retrieve variant comma-joins).

    def train_img_gen_pretrain(self, item, rng: np.random.Generator) -> Sample:
        img_id = " ".join(f"img_{i}" for i in self.img_id2semantic[str(item)])
        query = _truncate_words(self.meta_data[str(item)]["title"], 30)
        text = (
            f"Query: {query}. What is the generated image ID to the query? "
            f"<answer> {img_id}"
        )
        return Sample(text, [item], weight=1.0)

    def eval_img_gen_pretrain(self, item) -> Sample:
        img_id = " ".join(f"img_{i}" for i in self.img_id2semantic[str(item)])
        query = _truncate_words(self.meta_data[str(item)]["title"], 30)
        text = (
            f"Query: {query}. What is the generated Image ID to the query? "
            "<answer>"
        )
        return Sample(text, [item], target=img_id, extra={"item": item})

    # ------------- dispatch -------------

    def build(self, task: str, split: str, record, rng: np.random.Generator) -> Sample:
        train = split == "train"
        if task == "rec":
            return self.train_rec(record, rng) if train else self.eval_rec(record)
        if task == "search":
            return self.train_search(record, rng) if train else self.eval_search(record)
        if task == "img_sel":
            return self.train_img_sel(record, rng) if train else self.eval_img_sel(record)
        if task == "exp":
            return self.train_exp(record, rng) if train else self.eval_exp(record)
        if task == "img_gen":
            return self.train_img_gen(record, rng) if train else self.eval_img_gen(record)
        if task == "img_gen_pretrain":
            return (self.train_img_gen_pretrain(record, rng) if train
                    else self.eval_img_gen_pretrain(record))
        raise KeyError(f"unsupported task {task!r}")
