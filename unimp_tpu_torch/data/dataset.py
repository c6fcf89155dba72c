"""Task dataset: JSON user sequences + item images -> encoded samples.

Counterpart of ``unimp_tpu/data/dataset.py`` (capability parity with the
reference RecDataset, UniMP's pipeline/mm_utils/rec_dataset.py:56-279),
for every task, alone or mixed:

  * file layout: ``{split}_users.json`` (rec, search),
    ``{split}_{subset}_exp.json``, ``{split}_{subset}_img_sel.json``,
    ``search_merge_{split}.txt`` (img_gen retrieval sequences, a JSON
    list), ``meta_{subset}.json`` (its keys are img_gen_pretrain's
    records), ``id2semantic.json``/``img_id2semantic.json``, images at
    ``{subset}/{item_id}.jpg`` (rec_dataset.py:108-131)
  * per-subset history lengths: all=5 (img_gen: 2), netflix=3, hm=8
    (rec_dataset.py:134-142)
  * multi-task mixing with 25% subsampling of every non-final task, drawn
    from the dataset's rng (rec_dataset.py:180-206); each record keeps
    its task

Images are decoded and resized on the host (uint8, ``data/jpeg.py``) and
CLIP-normalized on the device (``transforms.normalize_on_device``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from unimp_tpu_torch.data.prompts import PromptBuilder
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.data.transforms import load_resized_uint8
from unimp_tpu_torch.data.vocab import ITEM_COUNTS

TASK_ORDER = {"img_sel": 0, "search": 1, "rec": 2, "exp": 3}  # rec_dataset.py:181

HISTORY_LEN = {"all": 5, "netflix": 3, "hm": 8}  # rec_dataset.py:134-142


class TaskDataset:
    """Map-style dataset over (task, user-record) pairs."""

    def __init__(
        self,
        data_dir: str,
        subset: str,
        task: Union[str, Sequence[str]],
        split: str,
        tokenizer: UniMPTokenizer,
        *,
        use_semantic: bool = False,
        image_size: int = 224,
        seed: int = 42,
        history_len: Optional[int] = None,
        n_items: Optional[int] = None,
        max_records: Optional[int] = None,
        load_images: bool = True,
    ):
        self.data_dir = data_dir
        self.subset = subset
        self.split = split
        self.tokenizer = tokenizer
        self.image_size = image_size
        # load_images=False: samples carry item image IDS instead of
        # pixels — the eval path encodes each item image once into a
        # device-side latent cache (evals/latent_cache.py) rather than
        # re-decoding + re-uploading it for every user that mentions it
        # (the reference re-encodes per user, eval_rec.py:100-110).
        self.load_images = load_images
        self.img_dir = os.path.join(data_dir, subset)
        self.rng = np.random.default_rng(seed)
        self._image_cache: Dict[int, np.ndarray] = {}

        if history_len is None:
            history_len = HISTORY_LEN.get(subset, 5)
            # as the JAX package compares it: a task list is never "img_gen"
            if task == "img_gen" and subset == "all":
                history_len = 2  # rec_dataset.py:135-136
        if n_items is None:
            n_items = ITEM_COUNTS.get(subset)

        meta = self._load_json(f"meta_{subset}.json")
        id2semantic = (
            self._load_json("id2semantic.json") if use_semantic else None
        )
        img_id2semantic = self._maybe_load_json("img_id2semantic.json")
        self.builder = PromptBuilder(
            subset=subset,
            meta_data=meta,
            history_len=history_len,
            n_items=n_items or len(meta),
            use_semantic=use_semantic,
            id2semantic=id2semantic,
            img_id2semantic=img_id2semantic,
        )

        self.records: List = []
        self.tasks: List[str] = []
        tasks = [task] if isinstance(task, str) else list(task)
        for i, t in enumerate(tasks):
            data = self._task_records(t)
            records = data if isinstance(data, list) else list(data.values())
            if i < len(tasks) - 1:  # 25% subsample of every non-final task
                idx = self.rng.permutation(len(records))[: int(0.25 * len(records))]
                records = [records[j] for j in idx]
            self.records.extend(records)
            self.tasks.extend([t] * len(records))
        if max_records is not None:
            self.records = self.records[:max_records]
            self.tasks = self.tasks[:max_records]

    # ------------- loading -------------

    def _path(self, name: str) -> str:
        return os.path.join(self.data_dir, name)

    def _load_json(self, name: str):
        with open(self._path(name)) as f:
            return json.load(f)

    def _maybe_load_json(self, name: str):
        p = self._path(name)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def _task_records(self, task: str):
        """The task's records: a dict keyed by user, or a list."""
        split = self.split
        if task in ("rec", "search"):
            return self._load_json(f"{split}_users.json")
        if task in ("exp", "img_sel"):
            return self._load_json(f"{split}_{self.subset}_{task}.json")
        if task == "img_gen":  # retrieval sequences (rec_dataset.py:169-176)
            return self._load_json(f"search_merge_{split}.txt")
        if task == "img_gen_pretrain":  # the catalogue's items (rec_dataset.py:174-178)
            return list(self.builder.meta_data.keys())
        raise KeyError(f"unsupported task {task!r}")

    # ------------- access -------------

    def __len__(self) -> int:
        return len(self.records)

    def _load_image(self, item_id: int) -> np.ndarray:
        if item_id in self._image_cache:
            return self._image_cache[item_id]
        img = load_resized_uint8(
            os.path.join(self.img_dir, f"{item_id}.jpg"), self.image_size
        )
        if len(self._image_cache) < 8192:
            self._image_cache[item_id] = img
        return img

    def item_image(self, item_id: int) -> np.ndarray:
        """Public accessor for the latent-cache builder."""
        return self._load_image(item_id)

    @property
    def n_items(self) -> int:
        return self.builder.n_items

    def __getitem__(self, index: int) -> dict:
        task = self.tasks[index]
        sample = self.builder.build(task, self.split, self.records[index], self.rng)
        train = self.split == "train"
        ids = self.tokenizer.encode(sample.text, add_bos=train, add_eos=train)
        out = {
            "input_ids": np.asarray(ids, np.int32),
            "weight": sample.weight,
            "task": task,
        }
        if self.load_images:
            out["images"] = np.stack(
                [self._load_image(i) for i in sample.image_ids]
            )
        else:
            out["image_ids"] = np.asarray(sample.image_ids, np.int32)
        if sample.target is not None:
            out["target"] = sample.target
        if sample.extra is not None:
            out["extra"] = sample.extra
        return out
