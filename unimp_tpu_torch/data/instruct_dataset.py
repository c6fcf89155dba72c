"""Instruction-tuning datasets (legacy Otter/MIMIC-IT family).

The port's own copy of ``unimp_tpu/data/instruct_dataset.py``: the same
rendering, the same ``random`` and numpy streams, images through the
port's ``load_resized_uint8``.

Capability parity with the reference's pretraining/instruction data path
(UniMP's pipeline/mm_utils/unify_dataset.py:62-443,
mimicit_dataset.py:41-120, input_dataset.py:7-60):

  * MultiInstructDataset — MIMIC-IT-style JSON: per-sample instruction/
    answer (+images), with optional in-context related samples rendered
    as "<image> User: ... GPT: <answer> ... <|endofchunk|>" chains
  * FileDataset — TSV-backed dataset with per-rank slicing for
    multi-host reads

Used for general instruction tuning on top of the same model; the UniMP
task scripts don't exercise it (SURVEY.md C9), but the framework keeps
the capability.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from unimp_tpu_torch.data.transforms import load_resized_uint8

# ---------------------------------------------------------------------------
# Text normalization (reference parity: unify_dataset.py:125-175).
# ---------------------------------------------------------------------------

_MULTISPACE = re.compile(r"\s{2,}")


def pre_question(question: str, max_words: int) -> str:
    """Normalize an instruction string (unify_dataset.py:125-143): lowercase,
    strip leading punctuation, '-' and '/' become spaces, collapse runs of
    whitespace, then truncate to max_words space-separated words."""
    question = (
        question.lower().lstrip(",.!?*#:;~").replace("-", " ").replace("/", " ")
    )
    question = _MULTISPACE.sub(" ", question)
    question = question.rstrip("\n").strip(" ")
    words = question.split(" ")
    if len(words) > max_words:
        question = " ".join(words[:max_words])
    return question


def pre_answer(answer: str, max_words: int) -> str:
    """Normalize an answer string (unify_dataset.py:145-174): collapse
    whitespace, then greedily keep whole '.'-separated sentences while the
    running text stays within max_words; fall back to a hard word cut when
    even the first sentence is too long.

    Reference quirk kept on purpose: the terminal '.' is re-appended whenever
    the kept text doesn't end in one — the guard `return_answer != answers`
    at unify_dataset.py:170 compares a str to a list, so it is always true.
    """
    answer = _MULTISPACE.sub(" ", answer)
    answer = answer.rstrip("\n").strip(" ")
    return_answer = ""
    sentences = answer.split(".")
    for sentence in sentences:
        cur = sentence if not return_answer else ".".join([return_answer, sentence])
        if len(cur.split(" ")) <= max_words:
            return_answer = cur
        else:
            break
    if return_answer == "":
        return_answer = " ".join(answer.split(" ")[:max_words])
    elif return_answer[-1] != ".":
        return_answer += "."
    return return_answer


# ---------------------------------------------------------------------------
# Per-source MIMIC-IT processors (reference parity: the process_* family at
# unify_dataset.py:205-443). Reworked as pure functions: the sample store and
# RNG are injected, and instead of eagerly decoding base64 images they return
# the image ids plus the chunk layout, so the host pipeline can batch-decode
# on the host. Each source renders a distinct in-context chain:
#
#   LA    one <image> per chain item, chain shuffled        (.py:205-237)
#   DC    single leading <image>, chain shuffled,
#         only the query sample's images                    (.py:239-269)
#   E4D   same format as DC                                 (.py:271-301)
#   SD    no in-context; "<image>User: ..." query only      (.py:303-327)
#   SN    in-context rendered WITHOUT shuffling, single
#         leading <image>, query appended last              (.py:329-363)
#   FunQA same format as DC                                 (.py:365-395)
#
# Reference bug, not reproduced: process_scene_navigation's final line reads
# `all_texts` before assignment (unify_dataset.py:362) and raises
# UnboundLocalError upstream; we render the evident intent
# (incontext_text + query_text).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RenderedInstruction:
    """One rendered training chain.

    image_ids are grouped per <image> chunk: LA yields one singleton group
    per chain item ([N, 1] layout, reference patch_images [N, 1, C, H, W]);
    every other source yields a single group of the query's images
    ([1, N] layout, reference patch_images [1, N, C, H, W]).
    """

    text: str
    image_groups: List[List[str]]


def _chain_text(store: Dict[str, dict], order: Sequence[str],
                max_src: int, max_tgt: int, with_image: bool) -> str:
    parts = []
    prefix = "<image>" if with_image else ""
    for sid in order:
        rec = store[sid]
        q = pre_question(rec["instruction"], max_src)
        a = pre_answer(rec["answer"], max_tgt)
        parts.append(f"{prefix}User: {q} GPT:<answer> {a}<|endofchunk|>")
    return "".join(parts)


def process_llava(store, sample_id, in_context_ids, rng,
                  max_src=256, max_tgt=256) -> RenderedInstruction:
    order = list(in_context_ids) + [sample_id]
    rng.shuffle(order)
    text = _chain_text(store, order, max_src, max_tgt, with_image=True)
    groups = [[store[sid]["image_ids"][0]] for sid in order]
    return RenderedInstruction(text=text, image_groups=groups)


def _shuffled_single_image(store, sample_id, in_context_ids, rng,
                           max_src, max_tgt) -> RenderedInstruction:
    order = list(in_context_ids) + [sample_id]
    rng.shuffle(order)
    text = "<image>" + _chain_text(store, order, max_src, max_tgt,
                                   with_image=False)
    return RenderedInstruction(
        text=text, image_groups=[list(store[sample_id]["image_ids"])]
    )


def process_dense_caption(store, sample_id, in_context_ids, rng,
                          max_src=256, max_tgt=256) -> RenderedInstruction:
    return _shuffled_single_image(store, sample_id, in_context_ids, rng,
                                  max_src, max_tgt)


def process_e4d(store, sample_id, in_context_ids, rng,
                max_src=256, max_tgt=256) -> RenderedInstruction:
    return _shuffled_single_image(store, sample_id, in_context_ids, rng,
                                  max_src, max_tgt)


def process_funqa(store, sample_id, in_context_ids, rng,
                  max_src=256, max_tgt=256) -> RenderedInstruction:
    return _shuffled_single_image(store, sample_id, in_context_ids, rng,
                                  max_src, max_tgt)


def process_spot_the_difference(store, sample_id, in_context_ids, rng,
                                max_src=256, max_tgt=256) -> RenderedInstruction:
    text = _chain_text(store, [sample_id], max_src, max_tgt, with_image=True)
    return RenderedInstruction(
        text=text, image_groups=[list(store[sample_id]["image_ids"])]
    )


def process_scene_navigation(store, sample_id, in_context_ids, rng,
                             max_src=256, max_tgt=256) -> RenderedInstruction:
    incontext = _chain_text(store, in_context_ids, max_src, max_tgt,
                            with_image=False)
    query = _chain_text(store, [sample_id], max_src, max_tgt, with_image=False)
    return RenderedInstruction(
        text=f"<image>{incontext}{query}",
        image_groups=[list(store[sample_id]["image_ids"])],
    )


_SOURCE_PROCESSORS: List[tuple] = [
    # Prefix dispatch order matters: process_image_text_pair checks
    # LA / DC / E4D / SD / SN / FunQA in this order (unify_dataset.py:418-443).
    ("LA", process_llava),
    ("DC", process_dense_caption),
    ("E4D", process_e4d),
    ("SD", process_spot_the_difference),
    ("SN", process_scene_navigation),
    ("FunQA", process_funqa),
]


def render_mimicit_sample(store: Dict[str, dict], sample_id: str,
                          in_context_ids: Sequence[str], rng: random.Random,
                          max_src: int = 256, max_tgt: int = 256,
                          ) -> Optional[RenderedInstruction]:
    """Dispatch a MIMIC-IT sample to its per-source processor by id prefix
    (unify_dataset.py:418-443; max_src/max_tgt fixed at 256 there).
    Returns None for unknown prefixes so callers can fall back to the
    generic renderer — and likewise when any record in the chain lacks
    image_ids: the prefixes are bare strings, so a non-MIMIC-IT dataset
    whose ids merely start with "LA"/"DC"/... must not be routed into
    processors that index image_ids[0] unconditionally."""
    for prefix, fn in _SOURCE_PROCESSORS:
        if sample_id.startswith(prefix):
            chain = list(in_context_ids) + [sample_id]
            if any(not store[sid].get("image_ids") for sid in chain):
                return None
            return fn(store, sample_id, in_context_ids, rng,
                      max_src=max_src, max_tgt=max_tgt)
    return None


class MultiInstructDataset:
    """samples: {id: {"instruction", "answer", "image_ids": [...],
    "rel_ins_ids": [...]}}; images under image_dir/{image_id}.jpg."""

    def __init__(
        self,
        annotations_path: str,
        image_dir: str,
        tokenizer,
        *,
        max_incontext: int = 2,
        image_size: int = 224,
        seed: int = 0,
    ):
        with open(annotations_path) as f:
            payload = json.load(f)
        self.data: Dict[str, dict] = payload.get("data", payload)
        self.keys = list(self.data.keys())
        self.image_dir = image_dir
        self.tokenizer = tokenizer
        self.max_incontext = max_incontext
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)
        self.chain_rng = random.Random(seed)

    def __len__(self):
        return len(self.keys)

    def _render(self, rec: dict) -> str:
        return (
            f"<image> User: {rec['instruction']} "
            f"GPT: <answer> {rec['answer']} <|endofchunk|> "
        )

    def __getitem__(self, index: int) -> dict:
        key = self.keys[index]
        rec = self.data[key]
        rel = [r for r in rec.get("rel_ins_ids", [])[: self.max_incontext]
               if r in self.data]
        rendered = render_mimicit_sample(self.data, key, rel, self.chain_rng)
        if rendered is not None:
            text = rendered.text
            image_ids = [i for grp in rendered.image_groups for i in grp]
        else:
            chain = [self.data[rid] for rid in rel] + [rec]
            text = "".join(self._render(r) for r in chain).rstrip()
            image_ids = [i for r in chain for i in r.get("image_ids", [])]
        images = np.stack([
            load_resized_uint8(
                os.path.join(self.image_dir, f"{i}.jpg"), self.image_size
            )
            for i in image_ids
        ]) if image_ids else np.zeros(
            (1, self.image_size, self.image_size, 3), np.uint8
        )
        ids = self.tokenizer.encode(text, add_bos=True, add_eos=True)
        return {
            "input_ids": np.asarray(ids, np.int32),
            "images": images,
            "weight": 1.0,
            "task": "instruct",
        }


class FileDataset:
    """TSV rows with per-rank slicing (input_dataset.py:47-56): rank r of
    w reads rows where row_index % w == r, enabling multi-host sharded
    streaming of very large files without an index."""

    def __init__(self, file_path: str, selected_cols: Optional[str] = None,
                 separator: str = "\t", rank: int = 0, world_size: int = 1):
        self.file_path = file_path
        self.separator = separator
        self.rank = rank
        self.world_size = world_size
        self.selected = (
            [int(c) for c in selected_cols.split(",")]
            if selected_cols else None
        )
        with open(file_path) as f:
            self.row_count = sum(1 for _ in f)

    def __len__(self):
        return (self.row_count - self.rank + self.world_size - 1) // self.world_size

    def __iter__(self):
        with open(self.file_path) as f:
            for i, line in enumerate(f):
                if i % self.world_size != self.rank:
                    continue
                cols = line.rstrip("\n").split(self.separator)
                yield [cols[c] for c in self.selected] if self.selected else cols
