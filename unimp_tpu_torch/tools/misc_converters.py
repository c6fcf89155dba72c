"""Miscellaneous converters (the reference's ``pipeline/utils`` scripts).

Counterpart of ``unimp_tpu/tools/misc_converters.py`` (host code):

  * apply_delta      — reconstruct target weights from a base checkpoint
    plus a delta (vicuna-style; the reference's apply_delta.py), over
    nested dicts of arrays or tensors
  * jsonl sharding   — interleaved web-corpus records -> size-bounded
    jsonl shards, the storage-agnostic equivalent of
    convert_mmc4_to_wds.py (plain shards instead of tar / webdataset)
  * the MIMIC-IT and LLaVA instruction indexes and the image index
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional

import numpy as np


def _tree_map(fn, a, b):
    """``fn`` leaf by leaf over two nested dicts of one structure."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise ValueError(f"tree structures differ: {sorted(a)} vs "
                             f"{sorted(b) if isinstance(b, dict) else type(b).__name__}")
        return {k: _tree_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def apply_delta(base_params, delta_params):
    """target = base + delta, leaf-wise; shapes must match."""
    def add(b, d):
        b = np.asarray(b)
        d = np.asarray(d)
        if b.shape != d.shape:
            raise ValueError(f"shape mismatch {b.shape} vs {d.shape}")
        return b + d

    return _tree_map(add, base_params, delta_params)


def make_delta(base_params, target_params):
    return _tree_map(lambda b, t: np.asarray(t) - np.asarray(b), base_params, target_params)


def shard_jsonl(
    records: Iterable[dict], out_dir: str, *, prefix: str = "shard",
    max_records_per_shard: int = 10_000,
) -> List[str]:
    """Write records into {out_dir}/{prefix}-{i:05d}.jsonl shards."""
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    buf: List[str] = []

    def flush():
        if not buf:
            return
        path = os.path.join(out_dir, f"{prefix}-{len(paths):05d}.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(buf) + "\n")
        paths.append(path)
        buf.clear()

    for rec in records:
        buf.append(json.dumps(rec))
        if len(buf) >= max_records_per_shard:
            flush()
    flush()
    return paths


def build_mimicit_train_index(
    instructions_path: str,
    out_path: str,
    *,
    round_delim: str = "_round",
) -> dict:
    """MIMIC-IT instructions JSON -> train index {final_round_id:
    rel_ins_ids}.

    The reference's get_SD/SN/llava generators
    (pipeline/utils/get_SN_train_data.py:14-44)
    walk a MIMIC-IT ``{"data": {id: {instruction, answer, image_ids,
    rel_ins_ids}}}`` file, group the instruction ids by conversation
    (everything before the trailing round number), and keep only each
    conversation's FINAL round as a training sample — its
    ``rel_ins_ids`` then provide the in-context chain
    (mimicit_dataset.py:82-120; consumed here by
    data/instruct_dataset.MultiInstructDataset). This is the generic,
    source-agnostic version of those per-dataset scripts.
    """
    import re

    with open(instructions_path) as f:
        payload = json.load(f)
    data = payload.get("data", payload)

    def split_round(ins_id: str):
        m = re.match(rf"^(.*{re.escape(round_delim)})(\d+)$", ins_id)
        if m:
            return m.group(1), int(m.group(2))
        return ins_id, 0  # no round structure: every id is final

    last_round: dict = {}
    for ins_id in data:
        conv, rnd = split_round(ins_id)
        if conv not in last_round or rnd > last_round[conv][1]:
            last_round[conv] = (ins_id, rnd)

    index = {
        ins_id: list(data[ins_id].get("rel_ins_ids", []))
        for ins_id, _ in last_round.values()
    }
    with open(out_path, "w") as f:
        json.dump(index, f)
    return index


def llava_train_index(
    instructions_path: str,
    out_path: str,
    *,
    rel_ins_ids_num: int = 2,
) -> dict:
    """LLaVA-family MIMIC-IT instructions -> train index, reproducing
    get_llava_train_data.py (pipeline/utils/get_llava_train_data.py:6-71):

      * CONV files (multi-round conversations, ids
        ``LACONV_00_INS_{conv}_{round}``): keep only each conversation's
        FINAL round; samples with zero in-context ids are DROPPED; the
        LAST ``rel_ins_ids_num`` ids are kept, padded by repetition when
        fewer.
      * other LA files (LACR_I2I / LACR_T2T / LADD, single-round): every
        id is a sample; the FIRST ``rel_ins_ids_num`` ids are kept (note
        first vs the CONV path's last — a reference asymmetry kept as
        is), repetition-padded, and zero-id samples are kept with [].

    CONV-ness is detected from the ids themselves (``LACONV`` prefix)
    rather than the reference's filename sniff.
    """
    with open(instructions_path) as f:
        data = json.load(f)
    data = data.get("data", data)

    def pad(rel, take_last):
        if len(rel) < rel_ins_ids_num:
            if not rel:
                return []
            rel = list(rel) * rel_ins_ids_num
            return rel[-rel_ins_ids_num:]
        return (list(rel[-rel_ins_ids_num:]) if take_last
                else list(rel[:rel_ins_ids_num]))

    index: dict = {}
    conv_ids = [i for i in data if i.startswith("LACONV")]
    if conv_ids:
        last_round: dict = {}
        for ins_id in conv_ids:
            *_, conv, rnd = ins_id.split("_")
            if conv not in last_round or int(rnd) > last_round[conv][1]:
                last_round[conv] = (ins_id, int(rnd))
        for ins_id, _ in last_round.values():
            rel = pad(data[ins_id].get("rel_ins_ids", []), take_last=True)
            if rel:
                index[ins_id] = rel
    for ins_id in data:
        if ins_id.startswith("LACONV"):
            continue
        index[ins_id] = pad(data[ins_id].get("rel_ins_ids", []),
                            take_last=False)
    with open(out_path, "w") as f:
        json.dump(index, f)
    return index


def llava_instructions_from_conversations(
    src_path: str,
    out_path: str,
    *,
    mode: str = "conv",           # "conv" | "single"
    prefix: str = "LACR_I2I",     # single-round id prefix
    similarity: Optional[dict] = None,  # id -> [similar ids] (single mode)
) -> dict:
    """LLaVA-Instruct-150K conversations JSON -> MIMIC-IT instructions
    JSON, reproducing get_llava_interleaved_data.py
    (pipeline/utils/get_llava_interleaved_data.py:33-98):

      * conv mode: each user/gpt turn pair becomes a round
        ``LACONV_00_INS_{id}_{round}`` whose in-context ids are all the
        PREVIOUS rounds of the same conversation; image
        ``LA_00_IMG_{id}``.
      * single mode (complex-reasoning / detail-description): the first
        turn pair only, id ``{prefix}_00_INS_{id}``, image_ids=[id],
        in-context ids drawn from a retrieval ``similarity`` map
        (clip/text top-k — tools/features.py builds those).

    "<image>" markers are stripped from turn text in both modes.
    """
    with open(src_path) as f:
        rows = json.load(f)
    out = {"meta": {"version": "0.0.1", "time": "2023-06", "author": "ntu"},
           "data": {}}
    data = out["data"]
    for rec in rows:
        convs = rec["conversations"]
        if mode == "conv":
            for cur in range(0, len(convs) - 1, 2):
                rnd = cur // 2
                ins_id = f"LACONV_00_INS_{rec['id']}_{rnd}"
                data[ins_id] = {
                    "instruction": convs[cur]["value"].strip()
                    .replace("<image>", ""),
                    "answer": convs[cur + 1]["value"].strip()
                    .replace("<image>", ""),
                    "image_ids": [f"LA_00_IMG_{rec['id']}"],
                    "rel_ins_ids": [
                        f"LACONV_00_INS_{rec['id']}_{p}" for p in range(rnd)
                    ],
                }
        else:
            # duplicate source ids: LAST occurrence wins — the reference's
            # dedup check tests the top-level {meta,data} dict (a no-op),
            # so later rows overwrite earlier ones there too.
            ins_id = f"{prefix}_00_INS_{rec['id']}"
            rel = ([f"{prefix}_00_INS_{p}"
                    for p in (similarity or {}).get(str(rec["id"]), [])])
            data[ins_id] = {
                "instruction": convs[0]["value"].strip()
                .replace("<image>", ""),
                "answer": convs[1]["value"].strip().replace("<image>", ""),
                "image_ids": [rec["id"]],
                "rel_ins_ids": rel,
            }
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out


def collect_image_index(
    tsv_paths: List[str],
    out_path: str,
    *,
    strip_round_suffix: bool = False,
) -> dict:
    """Dedupe LLaVA 8-column TSVs (uniq_id, image, caption, question,
    refs, gt_objects, dataset_name, type) into {id: {"id", "image"}}
    (get_llava_image_data.py:5-75). ``strip_round_suffix`` applies the
    conversation-file normalization (``uniq_id.split("_")[0]``)."""
    image_dict: dict = {}
    for path in tsv_paths:
        with open(path) as f:
            for line in f:
                uniq_id = line.rstrip("\n").split("\t")[0]
                cols = line.rstrip("\n").split("\t")
                if strip_round_suffix:
                    uniq_id = uniq_id.split("_")[0]
                if uniq_id not in image_dict:
                    image_dict[uniq_id] = {"id": uniq_id, "image": cols[1]}
    with open(out_path, "w") as f:
        json.dump(image_dict, f)
    return image_dict


def convert_interleaved_corpus(
    manifest_path: str, out_dir: str, **kw
) -> List[str]:
    """MMC4-style interleaved docs (one JSON per line: {"text_list",
    "image_info", ...}) -> jsonl shards (convert_mmc4_to_wds.py parity)."""
    def gen():
        with open(manifest_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)

    return shard_jsonl(gen(), out_dir, **kw)
