"""Batch collation: right-pad token ids, stack media, bucket lengths.

The port's copy of ``unimp_tpu/data/collate.py``. Semantics match the
reference collator (right padding to the batch max, UniMP's
pipeline/mm_utils/collate_rec.py:38-115), with sequence lengths bucketed
(rounded up to a multiple) as the JAX package buckets them, so a batch
has the same padded shape on both sides.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def collate_batch(
    samples: List[dict],
    pad_id: int,
    *,
    pad_to_multiple: int = 64,
    max_text_len: Optional[int] = None,
    fixed_media: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """samples: dicts with input_ids (int32 [T]), images (uint8/float
    [M, H, W, 3]), weight, and optional eval fields (target, input_len).

    Returns right-padded arrays:
      input_ids [B, T], attention_mask [B, T], seq_len [B], weights [B],
      images [B, M, H, W, 3], media_count [B]; eval extras passed through
      as python lists under "targets".
    """
    b = len(samples)
    lens = [len(s["input_ids"]) for s in samples]
    t = _round_up(max(lens), pad_to_multiple)
    if max_text_len is not None:
        t = min(t, max_text_len)
    ids = np.full((b, t), pad_id, np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, s in enumerate(samples):
        row = np.asarray(s["input_ids"], np.int32)[:t]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    seq_len = np.minimum(np.asarray(lens, np.int32), t)

    media_key = "images" if "images" in samples[0] else "image_ids"
    m = max(s[media_key].shape[0] for s in samples)
    if fixed_media is not None:
        m = max(m, fixed_media)
    media_count = np.zeros((b,), np.int32)
    if media_key == "images":
        img_shape = samples[0]["images"].shape[1:]
        media = np.zeros((b, m) + img_shape, samples[0]["images"].dtype)
    else:
        # id-only batches (latent-cache eval path): pad slots point at
        # item 0 — they are never attended (q_media stops at media_count)
        media = np.zeros((b, m), np.int32)
    for i, s in enumerate(samples):
        k = s[media_key].shape[0]
        media[i, :k] = s[media_key]
        media_count[i] = k

    batch = {
        "input_ids": ids,
        "attention_mask": mask,
        "seq_len": seq_len,
        "weights": np.asarray([s.get("weight", 1.0) for s in samples], np.float32),
        media_key: media,
        "media_count": media_count,
    }
    if any("target" in s for s in samples):
        batch["targets"] = [s.get("target") for s in samples]
    if any("extra" in s for s in samples):
        batch["extras"] = [s.get("extra") for s in samples]
    return batch
