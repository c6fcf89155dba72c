"""Answer-span label masking on the device.

Counterpart of ``unimp_tpu/data/masking.py`` (the reference's label loop,
mmrec.py:146-168). A token is inside a span iff the index of the most
recent ``<answer>`` strictly before it exceeds the index of the most recent
``<|endofchunk|>`` strictly before it: two inclusive ``cummax`` scans,
shifted by one. Pad tokens, position 0, every ``<answer>``,
``<|endofchunk|>`` and ``<image>`` token are masked too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE = -100


def answer_span_labels(input_ids: torch.Tensor, answer_id: int, endofchunk_id: int,
                       media_id: int, pad_id: int) -> torch.Tensor:
    """[B, T] token ids -> [B, T] int64 labels, IGNORE outside answer spans."""
    ids = input_ids.long()
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :].expand_as(ids)
    last_ans = torch.where(ids == answer_id, pos, -1).cummax(dim=1).values
    last_eoc = torch.where(ids == endofchunk_id, pos, -1).cummax(dim=1).values

    def before(x):  # the state before each position: shift right by one
        return F.pad(x, (1, 0), value=-1)[:, :-1]

    keep = ((before(last_ans) > before(last_eoc)) & (ids != endofchunk_id)
            & (ids != answer_id) & (ids != media_id) & (ids != pad_id) & (pos > 0))
    return torch.where(keep, ids, IGNORE)
