"""Attention dispatch: the CUDA flash kernel on the card, plain elsewhere.

Counterpart of ``unimp_tpu/ops/attention.py``. One entry point,
``multi_head_attention``, used by every model module (decoder
self-attention, ViT, perceiver, gated cross-attention). A CUDA tensor
always goes to the kernel: there is no KV-length threshold and no
override (the JAX package's thresholds were measured on a TPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from unimp_tpu_torch.ops.attention_ref import AttnMask
from unimp_tpu_torch.ops.flash_attention import flash_attention


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[AttnMask] = None,
    *,
    kv_len: Optional[torch.Tensor] = None,
    kv_start: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled-dot-product attention over [B, S, H, D]; returns [B, Sq, H, D].

    Padding is the per-row window ``[kv_start, kv_len)``; the kernel takes
    no ``mask.kv_valid``, so neither does this entry point.
    """
    mask = mask or AttnMask()
    if mask.kv_valid is not None:
        raise NotImplementedError("padding goes in as kv_len/kv_start, not kv_valid")
    return flash_attention(
        q, k, v, causal=mask.causal, kv_len=kv_len, kv_start=kv_start,
        q_media=mask.q_media, kv_media=mask.kv_media,
        media_mode=mask.media_mode, alibi_slopes=alibi, scale=scale,
    )[0]
