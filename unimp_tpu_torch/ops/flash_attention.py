"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu``.

Counterpart of ``unimp_tpu/ops/flash_attention.py`` (TPU kernel
``_fwd_kernel``). ``flash_attention`` launches the hand-written kernel on
a CUDA tensor and takes the plain version, ``attention_ref``, on a CPU
tensor. It returns the output and the logsumexp, which a backward pass
(training) needs.
"""

from __future__ import annotations

from typing import Optional

import torch

from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.ops.attention_ref import AttnMask, attention_ref

MEDIA_MODES = {None: 0, "immediate": 1, "all_previous": 2}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_len: Optional[torch.Tensor] = None,
    kv_start: Optional[torch.Tensor] = None,
    q_media: Optional[torch.Tensor] = None,
    kv_media: Optional[torch.Tensor] = None,
    media_mode: Optional[str] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """Attention over [B, S, H, D] tensors; returns (out, lse [B, H, Sq]).

    q [B, Sq, H, D]; k, v [B, Skv, Hkv, D] (Hkv divides H). kv_start /
    kv_len [B] int: the valid KV window. q_media / kv_media [B, Sq] /
    [B, Skv] int with media_mode "immediate" | "all_previous".
    alibi_slopes [H] f32. scale defaults to 1/sqrt(D).
    """
    if (q_media is None) != (media_mode is None):
        raise ValueError("q_media/kv_media and media_mode must be set together")
    if q.device.type == "cpu":
        mask = AttnMask(causal=causal, q_media=q_media, kv_media=kv_media,
                        media_mode=media_mode)
        return attention_ref(q, k, v, mask, kv_len=kv_len, kv_start=kv_start,
                             scale=scale, alibi=alibi_slopes)
    return flash_attention_cuda(
        q, k, v, causal=causal, kv_len=kv_len, kv_start=kv_start,
        q_media=q_media, kv_media=kv_media, media_mode=media_mode,
        alibi_slopes=alibi_slopes, scale=scale)


def flash_attention_cuda(q, k, v, *, causal=False, kv_len=None, kv_start=None,
                         q_media=None, kv_media=None, media_mode=None,
                         alibi_slopes=None, scale=None):
    """Launch the CUDA kernel; raises on anything it does not take."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernel_lib.check_cuda_tensor(name, t, q.dtype, 4)
    if q.dtype not in kernel_lib.DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if d not in kernel_lib.HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {kernel_lib.HEAD_DIMS}")
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if media_mode not in MEDIA_MODES:
        raise ValueError(f"unknown media_mode: {media_mode}")
    if b > 65535:  # the grid's z extent
        raise ValueError(f"batch {b} exceeds the kernel's 65535 rows")
    dev = q.device
    kv_start = kernel_lib.rows_i32("kv_start", kv_start, (b,), dev)
    kv_len = kernel_lib.rows_i32("kv_len", kv_len, (b,), dev)
    q_media = kernel_lib.rows_i32("q_media", q_media, (b, sq), dev)
    kv_media = kernel_lib.rows_i32("kv_media", kv_media, (b, skv), dev)
    slopes = kernel_lib.alibi_f32(alibi_slopes, h, dev)
    if scale is None:
        scale = 1.0 / (d**0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=dev, dtype=torch.float32)
    if b * sq * h == 0:
        return out, lse
    P = kernel_lib.ptr
    kernel_lib.launch(
        "flash_fwd", "flash_fwd",
        kernel_lib.DTYPE_CODES[q.dtype], d, P(q), P(k), P(v), P(out), P(lse),
        P(kv_start), P(kv_len), P(slopes), P(q_media), P(kv_media),
        b, sq, skv, h, hkv, int(causal), MEDIA_MODES[media_mode], float(scale),
    )
    return out, lse
