"""Flash attention with its gradient: the CUDA kernels ``csrc/flash_fwd.cu``
(forward) and ``csrc/flash_bwd.cu`` (backward).

Counterpart of ``unimp_tpu/ops/flash_attention.py`` (TPU kernels
``_fwd_kernel``, ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` under one custom
VJP). ``flash_attention`` goes through ``FlashAttentionFn``: on a CUDA
tensor the forward launches K1 and the backward K2 (dK, dV) and K3 (dQ); on
a CPU tensor each takes its plain version (``attention_ref``,
``flash_bwd_dkv_ref``, ``flash_bwd_dq_ref``). The wrappers raise on what a
kernel does not take; they never fall back to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.ops.attention_ref import (
    AttnMask,
    attention_ref,
    flash_bwd_dkv_ref,
    flash_bwd_dq_ref,
)

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
    alibi_slopes [H] f32. scale defaults to 1/sqrt(D). ``out`` has a
    gradient with respect to q, k and v; ``lse`` has none.
    """
    if (q_media is None) != (media_mode is None):
        raise ValueError("q_media/kv_media and media_mode must be set together")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return FlashAttentionFn.apply(q, k, v, kv_len, kv_start, q_media, kv_media,
                                  alibi_slopes, causal, media_mode, float(scale))


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward, K2 + K3 backward; the plain versions on CPU tensors.

    Saves (q, k, v, out, lse), the residuals of the JAX custom VJP. The
    index tensors and the options get no gradient.
    """

    @staticmethod
    def forward(ctx, q, k, v, kv_len, kv_start, q_media, kv_media, alibi, causal,
                media_mode, scale):
        masks = dict(causal=causal, kv_len=kv_len, kv_start=kv_start, q_media=q_media,
                     kv_media=kv_media, media_mode=media_mode, alibi_slopes=alibi,
                     scale=scale)
        if q.device.type == "cpu":
            out, lse = attention_ref(q, k, v, _mask(masks), kv_len=kv_len,
                                     kv_start=kv_start, scale=scale, alibi=alibi)
        else:
            out, lse = flash_attention_cuda(q, k, v, **masks)
        ctx.masks = masks
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        do = d_out.to(q.dtype).contiguous()
        dq, dk, dv = flash_backward(q, k, v, do, lse, attention_delta(do, out), **ctx.masks)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B, H, Sq]: computed outside the
    kernels, as in JAX."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward(q, k, v, do, lse, delta, **masks):
    """(dq, dk, dv) of attention under ``masks`` (``flash_attention``'s
    keyword arguments, ``scale`` given) against ``lse`` and ``delta``: K2
    and K3 on CUDA tensors, their plain versions on CPU tensors. ``lse``
    may be a larger softmax's (ring attention's merged one): the result is
    then this block's share of that softmax's gradient."""
    if q.device.type == "cpu":
        kw = dict(kv_len=masks.get("kv_len"), kv_start=masks.get("kv_start"),
                  scale=masks["scale"], alibi=masks.get("alibi_slopes"))
        mask = _mask(masks)
        dk, dv = flash_bwd_dkv_ref(q, k, v, do, lse, delta, mask, **kw)
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, mask, **kw), dk, dv
    return flash_attention_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), do,
                                    lse, delta, **masks)


def _mask(m) -> AttnMask:
    return AttnMask(causal=m.get("causal", False), q_media=m.get("q_media"),
                    kv_media=m.get("kv_media"), media_mode=m.get("media_mode"))


def _kernel_args(q, k, v, causal=False, kv_len=None, kv_start=None, q_media=None,
                 kv_media=None, media_mode=None, alibi_slopes=None, scale=None):
    """Check what every flash kernel takes; returns the dtype code, head
    dim, index pointers and shape arguments of the C interface."""
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
    index = [kernel_lib.rows_i32("kv_start", kv_start, (b,), dev),
             kernel_lib.rows_i32("kv_len", kv_len, (b,), dev),
             kernel_lib.alibi_f32(alibi_slopes, h, dev),
             kernel_lib.rows_i32("q_media", q_media, (b, sq), dev),
             kernel_lib.rows_i32("kv_media", kv_media, (b, skv), dev)]
    if scale is None:
        scale = 1.0 / (d**0.5)
    tail = (b, sq, skv, h, hkv, int(causal), MEDIA_MODES[media_mode], float(scale))
    # the converted index tensors stay referenced until the launch returns
    return kernel_lib.DTYPE_CODES[q.dtype], d, index, tail


def flash_attention_cuda(q, k, v, *, causal=False, kv_len=None, kv_start=None,
                         q_media=None, kv_media=None, media_mode=None,
                         alibi_slopes=None, scale=None):
    """Launch the forward kernel (K1); raises on anything it does not take."""
    code, d, index, tail = _kernel_args(q, k, v, causal, kv_len, kv_start, q_media,
                                        kv_media, media_mode, alibi_slopes, scale)
    b, sq, _, h = tail[:4]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, lse
    P = kernel_lib.ptr
    kernel_lib.launch("flash_fwd", "flash_fwd", code, d, P(q), P(k), P(v), P(out), P(lse),
                      *map(P, index), *tail)
    return out, lse


def _bwd_args(q, k, v, do, lse, delta, masks):
    code, d, index, tail = _kernel_args(q, k, v, **masks)
    b, sq, _, h = tail[:4]
    kernel_lib.check_cuda_tensor("do", do, q.dtype, 4)
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != q shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        kernel_lib.check_cuda_tensor(name, t, torch.float32, 3)
        if t.shape != (b, h, sq):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(b, h, sq)}")
    P = kernel_lib.ptr
    return (code, d, P(q), P(k), P(v), P(do), P(lse), P(delta)), index, tail


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **masks):
    """Launch K2: returns (dk, dv) [B, Skv, Hkv, D]. ``lse`` is the
    forward's, ``delta`` = rowsum(dO * O), both [B, H, Sq] f32; ``masks``
    are the forward's keyword arguments."""
    head, index, tail = _bwd_args(q, k, v, do, lse, delta, masks)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    P = kernel_lib.ptr
    kernel_lib.launch("flash_bwd_dkv", "flash_bwd", *head, P(dk), P(dv),
                      *map(P, index), *tail)
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, **masks):
    """Launch K3: returns dq [B, Sq, H, D]; arguments as
    ``flash_bwd_dkv_cuda``."""
    head, index, tail = _bwd_args(q, k, v, do, lse, delta, masks)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    P = kernel_lib.ptr
    kernel_lib.launch("flash_bwd_dq", "flash_bwd", *head, P(dq), *map(P, index), *tail)
    return dq


def flash_attention_bwd_cuda(q, k, v, do, lse, delta, **masks):
    """The whole backward on the card: K2 then K3; returns (dq, dk, dv)."""
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **masks)
    return flash_bwd_dq_cuda(q, k, v, do, lse, delta, **masks), dk, dv
