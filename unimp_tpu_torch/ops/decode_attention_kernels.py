"""Wrappers of the CUDA decode kernels in ``csrc/decode_attn.cu``.

Counterpart of ``unimp_tpu/ops/decode_attention_pallas.py``:

  decode_attention_cuda        <- pallas_decode_attention (TPU ``_kernel``)
  single_query_attention_cuda  <- pallas_single_query_attention
                                  (TPU ``_prompt_only_kernel``)

Each takes float caches of q's dtype, or int8 caches with their f32
scales; the int8 branch launches its own entry point
(``decode_attn_int8``, ``single_query_attn_int8``), counted apart in
``kernel_lib.LAUNCHES``. Their plain versions are ``decode_attention_ref``
and ``single_query_attention_ref`` in ``ops/decode_attention.py``.
"""

from __future__ import annotations

import torch

from unimp_tpu_torch.ops import kernel_lib


def _check_qkv(q, kvs, names, int8: bool):
    for name, t in zip(names, kvs):
        if t.dtype == torch.int8 and not int8:
            raise ValueError(f"{name} is int8: pass its scales")
    kernel_lib.check_cuda_tensor("q", q, None, 3)
    if q.dtype not in kernel_lib.DTYPE_CODES:
        raise TypeError(f"decode kernels take float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in kernel_lib.HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {kernel_lib.HEAD_DIMS}")
    kv_dtype = torch.int8 if int8 else q.dtype
    for name, t in zip(names, kvs):
        kernel_lib.check_cuda_tensor(name, t, kv_dtype, 4)
        if t.shape[-1] != q.shape[-1]:
            raise ValueError(f"{name} head dim {t.shape[-1]} != {q.shape[-1]}")


def _check_scales(names, scales, kvs):
    """Each [.., Hkv, S] f32 scale of an int8 [.., Hkv, S, D] cache."""
    for name, s, kv in zip(names, scales, kvs):
        kernel_lib.check_cuda_tensor(name, s, torch.float32, 3)
        if tuple(s.shape) != tuple(kv.shape[:3]):
            raise ValueError(f"{name} {tuple(s.shape)} does not fit its cache "
                             f"{tuple(kv.shape)}")


def _has_scales(*scales) -> bool:
    n = sum(s is not None for s in scales)
    if n not in (0, len(scales)):
        raise ValueError(f"int8 caches need all {len(scales)} scales or none; got {n}")
    return n > 0


def decode_attention_cuda(q, prompt_k, prompt_v, gen_k, gen_v, *, step,
                          kv_start=None, prompt_len=None, alibi=None,
                          scale=None, beam_sel=None, prompt_k_scale=None,
                          prompt_v_scale=None, gen_k_scale=None, gen_v_scale=None):
    """Launch the split-cache decode kernel; returns [BK, H, D] in q.dtype.

    q [BK, H, D]; prompt_k/v [B, Hkv, T, D]; gen_k/v [BK, Hkv, G, D];
    step: generated tokens including the current one, an int (checked
    against G here) or a one-element int32 tensor on q's device, which
    the kernel reads there (a CUDA graph's replays change it; the model
    makes it once a decode step, ``models/layers.py:decode_step_tensors``);
    beam_sel [BK, G] local ancestor beam (None: own row). int8 caches:
    the four f32 scales prompt_k/v_scale [B, Hkv, T] and gen_k/v_scale
    [BK, Hkv, G].
    """
    scales = (prompt_k_scale, prompt_v_scale, gen_k_scale, gen_v_scale)
    int8 = _has_scales(*scales)
    caches = (prompt_k, prompt_v, gen_k, gen_v)
    _check_qkv(q, caches, ("prompt_k", "prompt_v", "gen_k", "gen_v"), int8)
    bk, h, d = q.shape
    b, hkv, t = prompt_k.shape[:3]
    g = gen_k.shape[2]
    if bk % b or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit prompt {tuple(prompt_k.shape)}")
    if prompt_v.shape != prompt_k.shape or gen_k.shape != (bk, hkv, g, d) \
            or gen_v.shape != gen_k.shape:
        raise ValueError("prompt/gen cache shapes disagree")
    dev = q.device
    if isinstance(step, torch.Tensor):
        if step.device != dev or step.dtype != torch.int32 or step.numel() != 1:
            raise ValueError(f"step must be one int32 on {dev}, got {step.dtype} "
                             f"{tuple(step.shape)} on {step.device}")
    else:
        step = int(step)
        if not 0 <= step <= g:
            raise ValueError(f"step {step} outside [0, {g}]")
        step = torch.full((1,), step, dtype=torch.int32, device=dev)
    kv_start = kernel_lib.rows_i32("kv_start", kv_start, (b,), dev)
    prompt_len = kernel_lib.rows_i32("prompt_len", prompt_len, (b,), dev)
    beam_sel = kernel_lib.rows_i32("beam_sel", beam_sel, (bk, g), dev)
    slopes = kernel_lib.alibi_f32(alibi, h, dev)
    if scale is None:
        scale = 1.0 / (d**0.5)
    out = torch.empty_like(q)
    P = kernel_lib.ptr
    tail = (P(beam_sel), P(kv_start), P(prompt_len), P(slopes), P(out),
            b, bk // b, h, hkv, t, g, P(step), float(scale))
    head = (kernel_lib.DTYPE_CODES[q.dtype], d, P(q), *map(P, caches))
    if int8:
        _check_scales(("prompt_k_scale", "prompt_v_scale", "gen_k_scale", "gen_v_scale"),
                      scales, caches)
        kernel_lib.launch("decode_attn_int8", "decode_attn", *head, *map(P, scales), *tail)
    else:
        kernel_lib.launch("decode_attn", "decode_attn", *head, *tail)
    return out


def single_query_attention_cuda(q, k, v, mask, scale=None, k_scale=None, v_scale=None):
    """Launch the single-query kernel; returns [BK, H, D] in q.dtype.

    q [BK, H, D]; k, v [B, Hkv, S, D] shared by the beams of a row;
    mask [B, S] bool (True = allowed); int8 latents: k_scale, v_scale
    [B, Hkv, S] f32.
    """
    int8 = _has_scales(k_scale, v_scale)
    _check_qkv(q, (k, v), ("k", "v"), int8)
    bk, h, d = q.shape
    b, hkv, s = k.shape[:3]
    if bk % b or h % hkv or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} does not fit kv {tuple(k.shape)}")
    if mask.device != q.device or tuple(mask.shape) != (b, s) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [{b}, {s}] on {q.device}")
    allowed = mask.contiguous().view(torch.uint8)
    if scale is None:
        scale = 1.0 / (d**0.5)
    out = torch.empty_like(q)
    P = kernel_lib.ptr
    head = (kernel_lib.DTYPE_CODES[q.dtype], d, P(q), P(k), P(v))
    tail = (P(allowed), P(out), b, bk // b, h, hkv, s, float(scale))
    if int8:
        _check_scales(("k_scale", "v_scale"), (k_scale, v_scale), (k, v))
        kernel_lib.launch("single_query_attn_int8", "decode_attn", *head, P(k_scale),
                          P(v_scale), *tail)
    else:
        kernel_lib.launch("single_query_attn", "decode_attn", *head, *tail)
    return out
