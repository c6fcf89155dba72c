"""Wrappers of the CUDA decode kernels in ``csrc/decode_attn.cu``.

Counterpart of ``unimp_tpu/ops/decode_attention_pallas.py``:

  decode_attention_cuda        <- pallas_decode_attention (TPU ``_kernel``)
  single_query_attention_cuda  <- pallas_single_query_attention
                                  (TPU ``_prompt_only_kernel``)

Their plain versions are ``decode_attention_ref`` and
``single_query_attention_ref`` in ``ops/decode_attention.py``. The int8
KV branches of the TPU kernels are not ported yet.
"""

from __future__ import annotations

import torch

from unimp_tpu_torch.ops import kernel_lib


def _check_qkv(q, kvs, names):
    kernel_lib.check_cuda_tensor("q", q, None, 3)
    if q.dtype not in kernel_lib.DTYPE_CODES:
        raise TypeError(f"decode kernels take float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in kernel_lib.HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {kernel_lib.HEAD_DIMS}")
    for name, t in zip(names, kvs):
        kernel_lib.check_cuda_tensor(name, t, q.dtype, 4)
        if t.shape[-1] != q.shape[-1]:
            raise ValueError(f"{name} head dim {t.shape[-1]} != {q.shape[-1]}")


def decode_attention_cuda(q, prompt_k, prompt_v, gen_k, gen_v, *, step,
                          kv_start=None, prompt_len=None, alibi=None,
                          scale=None, beam_sel=None):
    """Launch the split-cache decode kernel; returns [BK, H, D] in q.dtype.

    q [BK, H, D]; prompt_k/v [B, Hkv, T, D]; gen_k/v [BK, Hkv, G, D];
    step: generated tokens including the current one (an int);
    beam_sel [BK, G] local ancestor beam (None: own row).
    """
    _check_qkv(q, (prompt_k, prompt_v, gen_k, gen_v),
               ("prompt_k", "prompt_v", "gen_k", "gen_v"))
    bk, h, d = q.shape
    b, hkv, t = prompt_k.shape[:3]
    g = gen_k.shape[2]
    if bk % b or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit prompt {tuple(prompt_k.shape)}")
    if prompt_v.shape != prompt_k.shape or gen_k.shape != (bk, hkv, g, d) \
            or gen_v.shape != gen_k.shape:
        raise ValueError("prompt/gen cache shapes disagree")
    step = int(step)
    if not 0 <= step <= g:
        raise ValueError(f"step {step} outside [0, {g}]")
    dev = q.device
    kv_start = kernel_lib.rows_i32("kv_start", kv_start, (b,), dev)
    prompt_len = kernel_lib.rows_i32("prompt_len", prompt_len, (b,), dev)
    beam_sel = kernel_lib.rows_i32("beam_sel", beam_sel, (bk, g), dev)
    slopes = kernel_lib.alibi_f32(alibi, h, dev)
    if scale is None:
        scale = 1.0 / (d**0.5)
    out = torch.empty_like(q)
    P = kernel_lib.ptr
    kernel_lib.launch(
        "decode_attn", "decode_attn",
        kernel_lib.DTYPE_CODES[q.dtype], d, P(q), P(prompt_k), P(prompt_v),
        P(gen_k), P(gen_v), P(beam_sel), P(kv_start), P(prompt_len), P(slopes),
        P(out), b, bk // b, h, hkv, t, g, step, float(scale),
    )
    return out


def single_query_attention_cuda(q, k, v, mask, scale=None):
    """Launch the single-query kernel; returns [BK, H, D] in q.dtype.

    q [BK, H, D]; k, v [B, Hkv, S, D] shared by the beams of a row;
    mask [B, S] bool (True = allowed).
    """
    _check_qkv(q, (k, v), ("k", "v"))
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
    kernel_lib.launch(
        "single_query_attn", "decode_attn",
        kernel_lib.DTYPE_CODES[q.dtype], d, P(q), P(k), P(v), P(allowed),
        P(out), b, bk // b, h, hkv, s, float(scale),
    )
    return out
