"""Split-cache decode attention: plain versions and dispatch.

Counterpart of ``unimp_tpu/ops/decode_attention.py``. The beam-search KV
cache is split into

  prompt KV [B, Hkv, T, D]   shared by the K beams of a row, written once
                             at prefill, never reordered or duplicated
  gen KV    [BK, Hkv, G, D]  the generated tokens only, in storage order;
                             beam k reads position g of its ancestor
                             ``beam_sel[bk, g]`` (never reordered)

``decode_attention_ref`` and ``single_query_attention_ref`` are the plain
versions of the CUDA kernels in ``ops/decode_attention_kernels.py`` (two
partial attentions merged by their logsumexps, full-width gen read).
``decode_attention`` / ``single_query_attention`` send a CUDA tensor to
the kernel and a CPU tensor to the plain version.

int8 caches come with f32 scales per (row, head, position) and follow the
arithmetic of the TPU kernels, not the JAX package's XLA path (which
dequantizes up front): logits = (q . k_int8) * scale * k_scale; the
running sum l takes the raw p; the PV product weighs v_int8 by
p * v_scale rounded to q's dtype. A gen position's scales come from the
ancestor row that holds its K/V.
"""

from __future__ import annotations

import torch

from unimp_tpu_torch.ops.attention_ref import NEG_INF
from unimp_tpu_torch.ops.decode_attention_kernels import (
    decode_attention_cuda,
    single_query_attention_cuda,
)


def _expand_kv(k, v, h, k_scale=None, v_scale=None):
    """Repeat the KV heads (and their int8 scales) up to the query heads."""
    rep = h // k.shape[1]
    if rep > 1:
        k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        if k_scale is not None:
            k_scale, v_scale = (t.repeat_interleave(rep, dim=1) for t in (k_scale, v_scale))
    return k, v, k_scale, v_scale


def _segment_attn(q, k, v, mask, scale, bias=None, k_scale=None, v_scale=None):
    """q [B, K, H, D]; k, v [B, H, S, D] (int8 with k_scale, v_scale
    [B, H, S]); mask [B or 1, S] or [B, K, S]; bias [1, H, S]. Returns
    (out [B, K, H, D] f32 unnormalized, m, l)."""
    logits = torch.einsum("bkhd,bhsd->bkhs", q.float(), k.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale[:, None]
    if bias is not None:
        logits = logits + bias[:, None]
    mask4 = mask[:, None, None, :] if mask.dim() == 2 else mask[:, :, None, :]
    logits = torch.where(mask4, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(mask4, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    w = p.to(v.dtype) if v_scale is None else (p * v_scale[:, None]).to(q.dtype)
    out = torch.einsum("bkhs,bhsd->bkhd", w.float(), v.float())
    return out, m, l


def _check_scales(*scales) -> None:
    n = sum(s is not None for s in scales)
    if n not in (0, len(scales)):
        raise ValueError(f"int8 caches need all {len(scales)} scales or none; got {n}")


def single_query_attention_ref(q, k, v, mask, scale=None, k_scale=None, v_scale=None):
    """q [BK, H, D]; k, v [B, Hkv, S, D] shared by the K beams of a row;
    mask [B, S] bool; int8 k, v with k_scale, v_scale [B, Hkv, S]. Returns
    [BK, H, D] in q.dtype; a fully masked row gives 0."""
    _check_scales(k_scale, v_scale)
    bk, h, d = q.shape
    b = k.shape[0]
    k, v, k_scale, v_scale = _expand_kv(k, v, h, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / (d**0.5)
    out, _, l = _segment_attn(q.reshape(b, bk // b, h, d), k, v, mask, scale,
                              k_scale=k_scale, v_scale=v_scale)
    out = out / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(bk, h, d).to(q.dtype)


def decode_attention_ref(q, prompt_k, prompt_v, gen_k, gen_v, *, step,
                         kv_start=None, prompt_len=None, alibi=None,
                         scale=None, beam_sel=None, prompt_k_scale=None,
                         prompt_v_scale=None, gen_k_scale=None, gen_v_scale=None):
    """Plain split-cache decode attention; returns [BK, H, D] in q.dtype.

    step counts the generated tokens INCLUDING the current one (gen
    positions g < step are valid): an int, or a one-element integer tensor
    on q's device (the model's form, ``models/layers.py:
    decode_step_tensors``), with the same result. beam_sel [BK, G]: local ancestor beam
    of each gen position (None: each beam reads its own row). int8
    caches: prompt_k/v_scale [B, Hkv, T] and gen_k/v_scale [BK, Hkv, G],
    all four or none.
    """
    _check_scales(prompt_k_scale, prompt_v_scale, gen_k_scale, gen_v_scale)
    bk, h, d = q.shape
    b, _, t = prompt_k.shape[:3]
    g = gen_k.shape[2]
    kb = bk // b
    dev = q.device
    if scale is None:
        scale = 1.0 / (d**0.5)
    q_abs = t + step - 1  # absolute position of the current token
    q_r = q.reshape(b, kb, h, d)

    pos_p = torch.arange(t, device=dev)[None, :]
    mask_p = torch.ones(b, t, dtype=torch.bool, device=dev)
    if kv_start is not None:
        mask_p = mask_p & (pos_p >= kv_start[:, None])
    if prompt_len is not None:
        mask_p = mask_p & (pos_p < prompt_len[:, None])
    bias_p = bias_g = None
    if alibi is not None:
        slopes = alibi.float()[None, :, None]
        bias_p = slopes * (pos_p.float()[:, None, :] - q_abs)  # [1, H, T]
        bias_g = slopes * ((t + torch.arange(g, device=dev)).float()[None, None, :] - q_abs)
    pk, pv, pks, pvs = _expand_kv(prompt_k, prompt_v, h, prompt_k_scale, prompt_v_scale)
    out_p, m_p, l_p = _segment_attn(q_r, pk, pv, mask_p, scale, bias_p, pks, pvs)

    # gen segment: gather each beam's ancestor rows, and their scales (the
    # gather is what the kernel does implicitly when it reads row
    # b*K + beam_sel)
    gk, gv, gks, gvs = _expand_kv(gen_k, gen_v, h, gen_k_scale, gen_v_scale)
    if beam_sel is None:
        rows = torch.arange(bk, device=dev)[:, None].expand(bk, g)
    else:
        rows = (torch.arange(bk, device=dev) // kb * kb)[:, None] + beam_sel.long()
    gpos = torch.arange(g, device=dev)[None, :].expand(bk, g)
    # [BK, G, H, D] -> per-beam key sets [B*K, H, G, D]; scales [B*K, H, G]
    gk_sel = gk[rows, :, gpos].permute(0, 2, 1, 3)
    gv_sel = gv[rows, :, gpos].permute(0, 2, 1, 3)
    if gks is not None:
        gks, gvs = (t[rows, :, gpos].permute(0, 2, 1) for t in (gks, gvs))
    mask_g = (torch.arange(g, device=dev) < step)[None, :].expand(bk, g)
    out_g, m_g, l_g = _segment_attn(
        q[:, None], gk_sel, gv_sel, mask_g, scale, bias_g, gks, gvs)
    out_g = out_g.reshape(b, kb, h, d)
    m_g = m_g.reshape(b, kb, h)
    l_g = l_g.reshape(b, kb, h)

    m = torch.maximum(m_p, m_g)
    a_p = torch.exp(m_p - m)
    a_g = torch.exp(m_g - m)
    l = l_p * a_p + l_g * a_g
    denom = torch.where(l > 0, l, 1.0)
    out = (out_p * a_p[..., None] + out_g * a_g[..., None]) / denom[..., None]
    return out.reshape(bk, h, d).to(q.dtype)


def decode_attention(q, prompt_k, prompt_v, gen_k, gen_v, **kw):
    """Split-cache decode attention: the CUDA kernel on the card, the
    plain version on the CPU. Arguments as ``decode_attention_ref``."""
    fn = decode_attention_ref if q.device.type == "cpu" else decode_attention_cuda
    return fn(q, prompt_k, prompt_v, gen_k, gen_v, **kw)


def single_query_attention(q, k, v, mask, **kw):
    """Single-query attention against beam-shared KV: the CUDA kernel on
    the card, the plain version on the CPU. Arguments as
    ``single_query_attention_ref``."""
    fn = single_query_attention_ref if q.device.type == "cpu" else single_query_attention_cuda
    return fn(q, k, v, mask, **kw)
