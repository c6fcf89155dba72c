"""Analytic FLOP counts of a train step and of a beam-decode batch, and
MFU on the card.

The port's own copy of ``train_step_flops`` and ``decode_flops`` from
``unimp_tpu/utils/flops.py``
(matmul FLOPs only; norms, activations and softmax are excluded by the usual
MFU convention):

  * a Dense of [in, out] over T tokens: 2*T*in*out FLOPs forward; the
    backward costs 2x forward (dX and dW), so a trained layer pays 3x;
  * attention scores + values: 4*T^2*H*Dh per layer forward.

MFU = model FLOPs / step time / the card's dense bf16 peak; recomputation
is not credited.
"""

from __future__ import annotations

import torch

# dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts)
GPU_PEAK_FLOPS = {"H100": 989e12, "H200": 989e12}


def detect_peak_flops(device=0) -> float:
    """Dense bf16 peak FLOP/s of the card; raises for a card not listed."""
    name = torch.cuda.get_device_name(device)
    for key, val in GPU_PEAK_FLOPS.items():
        if key in name:
            return val
    raise ValueError(f"no bf16 peak known for {name!r}")


def _dense(t: int, d_in: int, d_out: int) -> float:
    return 2.0 * t * d_in * d_out


def lm_forward_flops(cfg, batch: int, seq: int, *, with_logits: bool = True) -> float:
    """Decoder-stack matmul FLOPs for one forward over [batch, seq]."""
    lm = cfg.lm
    t = batch * seq
    d, h, dh = lm.hidden_size, lm.num_heads, lm.head_dim
    per_layer = (
        _dense(t, d, h * dh)
        + 2 * _dense(t, d, lm.kv_heads * dh)
        + _dense(t, h * dh, d)
        + _dense(t, d, lm.mlp_dim) * (2 if lm.act == "silu" else 1)
        + _dense(t, lm.mlp_dim, d)
    )
    total = lm.num_layers * (per_layer + 4.0 * batch * seq * seq * h * dh)
    if with_logits:
        total += _dense(t, d, lm.vocab_size)
    return total


def xattn_forward_flops(cfg, batch: int, seq: int, n_latents: int) -> float:
    """Gated cross-attention blocks: q from text, kv from media latents."""
    lm = cfg.lm
    d, h, dh = lm.hidden_size, lm.num_heads, lm.head_dim
    n_xattn = (lm.num_layers + cfg.cross_attn_every_n - 1) // cfg.cross_attn_every_n
    t, tl = batch * seq, batch * n_latents
    per = (
        _dense(t, d, h * dh) + 2 * _dense(tl, d, h * dh) + _dense(t, h * dh, d)
        + _dense(t, d, 4 * d) + _dense(t, 4 * d, d)
        + 4.0 * batch * seq * n_latents * h * dh
    )
    return n_xattn * per


def vision_forward_flops(cfg, n_images: int) -> float:
    """ViT tower over n_images (patchify + blocks)."""
    v = cfg.vision
    p = v.num_patches + 1
    t = n_images * p
    d = v.hidden_size
    patchify = _dense(n_images * v.num_patches, v.patch_size * v.patch_size * 3, d)
    per_layer = (4 * _dense(t, d, d) + _dense(t, d, v.mlp_ratio * d)
                 + _dense(t, v.mlp_ratio * d, d) + 4.0 * n_images * p * p * d)
    return patchify + v.num_layers * per_layer


def resampler_forward_flops(cfg, n_images: int) -> float:
    r, v = cfg.resampler, cfg.vision
    inner = r.num_heads * r.head_dim
    src = v.num_patches + r.num_latents
    per = (
        _dense(n_images * r.num_latents, v.hidden_size, inner)
        + 2 * _dense(n_images * src, v.hidden_size, inner)
        + _dense(n_images * r.num_latents, inner, v.hidden_size)
        + _dense(n_images * r.num_latents, v.hidden_size, r.ff_mult * v.hidden_size)
        + _dense(n_images * r.num_latents, r.ff_mult * v.hidden_size, v.hidden_size)
        + 4.0 * n_images * r.num_latents * src * inner
    )
    return r.depth * per


def train_step_flops(cfg, batch: int, seq: int, images_per_sample: int,
                     frozen_backbone: bool = False) -> float:
    """Matmul FLOPs for one train step over ``batch`` samples.

    Full model: 3x forward. With the reference's freezing
    (frozen_backbone=True) the vision tower pays forward only, the LM
    backbone forward + dX (the gradient flows down to the trainable
    embedding) but no dW, and the resampler, gated-xattn blocks and the
    logits pay 3x.
    """
    n_img = batch * images_per_sample
    n_lat = images_per_sample * cfg.resampler.num_latents
    lm_f = lm_forward_flops(cfg, batch, seq, with_logits=False)
    logits_f = _dense(batch * seq, cfg.lm.hidden_size, cfg.lm.vocab_size)
    x_f = xattn_forward_flops(cfg, batch, seq, n_lat)
    vis_f = vision_forward_flops(cfg, n_img)
    res_f = resampler_forward_flops(cfg, n_img)
    if not frozen_backbone:
        return 3.0 * (lm_f + logits_f + x_f + vis_f + res_f)
    return 2.0 * lm_f + 3.0 * (logits_f + x_f + res_f) + vis_f


def decode_flops(cfg, batch: int, prompt_len: int, images_per_sample: int,
                 num_beams: int, new_tokens: int) -> float:
    """Beam-decode FLOPs for one batch: vision encode + prefill + per-step
    incremental decode (KV cached, so per step each beam pays the
    projections and attention over the live KV)."""
    n_img = batch * images_per_sample
    n_lat = images_per_sample * cfg.resampler.num_latents
    prefill = (
        lm_forward_flops(cfg, batch, prompt_len, with_logits=False)
        + xattn_forward_flops(cfg, batch, prompt_len, n_lat)
        + vision_forward_flops(cfg, n_img)
        + resampler_forward_flops(cfg, n_img)
    )
    lm = cfg.lm
    d, h, dh = lm.hidden_size, lm.num_heads, lm.head_dim
    rows = batch * num_beams * new_tokens  # total generated tokens
    per_tok = lm.num_layers * (
        _dense(1, d, (h + 2 * lm.kv_heads) * dh)
        + _dense(1, h * dh, d)
        + _dense(1, d, lm.mlp_dim) * (2 if lm.act == "silu" else 1)
        + _dense(1, lm.mlp_dim, d)
        # attention against prompt KV + generated KV (mean live length)
        + 4.0 * (prompt_len + new_tokens / 2.0) * h * dh
    ) + _dense(1, d, lm.vocab_size)
    n_x = (lm.num_layers + cfg.cross_attn_every_n - 1) // cfg.cross_attn_every_n
    per_tok += n_x * (
        _dense(1, d, h * dh) + _dense(1, h * dh, d)
        + _dense(1, d, 4 * d) + _dense(1, 4 * d, d)
        + 4.0 * n_lat * h * dh
    )
    return prefill + rows * per_tok
