"""The benchmark's yardstick: peaks, model FLOPs and each kernel's least work.

Frozen copies, so that a later change to the program cannot move the
measure it is judged by:

  * ``lm_forward_flops`` ... ``decode_flops`` are the arithmetic of
    ``unimp_tpu_torch/utils/flops.py`` (matmul FLOPs only; a trained layer
    pays 3x its forward, recomputation is not credited);
  * ``bound``, ``flash_work``, ``k4_work`` and ``k5_work`` count what
    ``chip_smoke.py`` phase 3's ``bound`` / ``flash_work`` /
    ``allowed_pairs`` / ``decode_bound`` count: every input byte read once,
    every output byte written once, operations over the (query, key) pairs
    the masks allow; ``k6_work`` counts an int8 weight-streaming matmul
    (int8 weights, their f32 scales, bf16 x and output, once each).

A size object (``sizes``) is a configuration file read by
``manifest.model_sizes``: attributes ``lm``, ``vision``, ``resampler`` and
``cross_attn_every_n``.
"""

from __future__ import annotations

# one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float) -> float:
    """Least seconds for the work: the larger of bytes over the memory rate
    and operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


# ------------------------------------------------------------ model FLOPs

def _dense(t: int, d_in: int, d_out: int) -> float:
    return 2.0 * t * d_in * d_out


def lm_forward_flops(cfg, batch: int, seq: int, *, with_logits: bool = True) -> float:
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


def n_xattn(cfg) -> int:
    return (cfg.lm.num_layers + cfg.cross_attn_every_n - 1) // cfg.cross_attn_every_n


def xattn_forward_flops(cfg, batch: int, seq: int, n_latents: int) -> float:
    lm = cfg.lm
    d, h, dh = lm.hidden_size, lm.num_heads, lm.head_dim
    t, tl = batch * seq, batch * n_latents
    per = (
        _dense(t, d, h * dh) + 2 * _dense(tl, d, h * dh) + _dense(t, h * dh, d)
        + _dense(t, d, 4 * d) + _dense(t, 4 * d, d)
        + 4.0 * batch * seq * n_latents * h * dh
    )
    return n_xattn(cfg) * per


def vision_forward_flops(cfg, n_images: int) -> float:
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
    rows = batch * num_beams * new_tokens
    per_tok = lm.num_layers * (
        _dense(1, d, (h + 2 * lm.kv_heads) * dh)
        + _dense(1, h * dh, d)
        + _dense(1, d, lm.mlp_dim) * (2 if lm.act == "silu" else 1)
        + _dense(1, lm.mlp_dim, d)
        + 4.0 * (prompt_len + new_tokens / 2.0) * h * dh
    ) + _dense(1, d, lm.vocab_size)
    per_tok += n_xattn(cfg) * (
        _dense(1, d, h * dh) + _dense(1, h * dh, d)
        + _dense(1, d, 4 * d) + _dense(1, 4 * d, d)
        + 4.0 * n_lat * h * dh
    )
    return prefill + rows * per_tok


def eval_batch_flops(cfg, batch: int, prompt_len: int, images_per_sample: int,
                     num_beams: int, steps: int) -> float:
    """A rec-eval batch's model FLOPs in the window: ``decode_flops`` without
    the tower and perceiver, whose catalogue is encoded during set-up."""
    n_img = batch * images_per_sample
    return (decode_flops(cfg, batch, prompt_len, images_per_sample, num_beams, steps)
            - vision_forward_flops(cfg, n_img) - resampler_forward_flops(cfg, n_img))


# ------------------------------------------------------------ kernels' least work

def k4_work(prompt_rows: int, b: int, kb: int, step: int, h: int, hkv: int, d: int,
            elt: int, scale_bytes: int) -> tuple[float, float]:
    """(bytes, flops) of one split-cache decode-attention call (one layer,
    one step over ``step`` generated positions): q and out once (bf16),
    ``kv_start`` and the ancestry columns read, each valid prompt row once
    (shared by a user's beams) and one gen row per user and position (the
    least: the beams of a user may share every ancestor), K and V of
    ``elt`` bytes an element plus ``scale_bytes`` a row for int8 caches."""
    bk = b * kb
    rows = prompt_rows + b * step
    nbytes = (2 * bk * h * d * 2 + 4 * b + (4 * bk * step if kb > 1 else 0)
              + rows * hkv * 2 * (d * elt + scale_bytes))
    return nbytes, 4.0 * d * h * kb * rows


def k5_work(b: int, kb: int, n_latents: int, allowed_rows: int, h: int, hkv: int, d: int,
            elt: int, scale_bytes: int) -> tuple[float, float]:
    """(bytes, flops) of one single-query media read (a cross-attention
    layer at one decode step): q and out once (bf16), the [B, latents]
    mask, and each allowed latent row's K and V once (``allowed_rows``
    summed over users)."""
    bk = b * kb
    nbytes = 2 * bk * h * d * 2 + b * n_latents + allowed_rows * hkv * 2 * (d * elt + scale_bytes)
    return nbytes, 4.0 * d * h * kb * allowed_rows


def k6_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(bytes, flops) of x [m, k] bf16 @ int8 q [k, n] with f32 scales [n]."""
    return k * n + 4 * n + 2 * m * (k + n), 2.0 * m * k * n


def flash_work(b: int, sq: int, skv: int, h: int, hkv: int, d: int, pairs: int, *,
               backward: bool, mask_bytes: int = 0) -> tuple[float, float]:
    """(bytes, flops) of one attention call over ``pairs`` allowed (query,
    key) pairs (summed over the batch): the forward reads q, k, v (bf16)
    and the mask inputs and writes out and the f32 logsumexp, 4 * d * h
    flops a pair; the backward reads q, k, v, out, dout, the logsumexp and
    the mask inputs and writes dq, dk, dv, 10 * d * h flops a pair (the
    scores recomputed, then dV, dP, dK and dQ)."""
    q = b * sq * h * d * 2
    kv = 2 * b * skv * hkv * d * 2
    lse = b * h * sq * 4
    if backward:
        return 3 * q + 2 * kv + lse + mask_bytes, 10.0 * d * h * pairs
    return 2 * q + kv + lse + mask_bytes, 4.0 * d * h * pairs


def causal_pairs(seq_len, t: int) -> int:
    """Allowed pairs of a causal self-attention over a [B, t] window whose
    keys at or past ``seq_len[b]`` are masked (every query row counted)."""
    total = 0
    for n in seq_len:
        n = int(n)
        # query i sees keys 0..min(i, n - 1)
        total += sum(min(i + 1, n) for i in range(t))
    return total


def media_pairs(q_media_counts, n_latents: int) -> int:
    """Allowed pairs of an "immediate" cross-attention: each query after
    some medium sees that medium's ``n_latents`` latents; ``q_media_counts``
    holds, per row, the number of queries with a medium before them."""
    return int(sum(int(c) for c in q_media_counts)) * n_latents
