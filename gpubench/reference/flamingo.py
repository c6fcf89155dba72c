"""Plain float32 reference of the model the configurations describe.

CLIP-style ViT tower -> perceiver resampler -> language model with a
tanh-gated cross-attention block before every ``cross_attn_every_n``-th
decoder block (Flamingo), written from the published architecture in
plain ``torch`` operations: no kernels, no caches, no batching tricks.
Decoder blocks cover GPT-NeoX (parallel attention + MLP residual, rotary
embedding over ``rotary_pct`` of each head, biases) and MPT (sequential
residual, ALiBi, no biases, tied head), the blocks of the benchmark's
configurations: LayerNorm, GELU, as many key / value heads as queries.

It imports nothing of the program. Parameters are read by the program's
names (the Flax paths with "." for "/", as the public checkpoints lay
them out) from a callable ``params(name) -> float32 tensor``, which the
benchmark fills from ``gpubench/weights.py`` and serves as the cell's
configuration states (``served``): bf16-rounded matrices, or int8 / int4
weight-only kernels with one absmax scale per output channel. Every
computation is float32; TF32 must be off (``torch.backends``), which the
harness sets.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from gpubench import weights as W

MEAN = (0.48145466, 0.4578275, 0.40821073)  # CLIP's pixel normalisation
STD = (0.26862954, 0.26130258, 0.27577711)
IGNORE = -100
BIG_KERNEL = 1 << 16  # the smallest kernel a weight-only quantization takes


# ------------------------------------------------------------ parameters

def _ln(prefix: str, d: int) -> dict:
    return {f"{prefix}.scale": (d,), f"{prefix}.bias": (d,)}


def _attn(prefix: str, d_in: int, h: int, dh: int, *, kv_in: int = None, bias: bool) -> dict:
    kv_in = kv_in or d_in
    out = {f"{prefix}.q_proj.kernel": (d_in, h, dh), f"{prefix}.k_proj.kernel": (kv_in, h, dh),
           f"{prefix}.v_proj.kernel": (kv_in, h, dh), f"{prefix}.o_proj.kernel": (h, dh, d_in)}
    if bias:
        out.update({f"{prefix}.q_proj.bias": (h, dh), f"{prefix}.k_proj.bias": (h, dh),
                    f"{prefix}.v_proj.bias": (h, dh), f"{prefix}.o_proj.bias": (d_in,)})
    return out


def _mlp(prefix: str, d: int, hidden: int, *, bias: bool) -> dict:
    out = {f"{prefix}.up.kernel": (d, hidden), f"{prefix}.down.kernel": (hidden, d)}
    if bias:
        out.update({f"{prefix}.up.bias": (hidden,), f"{prefix}.down.bias": (d,)})
    return out


def param_shapes(s) -> dict:
    """{parameter name: shape} of the model sized by ``s``."""
    v, r, lm = s.vision, s.resampler, s.lm
    if lm.norm != "layernorm" or lm.act != "gelu" or lm.kv_heads != lm.num_heads:
        raise ValueError("the reference has GPT-NeoX and MPT blocks only: LayerNorm, GELU, "
                         "as many key / value heads as queries")
    dv, p = v.hidden_size, v.patch_size
    out = {"vision.patch_embed.kernel": (p * p * 3, dv), "vision.cls_token": (1, 1, dv),
           "vision.pos_embed": (1, v.num_patches + 1, dv)}
    out.update(_ln("vision.pre_ln", dv))
    for i in range(v.num_layers):
        b = f"vision.block_{i}"
        out.update(_ln(f"{b}.ln1", dv))
        out.update(_attn(f"{b}.attn", dv, v.num_heads, v.head_dim, bias=True))
        out.update(_ln(f"{b}.ln2", dv))
        out.update(_mlp(f"{b}.mlp", dv, v.mlp_ratio * dv, bias=True))
    out.update(_ln("vision.post_ln", dv))
    out["resampler.latents"] = (r.num_latents, dv)
    for i in range(r.depth):
        b = f"resampler.block_{i}"
        out.update(_ln(f"{b}.ln_latents", dv))
        out.update(_ln(f"{b}.ln_media", dv))
        out.update(_attn(f"{b}.attn", dv, r.num_heads, r.head_dim, bias=False))
        out.update(_ln(f"{b}.ln_ff", dv))
        out.update(_mlp(f"{b}.mlp", dv, r.ff_mult * dv, bias=False))
    out.update(_ln("resampler.out_ln", dv))
    d = lm.hidden_size
    out["embed.embedding"] = (lm.vocab_size, d)
    for i in range(lm.num_layers):
        if i % s.cross_attn_every_n == 0:
            x = f"xattn_{i}"
            out.update({f"{x}.attn_gate": (), f"{x}.ff_gate": ()})
            out.update(_ln(f"{x}.ln_attn", d))
            out.update(_attn(f"{x}.xattn", d, lm.num_heads, lm.head_dim, kv_in=dv, bias=False))
            out.update(_ln(f"{x}.ln_ff", d))
            out.update(_mlp(f"{x}.mlp", d, 4 * d, bias=False))
        b = f"block_{i}"
        out.update(_ln(f"{b}.ln1", d))
        out.update(_attn(f"{b}.attn", d, lm.num_heads, lm.head_dim, bias=lm.use_bias))
        out.update(_ln(f"{b}.ln2", d))
        out.update(_mlp(f"{b}.mlp", d, lm.mlp_dim, bias=lm.use_bias))
    out.update(_ln("final_ln", d))
    if not lm.tie_embeddings:
        out["lm_head.kernel"] = (d, lm.vocab_size)
    return out


def trainable(name: str) -> bool:
    """The reference's freezing: the perceiver, the gated cross-attention
    blocks, the token embedding and an untied head train; the vision
    tower and the language model's own blocks and final norm are frozen."""
    top = name.split(".", 1)[0]
    return top == "resampler" or top.startswith("xattn_") or top in ("embed", "lm_head")


def big_kernel(name: str, shape) -> bool:
    return name.endswith(".kernel") and len(shape) >= 2 and math.prod(shape) >= BIG_KERNEL


LEVELS = {"int8": 127, "int4": 7}


def quantize(w: torch.Tensor, n_in: int, levels: int):
    """Weight-only symmetric quantization with one absmax scale per output
    channel (over the ``n_in`` contracted axes): (round(w / scale) clipped
    to [-levels, levels] as int8, scale); 127 levels for int8, 7 for int4."""
    amax = w.abs().amax(dim=tuple(range(n_in)))
    scale = torch.clamp(amax, min=1e-8) / levels
    return torch.clamp(torch.round(w / scale), -levels, levels).to(torch.int8), scale


def quantize_dequantize(w: torch.Tensor, n_in: int, levels: int) -> torch.Tensor:
    q, scale = quantize(w, n_in, levels)
    return q.float() * scale


def qdq_rows(t: torch.Tensor) -> torch.Tensor:
    """An int8 KV cache's round trip: one absmax scale per row over the
    last (head) dimension."""
    scale = torch.clamp(t.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(t / scale), -127, 127) * scale


def serve(name: str, w: torch.Tensor, served: str) -> torch.Tensor:
    """``w`` (float32, as drawn) as an inference build of precision
    ``served`` holds it, in float32: "fp32" as drawn; "bf16" every matrix
    rounded to bfloat16; "int8" / "int4" the large kernels quantized from
    their bfloat16 rounding, every other matrix rounded to bfloat16."""
    if served == "fp32" or w.dim() < 2:
        return w
    w = w.to(torch.bfloat16).float()
    if served in LEVELS and big_kernel(name, w.shape):
        return quantize_dequantize(w, W.contracted_axes(name, w.dim()), LEVELS[served])
    if served not in ("bf16", "int8", "int4"):
        raise ValueError(f"unknown served precision {served!r}")
    return w


class Drawn:
    """``params(name)``: each tensor drawn from the seed when asked (the
    reference never holds the whole model), as ``served`` says."""

    def __init__(self, sizes, seed: int, device, served: str):
        self.shapes = param_shapes(sizes)
        self.seed, self.device, self.served = seed, device, served

    def __call__(self, name: str) -> torch.Tensor:
        return serve(name, W.draw(self.seed, name, self.shapes[name], self.device), self.served)


# ------------------------------------------------------------ layers

def norm(x, params, prefix: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], params(f"{prefix}.scale"), params(f"{prefix}.bias"), eps)


def dense(x, params, prefix: str, bias: bool):
    y = x @ params(f"{prefix}.kernel")
    return y + params(f"{prefix}.bias") if bias else y


def mlp(x, params, prefix: str, *, bias: bool, act: str = "gelu"):
    h = dense(x, params, f"{prefix}.up", bias)
    h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h, approximate="tanh")
    return dense(h, params, f"{prefix}.down", bias)


def project(x, params, name: str, bias: bool):
    """DenseGeneral to heads: x [..., in] @ kernel [in, H, d] -> [..., H, d]."""
    y = torch.einsum("...i,ihd->...hd", x, params(f"{name}.kernel"))
    return y + params(f"{name}.bias") if bias else y


def out_project(o, params, name: str, bias: bool):
    y = torch.einsum("...hd,hdo->...o", o, params(f"{name}.kernel"))
    return y + params(f"{name}.bias") if bias else y


def alibi_slopes(n: int) -> torch.Tensor:
    """ALiBi's head slopes, 2^(-8 i / n) for n a power of two (Press et
    al.), with the interleaved extension otherwise."""
    def pow2(m):
        start = 2.0 ** (-(2.0 ** -(math.log2(m) - 3)))
        return [start * start ** i for i in range(m)]

    if math.log2(n).is_integer():
        return torch.tensor(pow2(n))
    c = 2 ** math.floor(math.log2(n))
    return torch.tensor(pow2(c) + pow2(2 * c)[0::2][: n - c])


def rope(x, positions, pct: float, theta: float):
    """Rotary embedding (NeoX's half split) over the leading ``pct`` of
    each head; x [B, S, H, D], positions [B, S]."""
    d = x.shape[-1]
    rot = int(d * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = positions[..., None].float() * inv
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., : rot // 2], x[..., rot // 2: rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]], dim=-1)


def attend(q, k, v, allowed, alibi=None):
    """Softmax attention, q [B, Sq, H, D], k / v [B, Skv, H, D], allowed
    [B, Sq, Skv] bool or None; a query with nothing allowed gives 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if alibi is not None:
        rel = (torch.arange(k.shape[1], device=q.device)[None, :]
               - torch.arange(q.shape[1], device=q.device)[:, None]).float()
        s = s + alibi.to(q.device)[None, :, None, None] * rel
    if allowed is not None:
        mask = allowed[:, None]
        s = s.masked_fill(~mask, -1e30)
        p = torch.softmax(s, dim=-1) * mask
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attend_split(q, k, v, allowed, alibi, gen_rows):
    """int8 KV caches: queries where ``gen_rows`` [B, Sq] is true (the
    generated positions, which read the caches) attend to the int8 round
    trip of K and V; the prompt's queries (the prefill) to K and V."""
    if gen_rows is None:
        return attend(q, k, v, allowed, alibi)
    full = attend(q, k, v, allowed, alibi)
    cached = attend(q, qdq_rows(k), qdq_rows(v), allowed, alibi)
    return torch.where(gen_rows[:, :, None, None], cached, full)


# ------------------------------------------------------------ towers

def vision_tower(params, s, pixels):
    """CLIP-normalized pixels [N, H, W, 3] -> patch tokens [N, P, D] (the
    last layer's, CLS dropped, no post-norm)."""
    v = s.vision
    n, hh, ww, c = pixels.shape
    p = v.patch_size
    x = pixels.reshape(n, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, (hh // p) * (ww // p), p * p * c) @ params("vision.patch_embed.kernel")
    cls = params("vision.cls_token").expand(n, 1, -1)
    x = torch.cat([cls, x], dim=1) + params("vision.pos_embed")
    x = norm(x, params, "vision.pre_ln", v.layernorm_eps)
    for i in range(v.num_layers):
        b = f"vision.block_{i}"
        h = norm(x, params, f"{b}.ln1", v.layernorm_eps)
        q, k, vv = (project(h, params, f"{b}.attn.{m}_proj", True) for m in "qkv")
        x = x + out_project(attend(q, k, vv, None), params, f"{b}.attn.o_proj", True)
        x = x + mlp(norm(x, params, f"{b}.ln2", v.layernorm_eps), params, f"{b}.mlp", bias=True,
                    act="quick_gelu")
    return x[:, 1:]


def perceiver(params, s, media):
    """Patch tokens [N, P, D] -> latents [N, L, D]."""
    r = s.resampler
    x = params("resampler.latents")[None].expand(media.shape[0], -1, -1)
    for i in range(r.depth):
        b = f"resampler.block_{i}"
        h = norm(x, params, f"{b}.ln_latents", 1e-6)
        kv = torch.cat([norm(media, params, f"{b}.ln_media", 1e-6), h], dim=1)
        q = project(h, params, f"{b}.attn.q_proj", False)
        k, v = (project(kv, params, f"{b}.attn.{m}_proj", False) for m in "kv")
        x = x + out_project(attend(q, k, v, None), params, f"{b}.attn.o_proj", False)
        x = x + mlp(norm(x, params, f"{b}.ln_ff", 1e-6), params, f"{b}.mlp", bias=False)
    return norm(x, params, "resampler.out_ln", 1e-6)


def normalize(images_u8):
    mean = torch.tensor(MEAN, device=images_u8.device)
    std = torch.tensor(STD, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def encode(params, s, images_u8):
    """uint8 images [N, H, W, 3] -> media latents [N, L, D]."""
    return perceiver(params, s, vision_tower(params, s, normalize(images_u8)))


# ------------------------------------------------------------ language model

def lm_logits(params, s, ids, latents, q_media, allowed_self, positions, gen_rows=None,
              remat: bool = False):
    """Logits [B, S, V] of token ids [B, S] with media ``latents`` [B, M, L,
    D] (each text position sees the latents of its medium ``q_media``
    [B, S], 0 for none: Flamingo's "immediate" masking), self-attention
    under ``allowed_self`` [B, S, S]; ``gen_rows`` as ``attend_split``.
    ``remat``: each layer's activations are computed again in the backward
    (``torch.utils.checkpoint``), so that a training reference holds no
    layer's weights or activations across the forward."""
    lm = s.lm
    x = F.embedding(ids, params("embed.embedding"))
    b, m, l_, dv = latents.shape
    lat = latents.reshape(b, m * l_, dv)
    kv_media = torch.arange(1, m + 1, device=ids.device).repeat_interleave(l_)
    allowed_x = q_media[:, :, None] == kv_media[None, None, :]
    alibi = alibi_slopes(lm.num_heads) if lm.positions == "alibi" else None

    def layer(i, x, lat):
        if i % s.cross_attn_every_n == 0:
            p = f"xattn_{i}"
            h = norm(x, params, f"{p}.ln_attn", 1e-6)
            q = project(h, params, f"{p}.xattn.q_proj", False)
            k, v = (project(lat, params, f"{p}.xattn.{n}_proj", False) for n in "kv")
            a = out_project(attend_split(q, k, v, allowed_x, None, gen_rows), params,
                            f"{p}.xattn.o_proj", False)
            x = x + torch.tanh(params(f"{p}.attn_gate")) * a
            f = mlp(norm(x, params, f"{p}.ln_ff", 1e-6), params, f"{p}.mlp", bias=False)
            x = x + torch.tanh(params(f"{p}.ff_gate")) * f
        p = f"block_{i}"
        h = norm(x, params, f"{p}.ln1", lm.layernorm_eps)
        q, k, v = (project(h, params, f"{p}.attn.{n}_proj", lm.use_bias) for n in "qkv")
        if lm.positions == "rope":
            q = rope(q, positions, lm.rotary_pct, lm.rope_theta)
            k = rope(k, positions, lm.rotary_pct, lm.rope_theta)
        a = out_project(attend_split(q, k, v, allowed_self, alibi, gen_rows), params,
                        f"{p}.attn.o_proj", lm.use_bias)
        if lm.parallel_block:
            return x + a + mlp(norm(x, params, f"{p}.ln2", lm.layernorm_eps), params,
                               f"{p}.mlp", bias=lm.use_bias, act=lm.act)
        x = x + a
        return x + mlp(norm(x, params, f"{p}.ln2", lm.layernorm_eps), params,
                       f"{p}.mlp", bias=lm.use_bias, act=lm.act)

    for i in range(lm.num_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, i, x, lat, use_reentrant=False)
        else:
            x = layer(i, x, lat)
    x = norm(x, params, "final_ln", lm.layernorm_eps)
    if lm.tie_embeddings:
        return x @ params("embed.embedding").t()
    return x @ params("lm_head.kernel")


# ------------------------------------------------------------ training loss

def answer_labels(ids: torch.Tensor, tokens: dict) -> torch.Tensor:
    """Labels [B, T]: the tokens inside an answer span (after an
    ``<answer>``, before the next ``<|endofchunk|>``), IGNORE elsewhere and
    at position 0, at every ``<answer>``, ``<|endofchunk|>``, ``<image>``
    and pad token."""
    out = torch.full_like(ids, IGNORE)
    special = {tokens["answer"], tokens["endofchunk"], tokens["media"], tokens["pad"]}
    host = ids.cpu().tolist()
    for r, row in enumerate(host):
        inside = False
        for i, tok in enumerate(row):
            if i > 0 and inside and tok not in special:
                out[r, i] = tok
            if tok == tokens["answer"]:
                inside = True
            elif tok == tokens["endofchunk"]:
                inside = False
    return out


def focal_loss(logits, labels, weights, gamma: float):
    """The task-weighted focal cross-entropy of the next token, summed
    over the answer tokens and divided by their count."""
    lg, lab = logits[:, :-1], labels[:, 1:]
    valid = lab != IGNORE
    logp = torch.log_softmax(lg, dim=-1)
    ce = -logp.gather(-1, torch.where(valid, lab, 0)[..., None])[..., 0]
    tok = weights[:, None] * ce * (1.0 - torch.exp(-ce)) ** gamma
    return torch.where(valid, tok, 0.0).sum() / valid.sum().clamp(min=1)
