"""Shared layers: norms, rotary embeddings, projections, MLPs, attention.

Counterpart of ``unimp_tpu/models/layers.py``. Parameters keep the Flax
names and layouts (Dense ``kernel`` [in, out], ``Proj`` [in, H, d],
``OProj`` [H, d, out], norm ``scale`` / ``bias``), so a Flax tree maps
onto the port by path (``tools/from_flax.py``). Matmuls run in the
module's compute dtype, casting each weight to it at use.

``Attention`` has three modes:
  * full / prefill: ``multi_head_attention`` (the flash kernel on the
    card); optionally returns the projected K/V heads-major as the
    prompt cache;
  * self-attention decode: writes this token's K/V into the gen cache at
    ``step`` (in place: the cache is owned by the decode loop) and reads
    the split cache through ``decode_attention``;
  * cross-attention decode: one query per beam against cached projected
    latents through ``single_query_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unimp_tpu_torch.ops import AttnMask, alibi_slopes, multi_head_attention
from unimp_tpu_torch.ops.decode_attention import decode_attention, single_query_attention


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` (params ``scale``/``bias``; Flax's default
    epsilon is 1e-6, the config's norms pass 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = _param(dim)
        self.bias = _param(dim)

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = _param(dim)

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.scale.float()).to(self.dtype)


def make_norm(kind: str, dim: int, eps: float, dtype):
    if kind == "rmsnorm":
        return RMSNorm(dim, eps, dtype)
    if kind == "layernorm":
        return LayerNorm(dim, eps, dtype)
    raise ValueError(f"unknown norm {kind!r}")


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rotary_pct: float,
               theta: float) -> torch.Tensor:
    """NeoX-style (half-split) rotary embedding over the leading
    rotary_pct of head_dim. x [B, S, H, D]; positions [B, S]."""
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    inv_freq = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                             device=x.device) / rot))
    angles = positions[:, :, None].float() * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., : rot // 2].float()
    x2 = x[..., rot // 2 : rot].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


class Proj(nn.Module):
    """DenseGeneral(features=(H, d)): kernel [in, H, d], bias [H, d]."""

    def __init__(self, in_dim: int, heads: int, head_dim: int, use_bias: bool):
        super().__init__()
        self.kernel = _param(in_dim, heads, head_dim)
        self.bias = _param(heads, head_dim) if use_bias else None

    def forward(self, x):
        in_dim, h, d = self.kernel.shape
        y = x @ self.kernel.reshape(in_dim, h * d).to(x.dtype)
        y = y.reshape(*y.shape[:-1], h, d)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class DenseWeights(nn.Module):
    """nn.Dense params: kernel [in, F], bias [F]."""

    def __init__(self, in_dim: int, features: int, use_bias: bool):
        super().__init__()
        self.kernel = _param(in_dim, features)
        self.bias = _param(features) if use_bias else None

    def forward(self, x):
        y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class OProj(nn.Module):
    """DenseGeneral(axis=(-2, -1)) output projection: kernel [H, d, out]."""

    def __init__(self, heads: int, head_dim: int, out_dim: int, use_bias: bool,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(heads, head_dim, out_dim)
        self.bias = _param(out_dim) if use_bias else None

    def forward(self, y):  # [..., H, D] -> [..., out]
        h, d, out_dim = self.kernel.shape
        y2 = y.reshape(*y.shape[:-2], h * d).to(self.dtype)
        out = y2 @ self.kernel.reshape(h * d, out_dim).to(self.dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class Mlp(nn.Module):
    """Transformer MLP; act="silu" selects SwiGLU (gate * up). GELU is the
    tanh form (Flax ``approximate=True``); quick_gelu is CLIP's
    x * sigmoid(1.702 x)."""

    def __init__(self, d_model: int, hidden: int, act: str = "gelu",
                 use_bias: bool = True, dtype=torch.bfloat16,
                 quick_gelu: bool = False):
        super().__init__()
        self.act, self.dtype, self.quick_gelu = act, dtype, quick_gelu
        if act == "silu":
            self.gate = DenseWeights(d_model, hidden, use_bias)
        self.up = DenseWeights(d_model, hidden, use_bias)
        self.down = DenseWeights(hidden, d_model, use_bias)

    def forward(self, x):
        if self.act == "silu":
            h = F.silu(self.gate(x)) * self.up(x)
        else:
            h = self.up(x.to(self.dtype))
            if self.quick_gelu:
                h = h * torch.sigmoid(1.702 * h)
            else:
                h = F.gelu(h, approximate="tanh")
        return self.down(h.to(self.dtype))


class Attention(nn.Module):
    """Multi-head attention over [B, S, H, D] with split-cache decode."""

    def __init__(self, in_dim: int, num_heads: int, head_dim: int, *,
                 kv_in_dim: Optional[int] = None,
                 num_kv_heads: Optional[int] = None, use_bias: bool = True,
                 positions_mode: str = "none", rotary_pct: float = 1.0,
                 rope_theta: float = 10000.0, dtype=torch.bfloat16):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        self.positions_mode = positions_mode
        self.rotary_pct, self.rope_theta = rotary_pct, rope_theta
        kv_in = kv_in_dim or in_dim
        self.q_proj = Proj(in_dim, num_heads, head_dim, use_bias)
        self.k_proj = Proj(kv_in, self.num_kv_heads, head_dim, use_bias)
        self.v_proj = Proj(kv_in, self.num_kv_heads, head_dim, use_bias)
        self.o_proj = OProj(num_heads, head_dim, in_dim, use_bias, dtype)
        if positions_mode == "alibi":
            self.register_buffer("alibi", alibi_slopes(num_heads), persistent=False)
        else:
            self.alibi = None

    def forward(self, x, kv_x=None, *, mask: Optional[AttnMask] = None,
                kv_len=None, kv_start=None, positions=None,
                return_cache: bool = False, decode_state: Optional[dict] = None,
                xattn_cache: Optional[dict] = None, xattn_allowed=None):
        """Returns (out [B, S, in_dim], cache_or_None).

        decode_state (self-attention decode): {"prompt": {"k","v"}
        [B,Hkv,T,D], "gen": {"k","v"} [BK,Hkv,G,D], "step": int tokens
        generated so far (current excluded), "kv_start": [B], "gen_index":
        [BK, G] ancestry table or None}. xattn_cache: {"k","v"}
        [B,Hkv,S,D] projected latents; xattn_allowed: [B, S] mask.
        """
        if xattn_cache is not None:
            q = self.q_proj(x)
            out = single_query_attention(q[:, 0], xattn_cache["k"],
                                         xattn_cache["v"], xattn_allowed)
            return self.o_proj(out[:, None]), None

        kv_src = x if kv_x is None else kv_x
        q, k, v = self.q_proj(x), self.k_proj(kv_src), self.v_proj(kv_src)
        if self.positions_mode == "rope":
            if positions is None:
                positions = torch.arange(x.shape[1], device=x.device)[None].expand(
                    x.shape[0], -1)
            q = apply_rope(q, positions, self.rotary_pct, self.rope_theta)
            k = apply_rope(k, positions, self.rotary_pct, self.rope_theta)

        if decode_state is not None:
            step = int(decode_state["step"])
            gen = decode_state["gen"]
            # heads-major cache; this token's K/V land at column `step`
            gen["k"][:, :, step] = k[:, 0].to(gen["k"].dtype)
            gen["v"][:, :, step] = v[:, 0].to(gen["v"].dtype)
            prompt = decode_state["prompt"]
            gen_index = decode_state.get("gen_index")
            beam_sel = None
            if gen_index is not None:
                # ancestry: the cache is never reordered; global cache row
                # -> local beam index within the row's K beams
                k_beams = gen["k"].shape[0] // prompt["k"].shape[0]
                beam_sel = (gen_index % k_beams).to(torch.int32)
            out = decode_attention(
                q[:, 0], prompt["k"], prompt["v"], gen["k"], gen["v"],
                step=step + 1, kv_start=decode_state.get("kv_start"),
                alibi=self.alibi, beam_sel=beam_sel,
            )
            return self.o_proj(out[:, None]), gen

        out = multi_head_attention(q, k, v, mask, kv_len=kv_len,
                                   kv_start=kv_start, alibi=self.alibi)
        cache = None
        if return_cache:
            cache = {"k": k.transpose(1, 2).contiguous(),
                     "v": v.transpose(1, 2).contiguous()}
        return self.o_proj(out), cache
