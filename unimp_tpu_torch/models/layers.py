"""Shared layers: norms, rotary embeddings, projections, MLPs, attention.

Counterpart of ``unimp_tpu/models/layers.py``. Parameters keep the Flax
names and layouts (Dense ``kernel`` [in, out], ``Proj`` [in, H, d],
``OProj`` [H, d, out], norm ``scale`` / ``bias``), so a Flax tree maps
onto the port by path (``tools/from_flax.py``). Matmuls run in the
module's compute dtype, casting each weight to it at use, and go through
``quant_dot``: a kernel that ``utils/quant.py`` quantized to int8 runs the
int8 matmul (K6) at decode row counts.

``Attention`` has three modes:
  * full / prefill: ``multi_head_attention`` (the flash kernel on the
    card); optionally returns the projected K/V heads-major as the
    prompt cache;
  * self-attention decode: one fused QKV matmul when the projections are
    int8; writes this token's K/V into the gen cache at ``step`` (in
    place: the cache is owned by the decode loop; an int8 cache takes the
    token's int8 K/V and their scales) and reads the split cache through
    ``decode_attention``;
  * cross-attention decode: one query per beam against cached projected
    latents through ``single_query_attention``.

Under tensor parallelism (``parallel/sharding.py:shard_model_tp``) an
``Attention`` or ``Mlp`` holds its rank's heads or columns and a
``tp_group``: its input enters through ``copy_to_tp`` and the row-parallel
output projection (``OProj``, the MLP's ``down``) all-reduces its partial
product before the bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unimp_tpu_torch.ops import AttnMask, alibi_slopes, multi_head_attention
from unimp_tpu_torch.ops.decode_attention import decode_attention, single_query_attention
from unimp_tpu_torch.ops.quant_matmul import quant_dot
from unimp_tpu_torch.parallel.sharding import copy_to_tp, reduce_from_tp
from unimp_tpu_torch.utils.quant import QuantizedKernel, quantize_kv


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


def decode_step_tensors(step, device):
    """A decode step's ``step`` (the tokens generated before this one: an
    int, or a one-element int64 tensor on ``device``) as the two tensors
    the layers read on the device: (the gen caches' column for this
    token's K/V, [1] int64; the tokens generated including this one, [1]
    int32, the decode kernel's ``step``). A model call makes them once for
    all its layers. A tensor ``step`` is used in place, not copied, so
    that the replays of a CUDA graph captured over the call read each
    step's value (``decode/sampler.py``)."""
    if isinstance(step, torch.Tensor):
        col = step.reshape(1).to(device=device, dtype=torch.int64)
    else:
        col = torch.full((1,), int(step), dtype=torch.int64, device=device)
    return col, (col + 1).to(torch.int32)


class Proj(nn.Module):
    """DenseGeneral(features=(H, d)): kernel [in, H, d], bias [H, d]."""

    def __init__(self, in_dim: int, heads: int, head_dim: int, use_bias: bool):
        super().__init__()
        self.kernel = _param(in_dim, heads, head_dim)
        self.bias = _param(heads, head_dim) if use_bias else None

    def forward(self, x):
        _, h, d = self.kernel.shape
        y = quant_dot(x, self.kernel)
        y = y.reshape(*y.shape[:-1], h, d)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class DenseWeights(nn.Module):
    """nn.Dense params: kernel [in, F], bias [F]. ``stream=False`` is
    Flax's own ``nn.Dense`` (the ViT patch embedding): an int8 kernel is
    dequantized in its compute dtype at every row count, never streamed."""

    def __init__(self, in_dim: int, features: int, use_bias: bool, stream: bool = True):
        super().__init__()
        self.stream = stream
        self.tp_group = None  # row-parallel under tp: partial products summed
        self.kernel = _param(in_dim, features)
        self.bias = _param(features) if use_bias else None

    def forward(self, x):
        if not self.stream and isinstance(self.kernel, QuantizedKernel):
            y = x @ self.kernel.dequantize().to(x.dtype)
        else:
            y = quant_dot(x, self.kernel)
        y = reduce_from_tp(y, self.tp_group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class OProj(nn.Module):
    """DenseGeneral(axis=(-2, -1)) output projection: kernel [H, d, out]."""

    def __init__(self, heads: int, head_dim: int, out_dim: int, use_bias: bool,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.tp_group = None  # row-parallel under tp: partial products summed
        self.kernel = _param(heads, head_dim, out_dim)
        self.bias = _param(out_dim) if use_bias else None

    def forward(self, y):  # [..., H, D] -> [..., out]
        h, d, _ = self.kernel.shape
        # an int8 kernel's scale is [out] (both leading axes contract), so
        # it folds out of the flat [H*d, out] matmul
        out = quant_dot(y.reshape(*y.shape[:-2], h * d).to(self.dtype), self.kernel)
        out = reduce_from_tp(out, self.tp_group)
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
        self.tp_group = None
        if act == "silu":
            self.gate = DenseWeights(d_model, hidden, use_bias)
        self.up = DenseWeights(d_model, hidden, use_bias)
        self.down = DenseWeights(hidden, d_model, use_bias)

    def forward(self, x):
        x = copy_to_tp(x, self.tp_group)
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
        # int8 q/k/v payloads fused for the decode step, made when a decoder
        # block's projections are quantized (``utils/quant.py``)
        self.qkv_int8 = None
        self.tp_group = None
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
        [B,Hkv,T,D], "gen": {"k","v"} [BK,Hkv,G,D], "step": tokens
        generated so far (current excluded; an int or a one-element int64
        tensor), "step_tensors": ``decode_step_tensors(step)`` (made here
        when absent), "kv_start": [B], "gen_index": [BK, G] ancestry table
        or None}. xattn_cache: {"k","v"}
        [B,Hkv,S,D] projected latents; xattn_allowed: [B, S] mask. int8
        caches (prompt, gen, latents) also hold "k_scale" / "v_scale"
        [B*,Hkv,S] f32.
        """
        x = copy_to_tp(x, self.tp_group)
        if kv_x is not None:
            kv_x = copy_to_tp(kv_x, self.tp_group)
        if xattn_cache is not None:
            q = self.q_proj(x)
            out = single_query_attention(q[:, 0], xattn_cache["k"], xattn_cache["v"],
                                         xattn_allowed, k_scale=xattn_cache.get("k_scale"),
                                         v_scale=xattn_cache.get("v_scale"))
            return self.o_proj(out[:, None]), None

        if decode_state is not None and kv_x is None and self.qkv_int8 is not None:
            # one int8 matmul for q, k and v (each column keeps its scale)
            y = quant_dot(x, self.qkv_int8)
            if self.q_proj.bias is not None:
                y = y + torch.cat([p.bias.reshape(-1) for p in
                                   (self.q_proj, self.k_proj, self.v_proj)]).to(y.dtype)
            h, hkv, d = self.num_heads, self.num_kv_heads, self.head_dim
            q, k, v = torch.split(y, [h * d, hkv * d, hkv * d], dim=-1)
            q, k, v = (t.reshape(*x.shape[:2], -1, d) for t in (q, k, v))
        else:
            kv_src = x if kv_x is None else kv_x
            q, k, v = self.q_proj(x), self.k_proj(kv_src), self.v_proj(kv_src)
        if self.positions_mode == "rope":
            if positions is None:
                positions = torch.arange(x.shape[1], device=x.device)[None].expand(
                    x.shape[0], -1)
            q = apply_rope(q, positions, self.rotary_pct, self.rope_theta)
            k = apply_rope(k, positions, self.rotary_pct, self.rope_theta)

        if decode_state is not None:
            col, n_gen = (decode_state.get("step_tensors")
                          or decode_step_tensors(decode_state["step"], x.device))
            gen = decode_state["gen"]
            # heads-major cache; this token's K/V land at column `step`
            # (indexed on the device); an int8 cache takes them quantized
            # per (row, head) with their scales, written at the same column
            for name, t in (("k", k[:, 0]), ("v", v[:, 0])):
                if gen[name].dtype == torch.int8:
                    t, t_scale = quantize_kv(t)
                    gen[name + "_scale"].index_copy_(2, col, t_scale[:, :, None])
                gen[name].index_copy_(2, col, t.to(gen[name].dtype)[:, :, None])
            prompt = decode_state["prompt"]
            gen_index = decode_state.get("gen_index")
            beam_sel = None
            if gen_index is not None:
                # ancestry: the cache is never reordered; global cache row
                # -> local beam index within the row's K beams
                k_beams = gen["k"].shape[0] // prompt["k"].shape[0]
                beam_sel = (gen_index % k_beams).to(torch.int32)
            # q is a view into the fused int8 q/k/v output when no rotary
            # embedding copies it (ALiBi models): the kernel takes it dense
            out = decode_attention(
                q[:, 0].contiguous(), prompt["k"], prompt["v"], gen["k"], gen["v"],
                step=n_gen, kv_start=decode_state.get("kv_start"),
                alibi=self.alibi, beam_sel=beam_sel,
                prompt_k_scale=prompt.get("k_scale"), prompt_v_scale=prompt.get("v_scale"),
                gen_k_scale=gen.get("k_scale"), gen_v_scale=gen.get("v_scale"),
            )
            return self.o_proj(out[:, None]), gen

        out = multi_head_attention(q, k, v, mask, kv_len=kv_len,
                                   kv_start=kv_start, alibi=self.alibi)
        cache = None
        if return_cache:
            cache = {"k": k.transpose(1, 2).contiguous(),
                     "v": v.transpose(1, 2).contiguous()}
        return self.o_proj(out), cache
