"""Decoder blocks (counterpart of ``unimp_tpu/models/lm.py``).

One parameterized block covers MPT (layernorm + ALiBi, sequential
residual, no biases), GPT-NeoX / RedPajama (layernorm + partial RoPE,
parallel attention + MLP residual, biases) and LLaMA-style (RMSNorm +
RoPE + SwiGLU).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unimp_tpu_torch.models.config import LMConfig
from unimp_tpu_torch.models.layers import Attention, Mlp, make_norm
from unimp_tpu_torch.ops import AttnMask


class DecoderBlock(nn.Module):
    def __init__(self, cfg: LMConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.ln1 = make_norm(cfg.norm, d, cfg.layernorm_eps, dtype)
        self.attn = Attention(
            d, cfg.num_heads, cfg.head_dim, num_kv_heads=cfg.kv_heads,
            use_bias=cfg.use_bias, positions_mode=cfg.positions,
            rotary_pct=cfg.rotary_pct, rope_theta=cfg.rope_theta, dtype=dtype,
        )
        self.ln2 = make_norm(cfg.norm, d, cfg.layernorm_eps, dtype)
        self.mlp = Mlp(d, cfg.mlp_dim, act=cfg.act, use_bias=cfg.use_bias, dtype=dtype)

    def forward(self, x, *, kv_len=None, kv_start=None, positions=None,
                causal: bool = True, return_cache: bool = False,
                decode_state: Optional[dict] = None):
        """Returns (x, cache): prompt KV when return_cache, the updated gen
        cache in decode mode, else None."""
        kwargs = dict(
            mask=AttnMask(causal=causal and decode_state is None),
            kv_len=kv_len, kv_start=kv_start, positions=positions,
            return_cache=return_cache, decode_state=decode_state,
        )
        if self.cfg.parallel_block:
            # NeoX: x + attn(ln1 x) + mlp(ln2 x)
            attn_out, cache = self.attn(self.ln1(x), **kwargs)
            return x + attn_out + self.mlp(self.ln2(x)), cache
        attn_out, cache = self.attn(self.ln1(x), **kwargs)
        x = x + attn_out
        return x + self.mlp(self.ln2(x)), cache


def init_gen_cache(batch: int, max_new: int, cfg: LMConfig, dtype=torch.bfloat16,
                   device=None, quantized: bool = False) -> dict:
    """Per-layer generated-token KV cache, split K and V, heads-major
    [B*, Hkv, max_new, D] (the layout the decode kernel reads).
    ``quantized``: int8 K and V with f32 scales [B*, Hkv, max_new], one per
    (row, head, position)."""
    shape = (batch, cfg.kv_heads, max_new, cfg.head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
