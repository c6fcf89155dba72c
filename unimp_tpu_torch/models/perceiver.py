"""Perceiver resampler (counterpart of ``unimp_tpu/models/perceiver.py``).

A learned latent set cross-attends to one media item's patch tokens;
each block's KV set is [patch tokens ; latents]. Runs per media (the
batch dim folds B * n_media), so no masking is needed. Its LayerNorms
use Flax's default epsilon, 1e-6.
"""

from __future__ import annotations

import torch
from torch import nn

from unimp_tpu_torch.models.config import ResamplerConfig
from unimp_tpu_torch.models.layers import Attention, LayerNorm, Mlp


class ResamplerBlock(nn.Module):
    def __init__(self, cfg: ResamplerConfig, d: int, dtype=torch.bfloat16):
        super().__init__()
        self.ln_latents = LayerNorm(d, 1e-6, dtype)
        self.ln_media = LayerNorm(d, 1e-6, dtype)
        self.attn = Attention(d, cfg.num_heads, cfg.head_dim, use_bias=False, dtype=dtype)
        self.ln_ff = LayerNorm(d, 1e-6, dtype)
        self.mlp = Mlp(d, cfg.ff_mult * d, act="gelu", use_bias=False, dtype=dtype)

    def forward(self, latents, media):
        h_lat = self.ln_latents(latents)
        kv = torch.cat([self.ln_media(media), h_lat], dim=1)
        latents = latents + self.attn(h_lat, kv)[0]
        return latents + self.mlp(self.ln_ff(latents))


class PerceiverResampler(nn.Module):
    """media tokens [B*, P, D] -> latents [B*, num_latents, D]."""

    def __init__(self, cfg: ResamplerConfig, d: int, dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.latents = nn.Parameter(torch.zeros(cfg.num_latents, d))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", ResamplerBlock(cfg, d, dtype))
        self.out_ln = LayerNorm(d, 1e-6, dtype)

    def forward(self, media: torch.Tensor) -> torch.Tensor:
        b, _, d = media.shape
        x = self.latents.to(self.dtype)[None].expand(b, -1, d)
        for i in range(self.cfg.depth):
            x = getattr(self, f"block_{i}")(x, media)
        return self.out_ln(x)
