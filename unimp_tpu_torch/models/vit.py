"""CLIP-style ViT vision tower (counterpart of ``unimp_tpu/models/vit.py``).

The stride-14 patch convolution is a reshape plus one matmul; attention
goes through ``multi_head_attention`` (the flash kernel on the card); the
tower returns the final-layer patch tokens with CLS dropped, as Flamingo
consumes them. ``post_ln`` is applied to the CLS token only, and that
result is discarded (reference parity: the last hidden state is not
post-normed).
"""

from __future__ import annotations

import torch
from torch import nn

from unimp_tpu_torch.models.config import VisionConfig
from unimp_tpu_torch.models.layers import Attention, DenseWeights, LayerNorm, Mlp


class ViTBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, dtype=torch.bfloat16):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, cfg.layernorm_eps, dtype)
        self.attn = Attention(d, cfg.num_heads, cfg.head_dim, use_bias=True, dtype=dtype)
        self.ln2 = LayerNorm(d, cfg.layernorm_eps, dtype)
        self.mlp = Mlp(d, cfg.mlp_ratio * d, act="gelu", quick_gelu=True,
                       use_bias=True, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))[0]
        return x + self.mlp(self.ln2(x))


class VisionTower(nn.Module):
    """pixel_values [B, H, W, 3] (CLIP-normalized) -> patch tokens [B, P, D]."""

    def __init__(self, cfg: VisionConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, p = cfg.hidden_size, cfg.patch_size
        # Flax nn.Dense: an int8 kernel dequantizes, never streams
        self.patch_embed = DenseWeights(p * p * 3, d, use_bias=False, stream=False)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.pre_ln = LayerNorm(d, cfg.layernorm_eps, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ViTBlock(cfg, dtype))
        self.post_ln = LayerNorm(d, cfg.layernorm_eps, dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, hh, ww, c = pixel_values.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        x = pixel_values.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(b, gh * gw, p * p * c).to(self.dtype))
        cls = self.cls_token.to(self.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.pre_ln(x)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return x[:, 1:]
