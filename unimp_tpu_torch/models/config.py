"""Model configurations (PyTorch port of ``unimp_tpu/models/config.py``).

Same dataclasses, variant registry and ``get_config`` as the JAX package;
``compute_dtype`` is a torch dtype. The registry mirrors the reference's
model-building switch: MPT-1B (+instruct) with gated cross-attention every
layer, RedPajama-3B (+instruct) every 2 layers, MPT-7B every 4 layers, a
CLIP ViT-L/14 vision tower throughout, plus the tiny "debug" and "small"
variants used by tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP-style ViT vision tower."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    layernorm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Perceiver resampler: media patch tokens -> fixed latent set."""

    num_latents: int = 64
    depth: int = 6
    num_heads: int = 16
    head_dim: int = 64
    ff_mult: int = 4


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only causal LM (MPT, GPT-NeoX/RedPajama or LLaMA family)."""

    vocab_size: int = 50432
    hidden_size: int = 2560
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> num_heads
    mlp_hidden: Optional[int] = None  # None -> 4*hidden
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    positions: str = "rope"  # "rope" | "alibi"
    rotary_pct: float = 1.0  # fraction of head_dim rotated (NeoX: 0.25)
    rope_theta: float = 10000.0
    act: str = "gelu"  # "gelu" | "silu" (silu -> SwiGLU MLP)
    parallel_block: bool = False  # NeoX-style parallel attn+mlp residual
    use_bias: bool = True
    tie_embeddings: bool = True
    layernorm_eps: float = 1e-5
    max_seq_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.mlp_hidden or 4 * self.hidden_size


@dataclasses.dataclass(frozen=True)
class UniMPConfig:
    """Full Flamingo-style model: vision -> resampler -> gated-xattn LM."""

    vision: VisionConfig
    resampler: ResamplerConfig
    lm: LMConfig
    cross_attn_every_n: int = 2
    media_mode: str = "immediate"  # Flamingo: attend to most recent media
    dtype: str = "bfloat16"  # compute dtype
    # remat: checkpoint each LM block and each x-attn block in the training
    # forward (activations recomputed in the backward); remat_policy
    # "dots" saves the outputs of matmuls with no batch dims (JAX's
    # dots_with_no_batch_dims_saveable), "none" recomputes everything
    remat: bool = False
    remat_policy: str = "none"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "UniMPConfig":
        return dataclasses.replace(self, **kw)


_CLIP_L14 = VisionConfig()

_MPT_1B = LMConfig(
    vocab_size=50432, hidden_size=2048, num_layers=24, num_heads=16,
    norm="layernorm", positions="alibi", act="gelu", use_bias=False,
    tie_embeddings=True,
)
_REDPAJAMA_3B = LMConfig(
    vocab_size=50432, hidden_size=2560, num_layers=32, num_heads=32,
    norm="layernorm", positions="rope", rotary_pct=0.25, act="gelu",
    parallel_block=True, use_bias=True, tie_embeddings=False,
)
_MPT_7B = LMConfig(
    vocab_size=50432, hidden_size=4096, num_layers=32, num_heads=32,
    norm="layernorm", positions="alibi", act="gelu", use_bias=False,
    tie_embeddings=True,
)

_DEBUG_LM = LMConfig(
    vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
    norm="rmsnorm", positions="rope", act="silu", use_bias=False,
    tie_embeddings=True, max_seq_len=512,
)
_DEBUG_VISION = VisionConfig(
    image_size=28, patch_size=14, hidden_size=64, num_layers=2, num_heads=2
)
_DEBUG_RESAMPLER = ResamplerConfig(num_latents=8, depth=1, num_heads=2, head_dim=32)

_SMALL_LM = LMConfig(
    vocab_size=32768, hidden_size=512, num_layers=8, num_heads=8,
    norm="rmsnorm", positions="rope", act="silu", use_bias=False,
    tie_embeddings=True, max_seq_len=1024,
)
_SMALL_VISION = VisionConfig(
    image_size=224, patch_size=14, hidden_size=256, num_layers=4, num_heads=4
)
_SMALL_RESAMPLER = ResamplerConfig(num_latents=64, depth=2, num_heads=4, head_dim=64)


VARIANTS = {
    "debug": UniMPConfig(_DEBUG_VISION, _DEBUG_RESAMPLER, _DEBUG_LM, cross_attn_every_n=1),
    "small": UniMPConfig(_SMALL_VISION, _SMALL_RESAMPLER, _SMALL_LM, cross_attn_every_n=2),
    "3b-mpt": UniMPConfig(_CLIP_L14, ResamplerConfig(), _MPT_1B, cross_attn_every_n=1),
    "3b-mpt-instruct": UniMPConfig(_CLIP_L14, ResamplerConfig(), _MPT_1B, cross_attn_every_n=1),
    "4b": UniMPConfig(_CLIP_L14, ResamplerConfig(), _REDPAJAMA_3B, cross_attn_every_n=2),
    "4b-instruct": UniMPConfig(_CLIP_L14, ResamplerConfig(), _REDPAJAMA_3B, cross_attn_every_n=2),
    "9b": UniMPConfig(_CLIP_L14, ResamplerConfig(), _MPT_7B, cross_attn_every_n=4),
}


def get_config(name: str, **overrides) -> UniMPConfig:
    """Look up a variant (reference names like "4b-instruct" accepted)."""
    if name not in VARIANTS:
        raise KeyError(f"unknown variant {name!r}; have {sorted(VARIANTS)}")
    cfg = VARIANTS[name]
    return cfg.replace(**overrides) if overrides else cfg


# Otter/Flamingo-style JSON config loading — the reference's
# `FlamingoConfig.from_json_file("./flamingo/config.json")` build path
# (recommender.py:421-422, pipeline/train/config.json). Family defaults
# by text_config.model_type; any explicit HF-named field overrides them.

_TEXT_FAMILIES = {
    "llama": dict(norm="rmsnorm", positions="rope", act="silu",
                  parallel_block=False, use_bias=False, tie_embeddings=False,
                  vocab_size=32000, hidden_size=4096, num_layers=32,
                  num_heads=32, mlp_hidden=11008),
    "gpt_neox": dict(norm="layernorm", positions="rope", rotary_pct=0.25,
                     act="gelu", parallel_block=True, use_bias=True,
                     tie_embeddings=False, vocab_size=50432,
                     hidden_size=2560, num_layers=32, num_heads=32),
    "mpt": dict(norm="layernorm", positions="alibi", act="gelu",
                use_bias=False, tie_embeddings=True, vocab_size=50432,
                hidden_size=2048, num_layers=24, num_heads=16),
}

_TEXT_FIELD_MAP = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "mlp_hidden",
    "rms_norm_eps": "layernorm_eps",
    "layer_norm_eps": "layernorm_eps",
    "rope_theta": "rope_theta",
    "rotary_pct": "rotary_pct",
    "max_position_embeddings": "max_seq_len",
}


def config_from_json(path: str) -> UniMPConfig:
    """Build a UniMPConfig from an Otter/Flamingo config.json."""
    import json

    with open(path) as f:
        raw = json.load(f)

    tc = raw.get("text_config", {})
    family = tc.get("model_type", "llama")
    if family not in _TEXT_FAMILIES:
        raise KeyError(
            f"unknown text_config.model_type {family!r}; "
            f"have {sorted(_TEXT_FAMILIES)}"
        )
    lm_kw = dict(_TEXT_FAMILIES[family])
    for src, dst in _TEXT_FIELD_MAP.items():
        if src in tc:
            lm_kw[dst] = tc[src]
    if "tie_word_embeddings" in raw:
        lm_kw["tie_embeddings"] = bool(raw["tie_word_embeddings"])
    lm = LMConfig(**lm_kw)

    vc = raw.get("vision_config", {})
    vis_kw = {}
    for src, dst in (("image_size", "image_size"), ("patch_size", "patch_size"),
                     ("hidden_size", "hidden_size"),
                     ("num_hidden_layers", "num_layers"),
                     ("num_attention_heads", "num_heads"),
                     ("layer_norm_eps", "layernorm_eps")):
        if src in vc:
            vis_kw[dst] = vc[src]
    if "intermediate_size" in vc and "hidden_size" in vc:
        vis_kw["mlp_ratio"] = vc["intermediate_size"] // vc["hidden_size"]
    vision = VisionConfig(**vis_kw)

    return UniMPConfig(
        vision, ResamplerConfig(), lm,
        cross_attn_every_n=raw.get("cross_attn_every_n_layers", 4),
    )
