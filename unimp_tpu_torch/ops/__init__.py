"""Attention ops: hand-written CUDA kernels and their plain versions."""

from unimp_tpu_torch.ops.attention import multi_head_attention
from unimp_tpu_torch.ops.attention_ref import AttnMask, alibi_slopes, attention_ref

__all__ = ["multi_head_attention", "AttnMask", "alibi_slopes", "attention_ref"]
