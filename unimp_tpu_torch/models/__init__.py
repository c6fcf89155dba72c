"""PyTorch model zoo: vision tower, perceiver resampler, gated-xattn LM, and the
pure-text causal LM."""

from unimp_tpu_torch.models.config import (
    LMConfig,
    ResamplerConfig,
    UniMPConfig,
    VisionConfig,
    get_config,
)
from unimp_tpu_torch.models.flamingo import UniMPModel, compute_q_media
from unimp_tpu_torch.models.lm import CausalLM

__all__ = [
    "LMConfig",
    "ResamplerConfig",
    "UniMPConfig",
    "VisionConfig",
    "get_config",
    "UniMPModel",
    "CausalLM",
    "compute_q_media",
]
