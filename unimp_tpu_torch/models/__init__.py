"""PyTorch model zoo: vision tower, perceiver resampler, gated-xattn LM."""

from unimp_tpu_torch.models.config import (
    LMConfig,
    ResamplerConfig,
    UniMPConfig,
    VisionConfig,
    get_config,
)
from unimp_tpu_torch.models.flamingo import UniMPModel, compute_q_media

__all__ = [
    "LMConfig",
    "ResamplerConfig",
    "UniMPConfig",
    "VisionConfig",
    "get_config",
    "UniMPModel",
    "compute_q_media",
]
