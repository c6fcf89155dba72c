"""Inference-time parameter casting (counterpart of
``unimp_tpu/utils/inference.py``).

Decode streams the whole weight set every step, so casting float32
matrices to bfloat16 halves that traffic; norm scales, biases and gates
stay float32.
"""

from __future__ import annotations

import torch
from torch import nn


def cast_params_for_inference(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Matrices (ndim >= 2) to ``dtype``, in place; returns the model."""
    for p in model.parameters():
        if p.dim() >= 2 and p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model
