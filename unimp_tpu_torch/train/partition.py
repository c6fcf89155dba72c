"""Trainable / frozen parameters.

Counterpart of ``unimp_tpu/train/partition.py``. The reference trains only
the perceiver resampler, the gated cross-attention blocks and the (resized)
token embedding and lm head; the CLIP vision tower and the LM backbone stay
frozen (open_flamingo's ``requires_grad_(False)``). In PyTorch, freezing is
``requires_grad_(False)``: autograd then computes no weight gradient for a
frozen tensor (the vision tower records no graph at all, since its input
needs none) and the optimizer holds no state for it. Frozen tensors may be
stored in a smaller dtype (``frozen_dtype``, e.g. bfloat16: they are never
updated and the forward casts matrices to the compute dtype anyway);
trainable tensors stay float32 masters.
"""

from __future__ import annotations

from torch import nn


def backbone_trainable_mask(model: nn.Module) -> dict:
    """{parameter name: trainable}: resampler, xattn_*, embed, lm_head."""

    def trainable(name: str) -> bool:
        top = name.split(".", 1)[0]
        return top == "resampler" or top.startswith("xattn_") or top in ("embed", "lm_head")

    return {name: trainable(name) for name, _ in model.named_parameters()}


def freeze(model: nn.Module, mask: dict, frozen_dtype=None) -> nn.Module:
    """requires_grad_(mask[name]) for every parameter; frozen floating
    parameters move to ``frozen_dtype`` when given."""
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if not mask[name] and frozen_dtype is not None and p.is_floating_point():
            p.data = p.data.to(frozen_dtype)
    return model


def trainable_params(model: nn.Module) -> dict:
    """{name: parameter} of the parameters that require a gradient."""
    return {name: p for name, p in model.named_parameters() if p.requires_grad}
