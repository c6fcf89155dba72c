"""Trainable / frozen parameters.

Counterpart of ``unimp_tpu/train/partition.py``. The reference trains only
the perceiver resampler, the gated cross-attention blocks and the (resized)
token embedding and lm head; the CLIP vision tower and the LM backbone stay
frozen (open_flamingo's ``requires_grad_(False)``). In PyTorch, freezing is
``requires_grad_(False)``: autograd then computes no weight gradient for a
frozen tensor (the vision tower records no graph at all, since its input
needs none) and the optimizer holds no state for it. Frozen tensors may be
stored in a smaller dtype (``frozen_dtype``, e.g. bfloat16: they are never
updated and the forward casts matrices to the compute dtype anyway), or,
with ``frozen_dtype="int8"`` (``--frozen_int8``), the frozen matmul
kernels are quantized to int8 with a per-channel scale and read through
``ops/quant_matmul.py:quant_dot`` (the other frozen tensors stay float32),
as ``unimp_tpu/train/trainer.py:182-194`` quantizes the frozen subtree to
the model's compute dtype. Trainable tensors stay float32 masters.
"""

from __future__ import annotations

from torch import nn

from unimp_tpu_torch.utils.quant import quantize_params_int8


def backbone_trainable_mask(model: nn.Module) -> dict:
    """{parameter name: trainable}: resampler, xattn_*, embed, lm_head."""

    def trainable(name: str) -> bool:
        top = name.split(".", 1)[0]
        return top == "resampler" or top.startswith("xattn_") or top in ("embed", "lm_head")

    return {name: trainable(name) for name, _ in model.named_parameters()}


def freeze(model: nn.Module, mask: dict, frozen_dtype=None) -> nn.Module:
    """requires_grad_(mask[name]) for every parameter; frozen floating
    parameters move to ``frozen_dtype`` when given, or under "int8" the
    frozen float kernels are quantized (``apply_frozen_storage``)."""
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if (not mask[name] and frozen_dtype not in (None, "int8")
                and p.is_floating_point()):
            p.data = p.data.to(frozen_dtype)
    if frozen_dtype == "int8":
        apply_frozen_storage(model, mask)
    return model


def apply_frozen_storage(model: nn.Module, mask: dict) -> nn.Module:
    """The frozen (``not mask[name]``) float kernels quantized to int8, to
    the model's compute dtype; kernels quantized already stay as they are,
    and no ``requires_grad`` changes. After a float tree (a checkpoint's)
    has overwritten the int8 kernels, this puts them back: the JAX
    ``Trainer.apply_frozen_storage``."""
    return quantize_params_int8(model, dtype=model.cfg.compute_dtype,
                                select=lambda name: not mask[name])


def trainable_params(model: nn.Module) -> dict:
    """{name: parameter} of the parameters that require a gradient."""
    return {name: p for name, p in model.named_parameters() if p.requires_grad}
