"""Weights for the port: from a Flax tree, or a seeded init on the device.

The port's parameters keep the Flax names and layouts, so the Flax path
``vision/block_0/attn/q_proj/kernel`` is the port's
``vision.block_0.attn.q_proj.kernel`` with the same shape (Dense kernels
[in, out], ``Proj`` [in, H, d], ``OProj`` [H, d, out]).

``init_params`` draws every parameter from the distribution Flax's
initializers use (lecun-normal kernels, normal(0.02) embeddings of the
vision tower and perceiver, variance-scaled token embedding, zero biases
and gates, unit norm scales), from a ``torch.Generator``, on the
parameters' device: the card has no JAX to initialise with.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from unimp_tpu_torch.device import resolve_device
from unimp_tpu_torch.models.config import UniMPConfig
from unimp_tpu_torch.models.flamingo import UniMPModel
from unimp_tpu_torch.train.partition import backbone_trainable_mask, freeze

# flax truncated_normal variance scaling: stddev of a unit normal cut at
# +-2 sigma, divided out so the truncated draw has the asked variance
_TRUNC_STD = 0.87962566103423978


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """Nested mapping of arrays -> {"a/b/c": array}."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path))
        else:
            out[path] = val
    return out


def load_flax_params(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy a flattened Flax tree ({"a/b/c": numpy array}) onto ``model``.

    Every Flax leaf must map onto a port parameter of the same shape and
    every port parameter must be covered; raises otherwise.
    """
    params = dict(model.named_parameters())
    want = {name.replace(".", "/") for name in params}
    have = set(flat)
    if want != have:
        raise KeyError(f"flax tree and model differ: missing {sorted(want - have)[:8]}, "
                       f"unexpected {sorted(have - want)[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(flat[name.replace(".", "/")])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax shape {arr.shape} != port {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))


def _lecun_normal_(p: torch.Tensor, gen: torch.Generator) -> None:
    # flax fan_in for a kernel [..., in_axis, out]: every axis but the last
    fan_in = math.prod(p.shape[:-1])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter, in place, with Flax's distributions."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("attn_gate", "ff_gate", "bias"):
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "kernel":
                _lecun_normal_(p, generator)
            elif leaf == "embedding":  # flax nn.Embed: variance 1 / dim
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
            elif leaf in ("cls_token", "pos_embed", "latents"):
                p.normal_(0.0, 0.02, generator=generator)
            else:
                raise KeyError(f"no initializer for parameter {name}")


def cast_params_for_inference(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Matrices to ``dtype``; norm scales, biases and gates stay float32
    (counterpart of ``unimp_tpu/utils/inference.py``)."""
    for p in model.parameters():
        if p.dim() >= 2 and p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model


def build_model(cfg: UniMPConfig, *, device="cuda", seed: int = 0,
                inference_dtype=None, train: bool = False,
                frozen_dtype=None) -> UniMPModel:
    """A UniMPModel on ``device`` with seeded weights (``init_params``).

    Inference (default): ``.eval()``, matrices optionally cast
    (``cast_params_for_inference``). Training (``train=True``): the
    reference's freezing (``train/partition.py``): float32 trainable
    masters, frozen tensors with ``requires_grad=False`` stored in
    ``frozen_dtype`` when given, ``.train()``. ``load_flax_params`` loads a
    Flax tree into either build.
    """
    if train and inference_dtype is not None:
        raise ValueError("a training build takes frozen_dtype, not inference_dtype")
    device = resolve_device(device)
    with device:
        model = UniMPModel(cfg)
    init_params(model, torch.Generator(device).manual_seed(seed))
    if train:
        freeze(model, backbone_trainable_mask(model), frozen_dtype)
        return model.train()
    if inference_dtype is not None:
        cast_params_for_inference(model, inference_dtype)
    return model.eval()
