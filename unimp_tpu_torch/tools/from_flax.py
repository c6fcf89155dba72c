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

A tree that the JAX ``quantize_params_int8`` quantized holds
``.../kernel/q`` and ``.../kernel/scale`` leaves; ``load_flax_params``
turns those kernels of the port into ``QuantizedKernel``s and fills them.
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
from unimp_tpu_torch.parallel.sharding import shard_model_tp, shard_tree_tp
from unimp_tpu_torch.train.partition import backbone_trainable_mask, freeze
from unimp_tpu_torch.utils.inference import cast_params_for_inference
from unimp_tpu_torch.utils.quant import (
    QuantizedKernel,
    fuse_decode_kernels,
    quantize_params_int8,
)

# the cast of each eval_param_dtype (``unimp_tpu/cli/arguments.py``'s
# --eval_param_dtype); int8 casts to bfloat16 and then quantizes
EVAL_PARAM_DTYPES = {"fp32": None, "bf16": torch.bfloat16, "int8": torch.bfloat16}

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


def _match_quantized(model: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Make each kernel int8 where the tree's is (``.../kernel/q`` and
    ``.../kernel/scale`` leaves), float where the tree's is float."""
    dtype = model.cfg.compute_dtype
    for name, mod in list(model.named_modules()):
        k = getattr(mod, "kernel", None)
        if k is None:
            continue
        path = f"{name.replace('.', '/')}/kernel" if name else "kernel"
        if f"{path}/q" in flat and not isinstance(k, QuantizedKernel):
            mod._parameters.pop("kernel")
            mod.kernel = QuantizedKernel(  # filled by the load
                torch.zeros(np.shape(flat[f"{path}/q"]), dtype=torch.int8, device=k.device),
                torch.zeros(np.shape(flat[f"{path}/scale"]), device=k.device), dtype)
        elif path in flat and isinstance(k, QuantizedKernel):
            del mod.kernel
            mod.kernel = nn.Parameter(torch.zeros(k.shape, device=k.q.device))


def load_flax_params(model: nn.Module, flat: Mapping) -> None:
    """Copy a flattened Flax tree ({"a/b/c": numpy array or tensor}) onto
    ``model``, each value cast to its tensor's dtype (a tensor of the same
    dtype is copied bit for bit).

    Every Flax leaf must map onto a port tensor of the same shape (a
    parameter, or an int8 kernel's ``q`` / ``scale``) and every port
    tensor must be covered; raises otherwise. Kernels follow the tree:
    int8 where it is quantized, float where it is not. A model sliced over
    tp (``parallel/sharding.py:shard_model_tp``) takes its rank's block of
    each whole tensor of the tree (an int8 scale with its columns).
    """
    if getattr(model, "tp_layout", None):
        flat = shard_tree_tp(flat, model.tp_layout, model.tp_rank, model.tp_size)
    _match_quantized(model, flat)
    state = model.state_dict(keep_vars=True)
    want = {name.replace(".", "/") for name in state}
    have = set(flat)
    if want != have:
        raise KeyError(f"flax tree and model differ: missing {sorted(want - have)[:8]}, "
                       f"unexpected {sorted(have - want)[:8]}")
    with torch.no_grad():
        for name, p in state.items():
            val = flat[name.replace(".", "/")]
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.array(val))
            if tuple(val.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax shape {tuple(val.shape)} != port "
                                 f"{tuple(p.shape)}")
            p.copy_(val)
    fuse_decode_kernels(model)


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


def build_model(cfg: UniMPConfig, *, device="cuda", seed: int = 0,
                eval_param_dtype: str = "fp32", train: bool = False,
                frozen_dtype=None, weights: Mapping | None = None,
                trainable_mask=backbone_trainable_mask, mesh=None) -> UniMPModel:
    """A UniMPModel on ``device`` with seeded weights (``init_params``), or
    with ``weights`` (a flat float tree, {"a/b/c": tensor or array}, e.g.
    ``train/checkpoint.py:restore_params``) loaded in their place before
    anything is cast or quantized.

    Inference (default): ``.eval()``, parameters as ``eval_param_dtype``
    says, in the order ``unimp_tpu/cli/mmrec_eval.py`` applies them:
    "fp32" as initialised, "bf16" matrices cast
    (``cast_params_for_inference``), "int8" cast to bfloat16 and then
    weight-only quantized (``quantize_params_int8`` with its defaults).
    Training (``train=True``): ``trainable_mask(model)`` ({parameter
    name: trainable}; default the reference's freezing,
    ``train/partition.py``): float32 trainable masters, frozen tensors
    with ``requires_grad=False`` stored in ``frozen_dtype`` when given
    (a float dtype, or "int8": frozen kernels quantized, ``train/
    partition.py:freeze``), ``.train()``. ``load_flax_params`` loads a Flax tree into either build.
    ``mesh`` (``parallel/mesh.py``) with tp > 1: the whole model is built,
    loaded, frozen or cast and quantized as above, on every rank alike,
    then sliced to this rank's tp block (``shard_model_tp``).
    """
    if eval_param_dtype not in EVAL_PARAM_DTYPES:
        raise ValueError(f"eval_param_dtype {eval_param_dtype!r} not in "
                         f"{sorted(EVAL_PARAM_DTYPES)}")
    if train and eval_param_dtype != "fp32":
        raise ValueError("a training build takes frozen_dtype, not eval_param_dtype")
    device = resolve_device(device)
    with device:
        model = UniMPModel(cfg)
    if weights is None:
        init_params(model, torch.Generator(device).manual_seed(seed))
    else:
        load_flax_params(model, weights)
    if train:
        freeze(model, trainable_mask(model), frozen_dtype)
        model.train()
    else:
        cast = EVAL_PARAM_DTYPES[eval_param_dtype]
        if cast is not None:
            cast_params_for_inference(model, cast)
        if eval_param_dtype == "int8":
            quantize_params_int8(model)
        model.eval()
    if mesh is not None:
        shard_model_tp(model, mesh)
    return model
