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
from unimp_tpu_torch.models.config import LMConfig, UniMPConfig
from unimp_tpu_torch.models.flamingo import UniMPModel
from unimp_tpu_torch.models.lm import CausalLM
from unimp_tpu_torch.parallel.sharding import shard_model_fsdp, shard_model_tp, shard_tree_tp
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


def _match_quantized(model: nn.Module, flat: Mapping[str, np.ndarray]) -> list:
    """Make each kernel int8 where the tree's is (``.../kernel/q`` and
    ``.../kernel/scale`` leaves), float where the tree's is float; returns
    (flat path, owner, attribute) of each tensor it put in place whole (a
    ZeRO-3 model shards them once they are loaded)."""
    zero = getattr(model, "zero", None)
    made = []
    for name, mod in list(model.named_modules()):
        k = getattr(mod, "kernel", None)
        if k is None:
            continue
        path = f"{name.replace('.', '/')}/kernel" if name else "kernel"
        if f"{path}/q" in flat and not isinstance(k, QuantizedKernel):
            if zero is not None and zero.sharded(path):
                zero.forget(path)
            mod._parameters.pop("kernel")
            mod.kernel = QuantizedKernel(  # filled by the load
                torch.zeros(np.shape(flat[f"{path}/q"]), dtype=torch.int8, device=k.device),
                torch.zeros(np.shape(flat[f"{path}/scale"]), device=k.device),
                model.compute_dtype)
            made.append((f"{path}/q", mod.kernel, "q"))
        elif path in flat and isinstance(k, QuantizedKernel):
            del mod.kernel
            mod.kernel = nn.Parameter(torch.zeros(k.shape, device=k.q.device))
            made.append((path, mod, "kernel"))
    return made


def _requantize(model: nn.Module, flat: Mapping) -> dict:
    """``flat`` with each float kernel that the (ZeRO-3) model holds as int8
    quantized as ``quantize_params_int8`` quantizes it, from the whole
    tensor: a float checkpoint of an int8 frozen backbone lands in its
    chunks without a whole float kernel on the device (the model's own
    ``apply_frozen_storage`` after the load then has nothing to do)."""
    from unimp_tpu_torch.utils.quant import _quantize_leaf

    flat = dict(flat)
    for name, mod in model.named_modules():
        k = mod._modules.get("kernel")
        path = f"{name.replace('.', '/')}/kernel"
        if isinstance(k, QuantizedKernel) and k.persistent and path in flat:
            w = flat.pop(path)
            w = (w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w))).to(
                k.scale.device)
            n_in = w.dim() - k.scale.dim()
            flat[f"{path}/q"], flat[f"{path}/scale"] = _quantize_leaf(w, n_in)
    return flat


def load_flax_params(model: nn.Module, flat: Mapping) -> None:
    """Copy a flattened Flax tree ({"a/b/c": numpy array or tensor}) onto
    ``model``, each value cast to its tensor's dtype (a tensor of the same
    dtype is copied bit for bit).

    Every Flax leaf must map onto a port tensor of the same shape (a
    parameter, or an int8 kernel's ``q`` / ``scale``) and every port
    tensor must be covered; raises otherwise. Kernels follow the tree:
    int8 where it is quantized, float where it is not. A model sliced over
    tp (``parallel/sharding.py:shard_model_tp``) takes its rank's block of
    each whole tensor of the tree (an int8 scale with its columns). A
    ZeRO-3 model (``model.zero``) takes its chunk of each sharded tensor,
    and quantizes a float kernel that it holds as int8 (``_requantize``).
    """
    zero = getattr(model, "zero", None)
    if zero is not None:
        flat = _requantize(model, flat)
    if getattr(model, "tp_layout", None):
        flat = shard_tree_tp(flat, model.tp_layout, model.tp_rank, model.tp_size)
    made = _match_quantized(model, flat)
    state = model.state_dict(keep_vars=True)
    want = {name.replace(".", "/") for name in state}
    have = set(flat)
    if want != have:
        raise KeyError(f"flax tree and model differ: missing {sorted(want - have)[:8]}, "
                       f"unexpected {sorted(have - want)[:8]}")
    with torch.no_grad():
        for name, p in state.items():
            path = name.replace(".", "/")
            val = flat[path]
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.array(val))
            sharded = zero is not None and zero.sharded(path)
            shape = zero.shape(path) if sharded else p.shape
            if tuple(val.shape) != tuple(shape):
                raise ValueError(f"{name}: flax shape {tuple(val.shape)} != port "
                                 f"{tuple(shape)}")
            # a transposed host view (a converted kernel) crosses as it lies
            # in memory and is transposed on the device
            val = val.to(p.device)
            p.copy_(zero.local(path, val) if sharded else val)
    if zero is not None:
        for path, owner, attr in made:
            zero.adopt(path, owner, attr)
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


def build_model(cfg: UniMPConfig | LMConfig, *, device="cuda", seed: int = 0,
                eval_param_dtype: str = "fp32", train: bool = False,
                frozen_dtype=None, weights: Mapping | None = None,
                trainable_mask=backbone_trainable_mask, mesh=None,
                dtype: torch.dtype | None = None) -> UniMPModel | CausalLM:
    """A UniMPModel on ``device`` (a ``CausalLM`` when ``cfg`` is an
    ``LMConfig``: inference only, no mesh, computing in ``dtype``, default
    bfloat16; a UniMPConfig carries its own, ``cfg.dtype``, and a ``dtype``
    given with one raises) with seeded
    weights (``init_params``), or
    with ``weights`` (a flat float tree, {"a/b/c": tensor or array}, e.g.
    ``train/checkpoint.py:restore_params``) loaded in their place before
    anything is cast or quantized. ``weights`` may also be a function of
    the seeded model's flat tree that returns the tree to load (the
    ``.pt`` converter, which keeps the seeded value of a tensor its file
    does not map).

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
    ``mesh`` (``parallel/mesh.py``): the whole model is built, loaded,
    frozen or cast and quantized as above, on every rank alike, then
    sliced to this rank's tp block (``shard_model_tp``, tp > 1) and
    sharded over fsdp (``shard_model_fsdp``, ZeRO-3, fsdp > 1).
    """
    if eval_param_dtype not in EVAL_PARAM_DTYPES:
        raise ValueError(f"eval_param_dtype {eval_param_dtype!r} not in "
                         f"{sorted(EVAL_PARAM_DTYPES)}")
    if train and eval_param_dtype != "fp32":
        raise ValueError("a training build takes frozen_dtype, not eval_param_dtype")
    is_lm = isinstance(cfg, LMConfig)
    if is_lm and (train or mesh is not None):
        raise ValueError("a CausalLM is built for inference on one device")
    if not is_lm and dtype is not None:
        raise ValueError("a UniMPConfig sets its compute dtype itself (cfg.dtype)")
    device = resolve_device(device)
    with device:
        model = CausalLM(cfg, dtype or torch.bfloat16) if is_lm else UniMPModel(cfg)
    if weights is None or callable(weights):
        init_params(model, torch.Generator(device).manual_seed(seed))
    if callable(weights):
        weights = weights({n.replace(".", "/"): t.detach() for n, t in model.state_dict().items()})
    if weights is not None:
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
        shard_model_fsdp(model, mesh)
    return model
