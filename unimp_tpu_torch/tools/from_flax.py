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
from unimp_tpu_torch.ops.attention_ref import alibi_slopes
from unimp_tpu_torch.parallel.sharding import (
    ZeroShards,
    _narrow,
    fsdp_chunk,
    shard_model_tp,
    shard_tree_tp,
)
from unimp_tpu_torch.train.partition import backbone_trainable_mask
from unimp_tpu_torch.utils.quant import QuantizedKernel, fuse_decode_kernels, quantize_kernel

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
    ``.../kernel/scale`` leaves), float where the tree's is float, zeros
    for the load to fill; a ZeRO-3 model (``model.zero``) gets the new
    tensor's chunk where the table shards it."""
    zero = getattr(model, "zero", None)

    def put(path, owner, attr, shape, dtype, device):
        chunk = zero.placement(path, shape) if zero is not None else None
        t = torch.zeros(shape if chunk is None else chunk, dtype=dtype, device=device)
        if attr in owner._buffers:
            owner._buffers[attr] = t
        else:
            setattr(owner, attr, nn.Parameter(t))
        if chunk is not None:
            zero.adopt(path, owner, attr, shape)

    for name, mod in list(model.named_modules()):
        k = getattr(mod, "kernel", None)
        if k is None:
            continue
        path = f"{name.replace('.', '/')}/kernel" if name else "kernel"
        if f"{path}/q" in flat and not isinstance(k, QuantizedKernel):
            if zero is not None and zero.sharded(path):
                zero.forget(path)
            shape = np.shape(flat[f"{path}/q"])
            mod._parameters.pop("kernel")
            mod.kernel = QuantizedKernel(
                torch.empty(shape, dtype=torch.int8, device="meta"),
                torch.zeros(np.shape(flat[f"{path}/scale"]), device=k.device),
                model.compute_dtype)
            put(f"{path}/q", mod.kernel, "q", shape, torch.int8, k.device)
        elif path in flat and isinstance(k, QuantizedKernel):
            if zero is not None and zero.sharded(f"{path}/q"):
                zero.forget(f"{path}/q")
            shape, device = k.shape, k.scale.device
            del mod.kernel
            put(path, mod, "kernel", shape, torch.float32, device)


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
    _match_quantized(model, flat)
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
    fuse_decode_kernels(model)


def _lecun_normal_(p: torch.Tensor, gen: torch.Generator) -> None:
    # flax fan_in for a kernel [..., in_axis, out]: every axis but the last
    fan_in = math.prod(p.shape[:-1])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_tensor(name: str, p: torch.Tensor, generator: torch.Generator) -> None:
    """Seeded init of the parameter ``name`` in place, with Flax's
    distribution for its leaf name."""
    leaf = name.rsplit(".", 1)[-1]
    with torch.no_grad():
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


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter, in place, with Flax's distributions."""
    for name, p in model.named_parameters():
        init_tensor(name, p, generator)


def _materialize_buffers(model: nn.Module, device: torch.device) -> None:
    """The buffers that a model made on the meta device computed at
    construction, made again on ``device``: each attention's ALiBi slopes."""
    for name, mod in model.named_modules():
        for key, buf in mod._buffers.items():
            if buf is not None and buf.is_meta:
                if key != "alibi":
                    raise ValueError(f"no rule to materialize the buffer {name}.{key}")
                with device:
                    mod._buffers[key] = alibi_slopes(mod.num_heads)


def _check_tree(model: nn.Module, flat: Mapping) -> None:
    """Raise as ``load_flax_params`` does where ``flat`` and the (meta)
    model's parameters differ in names or shapes; an int8 kernel of the
    tree (``.../kernel/q`` and ``.../kernel/scale``) stands for its float
    kernel."""
    want, shapes = set(), {}
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        if name.endswith("kernel") and f"{path}/q" in flat:
            want.update((f"{path}/q", f"{path}/scale"))
            path = f"{path}/q"
        else:
            want.add(path)
        shapes[path] = p.shape
    have = set(flat)
    if want != have:
        raise KeyError(f"flax tree and model differ: missing {sorted(want - have)[:8]}, "
                       f"unexpected {sorted(have - want)[:8]}")
    for path, shape in shapes.items():
        val = flat[path]
        if not callable(val) and tuple(val.shape) != tuple(shape):
            raise ValueError(f"{path.replace('/', '.')}: flax shape {tuple(val.shape)} != "
                             f"port {tuple(shape)}")


def _on_device(val, shape, dtype, device) -> torch.Tensor:
    """A new tensor on ``device`` holding ``val`` (a host array or tensor)
    cast to ``dtype``, as ``load_flax_params`` copies a leaf into its
    tensor."""
    if not isinstance(val, torch.Tensor):
        val = torch.from_numpy(np.array(val))
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    with torch.no_grad():
        out.copy_(val.to(device))
    return out


class _Build:
    """``build_model``'s steps for one tensor at a time, on a model made on
    the meta device (tp wired and ``model.zero`` set by then)."""

    def __init__(self, model, device, gen, weights, *, train, mask, frozen_dtype, cast, int8):
        self.model, self.device, self.gen, self.weights = model, device, gen, weights
        self.train, self.mask, self.frozen_dtype = train, mask, frozen_dtype
        self.cast, self.int8 = cast, int8
        self.layout = getattr(model, "tp_layout", None) or {}
        self.tp_rank, self.tp = getattr(model, "tp_rank", 0), getattr(model, "tp_size", 1)
        self.zero = getattr(model, "zero", None)

    def materialize(self, name: str, meta: torch.Tensor):
        """The whole tensor of ``name`` on the device, float32: its seeded
        draw or its value in ``weights``; for an int8 kernel of
        ``weights``, its (q, scale)."""
        path = name.replace(".", "/")
        w = None
        if self.gen is not None:  # every tensor is drawn: the stream keeps its order
            w = torch.empty_like(meta, device=self.device)
            init_tensor(name, w, self.gen)
        if self.weights is None:
            return w
        if f"{path}/q" in self.weights:
            q, scale = self.weights[f"{path}/q"], self.weights[f"{path}/scale"]
            return (_on_device(q, q.shape, torch.int8, self.device),
                    _on_device(scale, scale.shape, torch.float32, self.device))
        val = self.weights[path]
        if callable(val):  # a function of the seeded tensor (a grown embedding)
            return val(w)
        if isinstance(val, torch.Tensor) and val.is_meta:  # the seeded value kept
            return w
        return _on_device(val, meta.shape, meta.dtype, self.device)

    def _tp_block(self, t: torch.Tensor, dim) -> torch.Tensor:
        return t if dim is None else _narrow(t, dim, self.tp_rank, self.tp)

    def _chunk(self, path: str, t: torch.Tensor):
        """``t`` (a tp block), or this rank's fsdp chunk of it where the
        table shards it; and whether it was cut."""
        if self.zero is None or self.zero.placement(path, t.shape) is None:
            return t, False
        return fsdp_chunk(t, self.zero.rank, self.zero.n), True

    def place(self, name: str, meta: torch.Tensor) -> None:
        """Make ``name``'s tensor and put this rank's part of it in its
        module, frozen, cast or quantized in the order the whole build
        applied them: quantized over the whole tensor (an int8 inference
        kernel from its bfloat16 cast), then sliced and chunked."""
        path = name.replace(".", "/")
        owner_name, _, attr = name.rpartition(".")
        owner = self.model.get_submodule(owner_name)
        trainable = self.mask[name] if self.train else True
        frozen = self.train and not trainable
        n_in = 2 if owner_name.rsplit(".", 1)[-1] == "o_proj" and meta.dim() == 3 else 1
        big_kernel = attr == "kernel" and meta.dim() >= 2 and meta.numel() >= 1 << 16
        w = self.materialize(name, meta)
        if isinstance(w, tuple):  # an int8 kernel of the tree
            (q, scale), qdtype = w, self.model.compute_dtype
        elif frozen and self.frozen_dtype == "int8" and big_kernel:
            (q, scale), qdtype = quantize_kernel(w, n_in), self.model.cfg.compute_dtype
        elif not self.train and self.int8 and big_kernel:
            (q, scale), qdtype = quantize_kernel(w, n_in, self.cast), torch.bfloat16
        else:
            cast = None
            if frozen and self.frozen_dtype not in (None, "int8") and w.is_floating_point():
                cast = self.frozen_dtype
            elif not self.train and w.dim() >= 2 and w.dtype == torch.float32:
                cast = self.cast
            w = self._tp_block(w, self.layout.get(path))
            shape = w.shape
            w, cut = self._chunk(path, w)
            # a cast rounds each element alone: on the chunk it gives the same bits
            owner._parameters[attr] = nn.Parameter(w if cast is None else w.to(cast),
                                                   requires_grad=trainable)
            if cut:
                self.zero.adopt(path, owner, attr, shape)
            return
        del w
        dim = self.layout.get(path)
        q = self._tp_block(q, dim)
        if dim is not None and dim >= q.dim() - scale.dim():
            scale = _narrow(scale, dim - (q.dim() - scale.dim()), self.tp_rank, self.tp)
        kernel = QuantizedKernel(q, scale, qdtype)
        chunk, cut = self._chunk(f"{path}/q", q)
        owner._parameters.pop(attr)
        setattr(owner, attr, kernel)
        if cut:
            kernel._buffers["q"] = chunk
            self.zero.adopt(f"{path}/q", kernel, "q", q.shape)


def build_model(cfg: UniMPConfig | LMConfig, *, device="cuda", seed: int = 0,
                eval_param_dtype: str = "fp32", train: bool = False,
                frozen_dtype=None, weights: Mapping | None = None,
                trainable_mask=backbone_trainable_mask, mesh=None,
                dtype: torch.dtype | None = None) -> UniMPModel | CausalLM:
    """A UniMPModel on ``device`` (a ``CausalLM`` when ``cfg`` is an
    ``LMConfig``: inference only, no mesh, computing in ``dtype``, default
    bfloat16; a UniMPConfig carries its own, ``cfg.dtype``, and a ``dtype``
    given with one raises) with seeded weights (``init_params``' draws), or
    with ``weights`` (a flat tree, {"a/b/c": tensor or array}, e.g.
    ``train/checkpoint.py:restore_params``; float, or with a kernel as the
    JAX int8 ``.../kernel/q`` and ``.../kernel/scale``) in their place
    before anything is cast or quantized. ``weights`` may also be a
    function of the seeded tree that returns the tree to load (the ``.pt``
    converter): it gets meta tensors, and a value it returns may be a meta
    tensor (keep the seeded one) or a function of the seeded tensor.

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
    partition.py:freeze``), ``.train()``.

    The model is made on the meta device and its tensors one at a time,
    in ``named_parameters()`` order: each is made whole in float32 on
    ``device`` (drawn from the one generator, or read from ``weights``),
    frozen, cast or quantized (over the whole tensor), sliced to this
    rank's tp block (``mesh``, tp > 1) and cut to this rank's fsdp chunk
    (ZeRO-3, fsdp > 1, ``parallel/sharding.py:ZeroShards``), as the JAX
    trainer makes its parameters already sharded; the whole tensor is
    freed before the next. The device so holds at most the model's
    resident bytes and one whole float32 tensor (and the copies of its
    block and chunk), and every rank's tensors equal, bit for bit, the
    whole model built, loaded, frozen or cast and then sliced.
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
    with torch.device("meta"):
        model = CausalLM(cfg, dtype or torch.bfloat16) if is_lm else UniMPModel(cfg)
    _materialize_buffers(model, device)
    if mesh is not None:
        shard_model_tp(model, mesh, sliced=True)
        model.zero = ZeroShards(model, mesh) if mesh.fsdp > 1 else None
    gen = None
    if weights is None or callable(weights):
        gen = torch.Generator(device).manual_seed(seed)
    if callable(weights):
        weights = weights({n.replace(".", "/"): p for n, p in model.named_parameters()})
    if weights is not None:
        _check_tree(model, weights)
    build = _Build(model, device, gen, weights, train=train,
                   mask=trainable_mask(model) if train else None, frozen_dtype=frozen_dtype,
                   cast=None if train else EVAL_PARAM_DTYPES[eval_param_dtype],
                   int8=not train and eval_param_dtype == "int8")
    for name, meta in list(model.named_parameters()):
        build.place(name, meta)
    fuse_decode_kernels(model)
    return model.train() if train else model.eval()
