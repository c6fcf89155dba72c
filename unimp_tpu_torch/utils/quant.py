"""Weight-only int8 quantization for inference.

Counterpart of ``unimp_tpu/utils/quant.py`` (the reference worker's
``load_in_8bit`` option): matmul kernels are stored int8 with a
per-output-channel f32 scale. A quantized kernel replaces its module's
``kernel`` parameter by a ``QuantizedKernel`` submodule whose buffers
``q`` and ``scale`` sit at the Flax tree's ``.../kernel/q`` and
``.../kernel/scale`` paths, so ``tools/from_flax.py`` loads a tree that
the JAX ``quantize_params_int8`` produced. ``ops/quant_matmul.py:quant_dot``
is where a quantized kernel is used.

The functions here change a model in place and return it (the JAX ones
map a parameter tree). The int8 frozen backbone (``--frozen_int8``)
quantizes the frozen kernels of a training model
(``train/partition.py:freeze``); its checkpoints are float trees, as the
JAX package writes them: ``dequantize_params_host`` gives the model's tree
with each int8 kernel dequantized on the host, one kernel at a time, and
``abstract_dequantized`` that tree's layout (meta tensors) as the target
a restore is checked against.
"""

from __future__ import annotations

import torch
from torch import nn


class QuantizedKernel(nn.Module):
    """int8 weight ``q`` in the kernel's Flax shape and an f32 ``scale``
    per output channel, over the axes after the leading (contracted) ones:
    ``q.shape[1:]`` for Dense [in, N] and Proj [in, H, d] kernels, [out]
    for o_proj kernels [H, d, out]. ``dtype`` is the compute dtype that
    ``dequantize`` targets (the JAX ``__jax_array__`` dequant).

    ``persistent=False`` marks a derived copy (the fused decode QKV): it
    moves with the model but is not part of its state or its tree."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16,
                 persistent: bool = True):
        super().__init__()
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(f"q must be int8 and scale float32, got {q.dtype}, {scale.dtype}")
        if tuple(q.shape[q.dim() - scale.dim():]) != tuple(scale.shape):
            raise ValueError(f"scale {tuple(scale.shape)} is not a trailing block of "
                             f"q {tuple(q.shape)}")
        self.dtype, self.persistent = dtype, persistent
        self.register_buffer("q", q, persistent=persistent)
        self.register_buffer("scale", scale, persistent=persistent)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def flat(self, in_dim: int):
        """(q [in_dim, N] int8, scale [N] f32) for a matmul that contracts
        the leading axes of q, whose sizes multiply to ``in_dim``."""
        n = self.scale.numel()
        if in_dim * n != self.q.numel():
            raise ValueError(f"kernel {tuple(self.q.shape)} with scale {tuple(self.scale.shape)} "
                             f"does not contract {in_dim} inputs")
        return self.q.reshape(in_dim, n), self.scale.reshape(n)

    def dequantize(self, dtype=None) -> torch.Tensor:
        """q * scale in ``dtype`` (default: the compute dtype), the rounding
        of the JAX ``QuantizedKernel.astype``."""
        dtype = dtype or self.dtype
        return self.q.to(dtype) * self.scale.to(dtype)

    def extra_repr(self) -> str:
        return f"shape={tuple(self.q.shape)}, scale={tuple(self.scale.shape)}, dtype={self.dtype}"


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127, computed as XLA compiles it (a product with
    the f32 reciprocal of 127), so that the JAX package and the port round
    the same values to the same int8."""
    return torch.clamp(amax, min=1e-8) * (1.0 / 127.0)


def _quantize_leaf(w: torch.Tensor, n_in_axes: int = 1, group=None):
    """Kernel -> (q int8, scale f32 reduced over the ``n_in_axes`` leading
    (input) axes): absmax scale = max(amax, 1e-8) / 127, q = round(w /
    scale) clipped to [-127, 127]; ``torch.round`` rounds half to even, as
    ``jnp.round`` does. ``group``: the kernel is a row block of a tp
    row-parallel kernel, whose amax is the maximum over the group (the
    whole kernel's)."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(range(n_in_axes)))
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = _absmax_scale(amax)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(t: torch.Tensor):
    """KV rows [..., D] -> (int8 [..., D], f32 scale [...]): symmetric
    absmax over the head dim, one scale per (row, head, position), the
    rule of the JAX package's int8 KV caches (the prefill caches,
    ``decode/sampler.py:quantize_kv_cache``, and each decode step's gen
    cache write, ``models/layers.py``)."""
    t = t.float()
    scale = _absmax_scale(t.abs().amax(dim=-1))
    q = torch.clamp(torch.round(t / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def concat_kernels_int8(kernels, persistent: bool = False) -> QuantizedKernel:
    """Concatenate quantized kernels with one input axis along the output
    axis without dequantizing (the fused-QKV decode matmul): the int8
    payloads concatenate on axis 1, the per-channel scales on axis 0, so
    each output column keeps its own scale."""
    q = torch.cat([k.q.reshape(k.q.shape[0], -1) for k in kernels], dim=1)
    s = torch.cat([k.scale.reshape(-1) for k in kernels])
    return QuantizedKernel(q, s, dtype=kernels[0].dtype, persistent=persistent)


def fuse_decode_kernels(model: nn.Module) -> nn.Module:
    """Give every decoder block's self-attention (the one that decodes)
    whose q/k/v projections are all quantized its fused int8 QKV
    (``Attention.qkv_int8``), concatenated once here rather than at every
    decode step; drop stale ones."""
    from unimp_tpu_torch.models.lm import DecoderBlock

    for block in model.modules():
        if isinstance(block, DecoderBlock):
            attn = block.attn
            ks = [attn.q_proj.kernel, attn.k_proj.kernel, attn.v_proj.kernel]
            fused = all(isinstance(k, QuantizedKernel) for k in ks)
            attn.qkv_int8 = concat_kernels_int8(ks) if fused else None
    return model


def _set_kernel(mod: nn.Module, kernel) -> None:
    mod._parameters.pop("kernel", None)
    mod._modules.pop("kernel", None)
    setattr(mod, "kernel", kernel)


def quantize_params_int8(model: nn.Module, *, min_size: int = 1 << 16,
                         dtype=torch.bfloat16, select=None) -> nn.Module:
    """Quantize every ``kernel`` parameter with ndim >= 2 and at least
    ``min_size`` elements to int8, in place; norms, biases, gates and
    embeddings stay as they are. o_proj kernels [H, d, out] contract both
    leading axes, so their scale is [out]. ``dtype`` is the compute dtype
    the kernels dequantize to. ``select`` (parameter name -> bool), when
    given, limits it to the kernels it accepts (the frozen subtree of a
    training model). Returns the model."""
    for name, mod in list(model.named_modules()):
        w = mod._parameters.get("kernel")
        if w is None or w.dim() < 2 or w.numel() < min_size:
            continue
        if select is not None and not select(f"{name}.kernel" if name else "kernel"):
            continue
        n_in = 2 if (name.rsplit(".", 1)[-1] == "o_proj" and w.dim() == 3) else 1
        # a tp row-parallel projection (parallel/sharding.py) holds a row block
        q, scale = _quantize_leaf(w, n_in, getattr(mod, "tp_group", None))
        _set_kernel(mod, QuantizedKernel(q, scale, dtype))
    return fuse_decode_kernels(model)


def dequantize_params(model: nn.Module, dtype=torch.float32) -> nn.Module:
    """Every quantized kernel back to a float ``kernel`` parameter of
    ``dtype`` (q * scale in that dtype), in place. Returns the model."""
    for mod in list(model.modules()):
        k = mod._modules.get("kernel")
        if isinstance(k, QuantizedKernel):
            _set_kernel(mod, nn.Parameter(k.dequantize(dtype)))
    return fuse_decode_kernels(model)


def _flat_tree(model: nn.Module, qleaf, leaf) -> dict:
    """{flat Flax path: leaf(tensor)} of the model's persistent state, each
    persistent ``QuantizedKernel`` as one leaf, ``qleaf(kernel)``, at its
    ``.../kernel`` path."""
    out = {}
    for name, t in model.state_dict().items():
        path = name.replace(".", "/")
        if path.endswith("kernel/scale"):
            continue
        if path.endswith("kernel/q"):
            out[path[:-2]] = qleaf(model.get_submodule(name.rsplit(".", 1)[0]))
        else:
            out[path] = leaf(t.detach())
    return out


def dequantize_params_host(model: nn.Module, dtype=torch.float32) -> dict:
    """{flat Flax path: tensor} of the model's state with every int8 kernel
    as a host ``dtype`` tensor (q * scale in float32 on its device, copied
    to the host and cast, one kernel at a time: the device never holds the
    whole float frozen tree); other tensors are the live ones (no copy)."""
    return _flat_tree(model, lambda k: k.dequantize(torch.float32).cpu().to(dtype),
                      lambda t: t)


def abstract_dequantized(model: nn.Module, dtype=torch.float32) -> dict:
    """{flat Flax path: meta tensor} of the dequantized layout (the tree a
    checkpoint of the model holds), with no memory behind it."""
    return _flat_tree(model, lambda k: torch.empty(k.shape, dtype=dtype, device="meta"),
                      lambda t: torch.empty_like(t, device="meta"))


def quantized_bytes(model: nn.Module) -> int:
    """Device bytes of the model's parameter tree (the persistent state:
    parameters, int8 payloads and scales; derived copies excluded)."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def count_quantized(model: nn.Module) -> int:
    return sum(1 for m in model.modules() if isinstance(m, QuantizedKernel) and m.persistent)


