"""Parameter sharding: the JAX package's rule table, tensor parallelism over
the tp axis, and ZeRO sharding of gradients and optimizer state over fsdp.

Counterpart of ``unimp_tpu/parallel/sharding.py``. ``partition_rules``,
``spec_for_path`` and ``param_specs`` are the JAX table, with a
PartitionSpec written as a tuple (one entry a dimension: None, an axis
name, or a tuple of axis names). XLA compiles that table into collectives;
here each part is explicit:

* tp (``shard_model_tp``): every tensor whose rule names "tp" holds this
  rank's block of that dimension. Attention q/k/v and the MLP up/gate are
  column-parallel (heads, columns): their input enters through
  ``copy_to_tp`` (identity forward, all-reduce of the input gradient);
  o_proj and the MLP down are row-parallel: their partial products are
  all-reduced (``reduce_from_tp``) before the bias. The token embedding is
  vocabulary-parallel (rows outside the block look up zeros, then an
  all-reduce), and the logits of the tied or untied head are computed over
  the block and all-gathered (``gather_from_tp``). A module whose heads,
  columns or rows do not divide by tp stays whole, as the JAX guard
  degrades an indivisible dimension to replicated. An int8 kernel's
  per-channel scale is sliced with its columns (column-parallel) and kept
  whole for a row-parallel kernel, whose contracted axis is sliced: the
  JAX package replicates every scale and XLA slices it.
* fsdp (``ZeroShards``): each trainable tensor lives in one flat buffer
  padded to a multiple of fsdp; this rank's optimizer updates its 1/fsdp
  view of it, from gradients reduce-scattered over fsdp (and all-reduced
  over dp), and the updated buffer is all-gathered back. The parameters
  stay whole on every rank (the reference's DeepSpeed ZeRO-2), and so do
  frozen tensors, int8 payloads included.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

Spec = Tuple


def partition_rules() -> List[Tuple[str, Spec]]:
    """(path regex, spec); first match wins. Paths are '/'-joined Flax
    paths, e.g. 'block_3/attn/q_proj/kernel'."""
    return [
        (r".*embed/embedding$", (("fsdp", "tp"), None)),
        (r".*lm_head/kernel$", ("fsdp", "tp")),
        (r".*(q_proj|k_proj|v_proj)/kernel$", ("fsdp", "tp", None)),
        (r".*(q_proj|k_proj|v_proj)/bias$", ("tp", None)),
        (r".*o_proj/kernel$", ("tp", None, "fsdp")),
        (r".*mlp/(up|gate)/kernel$", ("fsdp", "tp")),
        (r".*mlp/(up|gate)/bias$", ("tp",)),
        (r".*mlp/down/kernel$", ("tp", "fsdp")),
        (r".*patch_embed/kernel$", (None, "fsdp")),
        (r".*", ()),
    ]


def spec_for_path(path: str, rules=None) -> Spec:
    for pattern, spec in rules or partition_rules():
        if re.match(pattern, path):
            return spec
    return ()


def param_specs(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, Spec]:
    """{flat path: spec} for a flat tree's shapes, as the JAX
    ``param_specs``: an int8 kernel's payload (``.../kernel/q``) keeps the
    kernel's rule and its scale (``.../kernel/scale``) is replicated; a spec
    longer than the tensor's rank is cut to it."""
    rules = partition_rules()
    out = {}
    for path, shape in shapes.items():
        ndim = len(shape)
        if path.endswith("/scale") and path[: -len("/scale")].endswith("kernel"):
            out[path] = ()
            continue
        if path.endswith("kernel/q"):
            path_rule = path[: -len("/q")]
        else:
            path_rule = path
        spec = spec_for_path(path_rule, rules)
        fixed = [None if axis is None or i >= ndim else axis for i, axis in enumerate(spec)]
        out[path] = tuple(fixed[:ndim]) if ndim else ()
    return out


# ---------------------------------------------------------------- tp collectives


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the input gradient all-reduced over tp (each rank's
    column block contributes its part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) of the row blocks' partial products; the gradient
    passes through to every rank."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather of the last dimension's blocks (the vocabulary of the
    logits); the gradient keeps this rank's block (every rank computes the
    same loss on the gathered logits)."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        x = x.movedim(-1, 0).contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo: lo + ctx.width], None


def copy_to_tp(x, group):
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x, group):
    return x if group is None else _GatherFromTP.apply(x, group)


# ---------------------------------------------------------------- tp sharding


def _narrow(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).contiguous()


def _slice_kernel(mod: nn.Module, dim: int, rank: int, n: int) -> None:
    """``mod.kernel`` (a parameter or an int8 ``QuantizedKernel``) to its
    block of ``dim``; an int8 kernel's scale follows a non-contracted
    ``dim`` and stays whole otherwise."""
    from unimp_tpu_torch.utils.quant import QuantizedKernel

    k = mod.kernel
    if isinstance(k, QuantizedKernel):
        n_in = k.q.dim() - k.scale.dim()
        k.q = _narrow(k.q, dim, rank, n)
        if dim >= n_in:
            k.scale = _narrow(k.scale, dim - n_in, rank, n)
    else:
        k.data = _narrow(k.data, dim, rank, n)


def _slice_param(p: Optional[torch.Tensor], dim: int, rank: int, n: int) -> None:
    if p is not None:
        p.data = _narrow(p.data, dim, rank, n)


def _tp_modules(model: nn.Module, tp: int):
    """[(name, module, kind)] of the modules tp shards: "attn", "mlp",
    "embed", "head"; a module whose sizes do not divide stays whole."""
    from unimp_tpu_torch.models.flamingo import Embed, UniMPModel
    from unimp_tpu_torch.models.layers import Attention, Mlp

    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, Attention):
            if mod.num_heads % tp == 0 and mod.num_kv_heads % tp == 0:
                out.append((name, mod, "attn"))
        elif isinstance(mod, Mlp):
            if mod.down.kernel.shape[0] % tp == 0:
                out.append((name, mod, "mlp"))
        elif isinstance(mod, Embed):
            if mod.embedding.shape[0] % tp == 0:
                out.append((name, mod, "embed"))
        elif isinstance(mod, UniMPModel) and hasattr(mod, "lm_head"):
            if mod.lm_head.kernel.shape[1] % tp == 0:
                out.append((name, mod, "head"))
    return out


def _path(*parts) -> str:
    return "/".join(p.replace(".", "/") for p in parts if p)


def tp_layout(model: nn.Module, tp: int) -> Dict[str, int]:
    """{flat path: dimension} of every tensor that ``shard_model_tp``
    slices over tp (float kernels, biases and embeddings; an int8 kernel at
    its ``.../kernel`` path, whose payload follows it). Each dimension is
    the one the JAX rule table names "tp" for that path
    (``tests/test_torch_parallel.py`` holds it to ``param_specs``)."""
    layout = {}
    for name, mod, kind in _tp_modules(model, tp):
        if kind == "attn":
            for proj in ("q_proj", "k_proj", "v_proj"):
                layout[_path(name, proj, "kernel")] = 1
                if getattr(mod, proj).bias is not None:
                    layout[_path(name, proj, "bias")] = 0
            layout[_path(name, "o_proj", "kernel")] = 0
        elif kind == "mlp":
            for col in ("gate", "up"):
                if hasattr(mod, col):
                    layout[_path(name, col, "kernel")] = 1
                    if getattr(mod, col).bias is not None:
                        layout[_path(name, col, "bias")] = 0
            layout[_path(name, "down", "kernel")] = 0
        elif kind == "embed":
            layout[_path(name, "embedding")] = 0
        elif kind == "head":
            layout[_path(name, "lm_head", "kernel")] = 1
    return layout


def tensor_tp_dim(layout: Dict[str, int], path: str, shape=None) -> Optional[int]:
    """The tp dimension of a flat path under ``layout``, for the model's
    own paths and a tree's: ``.../kernel/q`` follows its kernel,
    ``.../kernel/scale`` the kernel's dimension less the contracted axes
    (None when the kernel is sliced on a contracted axis)."""
    if path in layout:
        return layout[path]
    if path.endswith("kernel/q"):
        return layout.get(path[: -len("/q")])
    if path.endswith("kernel/scale"):
        kdim = layout.get(path[: -len("/scale")])
        if kdim is None:
            return None
        # scales are over the output axes: o_proj [H, d, out] -> [out],
        # the others [in, ...] -> [...]
        n_in = 2 if path.endswith("o_proj/kernel/scale") else 1
        return kdim - n_in if kdim >= n_in else None
    return None


def shard_model_tp(model: nn.Module, mesh) -> nn.Module:
    """Slice ``model`` (whole weights, on every rank alike) to this rank's
    tp block, in place, and wire the tp collectives: each sharded module
    gets the group as ``tp_group``, the model its layout as ``tp_layout``
    (with ``tp_group``, ``tp_rank`` and ``tp_size``) and, when its head's
    matrix is sliced, ``logits_tp_group``. A mesh with
    tp 1 leaves the model as it is (``tp_layout`` empty). Call it after any
    int8 quantization: the scales are those of the whole kernels."""
    from unimp_tpu_torch.utils.quant import fuse_decode_kernels

    n = mesh.tp
    model.tp_layout, model.logits_tp_group = {}, None
    if n == 1:
        return model
    group, rank = mesh.group("tp"), mesh.coords[2]
    model.tp_layout = tp_layout(model, n)
    model.tp_group, model.tp_rank, model.tp_size = group, rank, n
    kinds = set()
    for _, mod, kind in _tp_modules(model, n):
        kinds.add(kind)
        if kind == "attn":
            for proj in (mod.q_proj, mod.k_proj, mod.v_proj):
                _slice_kernel(proj, 1, rank, n)
                _slice_param(proj.bias, 0, rank, n)
            _slice_kernel(mod.o_proj, 0, rank, n)
            mod.num_heads //= n
            mod.num_kv_heads //= n
            if mod.alibi is not None:
                mod.alibi = _narrow(mod.alibi, 0, rank, n)
            mod.tp_group = mod.o_proj.tp_group = group
        elif kind == "mlp":
            for col in ("gate", "up"):
                if hasattr(mod, col):
                    _slice_kernel(getattr(mod, col), 1, rank, n)
                    _slice_param(getattr(mod, col).bias, 0, rank, n)
            _slice_kernel(mod.down, 0, rank, n)
            mod.tp_group = mod.down.tp_group = group
        elif kind == "embed":
            mod.vocab_start = rank * (mod.embedding.shape[0] // n)
            _slice_param(mod.embedding, 0, rank, n)
            mod.tp_group = group
        elif kind == "head":
            _slice_kernel(mod.lm_head, 1, rank, n)
    # the logits are computed over this rank's vocabulary block when the
    # head's matrix is sliced: the tied embedding, or the untied lm_head
    if ("embed" if model.cfg.lm.tie_embeddings else "head") in kinds:
        model.logits_tp_group = group
    fuse_decode_kernels(model)
    return model


def shard_tree_tp(flat: dict, layout: Dict[str, int], rank: int, n: int) -> dict:
    """This rank's tp block of each tensor of a whole flat tree (``{path:
    array or tensor}``) that ``layout`` shards; the others as they are."""
    out = {}
    for path, val in flat.items():
        dim = tensor_tp_dim(layout, path)
        if dim is None or n == 1:
            out[path] = val
            continue
        t = val if isinstance(val, torch.Tensor) else torch.as_tensor(val)
        out[path] = _narrow(t, dim, rank, n)
    return out


def gather_tp(t: torch.Tensor, dim: int, group, device) -> torch.Tensor:
    """The whole tensor from every tp rank's block of ``dim`` (all-gather
    on ``device``); returns it on the host."""
    n = dist.get_world_size(group)
    x = t.to(device).movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).cpu()


# ---------------------------------------------------------------- ZeRO over fsdp


class ZeroShards:
    """Gradients and optimizer state of the trainable tensors sharded over
    the mesh's fsdp axis.

    Each parameter's data moves into a flat buffer padded to a multiple of
    fsdp (the parameter becomes a view of it); ``shards`` holds, by name,
    this rank's contiguous 1/fsdp view of each buffer as a leaf parameter,
    which is what the optimizer is built over (its in-place update writes
    the parameter's storage). ``reduce`` turns whole local gradients into
    this rank's summed shard (reduce-scatter over fsdp, then all-reduce
    over dp); ``gather_params`` all-gathers the updated buffers."""

    def __init__(self, params: Dict[str, nn.Parameter], mesh):
        self.mesh = mesh
        self.n = mesh.fsdp
        self.rank = mesh.coords[1]
        self.group = mesh.group("fsdp")
        self.shapes, self.numels, self.bufs, self.shards = {}, {}, {}, {}
        for name, p in params.items():
            numel = p.numel()
            chunk = math.ceil(numel / self.n)
            buf = torch.zeros(chunk * self.n, dtype=p.dtype, device=p.device)
            with torch.no_grad():
                buf[:numel].copy_(p.detach().reshape(-1))
            p.data = buf[:numel].view(p.shape)
            self.shapes[name], self.numels[name], self.bufs[name] = p.shape, numel, buf
            self.shards[name] = nn.Parameter(buf[self.rank * chunk:(self.rank + 1) * chunk])

    def chunk(self, name: str) -> int:
        return self.bufs[name].numel() // self.n

    def reduce(self, name: str, grad: Optional[torch.Tensor]) -> torch.Tensor:
        """This rank's shard of the gradient summed over the data axis."""
        c = self.chunk(name)
        flat = torch.zeros(c * self.n, dtype=self.bufs[name].dtype if grad is None
                           else grad.dtype, device=self.bufs[name].device)
        if grad is not None:
            flat[: self.numels[name]] = grad.reshape(-1)
        out = torch.empty(c, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat, group=self.group)
        if self.mesh.dp > 1:
            dist.all_reduce(out, group=self.mesh.group("dp"))
        return out

    @torch.no_grad()
    def gather_params(self) -> None:
        for name, buf in self.bufs.items():
            dist.all_gather_into_tensor(buf, self.shards[name].detach().clone(),
                                        group=self.group)

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole tensor (the parameter's shape) of a shard-shaped state
        tensor (a moment), all-gathered over fsdp."""
        out = torch.empty(self.chunk(name) * self.n, dtype=shard.dtype, device=shard.device)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.group)
        return out[: self.numels[name]].view(self.shapes[name])

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor of the parameter's shape."""
        c = self.chunk(name)
        flat = torch.zeros(c * self.n, dtype=whole.dtype, device=whole.device)
        flat[: self.numels[name]] = whole.reshape(-1)
        return flat[self.rank * c:(self.rank + 1) * c].clone()
