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
* fsdp (``ZeroShards``, ZeRO-3): every tensor whose rule names fsdp on a
  dimension the axis divides, trainable or frozen (an int8 payload by its
  kernel's rule), keeps only this rank's flat 1/fsdp chunk resident; the
  rest stays whole, as in JAX. A block's tensors are all-gathered just
  before it runs and freed after; a trainable tensor's gradient is
  reduce-scattered over fsdp (and all-reduced over dp) into its chunk by
  the gather's own backward, and the optimizer updates the chunks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import time
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint as torch_checkpoint
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
    """This rank's block of ``dim``, a tensor of its own: a view (or a
    ``contiguous`` one, which is a view for a block of the first dimension)
    would keep the whole tensor's storage alive."""
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).clone(memory_format=torch.contiguous_format)


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


def shard_model_tp(model: nn.Module, mesh, sliced: bool = False) -> nn.Module:
    """Slice ``model`` (whole weights, on every rank alike) to this rank's
    tp block, in place, and wire the tp collectives: each sharded module
    gets the group as ``tp_group``, the model its layout as ``tp_layout``
    (with ``tp_group``, ``tp_rank`` and ``tp_size``) and, when its head's
    matrix is sliced, ``logits_tp_group``. A mesh with
    tp 1 leaves the model as it is (``tp_layout`` empty). Call it after any
    int8 quantization: the scales are those of the whole kernels.
    ``sliced``: wire a model whose parameters are still to be placed
    (``tools/from_flax.py:build_model``, on the meta device, slices each
    tensor by ``tp_layout`` as it makes it); its shapes are the whole
    ones."""
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
            if not sliced:
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
            if not sliced:
                for col in ("gate", "up"):
                    if hasattr(mod, col):
                        _slice_kernel(getattr(mod, col), 1, rank, n)
                        _slice_param(getattr(mod, col).bias, 0, rank, n)
                _slice_kernel(mod.down, 0, rank, n)
            mod.tp_group = mod.down.tp_group = group
        elif kind == "embed":
            mod.vocab_start = rank * (mod.embedding.shape[0] // n)
            if not sliced:
                _slice_param(mod.embedding, 0, rank, n)
            mod.tp_group = group
        elif kind == "head" and not sliced:
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


# ---------------------------------------------------------------- ZeRO-3 over fsdp


def fsdp_dim(path: str, shape, fsdp: int, tp: int = 1) -> Optional[int]:
    """The dimension of a tensor (flat ``path``, whole ``shape``) that the
    JAX table shards over fsdp, or None: its spec names no fsdp, or the
    axes named on that dimension (fsdp, with tp for the token embedding)
    do not divide it, which ``param_sharding``'s guard degrades to
    replicated."""
    spec = param_specs({path: tuple(shape)})[path]
    for i, axis in enumerate(spec):
        axes = axis if isinstance(axis, tuple) else (axis,)
        if "fsdp" in axes:
            size = math.prod({"fsdp": fsdp, "tp": tp}.get(a, 1) for a in axes)
            return i if shape[i] % size == 0 else None
    return None


def fsdp_chunk(t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """This rank's flat 1/n chunk of ``t`` (a new tensor), the last one
    zero-padded to ``ceil(numel / n)`` elements."""
    numel = t.numel()
    chunk = math.ceil(numel / n)
    lo, hi = min(rank * chunk, numel), min((rank + 1) * chunk, numel)
    piece = torch.zeros(chunk, dtype=t.dtype, device=t.device)
    with torch.no_grad():
        piece[: hi - lo] = t.detach().reshape(-1)[lo:hi]
    return piece


@dataclasses.dataclass(eq=False)
class _Shard:
    """One fsdp-sharded tensor: ``owner.attr`` stores this rank's flat
    ``chunk`` of the tensor of ``shape`` (its tp block), zero-padded to
    ``chunk * fsdp`` elements of ``itemsize`` bytes."""

    path: str
    owner: nn.Module
    attr: str
    shape: torch.Size
    chunk: int
    itemsize: int

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def slots(self) -> dict:
        """The owner's dict that holds the tensor (parameters or buffers)."""
        owner = self.owner
        return owner._parameters if self.attr in owner._parameters else owner._buffers


class _GatherFsdp(torch.autograd.Function):
    """All-gather of a trainable shard into its whole tensor; the backward
    reduce-scatters the whole tensor's gradient into this rank's shard
    (and all-reduces it over dp). It sits in autograd's graph, so the
    reduction runs under ``.backward()`` and ``torch.autograd.grad``
    alike, once for every gather (a tied embedding's two uses share one)."""

    @staticmethod
    def forward(ctx, shard, zero, entry):
        ctx.zero, ctx.entry = zero, entry
        return zero._all_gather(shard, entry)

    @staticmethod
    def backward(ctx, g):
        return ctx.zero._reduce_scatter(g, ctx.entry), None, None


class ZeroShards:
    """ZeRO-3 over the mesh's fsdp axis, placed by the JAX rule table.

    Every tensor whose spec names fsdp on a dimension the axis divides
    (``fsdp_dim``: the embedding and the LM head, q/k/v/o of every
    attention, the MLPs' up / gate / down, the patch embedding; trainable
    or frozen, an int8 payload by its kernel's rule) keeps only this rank's
    flat chunk of its tp block resident: a trainable parameter's ``.data``
    becomes the 1-D chunk (the optimizer is built over it, so its moments
    are chunks too), an int8 payload's buffer likewise. Everything else
    (norms, gates, biases, latents, position embeddings, int8 scales) stays
    whole, as in JAX. It is made empty; the build
    (``tools/from_flax.py:build_model``) puts each chunk in its slot and
    ``adopt``s it, so that no rank holds a whole model.

    The tensors are gathered per unit: each ViT, perceiver, decoder and
    x-attn block, the token embedding (the whole model when the head is
    tied, so that its two uses share one gather and one reduce-scatter),
    the untied head and the patch embedding. A unit's ``forward`` is
    wrapped: it all-gathers the unit's tensors into their modules' slots,
    runs, and puts the chunks back. Under autograd a trainable tensor is
    gathered through ``_GatherFsdp``, whose backward reduce-scatters the
    gradient; and a block runs under non-reentrant activation
    checkpointing (already the case for decoder and x-attn blocks under
    ``--remat``), so autograd keeps no gathered tensor for the backward:
    the recompute gathers again. A decoder block's int8 q/k/v are fused
    for decode after each gather (``utils/quant.py:fuse_decode_kernels``
    leaves a sharded model unfused).

    Counters: ``alive_bytes`` / ``peak_alive_bytes`` (gathered buffers not
    yet freed, by weak references on their storages), ``gathered_bytes``
    and ``gather_s`` (every gather), ``scattered_bytes`` (every gradient
    reduce-scatter); ``reset_counters`` zeroes them."""

    def __init__(self, model: nn.Module, mesh):
        self.model = model
        self.n, self.rank = mesh.fsdp, mesh.coords[1]
        self.tp = mesh.tp
        self.group = mesh.group("fsdp")
        self.dp_group = mesh.group("dp") if mesh.dp > 1 else None
        self.entries: Dict[str, _Shard] = {}
        self.units: Dict[nn.Module, List[str]] = {}
        self.held_units: set = set()
        self.alive_bytes = 0
        self.reset_counters()

    # -- placement

    def _whole_shape(self, path: str, shape) -> Tuple[int, ...]:
        """The whole (pre-tp) shape of a tensor of this rank's tp block."""
        shape = list(shape)
        dim = tensor_tp_dim(getattr(self.model, "tp_layout", {}) or {}, path)
        if dim is not None:
            shape[dim] *= self.tp
        return tuple(shape)

    def placement(self, path: str, shape) -> Optional[int]:
        """The chunk's length if the table shards the tensor at ``path``
        whose tp block has ``shape``, else None."""
        if fsdp_dim(path, self._whole_shape(path, shape), self.n, self.tp) is None:
            return None
        return math.ceil(math.prod(shape) / self.n)

    def adopt(self, path: str, owner: nn.Module, attr: str, shape) -> None:
        """Track ``owner.attr`` (at flat ``path``), which holds this rank's
        chunk (``fsdp_chunk``) of a tensor of ``shape`` (its tp block)."""
        t = getattr(owner, attr)
        if t.shape != (self.placement(path, shape),):
            raise ValueError(f"{path}: {tuple(t.shape)} is not a chunk of {tuple(shape)}")
        self.entries[path] = _Shard(path, owner, attr, torch.Size(shape), t.numel(),
                                    t.element_size())
        unit, recompute = self._unit_of(path)
        if unit not in self.units:
            self.units[unit] = []
            self._wrap(unit, recompute)
        self.units[unit].append(path)

    def forget(self, path: str) -> None:
        """Stop tracking ``path`` (its module's tensor is being replaced)."""
        self.entries.pop(path)
        for paths in self.units.values():
            if path in paths:
                paths.remove(path)

    def _unit_of(self, path: str):
        """(module whose forward gathers ``path``, whether it recomputes
        under autograd)."""
        from unimp_tpu_torch.models.flamingo import GatedCrossAttnBlock
        from unimp_tpu_torch.models.lm import DecoderBlock
        from unimp_tpu_torch.models.perceiver import ResamplerBlock
        from unimp_tpu_torch.models.vit import ViTBlock
        from unimp_tpu_torch.utils.quant import QuantizedKernel

        model = self.model
        parts = path.split("/")[:-1]
        for i in range(len(parts), 0, -1):
            mod = model.get_submodule(".".join(parts[:i]))
            if isinstance(mod, (ViTBlock, ResamplerBlock)):
                return mod, True
            if isinstance(mod, (DecoderBlock, GatedCrossAttnBlock)):
                # under --remat the model's forward checkpoints these already
                return mod, not getattr(model.cfg, "remat", False)
        lm = getattr(model.cfg, "lm", model.cfg)
        if path == "embed/embedding" and lm.tie_embeddings:
            return model, False
        user = model.get_submodule(".".join(parts))
        if isinstance(user, QuantizedKernel):
            user = model.get_submodule(".".join(parts[:-1]))
        return user, False

    def _wrap(self, unit: nn.Module, recompute: bool) -> None:
        inner = unit.forward

        def gathered_forward(*args, **kw):
            with self.gathered(unit):
                return inner(*args, **kw)

        def forward(*args, **kw):
            if recompute and torch.is_grad_enabled():
                return torch_checkpoint.checkpoint(gathered_forward, *args,
                                                   use_reentrant=False, **kw)
            return gathered_forward(*args, **kw)

        unit.forward = forward

    @contextlib.contextmanager
    def gathered(self, unit: nn.Module):
        """``unit``'s sharded tensors whole in their modules inside."""
        from unimp_tpu_torch.models.lm import DecoderBlock
        from unimp_tpu_torch.utils.quant import QuantizedKernel, concat_kernels_int8

        if unit in self.held_units:
            yield
            return
        entries = [self.entries[p] for p in self.units.get(unit, ())]
        chunks = [e.slots[e.attr] for e in entries]
        for e, c in zip(entries, chunks):
            e.slots[e.attr] = self.gather(e, c)
        fused = None
        if isinstance(unit, DecoderBlock) and not torch.is_grad_enabled():
            ks = [unit.attn.q_proj.kernel, unit.attn.k_proj.kernel, unit.attn.v_proj.kernel]
            if all(isinstance(k, QuantizedKernel) for k in ks):
                fused = unit.attn.qkv_int8 = concat_kernels_int8(ks)
        try:
            yield
        finally:
            for e, c in zip(entries, chunks):
                e.slots[e.attr] = c
            if fused is not None:
                unit.attn.qkv_int8 = None

    @contextlib.contextmanager
    def held(self, module: nn.Module):
        """Every unit inside ``module`` gathered once for a loop of forward
        calls without gradients (the frozen tower's cache build), instead
        of once a call."""
        inside = {id(m) for m in module.modules()}
        units = [u for u in self.units if id(u) in inside and u not in self.held_units]
        with contextlib.ExitStack() as stack:
            for u in units:
                stack.enter_context(self.gathered(u))
            self.held_units.update(units)
            try:
                yield
            finally:
                self.held_units.difference_update(units)

    # -- collectives

    def gather(self, e: _Shard, chunk: torch.Tensor) -> torch.Tensor:
        """The whole tensor of ``e`` from this rank's ``chunk``: through
        autograd for a trainable chunk with gradients on, else a plain
        all-gather."""
        if chunk.requires_grad and torch.is_grad_enabled():
            return _GatherFsdp.apply(chunk, self, e)
        return self._all_gather(chunk.detach(), e)

    def _all_gather(self, shard: torch.Tensor, e: _Shard) -> torch.Tensor:
        t0 = time.perf_counter()
        out = self._gather_flat(shard, e)
        nbytes = out.numel() * out.element_size()
        whole = out[: e.numel].view(e.shape)
        self.alive_bytes += nbytes
        self.peak_alive_bytes = max(self.peak_alive_bytes, self.alive_bytes)
        self.gathered_bytes += nbytes
        self.gathers += 1
        # on the storage: a view that autograd saves keeps it alive
        weakref.finalize(out.untyped_storage(), self._freed, nbytes)
        self.gather_s += time.perf_counter() - t0
        return whole

    def _freed(self, nbytes: int) -> None:
        self.alive_bytes -= nbytes

    def _gather_flat(self, shard: torch.Tensor, e: _Shard) -> torch.Tensor:
        out = torch.empty(e.chunk * self.n, dtype=shard.dtype, device=shard.device)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.group)
        return out

    def _reduce_scatter(self, g: torch.Tensor, e: _Shard) -> torch.Tensor:
        flat = torch.zeros(e.chunk * self.n, dtype=g.dtype, device=g.device)
        flat[: e.numel] = g.reshape(-1)
        out = torch.empty(e.chunk, dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, flat, group=self.group)
        if self.dp_group is not None:
            dist.all_reduce(out, group=self.dp_group)
        self.scattered_bytes += flat.numel() * flat.element_size()
        return out

    def reset_counters(self) -> None:
        self.peak_alive_bytes = self.alive_bytes
        self.gathered_bytes = self.scattered_bytes = self.gathers = 0
        self.gather_s = 0.0

    # -- whole tensors for the trainer and checkpoints

    def sharded(self, name: str) -> bool:
        """Whether the tensor at ``name`` (dotted or flat path) is sharded."""
        return name.replace(".", "/") in self.entries

    def shape(self, name: str) -> torch.Size:
        return self.entries[name.replace(".", "/")].shape

    def offset(self, name: str) -> int:
        """Flat index of this rank's chunk's first element."""
        return self.rank * self.entries[name.replace(".", "/")].chunk

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole tensor (the stored tensor's shape) of a chunk-shaped
        one (a chunk of the tensor itself, or of a moment), all-gathered
        over fsdp. Collective."""
        e = self.entries[name.replace(".", "/")]
        return self._gather_flat(shard, e)[: e.numel].view(e.shape)

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a whole tensor of the stored tensor's shape."""
        e = self.entries[name.replace(".", "/")]
        if whole.numel() != e.numel:
            raise ValueError(f"{name}: {tuple(whole.shape)} is not {tuple(e.shape)}")
        return fsdp_chunk(whole, self.rank, self.n)

    def unit_bytes(self) -> Dict[str, int]:
        """{unit's module name: bytes of its gathered (padded) tensors}."""
        names = {mod: name for name, mod in self.model.named_modules()}
        return {names[unit] or "<model>": sum(
            self.entries[p].chunk * self.n * self.entries[p].itemsize
            for p in paths) for unit, paths in self.units.items() if paths}


def whole_like(model: nn.Module, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params`` with each ZeRO-3 chunk as a meta tensor of its whole
    shape (what ``train/optimizer.py:decay_mask`` reads)."""
    zero = getattr(model, "zero", None)
    return {n: torch.empty(zero.shape(n), dtype=p.dtype, device="meta")
            if zero is not None and zero.sharded(n) else p for n, p in params.items()}


def resident_bytes(model: nn.Module) -> Dict[str, int]:
    """{"sharded", "replicated"}: device bytes of the model's persistent
    state this rank holds (``ZeroShards`` chunks, and whole tensors)."""
    zero = getattr(model, "zero", None)
    out = {"sharded": 0, "replicated": 0}
    for name, t in model.state_dict().items():
        key = "sharded" if zero is not None and zero.sharded(name) else "replicated"
        out[key] += t.numel() * t.element_size()
    return out


def predicted_resident_bytes(shapes: Dict[str, Tuple[Tuple[int, ...], int]], fsdp: int,
                             tp: int = 1, layout: Optional[Dict[str, int]] = None
                             ) -> Dict[str, int]:
    """What ``resident_bytes`` should read, from the whole tensors' shapes
    alone: ``shapes`` is {flat path: (whole shape, bytes an element)};
    ``layout`` the model's tp layout. A tensor the table shards over fsdp
    keeps 1/fsdp of its tp block, the rest the whole block."""
    out = {"sharded": 0, "replicated": 0}
    for path, (shape, size) in shapes.items():
        numel = math.prod(shape)
        if tensor_tp_dim(layout or {}, path) is not None:
            numel //= tp
        if fsdp > 1 and fsdp_dim(path, shape, fsdp, tp) is not None:
            out["sharded"] += numel // fsdp * size
        else:
            out["replicated"] += numel * size
    return out
