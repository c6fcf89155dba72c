"""The rec training step (counterpart of ``unimp_tpu/train/trainer.py``).

The reference's hot loop (mmrec.py:65-302): answer-span labels, forward,
focal loss, backward, clip, AdamW. Per step: labels from
``answer_span_labels`` and media indices from ``compute_q_media`` on the
device, uint8 images CLIP-normalized on the device, the forward with
``kv_len = seq_len``, the loss, and the backward with respect to the
trainable parameters only (the model is built by ``build_model(...,
train=True)``: frozen tensors have ``requires_grad=False``), over
``accum_steps`` micro-batches. The loss and gradients are the mean over
micro-batches of each micro-batch's own normalized loss, as the JAX
step's scan is. Then the ``mask_lm_head`` row mask, the clip and the
optimizer step.

Non-finite guard: a step whose loss or gradient norm is not finite leaves
the parameters, both Adam moments, the optimizer's step count and the
schedule where they were, and under ``MultiSteps`` its running mean and
mini-step count too (the JAX step's ``jnp.where`` over params and the
whole opt_state). Deciding that costs one device-to-host read per step,
which the jitted JAX step does not need. ``step`` counts every call, as
the JAX ``TrainState.step`` does, skipped ones included.

Cached vision (``vision_cache``, ``train/vision_cache.py``): batches
carry ``image_ids`` [B, M] in place of pixels and the step gathers the
frozen tower's features, so only the trainable perceiver runs.

bfloat16 gradients (``grad_dtype``, ``--bf16_opt_state``): each
micro-batch's gradient is taken with ``torch.autograd.grad``, cast to
``grad_dtype`` and summed in a buffer of that dtype, and the sum is
multiplied by 1 / accum in it, the JAX step's order of rounding
(``unimp_tpu/train/trainer.py:282-307``); the optimizer gets them through
``set_grads`` (a ``ClippedAdamWCast``, or a ``MultiSteps`` over one). By
default the micro-batches' ``backward()`` sums float32 ``.grad``.

Several ranks (``mesh``, ``parallel/mesh.py``): each rank of the data
axis (dp x fsdp) computes on its own rows, and explicit collectives make
the step the JAX step on the global batch
(``unimp_tpu/train/trainer.py:233-330``):
  * each micro-batch's count of answer tokens is all-reduced over the data
    axis and normalizes every rank's token sum, so that the ranks' losses
    (and CE and accuracy) sum to the global micro-batch's;
  * gradients are summed over the data axis, not averaged: an all-reduce
    after the micro-batches (float32), or under ``grad_dtype`` an
    all-reduce of each micro-batch's float32 gradient before its cast (the
    JAX order of rounding: the global float32 gradient, then bfloat16);
    under fsdp > 1 a reduce-scatter over fsdp (and an all-reduce over dp)
    into this rank's shard (``parallel/sharding.py:ZeroShards``; the
    optimizer holds shards and the updated shards are all-gathered);
  * the loss is reduced before the non-finite check, and the norm of the
    whole gradient (``optimizer.norm_reduce`` over fsdp and tp) feeds the
    clip: every rank takes the same decision;
  * under tp every rank of a tp group reads the same rows and holds its
    block of the tp-sharded tensors (their gradients need no reduction
    over tp; the model's collectives make them whole-model gradients).
With one rank the step is the one-process step, collectives included.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from unimp_tpu_torch.data.masking import IGNORE, answer_span_labels
from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.device import resolve_device
from unimp_tpu_torch.models.flamingo import compute_q_media
from unimp_tpu_torch.parallel.sharding import gather_tp, shard_tree_tp
from unimp_tpu_torch.train.loss import masked_focal_loss
from unimp_tpu_torch.train.optimizer import embedding_row_mask_update
from unimp_tpu_torch.train.partition import trainable_params

BATCH_KEYS = ("input_ids", "seq_len", "weights", "images", "image_ids")
STATE_TREES = ("mu", "nu", "acc")  # the optimizer state's {name: tensor} entries


class Trainer:
    """Owns the optimizer and runs ``train_step(batch) -> metrics``.

    batch: {"input_ids" [B, T] int, "seq_len" [B] int, "weights" [B]
    float, and "images" [B, M, H, W, 3] uint8 or, with ``vision_cache``
    set, "image_ids" [B, M] int}, as numpy arrays or tensors; B is a
    multiple of ``accum_steps``. ``optimizer`` is a ``ClippedAdamW`` or a
    ``MultiSteps`` over one, or with ``grad_dtype`` a ``ClippedAdamWCast``
    or a ``MultiSteps`` over one.
    """

    def __init__(self, model, optimizer, *, media_id: int, answer_id: int,
                 endofchunk_id: int, pad_id: int, gamma: float = 2.0,
                 use_reweight: bool = False, mask_lm_head: bool = False,
                 accum_steps: int = 1, device="cuda", vision_cache=None,
                 grad_dtype=None, mesh=None, zero=None):
        self.device = resolve_device(device)
        for name, p in model.named_parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"{name} is on {p.device}, the trainer runs on {self.device}")
        self.model = model
        self.optimizer = optimizer
        self.params = trainable_params(model)
        self.ids = dict(media=media_id, answer=answer_id, eoc=endofchunk_id, pad=pad_id)
        self.gamma = gamma
        self.use_reweight = use_reweight
        self.mask_lm_head = mask_lm_head
        self.accum_steps = accum_steps
        self.vision_cache = vision_cache  # [n_items, P, Dv] tower features, or None
        self.grad_dtype = grad_dtype
        self.step = 0
        # several ranks: the data group (None: one process, no group) and,
        # under fsdp, the ZeroShards the optimizer was built over
        self.mesh, self.zero = mesh, zero
        self.data_group = mesh.group("data") if mesh is not None else None
        if self._sharded():
            getattr(optimizer, "inner", optimizer).norm_reduce = self._norm_reduce

    def loss_fn(self, batch: dict):
        """(loss, aux) of one micro-batch on the device."""
        ids = batch["input_ids"]
        labels = answer_span_labels(ids, self.ids["answer"], self.ids["eoc"],
                                    self.ids["media"], self.ids["pad"])
        n_total = None
        if self.data_group is not None:
            # the global micro-batch's count of answer tokens
            n_total = (labels[:, 1:] != IGNORE).sum()
            dist.all_reduce(n_total, group=self.data_group)
        if self.vision_cache is not None and "image_ids" in batch:
            media = {"tower_x": self.vision_cache[batch["image_ids"]]}
        else:
            media = {"vision_x": normalize_on_device(batch["images"],
                                                     self.model.cfg.compute_dtype)}
        logits, _ = self.model(ids, q_media=compute_q_media(ids, self.ids["media"]),
                               kv_len=batch["seq_len"], **media)
        return masked_focal_loss(logits, labels, batch["weights"], self.gamma,
                                 self.use_reweight, n_total=n_total)

    def compute_grads(self, batch: dict):
        """Hand the optimizer the step's gradient (mean over micro-batches,
        then the lm-head row mask): each trainable parameter's ``.grad``,
        or under ``grad_dtype`` the optimizer's ``set_grads``; returns the
        mean (loss, aux), detached."""
        batch = self.device_batch(batch)
        n = batch["input_ids"].shape[0]
        if n % self.accum_steps:
            raise ValueError(f"batch {n} does not split into {self.accum_steps} micro-batches")
        self.optimizer.zero_grad()
        for p in self.params.values():
            p.grad = None
        inv = 1.0 / self.accum_steps
        names, params = list(self.params), list(self.params.values())
        loss_sum, aux_sum, gsum = 0.0, {}, None
        for mb in range(self.accum_steps):
            part = {k: v.chunk(self.accum_steps)[mb] for k, v in batch.items()}
            loss, aux = self.loss_fn(part)
            if self.grad_dtype is None:
                (loss * inv).backward()
            else:
                # cast (and add) one tensor at a time: the float32 gradient
                # tree is released as it goes
                grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
                if self.mask_lm_head and self.zero is not None:
                    # the row mask needs the whole tensor: before the shard
                    self._mask_lm_head(dict(zip(names, grads)))
                for i, g in enumerate(grads):
                    grads[i] = None
                    g = self._reduce(names[i], g).to(self.grad_dtype)
                    if gsum is None:
                        grads[i] = g
                    else:
                        gsum[i].add_(g)
                gsum = grads if gsum is None else gsum
            loss_sum = loss_sum + loss.detach()
            aux_sum = {k: aux_sum.get(k, 0) + v for k, v in aux.items()}
        if self.grad_dtype is None:
            full = {name: p.grad for name, p in self.params.items()}
            if self.mask_lm_head:
                self._mask_lm_head(full)
            if self.zero is not None:
                for name, p in self.params.items():
                    self.zero.shards[name].grad = self._reduce(name, p.grad)
                    p.grad = None
            else:
                for name, g in full.items():
                    self._reduce(name, g)
        else:
            if self.accum_steps > 1:
                for g in gsum:
                    g.mul_(inv)
            grads = dict(zip(names, gsum))
            if self.mask_lm_head and self.zero is None:
                self._mask_lm_head(grads)
            self.optimizer.set_grads(grads)
        loss, aux = loss_sum * inv, {k: v * inv for k, v in aux_sum.items()}
        if self.data_group is not None:
            # the ranks' shares of the global micro-batches' sums
            keys = [k for k in aux if k != "n_answer_tokens"]
            vals = torch.stack([loss] + [aux[k].float() for k in keys])
            dist.all_reduce(vals, group=self.data_group)
            loss, aux = vals[0], {**aux, **dict(zip(keys, vals[1:]))}
        return loss, aux

    def _mask_lm_head(self, grads: dict) -> None:
        embed = self.model.embed
        start = embed.vocab_start if embed.tp_group is not None else 0
        embedding_row_mask_update(grads, self.ids["answer"], start)

    def _reduce(self, name: str, g):
        """A whole local gradient summed over the data axis: in place (dp),
        or this rank's shard of it (fsdp); unchanged with one process."""
        if self.zero is not None:
            return self.zero.reduce(name, g)
        if self.data_group is not None:
            if g is None:
                g = torch.zeros_like(self.params[name])
                self.params[name].grad = g
            dist.all_reduce(g, group=self.data_group)
        return g

    def _norm_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        """Per-tensor sums of squares of this rank's blocks -> the whole
        tensors': summed over tp for the tp-sharded tensors, then over fsdp
        (every tensor is sharded there)."""
        mesh = self.mesh
        if mesh.tp > 1:
            layout = self.model.tp_layout
            sharded = torch.tensor([n.replace(".", "/") in layout for n in self.params],
                                   device=sq.device)
            part = torch.where(sharded, sq, 0.0)
            dist.all_reduce(part, group=mesh.group("tp"))
            sq = torch.where(sharded, part, sq)
        if mesh.fsdp > 1:
            sq = sq.clone()
            dist.all_reduce(sq, group=mesh.group("fsdp"))
        return sq

    def train_step(self, batch: dict) -> dict:
        """One optimizer step; returns device scalars {"loss", "grad_norm",
        "skipped_nonfinite", "ce", "n_answer_tokens", "accuracy"}."""
        loss, aux = self.compute_grads(batch)
        gnorm = self.optimizer.grad_norm()
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        if bool(ok):  # the step's one device->host read
            self.optimizer.step(gnorm)
            if self.zero is not None:
                self.zero.gather_params()
        self.step += 1
        return {"loss": loss, "grad_norm": gnorm,
                "skipped_nonfinite": (~ok).to(torch.int32), **aux}

    def _sharded(self) -> bool:
        return self.mesh is not None and (self.mesh.fsdp > 1 or self.mesh.tp > 1)

    def optimizer_state(self) -> dict:
        """The optimizer's ``state_dict()`` with whole tensors: fsdp shards
        and tp blocks all-gathered (collective; the live tensors with one
        rank or pure dp)."""
        state = dict(self.optimizer.state_dict())
        if not self._sharded():
            return state
        layout, group = self.model.tp_layout, self.model.tp_group
        dev = "cuda" if group is not None and dist.get_backend(group) == "nccl" else "cpu"
        for key in STATE_TREES:
            whole = {}
            for name, t in state.get(key, {}).items():
                if self.zero is not None:
                    t = self.zero.full(name, t)
                dim = layout.get(name.replace(".", "/"))
                if dim is not None:
                    t = gather_tp(t, dim, group, dev)
                whole[name] = t
            if key in state:
                state[key] = whole
        return state

    def load_optimizer_state(self, state: dict) -> None:
        """Load a whole ``optimizer_state()`` (any mesh's checkpoint): each
        rank takes its tp block and fsdp shard of every tensor."""
        if self._sharded():
            state = dict(state)
            model = self.model
            for key in STATE_TREES:
                if key not in state:
                    continue
                local = {}
                for name, t in state[key].items():
                    path = name.replace(".", "/")
                    if model.tp_layout:
                        t = shard_tree_tp({path: t}, model.tp_layout, model.tp_rank,
                                          model.tp_size)[path]
                    if self.zero is not None:
                        t = self.zero.local(name, t.to(self.device))
                    local[name] = t
                state[key] = local
        self.optimizer.load_state_dict(state)

    def device_batch(self, batch: dict) -> dict:
        """The step's inputs on the device; host arrays go through pinned
        memory with ``non_blocking=True`` copies."""
        out = {}
        for key in BATCH_KEYS:
            if key not in batch:
                continue
            t = batch[key]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.ascontiguousarray(t))
            if t.device.type == "cpu" and self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t.to(self.device)
        out["input_ids"] = out["input_ids"].long()
        if "image_ids" in out:
            out["image_ids"] = out["image_ids"].long()
        return out
