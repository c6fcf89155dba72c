"""Optimizer + LR schedules (counterpart of ``unimp_tpu/train/optimizer.py``).

AdamW with weight decay on the gated cross-attention matrices only (not
gates, norms or biases), the reference's get_grouped_params
(mmrec.py:609-631); schedules as transformers'
get_{linear,cosine,constant}_schedule_with_warmup (mmrec.py:682-697):
linear warmup from 0, then linear or half-cosine decay to 0, or constant;
global-norm clipping at 1.0 (mmrec.py:247-248). The optimizer holds no
TPU kernel, so it is ``torch.optim.AdamW``; with ``--bf16_opt_state`` the
moments are stored in bfloat16 with the arithmetic in float32, which
``torch.optim.AdamW`` cannot do (it keeps its moments in the parameter's
dtype), so that path is the port's own update, ``ClippedAdamWCast``.
``MultiSteps`` is the counterpart of ``optax.MultiSteps``
(``--gradient_accumulation_steps`` without ``--fused_accumulation``).
Each saves and restores its state by parameter name (``state_dict`` /
``load_state_dict``) for ``train/checkpoint.py``.

Over several ranks (``train/trainer.py``) a rank may hold a block of a
gradient (its fsdp shard, its tp block): the trainer then sets
``norm_reduce``, which turns the vector of per-tensor sums of squares
(float32, one entry a parameter in ``named`` order) into the whole
tensors' sums, so that the logged norm and both clips use the norm of the
whole gradient. A sharded optimizer is built over 1-D shards, so its
weight-decay mask (``decay``) comes from the whole parameters.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

SCHEDULES = ("linear", "cosine", "constant")


def decay_mask(params: dict) -> dict:
    """{name: weight decay applies}: gated-xattn matrices only. Names are
    the port's dotted parameter names (the Flax paths with "." for "/")."""

    def keep(name: str, p) -> bool:
        return ("xattn_" in name and "gate" not in name and "ln" not in name
                and "bias" not in name and p.dim() >= 2)

    return {name: keep(name, p) for name, p in params.items()}


def make_schedule(kind: str, base_lr: float, total_steps: int,
                  warmup_steps: int) -> Callable[[int], float]:
    """step -> learning rate, step by step the values of the JAX package's
    optax ``join_schedules([linear warmup from 0, decay], [warmup_steps])``."""
    if kind not in SCHEDULES:
        raise ValueError(f"unknown scheduler {kind!r}")
    warm = max(warmup_steps, 1)
    rest = max(total_steps - warmup_steps, 1)

    def linear(init, end, steps, count):  # optax.linear_schedule
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def decay(count):
        if kind == "linear":
            return linear(base_lr, 0.0, rest, count)
        if kind == "cosine":  # optax.cosine_decay_schedule
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * min(count, rest) / rest))
        return base_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return linear(0.0, base_lr, warm, step)
        return decay(step - warmup_steps)

    return schedule


class ClippedAdamW:
    """Global-norm clip (the norm accumulated in float32), then AdamW over
    two parameter groups (decay / no decay), then the schedule.

    ``torch.optim.AdamW`` updates p <- p - lr*wd*p - lr*m_hat/(sqrt(v_hat)
    + eps), with lr from the schedule: the same update as the JAX package's
    optax chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate),
    which subtracts lr * (m_hat/(sqrt(v_hat) + eps) + wd*p).
    """

    def __init__(self, params: dict, *, schedule: Callable[[int], float],
                 weight_decay: float, max_grad_norm: float, b1: float, b2: float,
                 eps: float, decay: dict = None):
        self.named = dict(params)
        self.params = list(params.values())
        self.schedule = schedule
        self.norm_reduce = None
        decay = decay if decay is not None else decay_mask(params)
        groups = [{"params": [p for n, p in params.items() if decay[n]],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in params.items() if not decay[n]],
                   "weight_decay": 0.0}]
        # lr 1.0 times the schedule's value: LambdaLR sets each step's lr
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=1.0,
                                       betas=(b1, b2), eps=eps)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)
        self.max_grad_norm = max_grad_norm

    def grads(self) -> list:
        return [p.grad for p in self.params if p.grad is not None]

    def named_grads(self) -> dict:
        """{name: gradient or None}: the parameters' ``.grad``."""
        return {name: p.grad for name, p in self.named.items()}

    def set_grads(self, grads: dict) -> None:
        for name, p in self.named.items():
            p.grad = grads[name]

    def grad_norm(self) -> torch.Tensor:
        """Global L2 norm of the gradients, accumulated in float32."""
        if self.norm_reduce is not None:
            return torch.sqrt(self.norm_reduce(_square_sums(self.named_grads(), self.named)).sum())
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in self.grads()]
        return torch.linalg.vector_norm(torch.stack(norms))

    def step(self, grad_norm: torch.Tensor) -> None:
        """Clip by ``grad_norm`` (from ``grad_norm()``), update, advance
        the schedule."""
        scale = torch.clamp(self.max_grad_norm / torch.clamp(grad_norm, min=1e-16), max=1.0)
        for g in self.grads():
            g.mul_(scale.to(g.dtype))
        self.adamw.step()
        self.scheduler.step()

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """{"mu": {name: first moment}, "nu": {name: second moment},
        "count": AdamW's step, "schedule_count": the schedule's step}; the
        moments are the live tensors (no copy). Before the first update
        both moments are empty."""
        mu, nu, counts = {}, {}, set()
        for name, p in self.named.items():
            st = self.adamw.state.get(p)
            if st:
                mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
                counts.add(int(st["step"]))
        if len(counts) > 1:
            raise ValueError(f"parameters at different AdamW steps {sorted(counts)}")
        return {"mu": mu, "nu": nu, "count": counts.pop() if counts else 0,
                "schedule_count": self.scheduler.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s content (tensors copied onto each
        parameter's device and dtype) and the learning rate it implies."""
        mu, nu = state["mu"], state["nu"]
        if set(mu) != set(nu) or not set(mu) <= set(self.named):
            unknown = sorted((set(mu) | set(nu)) - set(self.named))
            raise KeyError(f"moments do not match the parameters: {unknown[:8]}")
        self.adamw.state.clear()
        for name, p in self.named.items():
            if name in mu:
                self.adamw.state[p] = {
                    "step": torch.tensor(float(state["count"])),
                    "exp_avg": mu[name].to(device=p.device, dtype=p.dtype).clone(),
                    "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype).clone()}
        count = int(state["schedule_count"])
        self.scheduler.last_epoch = count
        lrs = [self.schedule(count) * base for base in self.scheduler.base_lrs]
        for group, lr in zip(self.adamw.param_groups, lrs):
            group["lr"] = lr
        self.scheduler._last_lr = lrs


def _square_sums(grads: dict, named: dict) -> torch.Tensor:
    """[len(named)] float32: each gradient's sum of squares (0 for None), in
    ``named`` order."""
    dev = next(iter(named.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack([zero if grads.get(n) is None else
                        (grads[n].float() * grads[n].float()).sum() for n in named])


def global_norm(grads, sq=None) -> torch.Tensor:
    """``optax.global_norm`` of the gradients, rounded as the jitted JAX
    step rounds it: each tensor's sum of squares taken in float32 and
    rounded to the tensor's dtype, the sum over tensors and the square
    root in that dtype (bfloat16 under ``--bf16_opt_state``). ``sq``, when
    given, holds the whole tensors' float32 sums of squares in ``grads``'
    order (a sharded gradient's)."""
    total = None
    for i, g in enumerate(grads):
        part = (g.float() * g.float()).sum() if sq is None else sq[i]
        part = part.to(g.dtype)
        total = part if total is None else total + part
    return torch.sqrt(total)


class ClippedAdamWCast:
    """``--bf16_opt_state``: the JAX package's optax chain with both Adam
    moments stored in ``mu_dtype`` / ``nu_dtype`` (bfloat16) and the
    arithmetic in float32 (``unimp_tpu/train/optimizer.py``: the clip of
    ``_clip_by_global_norm_f32``, ``_scale_by_adam_cast``, decayed weights
    on the ``decay_mask`` tensors, then the schedule), operation for
    operation in the chain's order, one tensor at a time.

    The gradients live in a dict (``set_grads``), not in ``.grad``: they
    arrive in bfloat16 (the trainer's ``grad_dtype``) while the masters
    are float32. ``grad_norm`` is the logged norm (``global_norm``, in the
    gradients' dtype); ``step`` clips by the norm accumulated in float32,
    scales in float32 and casts back to each gradient's dtype."""

    def __init__(self, params: dict, *, schedule: Callable[[int], float],
                 weight_decay: float, max_grad_norm: float, b1: float, b2: float,
                 eps: float, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16,
                 decay: dict = None):
        self.named = dict(params)
        self.schedule = schedule
        self.norm_reduce = None
        self.decay = decay if decay is not None else decay_mask(params)
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype) for n, p in self.named.items()}
        self.nu = {n: torch.zeros_like(p, dtype=nu_dtype) for n, p in self.named.items()}
        self.grad = dict.fromkeys(self.named)
        self.count = 0  # scale_by_adam's count
        self.schedule_count = 0  # scale_by_learning_rate's

    def grads(self) -> list:
        return [g for g in self.grad.values() if g is not None]

    def named_grads(self) -> dict:
        return dict(self.grad)

    def set_grads(self, grads: dict) -> None:
        self.grad = {name: grads[name] for name in self.named}

    def grad_norm(self) -> torch.Tensor:
        if self.norm_reduce is None:
            return global_norm(self.grads())
        names = [n for n in self.named if self.grad[n] is not None]
        sq = self.norm_reduce(_square_sums(self.grad, self.named))
        keep = torch.tensor([self.grad[n] is not None for n in self.named], device=sq.device)
        return global_norm([self.grad[n] for n in names], sq[keep])

    def zero_grad(self) -> None:
        self.grad = dict.fromkeys(self.named)

    @torch.no_grad()
    def step(self, grad_norm: torch.Tensor = None) -> None:
        """Clip, update, advance the schedule (``grad_norm``, the logged
        one, is not the clip's)."""
        f32 = torch.float32
        if self.norm_reduce is None:
            sq = sum((g.float() * g.float()).sum() for g in self.grads())
        else:
            sq = self.norm_reduce(_square_sums(self.grad, self.named)).sum()
        scale = torch.clamp(self.max_grad_norm / torch.clamp(torch.sqrt(sq), min=1e-16),
                            max=1.0)
        self.count += 1
        dev = scale.device
        count = torch.tensor(float(self.count), dtype=f32, device=dev)
        bc1 = 1 - torch.tensor(self.b1, dtype=f32, device=dev) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32, device=dev) ** count
        step_size = torch.tensor(-self.schedule(self.schedule_count), dtype=f32, device=dev)
        for name, p in self.named.items():
            g = self.grad[name]
            g = torch.zeros_like(p) if g is None else (g.float() * scale).to(g.dtype)
            g = g.float()
            mu, nu = self.mu[name], self.nu[name]
            mu.copy_(self.b1 * mu.float() + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu.float() + (1 - self.b2) * g * g)
            u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + self.eps)
            if self.decay[name]:
                u = u + self.weight_decay * p
            p.add_(step_size * u)
        self.schedule_count += 1

    def state_dict(self) -> dict:
        """{"mu", "nu" (by name, live tensors in their storage dtype),
        "count", "schedule_count"}: the keys of ``ClippedAdamW``'s."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "schedule_count": self.schedule_count}

    def load_state_dict(self, state: dict) -> None:
        if set(state["mu"]) != set(self.named) or set(state["nu"]) != set(self.named):
            raise KeyError("moments do not match the parameters")
        for name in self.named:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])
        self.count = int(state["count"])
        self.schedule_count = int(state["schedule_count"])


class MultiSteps:
    """``optax.MultiSteps(ClippedAdamW, k)``: the inner optimizer updates
    once every ``k`` calls of ``step``, on the running mean of the ``k``
    gradients (optax's ``acc + (g - acc) / (n + 1)``); the other calls only
    accumulate. The clip applies to the norm of that mean; ``grad_norm``
    is the current gradient's, as the trainer logs it. AdamW's step and the
    schedule advance once per ``k``. A call that the trainer skips (a
    non-finite loss or norm) touches neither the mean nor the count. The
    mean is kept in the parameters' dtype (float32) whatever the
    gradients' dtype, as optax's is (``zeros_like`` of the parameters;
    ``acc + (g - acc) / (n + 1)`` promotes a bfloat16 g); ``inner`` may be
    a ``ClippedAdamW`` or a ``ClippedAdamWCast``."""

    def __init__(self, inner, k: int):
        self.inner, self.k = inner, k
        self.acc = {name: torch.zeros_like(p) for name, p in inner.named.items()}
        self.mini_step = 0
        self.gradient_step = 0

    def grad_norm(self) -> torch.Tensor:
        return self.inner.grad_norm()

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def set_grads(self, grads: dict) -> None:
        self.inner.set_grads(grads)

    def step(self, grad_norm: torch.Tensor) -> None:
        """Fold the parameters' ``.grad`` into the mean; on every k-th call
        update with it (``grad_norm``, the current gradient's, is unused)."""
        n = self.mini_step
        grads = self.inner.named_grads()
        for name, acc in self.acc.items():
            g = grads[name] if grads[name] is not None else torch.zeros_like(acc)
            acc.add_((g - acc) / (n + 1))
        if n < self.k - 1:
            self.mini_step += 1
            return
        self.inner.set_grads({name: acc.clone() for name, acc in self.acc.items()})
        self.inner.step(self.inner.grad_norm())
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1

    def state_dict(self) -> dict:
        return {**self.inner.state_dict(), "acc": self.acc, "mini_step": self.mini_step,
                "gradient_step": self.gradient_step}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)
        for name, acc in self.acc.items():
            acc.copy_(state["acc"][name])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])


def make_optimizer(params: dict, *, learning_rate: float = 1e-4,
                   lr_scheduler: str = "constant", total_steps: int = 10_000,
                   warmup_steps: int = 0, weight_decay: float = 0.1,
                   max_grad_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, moment_dtype=None, decay: dict = None):
    """The reference AdamW over ``params`` ({name: parameter}): pass the
    trainable ones (``partition.trainable_params``) so that decay, clipping
    and the moments exist only for them. ``moment_dtype`` (bfloat16 under
    ``--bf16_opt_state``: the JAX ``mu_dtype`` and ``nu_dtype``) gives a
    ``ClippedAdamWCast``; by default a ``ClippedAdamW``. ``decay`` ({name:
    decayed}) overrides ``decay_mask(params)``: a sharded optimizer's
    ``params`` are 1-D shards (``parallel/sharding.py:ZeroShards``)."""
    schedule = make_schedule(lr_scheduler, learning_rate, total_steps, warmup_steps)
    kw = dict(schedule=schedule, weight_decay=weight_decay, max_grad_norm=max_grad_norm,
              b1=b1, b2=b2, eps=eps, decay=decay)
    if moment_dtype is not None:
        return ClippedAdamWCast(params, mu_dtype=moment_dtype, nu_dtype=moment_dtype, **kw)
    return ClippedAdamW(params, **kw)


def embedding_row_mask_update(grads: dict, answer_token_id: int, vocab_start: int = 0) -> None:
    """--mask_lm_head (mmrec.py:218-233): keep only the <answer> row of the
    token embedding's gradient and the <answer> column of the lm head's,
    in place (a multiply by a one-hot, as the JAX package does); ``grads``
    is {parameter name: gradient or None}. Under tp both hold the
    vocabulary block from ``vocab_start``: a block without <answer> keeps
    nothing."""
    idx = answer_token_id - vocab_start
    for name, g in grads.items():
        if g is None:
            continue
        if name.endswith("embed.embedding"):
            row = torch.zeros(g.shape[0], dtype=g.dtype, device=g.device)
            if 0 <= idx < g.shape[0]:
                row[idx] = 1.0
            g.mul_(row[:, None])
        elif name.endswith("lm_head.kernel"):  # [D, V]: a column
            col = torch.zeros(g.shape[1], dtype=g.dtype, device=g.device)
            if 0 <= idx < g.shape[1]:
                col[idx] = 1.0
            g.mul_(col[None, :])
