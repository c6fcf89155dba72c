"""Optimizer + LR schedules (counterpart of ``unimp_tpu/train/optimizer.py``).

AdamW with weight decay on the gated cross-attention matrices only (not
gates, norms or biases), the reference's get_grouped_params
(mmrec.py:609-631); schedules as transformers'
get_{linear,cosine,constant}_schedule_with_warmup (mmrec.py:682-697):
linear warmup from 0, then linear or half-cosine decay to 0, or constant;
global-norm clipping at 1.0 (mmrec.py:247-248). The optimizer holds no
TPU kernel, so it is ``torch.optim.AdamW``. ``MultiSteps`` is the
counterpart of ``optax.MultiSteps`` (``--gradient_accumulation_steps``
without ``--fused_accumulation``). Both save and restore their state by
parameter name (``state_dict`` / ``load_state_dict``) for
``train/checkpoint.py``.
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
                 eps: float):
        self.named = dict(params)
        self.params = list(params.values())
        self.schedule = schedule
        decay = decay_mask(params)
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

    def grad_norm(self) -> torch.Tensor:
        """Global L2 norm of the gradients, accumulated in float32."""
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


class MultiSteps:
    """``optax.MultiSteps(ClippedAdamW, k)``: the inner optimizer updates
    once every ``k`` calls of ``step``, on the running mean of the ``k``
    gradients (optax's ``acc + (g - acc) / (n + 1)``); the other calls only
    accumulate. The clip applies to the norm of that mean; ``grad_norm``
    is the current gradient's, as the trainer logs it. AdamW's step and the
    schedule advance once per ``k``. A call that the trainer skips (a
    non-finite loss or norm) touches neither the mean nor the count."""

    def __init__(self, inner: ClippedAdamW, k: int):
        self.inner, self.k = inner, k
        self.acc = {name: torch.zeros_like(p) for name, p in inner.named.items()}
        self.mini_step = 0
        self.gradient_step = 0

    def grad_norm(self) -> torch.Tensor:
        return self.inner.grad_norm()

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def step(self, grad_norm: torch.Tensor) -> None:
        """Fold the parameters' ``.grad`` into the mean; on every k-th call
        update with it (``grad_norm``, the current gradient's, is unused)."""
        n = self.mini_step
        for name, p in self.inner.named.items():
            acc = self.acc[name]
            g = p.grad if p.grad is not None else torch.zeros_like(acc)
            acc.add_((g - acc) / (n + 1))
        if n < self.k - 1:
            self.mini_step += 1
            return
        for name, p in self.inner.named.items():
            p.grad = self.acc[name].clone()
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
                   eps: float = 1e-8) -> ClippedAdamW:
    """The reference AdamW over ``params`` ({name: parameter}): pass the
    trainable ones (``partition.trainable_params``) so that decay, clipping
    and the moments exist only for them."""
    schedule = make_schedule(lr_scheduler, learning_rate, total_steps, warmup_steps)
    return ClippedAdamW(params, schedule=schedule, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm, b1=b1, b2=b2, eps=eps)


def embedding_row_mask_update(params: dict, answer_token_id: int) -> None:
    """--mask_lm_head (mmrec.py:218-233): keep only the <answer> row of the
    token embedding's gradient and the <answer> column of the lm head's,
    in place (a multiply by a one-hot, as the JAX package does)."""
    for name, p in params.items():
        if p.grad is None:
            continue
        if name.endswith("embed.embedding"):
            row = torch.zeros(p.grad.shape[0], dtype=p.grad.dtype, device=p.grad.device)
            row[answer_token_id] = 1.0
            p.grad.mul_(row[:, None])
        elif name.endswith("lm_head.kernel"):  # [D, V]: a column
            col = torch.zeros(p.grad.shape[1], dtype=p.grad.dtype, device=p.grad.device)
            col[answer_token_id] = 1.0
            p.grad.mul_(col[None, :])
