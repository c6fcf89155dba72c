"""Optimizer + LR schedules (counterpart of ``unimp_tpu/train/optimizer.py``).

AdamW with weight decay on the gated cross-attention matrices only (not
gates, norms or biases), the reference's get_grouped_params
(mmrec.py:609-631); schedules as transformers'
get_{linear,cosine,constant}_schedule_with_warmup (mmrec.py:682-697):
linear warmup from 0, then linear or half-cosine decay to 0, or constant;
global-norm clipping at 1.0 (mmrec.py:247-248). The optimizer holds no
TPU kernel, so it is ``torch.optim.AdamW``.
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
        self.params = list(params.values())
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
