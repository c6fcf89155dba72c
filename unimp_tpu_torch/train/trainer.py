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
"""

from __future__ import annotations

import numpy as np
import torch

from unimp_tpu_torch.data.masking import answer_span_labels
from unimp_tpu_torch.data.transforms import normalize_on_device
from unimp_tpu_torch.device import resolve_device
from unimp_tpu_torch.models.flamingo import compute_q_media
from unimp_tpu_torch.train.loss import masked_focal_loss
from unimp_tpu_torch.train.optimizer import embedding_row_mask_update
from unimp_tpu_torch.train.partition import trainable_params

BATCH_KEYS = ("input_ids", "seq_len", "weights", "images", "image_ids")


class Trainer:
    """Owns the optimizer and runs ``train_step(batch) -> metrics``.

    batch: {"input_ids" [B, T] int, "seq_len" [B] int, "weights" [B]
    float, and "images" [B, M, H, W, 3] uint8 or, with ``vision_cache``
    set, "image_ids" [B, M] int}, as numpy arrays or tensors; B is a
    multiple of ``accum_steps``. ``optimizer`` is a ``ClippedAdamW`` or a
    ``MultiSteps`` over one.
    """

    def __init__(self, model, optimizer, *, media_id: int, answer_id: int,
                 endofchunk_id: int, pad_id: int, gamma: float = 2.0,
                 use_reweight: bool = False, mask_lm_head: bool = False,
                 accum_steps: int = 1, device="cuda", vision_cache=None):
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
        self.step = 0

    def loss_fn(self, batch: dict):
        """(loss, aux) of one micro-batch on the device."""
        ids = batch["input_ids"]
        labels = answer_span_labels(ids, self.ids["answer"], self.ids["eoc"],
                                    self.ids["media"], self.ids["pad"])
        if self.vision_cache is not None and "image_ids" in batch:
            media = {"tower_x": self.vision_cache[batch["image_ids"]]}
        else:
            media = {"vision_x": normalize_on_device(batch["images"],
                                                     self.model.cfg.compute_dtype)}
        logits, _ = self.model(ids, q_media=compute_q_media(ids, self.ids["media"]),
                               kv_len=batch["seq_len"], **media)
        return masked_focal_loss(logits, labels, batch["weights"], self.gamma,
                                 self.use_reweight)

    def compute_grads(self, batch: dict):
        """Fill each trainable parameter's ``.grad`` with the step's gradient
        (mean over micro-batches, then the lm-head row mask); returns the
        mean (loss, aux), detached."""
        batch = self.device_batch(batch)
        n = batch["input_ids"].shape[0]
        if n % self.accum_steps:
            raise ValueError(f"batch {n} does not split into {self.accum_steps} micro-batches")
        self.optimizer.zero_grad()
        inv = 1.0 / self.accum_steps
        loss_sum, aux_sum = 0.0, {}
        for mb in range(self.accum_steps):
            part = {k: v.chunk(self.accum_steps)[mb] for k, v in batch.items()}
            loss, aux = self.loss_fn(part)
            (loss * inv).backward()
            loss_sum = loss_sum + loss.detach()
            aux_sum = {k: aux_sum.get(k, 0) + v for k, v in aux.items()}
        if self.mask_lm_head:
            embedding_row_mask_update(self.params, self.ids["answer"])
        return loss_sum * inv, {k: v * inv for k, v in aux_sum.items()}

    def train_step(self, batch: dict) -> dict:
        """One optimizer step; returns device scalars {"loss", "grad_norm",
        "skipped_nonfinite", "ce", "n_answer_tokens", "accuracy"}."""
        loss, aux = self.compute_grads(batch)
        gnorm = self.optimizer.grad_norm()
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        if bool(ok):  # the step's one device->host read
            self.optimizer.step(gnorm)
        self.step += 1
        return {"loss": loss, "grad_norm": gnorm,
                "skipped_nonfinite": (~ok).to(torch.int32), **aux}

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
