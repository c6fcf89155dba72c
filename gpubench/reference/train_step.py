"""The reference's training updates, in float32.

The rec training job as its configuration states it, written out in
plain operations: the focal cross-entropy of the answer tokens
(``flamingo.focal_loss``) over the whole model in float32, the gradient
of the trainable tensors (``flamingo.trainable``) averaged over the
micro-batches of an update, clipped to a global norm of 1, and AdamW
(decoupled weight decay on the cross-attention blocks' kernels only, bias
corrections, epsilon outside the square root) at the learning rate of a
linear warm-up from 0 followed by a half-cosine decay to 0. Frozen
tensors are stored as the cell says: float32, bfloat16, or int8
weight-only kernels (one absmax scale per output channel, from float32).

It imports nothing of the program: the weights are drawn again from the
seed, the images from the seed, the rows are the benchmark's own.
"""

from __future__ import annotations

import math

import torch

from gpubench import weights as W
from gpubench.reference import flamingo as ref

BETA1, BETA2, EPS, MAX_NORM = 0.9, 0.999, 1e-8, 1.0


def schedule(step: int, base: float, total: int, warmup: int) -> float:
    if step < warmup:
        return base * step / max(warmup, 1)
    rest = max(total - warmup, 1)
    return base * 0.5 * (1.0 + math.cos(math.pi * min(step - warmup, rest) / rest))


def decayed(name: str) -> bool:
    return name.startswith("xattn_") and name.endswith(".kernel")


class Params(dict):
    """{name: tensor}, a weight-only quantized frozen kernel held as (int8
    payload, scale) and dequantized to float32 where it is read."""

    def __getitem__(self, name):
        val = super().__getitem__(name)
        return val[0].float() * val[1] if isinstance(val, tuple) else val


def stored(name: str, w: torch.Tensor, frozen: str):
    """A frozen tensor as the training build stores it: float32, bfloat16
    (in float32), or for "int8" / "int4" a large kernel quantized from
    float32."""
    if frozen == "bf16":
        return w.to(torch.bfloat16).float()
    if frozen in ref.LEVELS and ref.big_kernel(name, w.shape):
        return ref.quantize(w, W.contracted_axes(name, w.dim()), ref.LEVELS[frozen])
    return w


def model_params(sizes, seed: int, device, frozen: str) -> Params:
    """Every tensor of the model: trainable ones as float32 leaves that
    take a gradient, frozen ones as stored."""
    out = Params()
    for name, shape in ref.param_shapes(sizes).items():
        w = W.draw(seed, name, shape, device)
        out[name] = w.requires_grad_(True) if ref.trainable(name) else stored(name, w, frozen)
    return out


def loss_of(params: dict, sizes, rows: dict, images: torch.Tensor, tokens: dict,
            gamma: float) -> torch.Tensor:
    """The focal loss of one micro-batch: ``rows`` {"input_ids" [B, T],
    "seq_len" [B], "weights" [B], "image_ids" [B, M]}, ``images`` the
    catalogue [N, H, W, 3] uint8."""
    get = params.__getitem__
    ids, seq_len = rows["input_ids"].long(), rows["seq_len"]
    b, t = ids.shape
    m = rows["image_ids"].shape[1]
    pix = images[rows["image_ids"].reshape(-1)]
    with torch.no_grad():  # the tower is frozen and its input takes no gradient
        feats = ref.vision_tower(get, sizes, ref.normalize(pix))
    lat = ref.perceiver(get, sizes, feats)
    lat = lat.reshape(b, m, lat.shape[1], lat.shape[2])
    pos = torch.arange(t, device=ids.device)
    allowed = (pos[None, :, None] >= pos[None, None, :]) & (pos[None, None, :] < seq_len[:, None, None])
    q_media = torch.cumsum(ids == tokens["media"], dim=1)
    logits = ref.lm_logits(get, sizes, ids, lat, q_media, allowed, pos[None].expand(b, -1),
                           remat=True)
    labels = ref.answer_labels(ids, tokens)
    return ref.focal_loss(logits, labels, rows["weights"].float(), gamma)


def follow(r, t: dict, micro_batches: list, frozen: str = None) -> dict:
    """The first ``len(micro_batches) / accum`` updates: {"losses": each
    micro-batch's loss, "grad": {leaf: norm of the first update's clipped
    mean gradient}, "change": {leaf: norm of the change after the last}};
    frozen tensors stored as the cell's program says, or as ``frozen``."""
    dev, sizes, seed = r.device, r.sizes, r.seed
    params = model_params(sizes, seed, dev, frozen or r.spec["program"]["frozen"])
    names = [n for n in params if ref.trainable(n)]
    leaves = [params[n] for n in names]
    images = W.images(seed, "catalogue", t["n_items"], sizes.vision.image_size, dev)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    accum = t["accum"]
    losses, first = [], None
    for u in range(len(micro_batches) // accum):
        acc = [torch.zeros_like(p) for p in leaves]
        for a in range(accum):
            loss = loss_of(params, sizes, micro_batches[u * accum + a], images, sizes.tokens,
                           t["gamma"])
            losses.append(float(loss.detach()))
            grads = torch.autograd.grad(loss, leaves)
            for g_acc, g in zip(acc, grads):
                g_acc.add_((g - g_acc) / (a + 1))
            del grads, loss
        norm = torch.sqrt(sum((g * g).sum() for g in acc))
        scale = torch.clamp(MAX_NORM / torch.clamp(norm, min=1e-16), max=1.0)
        for g in acc:
            g.mul_(scale)
        if first is None:
            first = dict(zip(names, torch.stack([g.norm() for g in acc]).tolist()))
        lr = schedule(u, t["learning_rate"], t["total_updates"], t["warmup_updates"])
        count = u + 1
        bc1, bc2 = 1 - BETA1 ** count, 1 - BETA2 ** count
        with torch.no_grad():
            for name, p, g, m, v in zip(names, leaves, acc, mu, nu):
                m.mul_(BETA1).add_(g, alpha=1 - BETA1)
                v.mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                if decayed(name):
                    p.mul_(1 - lr * t["weight_decay"])
                p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + EPS))
        del acc
    with torch.no_grad():
        change = torch.stack([(p - W.draw(seed, n, p.shape, dev)).norm()
                              for n, p in zip(names, leaves)]).tolist()
    return {"losses": losses, "grad": first, "change": dict(zip(names, change))}
