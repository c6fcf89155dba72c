"""Traffic family ``train``: the rec training job's updates.

The trainer is built as ``unimp_tpu_torch/cli/mmrec.py`` builds it: the
reference's freezing (frozen tensors float32, bfloat16 or int8 as the
cell's ``program`` says), AdamW over the trainable tensors with decay on
the cross-attention matrices, the cosine schedule with warm-up, and
``MultiSteps`` over ``accum`` micro-batches of ``micro_batch`` rows, each
a ``Trainer.train_step``. Rows come from ``traffic.train_batch`` (a pool
drawn from the seed, all rows distinct, cycled), with item images drawn
on the device (``images``: the pixels go through the frozen tower inside
the step) or, under ``cache_vision_latents``, the tower's features of the
whole catalogue computed in set-up (``image_ids``).

Set-up drives the trainer through its first ``check_updates`` updates on
the pool's first rows and reads what ``checks.train`` compares; the same
trainer then runs the window, one update at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import checks, common, traffic
from gpubench import weights as W
from gpubench.reference import train_step as ref_train


def make_pool(r: common.Run, t: dict) -> list:
    """``pool`` micro-batches of ``micro_batch`` distinct rows each, on the
    device: {"input_ids", "seq_len", "weights", "image_ids"}."""
    rng = np.random.default_rng([r.seed % 2**63, 0])
    out = []
    for _ in range(t["pool"]):
        ids, seq_len, image_ids, weights = traffic.train_batch(
            rng, t["micro_batch"], t["seq_len"], t["media"], t["n_items"], t["min_len"],
            r.sizes.tokens)
        out.append({"input_ids": torch.from_numpy(ids).to(r.device),
                    "seq_len": torch.from_numpy(seq_len).to(r.device),
                    "weights": torch.from_numpy(weights).to(r.device),
                    "image_ids": torch.from_numpy(image_ids).to(r.device)})
    return out


def first_moment_norms(optimizer, names) -> dict:
    """{leaf: norm of the gradient the first update used}: Adam's first
    moment after one update over 1 - beta1 (0 where the update left no
    state)."""
    inner = optimizer.inner
    moments = []
    for name in names:
        if hasattr(inner, "adamw"):
            st = inner.adamw.state.get(inner.named[name])
            moments.append(st["exp_avg"] if st else None)
        else:
            moments.append(inner.mu[name] if inner.count else None)
    dev = next(iter(inner.named.values())).device
    norms = torch.stack([torch.zeros((), device=dev) if m is None else m.float().norm()
                         for m in moments])
    return dict(zip(names, (norms / (1 - ref_train.BETA1)).tolist()))


def change_norms(trainable: dict, seed: int) -> dict:
    """{leaf: norm of the parameter's change since its seeded value}."""
    with torch.no_grad():
        norms = torch.stack([(p.float() - W.draw(seed, n, p.shape, p.device)).norm()
                             for n, p in trainable.items()])
    return dict(zip(trainable, norms.tolist()))


def trace_spans(r: common.Run, trainer, optimizer) -> None:
    """Host spans around the step's layers for the traced run; the
    optimizer's is synchronised on both sides."""
    trainer.compute_grads = r.spans.wrap("compute_grads", trainer.compute_grads)
    real_step, dev = optimizer.step, trainer.device

    def timed_step(*args, **kwargs):
        common.sync(dev)
        with r.spans.span("optimizer_step"):
            out = real_step(*args, **kwargs)
            common.sync(dev)
        return out

    optimizer.step = timed_step


def run(r: common.Run) -> dict:
    from unimp_tpu_torch.ops import kernel_lib
    from unimp_tpu_torch.tools.from_flax import build_model
    from unimp_tpu_torch.train.optimizer import MultiSteps, decay_mask, make_optimizer
    from unimp_tpu_torch.train.partition import trainable_params
    from unimp_tpu_torch.train.trainer import Trainer
    from unimp_tpu_torch.train.vision_cache import build_tower_cache

    t, p, tok = r.spec["traffic"], dict(r.spec["program"]), r.sizes.tokens
    p.update(r.overrides.get("program", {}))
    dev = r.device
    if dev.type == "cuda":
        kernel_lib.build_all()
    cfg = common.port_config(r.spec["config_file"], p)
    frozen = {"fp32": None, "bf16": torch.bfloat16, "int8": "int8"}[p["frozen"]]
    model = build_model(cfg, device=dev, train=True, frozen_dtype=frozen,
                        weights=common.seeded_weights(r.sizes, r.seed, dev))
    trainable = trainable_params(model)
    bf16_state = torch.bfloat16 if p.get("bf16_opt_state") else None
    optimizer = make_optimizer(trainable, learning_rate=t["learning_rate"],
                               lr_scheduler=t["lr_scheduler"], total_steps=t["total_updates"],
                               warmup_steps=t["warmup_updates"], weight_decay=t["weight_decay"],
                               moment_dtype=bf16_state, decay=decay_mask(trainable))
    optimizer = MultiSteps(optimizer, t["accum"])
    trainer = Trainer(model, optimizer, media_id=tok["media"], answer_id=tok["answer"],
                      endofchunk_id=tok["endofchunk"], pad_id=tok["pad"], gamma=t["gamma"],
                      use_reweight=True, accum_steps=1, device=dev, grad_dtype=bf16_state)
    n_items, size = t["n_items"], r.sizes.vision.image_size
    catalogue = W.images(r.seed, "catalogue", n_items, size, dev)
    if p.get("cache_vision_latents"):
        host = catalogue.cpu().numpy()
        trainer.vision_cache = build_tower_cache(model, lambda i: host[i], n_items)
        del host
    pool = make_pool(r, t)

    fault = r.overrides.get("fault")

    def micro(i):
        rows = pool[i % len(pool)]
        batch = {"input_ids": rows["input_ids"], "seq_len": rows["seq_len"],
                 "weights": rows["weights"]}
        if trainer.vision_cache is not None:
            batch["image_ids"] = rows["image_ids"]
        else:
            batch["images"] = catalogue[rows["image_ids"]]
        if fault == "half_batch":  # half of the rows left out, the mean over the rest
            half = batch["input_ids"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        if fault == "token_altered":  # the answer token changed where it is read
            ids = batch["input_ids"].clone()
            rows_ = torch.arange(ids.shape[0], device=ids.device)
            ids[rows_, batch["seq_len"] - 2] = tok["item_base"] + (
                ids[rows_, batch["seq_len"] - 2] - tok["item_base"] + 1) % n_items
            batch["input_ids"] = ids
        return trainer.train_step(batch)

    if fault == "stale_state":  # the update leaves the parameters as they were
        optimizer.inner.step = lambda grad_norm: None

    # set-up: the first updates, which the reference follows
    accum, names = t["accum"], list(trainable)
    losses, readings = [], {}
    for u in range(t["check_updates"]):
        for a in range(accum):
            losses.append(float(micro(u * accum + a)["loss"]))
        if u == 0:
            readings["grad"] = first_moment_norms(optimizer, names)
    readings["change"] = change_norms(trainable, r.seed)
    readings["losses"] = losses
    common.sync(dev)

    if r.trace:
        trace_spans(r, trainer, optimizer)
    first = t["check_updates"] * accum
    done = []

    def update(i):
        for a in range(accum):
            done.append(first + i * accum + a)
            micro(first + i * accum + a)
        common.sync(dev)

    ends = r.record["step_ends_s"] = []
    r.record["setup_s"] = common.process_start_s()
    if r.trace:
        from gpubench.trace import DeviceTrace

        with DeviceTrace() as dt:
            n, secs = traffic.run_window(update, r.seconds, ends=ends)
        r.record["device_trace"] = dt
    else:
        n, secs = traffic.run_window(update, r.seconds, ends=ends)
    rows = t["micro_batch"] * accum
    r.record.update(updates=n, micro_batches=[pool[i % len(pool)] for i in done],
                    peak_bytes=common.peak_bytes(dev))
    del trainer, optimizer, model, trainable, catalogue
    common.free_device()

    reference = ref_train.follow(r, t, pool[:first])
    control = r.overrides.get("reference_in_place")
    if control:  # the reference at a lower precision, put in the program's place
        readings = ref_train.follow(r, t, pool[:first], frozen=control)
    check = checks.train(r, readings, reference)
    return {"attempted": n * rows, "failed": 0,
            "e2e": {"samples_per_s": n * rows / secs,
                    "peak_mem_gib": r.record["peak_bytes"] / 2**30,
                    "setup_s": r.record["setup_s"]},
            "check": check}
