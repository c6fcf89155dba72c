"""Training entry point: the port's ``mmrec`` (counterpart of
``unimp_tpu/cli/mmrec.py``, the reference's mmrec.py:306-894).

    python -m unimp_tpu_torch.cli.mmrec --mmrec_path DATA --subset beauty \\
        --task rec --single_task --do_test [--device cpu] ...

Builds the tokenizer, the model (seeded weights; the reference's freezing)
and the train loader; sizes the schedule; then per epoch trains over the
shuffled loader (``seed + epoch``), logging loss, CE, accuracy, gradient
norm and the step timer's throughput every ``--logging_steps``, evaluates
the eval and test splits with one latent cache, and writes
``weights_epoch_{e}`` and ``checkpoint_{e}``; ``final_weights`` at the end.
``--resume_from_checkpoint`` continues from the latest ``checkpoint_{e}``
of the run, and ``--cache_vision_latents`` encodes every item through the
frozen tower once (``train/vision_cache.py``).
"""

from __future__ import annotations

import os
import shutil

import torch

from unimp_tpu_torch.cli import common
from unimp_tpu_torch.cli.arguments import build_parser
from unimp_tpu_torch.data.loader import prefetch_to_device
from unimp_tpu_torch.evals.evaluators import EVALUATORS
from unimp_tpu_torch.tools.from_flax import load_flax_params
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train.optimizer import MultiSteps, make_optimizer
from unimp_tpu_torch.train.partition import trainable_params
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.train.vision_cache import build_tower_cache
from unimp_tpu_torch.utils.logging import MetricLogger
from unimp_tpu_torch.utils.profiling import StepTimer, maybe_trace


def train_one_epoch(args, trainer, loader, epoch, logger, timer):
    loader.set_epoch(epoch)
    num_batches = len(loader)
    batches = iter(loader)
    if os.environ.get("UNIMP_DEVICE_PREFETCH", "") == "1":
        batches = prefetch_to_device(batches, trainer.device_batch)
    for step_idx, batch in enumerate(batches):
        timer.data_loaded()
        metrics = trainer.train_step(batch)
        timer.step_done()
        global_step = epoch * num_batches + step_idx
        if (step_idx + 1) % args.logging_steps == 0:
            loss = float(metrics["loss"])
            logger.log(
                {
                    "loss_multi_instruct": loss,
                    "ce": float(metrics["ce"]),
                    "accuracy": float(metrics["accuracy"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    **timer.throughput(args.batch_size),
                },
                step=global_step,
            )
            logger.print(f"Step {step_idx + 1}/{num_batches} of epoch "
                         f"{epoch + 1}/{args.num_epochs}. Loss: {loss:.3f}")


def run_evals(args, model, tokenizer, logger, epoch, tasks=None, split="test",
              cache_holder=None):
    """Evaluate ``tasks`` on ``split``; per-user dumps named as the
    reference names them (eval_rec.py:158), rooted in the run dir. A model
    in training mode is evaluated in place, in ``eval()`` mode under
    ``torch.no_grad()``, and handed back in training mode."""
    tasks = tasks or ([args.task] if args.single_task else common.ALL_EVAL_TASKS)
    run_dir = os.path.join(args.external_save_dir or ".", args.run_name)
    rank = 0
    if cache_holder is None:
        cache_holder = {}
    training = model.training
    model.eval()
    results = {}
    try:
        for task in tasks:
            try:
                ds = common.make_dataset(args, tokenizer, split, task=task)
            except FileNotFoundError as e:
                logger.print(f"[eval] skipping {task} ({split}): {e}")
                continue
            if task not in EVALUATORS:
                raise NotImplementedError(f"the {task} evaluator is not ported yet "
                                          "(ROADMAP.md §1, item 5)")
            loader = common.make_loader(args, ds, tokenizer, train=False)
            with torch.no_grad():
                metrics = EVALUATORS[task](
                    model, loader, tokenizer, num_beams=args.num_beams,
                    kv_int8=getattr(args, "kv_int8", False), cache_holder=cache_holder,
                    dump_path=os.path.join(
                        run_dir, "results",
                        f"{args.run_name}_{task}_{split}_epoch_{epoch}_rank_{rank}.json"))
            results[task] = metrics
            prefix = task if split == "test" else f"{task}/{split}"
            logger.log({f"{prefix}/{k}": v for k, v in metrics.items()
                        if isinstance(v, (int, float))}, step=epoch)
            logger.print(f"[epoch {epoch}] {task} ({split}): " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, (int, float))))
    finally:
        model.train(training)
    return results


def main(argv=None):
    """Train as ``unimp_tpu/cli/mmrec.py:main`` does; returns the trainer
    and its state {"step", "epoch"} (the last epoch run)."""
    args = build_parser().parse_args(argv)
    common.check_ported(args, train=True)
    tokenizer = common.build_tokenizer(args)
    model = common.build_model(args, tokenizer, train=True)

    task = args.task if args.single_task else common.multi_task_list(args)
    train_ds = common.make_dataset(args, tokenizer, "train", task=task)
    train_loader = common.make_loader(args, train_ds, tokenizer, train=True)
    # the JAX package builds one batch to size its parameter init; that
    # batch's prompt draws (train_rec's window starts) shift every later
    # batch's, so the port draws it too and trains on the same batches
    next(iter(train_loader))

    accum = args.gradient_accumulation_steps
    total_steps = len(train_loader) * args.num_epochs
    if accum > 1 and not args.fused_accumulation:
        # MultiSteps advances the schedule once per accumulated update: size
        # the horizon in updates (fused, the loader already yields one a batch)
        total_steps = max(1, total_steps // accum)
    warmup = (int(total_steps * args.warmup_steps_ratio)
              if args.warmup_steps_ratio is not None else args.warmup_steps)

    save_dir = os.path.join(args.external_save_dir or ".", args.run_name)
    logger = MetricLogger(save_dir, args.run_name, use_wandb=args.report_to_wandb,
                          wandb_project=args.wandb_project, wandb_entity=args.wandb_entity,
                          config=vars(args))
    logger.print(f"Total training steps: {total_steps}")

    optimizer = make_optimizer(trainable_params(model), learning_rate=args.learning_rate,
                               lr_scheduler=args.lr_scheduler, total_steps=total_steps,
                               warmup_steps=warmup, weight_decay=args.weight_decay)
    if accum > 1 and not args.fused_accumulation:
        optimizer = MultiSteps(optimizer, accum)
    trainer = Trainer(
        model, optimizer, media_id=tokenizer.media_token_id,
        answer_id=tokenizer.answer_token_id, endofchunk_id=tokenizer.endofchunk_token_id,
        pad_id=tokenizer.pad_token_id, gamma=args.gamma, use_reweight=args.use_reweight,
        mask_lm_head=args.mask_lm_head, accum_steps=accum if args.fused_accumulation else 1,
        device=args.device)

    resume_epoch = 0
    if args.resume_from_checkpoint:
        latest = ckpt.latest_checkpoint(save_dir)
        if latest:
            logger.print(f"Resuming from {latest}")
            load_flax_params(model, ckpt.restore_params(save_dir, latest))
            state = ckpt.restore_train_state(save_dir, latest)
            optimizer.load_state_dict(state["opt_state"])
            trainer.step = int(state["step"])
            resume_epoch = int(state["epoch"]) + 1

    if args.cache_vision_latents:
        # built after any restore: the features are a function of the
        # (frozen) tower's weights
        trainer.vision_cache = build_tower_cache(model, train_ds.item_image, train_ds.n_items)
        logger.print(f"vision tower cache: {train_ds.n_items} items, "
                     f"{trainer.vision_cache.nbytes / 2**20:.0f} MiB on device")

    timer = StepTimer()
    epoch = resume_epoch - 1
    for epoch in range(resume_epoch, args.num_epochs):
        if args.train_method == "continue":
            tasks = common.curriculum_tasks(epoch, args.num_epochs)
            train_ds = common.make_dataset(args, tokenizer, "train", task=tasks)
            train_loader = common.make_loader(args, train_ds, tokenizer, train=True)
        with maybe_trace(args.trace_dir if epoch == resume_epoch else None):
            train_one_epoch(args, trainer, train_loader, epoch, logger, timer)
        # the reference's separate eval-split and test-split passes
        # (mmrec.py:606-608, 775-871); one latent cache serves both
        epoch_cache = {}
        if args.do_eval:
            run_evals(args, model, tokenizer, logger, epoch, split="eval",
                      cache_holder=epoch_cache)
        if args.do_test:
            run_evals(args, model, tokenizer, logger, epoch, split="test",
                      cache_holder=epoch_cache)
        ckpt.save_epoch(save_dir, model, epoch)
        ckpt.save_train_state(save_dir, trainer, epoch)
        if args.delete_previous_checkpoint and epoch > 0:
            prev = os.path.join(save_dir, f"checkpoint_{epoch - 1}")
            if os.path.isdir(prev):
                shutil.rmtree(prev)
    ckpt.save_params(save_dir, model, "final_weights")
    logger.print(f"Saved final weights under {save_dir}")
    return trainer, {"step": trainer.step, "epoch": epoch}


if __name__ == "__main__":
    main()
