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
``--load_from_original_checkpoint PATH.pt`` converts a reference
``.pt`` onto the model first (``tools/convert_torch.py``; under
``--frozen_int8`` onto its dequantized floats, then quantized again), and
``--save_hf_model`` writes ``final_weights_torch.pt`` beside
``final_weights`` (``tools/export_torch.py``).
``--resume_from_checkpoint`` continues from the latest ``checkpoint_{e}``
of the run, and ``--cache_vision_latents`` encodes every item through the
frozen tower once (``train/vision_cache.py``). The JAX package's headline
configuration runs too: ``--frozen_int8`` (frozen kernels int8, read
through K6 at <= 512 rows; checkpoints stay float trees and a resume
quantizes them again), ``--bf16_opt_state`` (bfloat16 gradients and Adam
moments) and ``--remat [--remat_policy dots]``.

Several GPUs: one process each, launched by ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N -m unimp_tpu_torch.cli.mmrec
...``), over a ("dp", "fsdp", "tp") mesh (``--mesh_fsdp``, ``--mesh_tp``;
``cli/common.py:build_mesh``). Each rank trains on its shard of every
batch (``--batch_size`` is per rank), its epoch as long as the shortest
rank's; rank 0 alone logs and writes checkpoints and dumps, and every
rank evaluates its shard of the users (``evals/dist.py`` joins the
metrics).
"""

from __future__ import annotations

import os
import shutil

import torch

from unimp_tpu_torch.cli import common
from unimp_tpu_torch.cli.arguments import build_parser, variant_name
from unimp_tpu_torch.data.loader import prefetch_to_device
from unimp_tpu_torch.evals.bertscore import make_model_bertscore
from unimp_tpu_torch.evals.evaluators import EVALUATORS
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.parallel.sharding import shard_tree_tp, whole_like
from unimp_tpu_torch.tools.convert_torch import load_torch_checkpoint
from unimp_tpu_torch.tools.export_torch import family_of, save_torch_checkpoint
from unimp_tpu_torch.tools.from_flax import load_flax_params
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train.optimizer import MultiSteps, decay_mask, make_optimizer
from unimp_tpu_torch.train.partition import (apply_frozen_storage, int8_kernel_names,
                                              trainable_params)
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.train.vision_cache import build_tower_cache
from unimp_tpu_torch.utils.logging import MetricLogger
from unimp_tpu_torch.utils.profiling import StepTimer, maybe_trace


def train_one_epoch(args, trainer, loader, epoch, logger, timer):
    loader.set_epoch(epoch)
    if trainer.mesh is not None:
        # every rank runs the same number of steps (their collectives pair)
        loader.max_batches = None
        loader.max_batches = common.min_over_ranks(len(loader), trainer.mesh)
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
    """Evaluate ``tasks`` on ``split``, with the dumps named as the reference
    names them, rooted in the run dir: rec / search per-user metrics under
    ``results/`` (eval_rec.py:158), exp generations under ``save_gen/`` and
    an appended ``results_exp.txt`` (eval_exp.py:152-175), img_gen tokens
    under ``save_img_gen/`` (eval_img_gen.py:141-144). ``--num_beams`` goes
    to rec and search only; the other tasks keep their own beams. A model
    in training mode is evaluated in place, in ``eval()`` mode under
    ``torch.no_grad()``, and handed back in training mode."""
    tasks = tasks or ([args.task] if args.single_task else common.ALL_EVAL_TASKS)
    run_dir = os.path.join(args.external_save_dir or ".", args.run_name)
    # the ranks of one tp group read the same users: the first writes their
    # dumps, named by the data-axis rank
    mesh = common.pmesh.get_mesh()
    rank, dumps = mesh.data_rank, mesh.coords[2] == 0
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
            loader = common.make_loader(args, ds, tokenizer, train=False)
            kwargs = {"kv_int8": getattr(args, "kv_int8", False),
                      "cache_holder": cache_holder}
            if task in ("rec", "search"):
                kwargs["num_beams"] = args.num_beams
                kwargs["dump_path"] = os.path.join(
                    run_dir, "results",
                    f"{args.run_name}_{task}_{split}_epoch_{epoch}_rank_{rank}.json"
                ) if dumps else None
            elif task == "exp":
                kwargs["dump_dir"] = os.path.join(run_dir, "save_gen") if dumps else None
                kwargs["rank"] = rank
                if getattr(args, "eval_embed", False):
                    kwargs["bertscore_fn"] = make_model_bertscore(model, tokenizer)
            elif task == "img_gen":
                kwargs["dump_path"] = os.path.join(
                    run_dir, "save_img_gen",
                    f"img_gen_{rank}_epoch_{epoch}_name_{args.run_name}.json"
                ) if dumps else ""
            with torch.no_grad():
                metrics = EVALUATORS[task](model, loader, tokenizer, **kwargs)
            results[task] = metrics
            if task == "exp" and ckpt.is_writer():
                # the reference appends the aggregate to results_exp.txt
                # (eval_exp.py:168-175)
                line = " \n".join(f"{k}: {metrics[k]}" for k in (
                    "rmse", "mae", "bleu", "rouge1", "rouge2", "rougeL", "meteor", "bertscore")
                    if k in metrics)
                with open(os.path.join(run_dir, "results_exp.txt"), "a+") as f:
                    f.write(line + "\n\n")
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
    mesh = common.build_mesh(args)
    tokenizer = common.build_tokenizer(args)
    model = common.build_model(args, tokenizer, train=True, mesh=mesh)

    task = args.task if args.single_task else common.multi_task_list(args)
    train_ds = common.make_dataset(args, tokenizer, "train", task=task)
    train_loader = common.make_loader(args, train_ds, tokenizer, train=True)
    # the JAX package builds one batch to size its parameter init; that
    # batch's prompt draws (train_rec's window starts) shift every later
    # batch's, so the port draws it too and trains on the same batches
    next(iter(train_loader))

    accum = args.gradient_accumulation_steps
    total_steps = common.min_over_ranks(len(train_loader), mesh) * args.num_epochs
    if accum > 1 and not args.fused_accumulation:
        # MultiSteps advances the schedule once per accumulated update: size
        # the horizon in updates (fused, the loader already yields one a batch)
        total_steps = max(1, total_steps // accum)
    warmup = (int(total_steps * args.warmup_steps_ratio)
              if args.warmup_steps_ratio is not None else args.warmup_steps)

    save_dir = os.path.join(args.external_save_dir or ".", args.run_name)
    logger = MetricLogger(save_dir, args.run_name, use_wandb=args.report_to_wandb,
                          wandb_project=args.wandb_project, wandb_entity=args.wandb_entity,
                          config=vars(args), rank=mesh.rank)
    logger.print(f"Total training steps: {total_steps}")

    bf16_state = torch.bfloat16 if args.bf16_opt_state else None
    trainable = trainable_params(model)
    # under fsdp (ZeRO-3) the optimizer updates this rank's chunks
    optimizer = make_optimizer(trainable,
                               learning_rate=args.learning_rate,
                               lr_scheduler=args.lr_scheduler, total_steps=total_steps,
                               warmup_steps=warmup, weight_decay=args.weight_decay,
                               moment_dtype=bf16_state,
                               decay=decay_mask(whole_like(model, trainable)))
    if accum > 1 and not args.fused_accumulation:
        optimizer = MultiSteps(optimizer, accum)
    trainer = Trainer(
        model, optimizer, media_id=tokenizer.media_token_id,
        answer_id=tokenizer.answer_token_id, endofchunk_id=tokenizer.endofchunk_token_id,
        pad_id=tokenizer.pad_token_id, gamma=args.gamma, use_reweight=args.use_reweight,
        mask_lm_head=args.mask_lm_head, accum_steps=accum if args.fused_accumulation else 1,
        device=args.device, grad_dtype=bf16_state, mesh=mesh)

    if args.load_from_original_checkpoint:
        # the converter fits the file onto a float tree and keeps the
        # model's value where it maps nothing: int8 kernels go in as their
        # dequantized floats and are quantized again after the load
        int8 = int8_kernel_names(model)
        flat = load_torch_checkpoint(args.load_from_original_checkpoint,
                                     ckpt.full_model_tree(model))
        load_flax_params(model, flat)
        del flat  # release the file's mapping
        if int8:
            apply_frozen_storage(model, int8)

    resume_epoch = 0
    if args.resume_from_checkpoint:
        latest = ckpt.latest_checkpoint(save_dir)
        if latest:
            logger.print(f"Resuming from {latest}")
            restored = ckpt.restore_params(save_dir, latest)
            int8 = int8_kernel_names(model)
            if int8:
                # checkpoints are float trees: check the file against the
                # dequantized layout, load it, then quantize the frozen
                # kernels again
                like = ckpt.abstract_tree(model)
                # under tp the model holds its blocks of the file's tensors
                view = {p: torch.empty(t.shape, device="meta") for p, t in restored.items()}
                if model.tp_layout:
                    view = shard_tree_tp(view, model.tp_layout, model.tp_rank, model.tp_size)
                bad = sorted(p for p in set(like) | set(view)
                             if p not in like or p not in view
                             or tuple(like[p].shape) != tuple(view[p].shape))
                if bad:
                    raise KeyError(f"{latest} does not fit the model: {bad[:8]}")
            load_flax_params(model, restored)
            del restored  # release the file's mapping
            if int8:
                # the float kernels the load put in place of int8 ones go back
                apply_frozen_storage(model, int8)
            state = ckpt.restore_train_state(save_dir, latest)
            trainer.load_optimizer_state(state["opt_state"])
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
        # --trace_dir: the first epoch's training and evals
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
        if args.delete_previous_checkpoint and epoch > 0 and ckpt.is_writer():
            prev = os.path.join(save_dir, f"checkpoint_{epoch - 1}")
            if os.path.isdir(prev):
                shutil.rmtree(prev)
    ckpt.save_params(save_dir, model, "final_weights")
    if args.save_checkpoints_to_wandb:
        logger.log_artifact(os.path.join(save_dir, "final_weights"),
                            name=f"{args.run_name}_final_weights")
    if args.save_hf_model:
        # the decoder's naming follows the variant, as the JAX CLI picks it
        out = save_torch_checkpoint(model, os.path.join(save_dir, "final_weights_torch.pt"),
                                    family_of(get_config(variant_name(args)).lm.positions))
        logger.print(f"Exported torch checkpoint: {out}")
    logger.print(f"Saved final weights under {save_dir}")
    return trainer, {"step": trainer.step, "epoch": epoch}


if __name__ == "__main__":
    main()
