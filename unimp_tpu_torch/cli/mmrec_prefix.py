"""New-domain transfer entry point: the port's ``mmrec_prefix`` (counterpart
of ``unimp_tpu/cli/mmrec_prefix.py``, the reference's mmrec_prefix.py).

    python -m unimp_tpu_torch.cli.mmrec_prefix --mmrec_path DATA --subset beauty \\
        --task rec --transfer_domain office --load_run_name RUN \\
        --load_weights_name final_weights [--only_test] [--device cpu] ...

Extends the vocabulary with ``item_domain_{i}`` tokens (office = 1,574,
tool = 6,885; default office), builds the model with every tensor float32
and the perceiver resampler and the gated cross-attention blocks frozen
(``frozen_mask``), restores ``{load_dir or external_save_dir/(load_run_name
or run_name)}/{load_weights_name}`` onto it with growth
(``train/checkpoint.py:merge_with_growth``: the new vocabulary rows keep
the fresh init), then fine-tunes it with the Trainer, schedule and
accumulation of ``cli/mmrec.py``, writing ``weights_epoch_{e}`` and
``final_weights`` under ``{external_save_dir}/{run_name}_{domain}``.
``--only_test`` evaluates the restored weights instead. ``--trace_dir``
records the first epoch (or the ``--only_test`` evals). ``--remat`` /
``--remat_policy`` apply (the model's config); ``--frozen_int8`` and
``--bf16_opt_state`` leave this entry's float32 tensors, gradients and
moments as they are, as the JAX entry does (its Trainer and optimizer get
neither flag, ``unimp_tpu/cli/mmrec_prefix.py:95-114``).
"""

from __future__ import annotations

import os

from unimp_tpu_torch.cli import common
from unimp_tpu_torch.cli.arguments import build_parser
from unimp_tpu_torch.cli.mmrec import run_evals, train_one_epoch
from unimp_tpu_torch.parallel.sharding import whole_like
from unimp_tpu_torch.tools.from_flax import load_flax_params
from unimp_tpu_torch.train import checkpoint as ckpt
from unimp_tpu_torch.train.optimizer import MultiSteps, decay_mask, make_optimizer
from unimp_tpu_torch.train.partition import trainable_params
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.train.vision_cache import build_tower_cache
from unimp_tpu_torch.utils.logging import MetricLogger
from unimp_tpu_torch.utils.profiling import StepTimer, maybe_trace


def frozen_mask(model) -> dict:
    """{parameter name: trainable}: everything but the perceiver resampler
    and the gated cross-attention blocks (mmrec_prefix.py:631-632).

    The reference also calls ``requires_grad_(False)`` on the input
    embeddings (mmrec_prefix.py:633) but then
    ``resize_token_embeddings(len(tokenizer))`` (mmrec_prefix.py:647-654)
    replaces the embedding module with a fresh, trainable one; freezing it
    here would leave the new ``item_domain_{i}`` rows at their init."""
    return {name: not (name.startswith("resampler") or "xattn_" in name)
            for name, _ in model.named_parameters()}


def main(argv=None):
    """Transfer as ``unimp_tpu/cli/mmrec_prefix.py:main`` does; returns the
    trainer and its state {"step", "epoch"}, or, with ``--only_test``,
    ``run_evals``' results."""
    args = build_parser(eval_only=True).parse_args(argv)
    common.check_ported(args)
    mesh = common.build_mesh(args)
    if args.transfer_domain is None:
        args.transfer_domain = "office"
    tokenizer = common.build_tokenizer(args)  # adds item_domain_{i}
    model = common.build_model(args, tokenizer, train=True, trainable_mask=frozen_mask,
                               mesh=mesh)

    train_ds = common.make_dataset(args, tokenizer, "train", task=args.task)
    train_loader = common.make_loader(args, train_ds, tokenizer, train=True)
    # the JAX package sizes its init with one batch, which advances the
    # dataset's prompt draws: the port draws it too (as cli/mmrec.py does)
    next(iter(train_loader))

    save_dir = os.path.join(args.external_save_dir or ".",
                            f"{args.run_name}_{args.transfer_domain}")
    logger = MetricLogger(save_dir, args.run_name, use_wandb=args.report_to_wandb,
                          wandb_project=args.wandb_project, wandb_entity=args.wandb_entity,
                          config=vars(args), rank=mesh.rank)
    if args.load_weights_name:
        # the vocabulary grew: the overlap of each table comes from the
        # checkpoint, the new rows keep the fresh init
        restored = ckpt.restore_params(common.weights_dir(args), args.load_weights_name)
        # (whole tensors under tp: the load takes each rank's block)
        load_flax_params(model, ckpt.merge_with_growth(restored, ckpt.full_model_tree(model)))
        del restored  # release the file's mapping
    if args.only_test:
        with maybe_trace(args.trace_dir):
            return run_evals(args, model, tokenizer, logger, epoch=0, tasks=[args.task])

    accum = args.gradient_accumulation_steps
    total_steps = common.min_over_ranks(len(train_loader), mesh) * args.num_epochs
    if accum > 1 and not args.fused_accumulation:
        total_steps = max(1, total_steps // accum)  # in updates (see cli/mmrec.py)
    warmup = (int(total_steps * args.warmup_steps_ratio)
              if args.warmup_steps_ratio is not None else args.warmup_steps)
    trainable = trainable_params(model)
    # under fsdp (ZeRO-3) the optimizer updates this rank's chunks
    optimizer = make_optimizer(trainable,
                               learning_rate=args.learning_rate,
                               lr_scheduler=args.lr_scheduler, total_steps=total_steps,
                               warmup_steps=warmup, weight_decay=args.weight_decay,
                               decay=decay_mask(whole_like(model, trainable)))
    if accum > 1 and not args.fused_accumulation:
        optimizer = MultiSteps(optimizer, accum)
    trainer = Trainer(
        model, optimizer, media_id=tokenizer.media_token_id,
        answer_id=tokenizer.answer_token_id, endofchunk_id=tokenizer.endofchunk_token_id,
        pad_id=tokenizer.pad_token_id, gamma=args.gamma, use_reweight=args.use_reweight,
        accum_steps=accum if args.fused_accumulation else 1, device=args.device,
        mesh=mesh)

    if args.cache_vision_latents:
        # from the restored tower, as the JAX entry builds it
        trainer.vision_cache = build_tower_cache(model, train_ds.item_image, train_ds.n_items)
        logger.print(f"vision tower cache: {train_ds.n_items} items, "
                     f"{trainer.vision_cache.nbytes / 2**20:.0f} MiB on device")

    timer = StepTimer()
    epoch = -1
    for epoch in range(args.num_epochs):
        # --trace_dir: the first epoch's training and evals
        with maybe_trace(args.trace_dir if epoch == 0 else None):
            train_one_epoch(args, trainer, train_loader, epoch, logger, timer)
            epoch_cache = {}
            if args.do_eval:
                run_evals(args, model, tokenizer, logger, epoch, tasks=[args.task],
                          split="eval", cache_holder=epoch_cache)
            if args.do_test:
                run_evals(args, model, tokenizer, logger, epoch, tasks=[args.task],
                          split="test", cache_holder=epoch_cache)
        ckpt.save_epoch(save_dir, model, epoch)
    ckpt.save_params(save_dir, model, "final_weights")
    return trainer, {"step": trainer.step, "epoch": epoch}


if __name__ == "__main__":
    main()
