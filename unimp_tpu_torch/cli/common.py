"""Shared CLI setup: tokenizer, vocab, model, datasets, loaders.

Counterpart of ``unimp_tpu/cli/common.py`` (the setup sections of the
reference's mmrec.py:475-608: model build per variant, vocab extension +
embedding resize, loader construction), on one process and one device.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from unimp_tpu_torch.cli.arguments import variant_name
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.loader import DataLoader
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.data.vocab import extend_vocabulary
from unimp_tpu_torch.device import resolve_device
from unimp_tpu_torch.evals.evaluators import EVALUATORS
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.models.config import config_from_json
from unimp_tpu_torch.tools import from_flax

TRAIN_TASKS = ("rec", "search")  # the tasks whose dataset the port has
ALL_EVAL_TASKS = ["rec", "exp", "img_sel", "search"]  # run_evals' multi-task default
# flag -> (what it needs, its ROADMAP.md §1 item)
UNPORTED = {
    "seq_shard": ("--seq_shard: ring attention", "item 7"),
    "eval_embed": ("--eval_embed: the exp evaluator and BERTScore", "item 5"),
    "frozen_int8": ("--frozen_int8: the int8 frozen backbone under autograd", "item 3.6"),
    "bf16_opt_state": ("--bf16_opt_state: bf16 gradients and moments", "item 3.5"),
    "remat": ("--remat: activation checkpointing", "item 3.4"),
    "load_from_original_checkpoint": ("--load_from_original_checkpoint: the torch .pt "
                                      "converter", "item 8"),
    "save_hf_model": ("--save_hf_model: the torch .pt exporter", "item 8"),
    "save_checkpoints_to_wandb": ("--save_checkpoints_to_wandb: wandb artifacts",
                                  "where the port logs JSONL only"),
}


def check_ported(args, *, train: bool = False) -> None:
    """Raise, before any work, on a flag whose machinery the port does not
    have yet, or on a run whose train or eval task list reaches a task the
    port cannot run."""
    if getattr(args, "mesh_fsdp", 1) > 1 or getattr(args, "mesh_tp", 1) > 1:
        raise NotImplementedError("--mesh_fsdp / --mesh_tp above 1: multi-GPU is not "
                                  "ported yet (ROADMAP.md §1, item 7)")
    for flag, (what, item) in UNPORTED.items():
        if getattr(args, flag, False):
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md §1, {item})")
    if getattr(args, "remat_policy", "none") != "none":
        raise NotImplementedError("--remat_policy: activation checkpointing is not ported yet "
                                  "(ROADMAP.md §1, item 3.4)")
    if (getattr(args, "load_weights_name", None) or "").endswith(".pt"):
        raise NotImplementedError("--load_weights_name *.pt: the torch .pt converter is not "
                                  "ported yet (ROADMAP.md §1, item 8)")
    if train and args.cache_vision_latents and args.unfreeze_backbone:
        raise SystemExit("--cache_vision_latents requires the frozen tower "
                         "(drop --unfreeze_backbone)")
    lists = []
    if train:
        lists.append(args.task if args.single_task else multi_task_list(args))
        if args.train_method == "continue":
            lists += [curriculum_tasks(e, args.num_epochs) for e in range(args.num_epochs)]
    for tasks in lists:
        for t in [tasks] if isinstance(tasks, str) else tasks:
            if t not in TRAIN_TASKS:
                raise NotImplementedError(f"training on the {t} task: its dataset is not "
                                          "ported yet (ROADMAP.md §1, item 5)")
    if not train or args.do_eval or args.do_test:
        for t in [args.task] if args.single_task else ALL_EVAL_TASKS:
            if t not in EVALUATORS:
                raise NotImplementedError(f"the {t} evaluator is not ported yet "
                                          "(ROADMAP.md §1, item 5)")


def build_tokenizer(args) -> UniMPTokenizer:
    if args.tokenizer_path:
        tok = UniMPTokenizer.load(args.tokenizer_path)
    else:
        corpus_path = os.path.join(args.mmrec_path, "corpus.txt")
        if os.path.exists(corpus_path):
            with open(corpus_path) as f:
                corpus = f.read().splitlines()
        else:
            # fall back to item metadata as the corpus
            with open(os.path.join(args.mmrec_path, f"meta_{args.subset}.json")) as f:
                meta = json.load(f)
            corpus = [
                " ".join(str(v) for v in (m.values() if isinstance(m, dict) else m))
                for m in meta.values()
            ]
        tok = UniMPTokenizer.from_corpus(corpus)
    extend_vocabulary(
        tok, subset=args.subset, use_semantic=args.use_semantic,
        task=args.task, n_items=args.n_items,
        transfer_domain=getattr(args, "transfer_domain", None),
    )
    return tok


def build_model(args, tokenizer, *, train: bool = False, weights=None):
    """The variant (or ``--config_json``) with the CLI's overrides and the
    vocab sized to the extended tokenizer, rounded up to 128, on
    ``--device``, with the port's seeded weights (``--seed``) or
    ``weights`` (a flat tree, ``train/checkpoint.py:restore_params``).
    Inference: cast or quantized as ``--eval_param_dtype`` says, after
    ``weights`` are loaded. Training (``train``): the reference's freezing,
    frozen tensors in bfloat16 under ``--frozen_bf16``, or every tensor
    trainable (float32) under ``--unfreeze_backbone``."""
    if getattr(args, "config_json", None):
        cfg = config_from_json(args.config_json)
    else:
        cfg = get_config(variant_name(args))
    if args.cross_attn_every_n_layers:
        cfg = cfg.replace(cross_attn_every_n=args.cross_attn_every_n_layers)
    if args.precision in ("fp32", "amp"):
        cfg = cfg.replace(dtype="float32")
    vocab = ((len(tokenizer) + 127) // 128) * 128
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    device = resolve_device(args.device)
    if not train:
        return from_flax.build_model(cfg, device=device, seed=args.seed, weights=weights,
                                     eval_param_dtype=args.eval_param_dtype)
    unfreeze = args.unfreeze_backbone
    frozen = torch.bfloat16 if args.frozen_bf16 and not unfreeze else None
    model = from_flax.build_model(cfg, device=device, seed=args.seed, weights=weights,
                                  train=True, frozen_dtype=frozen)
    if unfreeze:
        model.requires_grad_(True)
    return model


def make_dataset(args, tokenizer, split: str, task=None) -> TaskDataset:
    task = task if task is not None else args.task
    # eval batches carry item ids; images are encoded once into the
    # device-side latent cache (evals/latent_cache.py). Train batches do the
    # same under --cache_vision_latents (train/vision_cache.py).
    if split == "train":
        load_images = not getattr(args, "cache_vision_latents", False)
    else:
        load_images = getattr(args, "no_eval_latent_cache", False)
    return TaskDataset(
        args.mmrec_path,
        args.subset,
        task,
        split,
        tokenizer,
        use_semantic=args.use_semantic,
        image_size=args.patch_image_size,
        seed=args.pretrain_seed,
        history_len=args.history_len,
        n_items=args.n_items,
        load_images=load_images,
        max_records=args.max_records,
    )


def make_loader(args, ds, tokenizer, *, train: bool) -> DataLoader:
    """A train loader shuffles (``seed + epoch``) and drops the last partial
    batch, and under ``--fused_accumulation`` yields the accumulation's
    micro-batches at once; an eval loader keeps the order and the last
    partial batch."""
    accum = (args.gradient_accumulation_steps
             if train and getattr(args, "fused_accumulation", False) else 1)
    return DataLoader(
        ds,
        batch_size=args.batch_size * accum if train else args.eval_batch_size,
        pad_id=tokenizer.pad_token_id,
        shuffle=train,
        seed=args.seed,
        drop_last=train,
        num_workers=args.workers,
        pad_to_multiple=128,
        max_text_len=args.max_src_length,
    )


def multi_task_list(args):
    """Reference multi-task order (rec_dataset.py:180-206 consumes the
    list; unimp_all_tasks.sh passes img_sel,search,rec,exp)."""
    if args.single_task:
        return args.task
    return ["img_sel", "search", "rec", "exp"]


def curriculum_tasks(epoch: int, num_epochs: int):
    """--train_method continue schedule (mmrec.py:743-755)."""
    if epoch <= num_epochs // 4:
        return ["rec"]
    if epoch <= num_epochs // 2:
        return ["rec", "search"]
    if epoch <= num_epochs // 4 * 3:
        return ["rec", "search", "img_sel"]
    return ["rec", "search", "img_sel", "exp"]
