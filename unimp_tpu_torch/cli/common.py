"""Shared CLI setup: tokenizer, vocab, model, datasets, loaders.

Counterpart of ``unimp_tpu/cli/common.py`` (the setup sections of the
reference's mmrec.py:475-608: model build per variant, vocab extension +
embedding resize, loader construction), on one process and one device.
"""

from __future__ import annotations

import dataclasses
import json
import os

from unimp_tpu_torch.cli.arguments import variant_name
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.loader import DataLoader
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.data.vocab import extend_vocabulary
from unimp_tpu_torch.device import resolve_device
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.models.config import config_from_json
from unimp_tpu_torch.tools import from_flax


def check_ported(args) -> None:
    """Raise on a flag whose machinery the port does not have yet."""
    if getattr(args, "mesh_fsdp", 1) > 1 or getattr(args, "mesh_tp", 1) > 1:
        raise NotImplementedError("--mesh_fsdp / --mesh_tp above 1: multi-GPU is not "
                                  "ported yet (ROADMAP.md §1, item 7)")
    if getattr(args, "seq_shard", False):
        raise NotImplementedError("--seq_shard: ring attention is not ported yet "
                                  "(ROADMAP.md §1, item 7)")
    if getattr(args, "load_weights_name", None):
        raise NotImplementedError("--load_weights_name: the Orbax / .pt restore is not "
                                  "ported yet (ROADMAP.md §1, item 3.3 and item 8)")
    if getattr(args, "eval_embed", False):
        raise NotImplementedError("--eval_embed: the exp evaluator and BERTScore are not "
                                  "ported yet (ROADMAP.md §1, item 5)")


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


def build_model(args, tokenizer):
    """The variant (or ``--config_json``) with the CLI's overrides and the
    vocab sized to the extended tokenizer, rounded up to 128, on
    ``--device`` with the port's seeded weights (``--seed``), cast or
    quantized as ``--eval_param_dtype`` says."""
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
    return from_flax.build_model(cfg, device=resolve_device(args.device), seed=args.seed,
                                 eval_param_dtype=args.eval_param_dtype)


def make_dataset(args, tokenizer, split: str, task=None) -> TaskDataset:
    task = task if task is not None else args.task
    # eval batches carry item ids; images are encoded once into the
    # device-side latent cache (evals/latent_cache.py)
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


def make_loader(args, ds, tokenizer) -> DataLoader:
    """An eval loader: no shuffle, the last partial batch kept."""
    return DataLoader(
        ds,
        batch_size=args.eval_batch_size,
        pad_id=tokenizer.pad_token_id,
        shuffle=False,
        seed=args.seed,
        drop_last=False,
        num_workers=args.workers,
        pad_to_multiple=128,
        max_text_len=args.max_src_length,
    )
