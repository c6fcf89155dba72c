"""Shared CLI setup: tokenizer, vocab, model, datasets, loaders.

Counterpart of ``unimp_tpu/cli/common.py`` (the setup sections of the
reference's mmrec.py:475-608: model build per variant, vocab extension +
embedding resize, loader construction, the mesh). One process a GPU: under
``torchrun`` (or any launcher that sets RANK / WORLD_SIZE / MASTER_ADDR)
``build_mesh`` joins the process group and builds the ("dp", "fsdp", "tp")
mesh from ``--mesh_fsdp`` / ``--mesh_tp`` (dp takes the rest), and
``--seq_shard`` routes causal self-attention through ring attention over
fsdp; launched alone, a run is a mesh of one.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.distributed as dist

from unimp_tpu_torch.cli.arguments import variant_name
from unimp_tpu_torch.data.dataset import TaskDataset
from unimp_tpu_torch.data.loader import DataLoader
from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
from unimp_tpu_torch.data.vocab import extend_vocabulary
from unimp_tpu_torch.device import resolve_device
from unimp_tpu_torch.models import get_config
from unimp_tpu_torch.models.config import config_from_json
from unimp_tpu_torch.parallel import mesh as pmesh
from unimp_tpu_torch.parallel.seq_shard import set_sequence_sharding
from unimp_tpu_torch.tools import from_flax

ALL_EVAL_TASKS = ["rec", "exp", "img_sel", "search"]  # run_evals' multi-task default


def check_ported(args, *, train: bool = False) -> None:
    """Refuse, before any work, flags that cannot go together."""
    if train and args.cache_vision_latents and args.unfreeze_backbone:
        raise SystemExit("--cache_vision_latents requires the frozen tower "
                         "(drop --unfreeze_backbone)")


def build_mesh(args) -> pmesh.Mesh:
    """Join the launcher's process group (``parallel/mesh.py:
    init_distributed``; a group initialised already is kept), build the
    mesh with dp taking the world's rest (``make_mesh`` raises on sizes
    that do not divide it), make it the run's, and under ``--seq_shard``
    route causal self-attention through ring attention over fsdp."""
    pmesh.init_distributed(device=args.device)
    mesh = pmesh.make_mesh(dp=None, fsdp=getattr(args, "mesh_fsdp", 1),
                           tp=getattr(args, "mesh_tp", 1), device=args.device)
    pmesh.set_mesh(mesh)
    set_sequence_sharding(mesh if getattr(args, "seq_shard", False) else None)
    return mesh


def min_over_ranks(n: int, mesh: pmesh.Mesh) -> int:
    """The smallest ``n`` over the data axis' ranks (a training epoch's
    batch count: a rank with a batch more would wait for its peers in the
    next collective; DistributedSampler's convention)."""
    group = mesh.group("data")
    if group is None:
        return n
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())


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


def weights_dir(args) -> str:
    """Where ``--load_weights_name`` is read: ``--load_dir``, else
    ``{external_save_dir}/{load_run_name or run_name}``."""
    return args.load_dir or os.path.join(args.external_save_dir or ".",
                                         args.load_run_name or args.run_name)


def build_model(args, tokenizer, *, train: bool = False, weights=None, trainable_mask=None,
                mesh=None):
    """The variant (or ``--config_json``) with the CLI's overrides and the
    vocab sized to the extended tokenizer, rounded up to 128, on
    ``--device``, with the port's seeded weights (``--seed``) or
    ``weights`` (a flat tree, ``train/checkpoint.py:restore_params``, or
    a function of the seeded tree, ``tools/from_flax.py:build_model``).
    Inference: cast or quantized as ``--eval_param_dtype`` says, after
    ``weights`` are loaded. Training (``train``): the reference's freezing,
    frozen kernels int8 under ``--frozen_int8`` (which wins over
    ``--frozen_bf16``, as in the JAX CLI), frozen tensors in bfloat16
    under ``--frozen_bf16``, or every tensor trainable (float32) under
    ``--unfreeze_backbone``; or, given ``trainable_mask`` (model ->
    {parameter name: trainable}), that freezing with every tensor float32
    (the transfer entry's). ``--remat`` / ``--remat_policy`` set the
    config's activation checkpointing, as the JAX CLI does. ``mesh``:
    each rank makes its own tp block and fsdp chunk of every tensor, one
    tensor at a time (``tools/from_flax.py:build_model``)."""
    if getattr(args, "config_json", None):
        cfg = config_from_json(args.config_json)
    else:
        cfg = get_config(variant_name(args))
    if args.cross_attn_every_n_layers:
        cfg = cfg.replace(cross_attn_every_n=args.cross_attn_every_n_layers)
    if args.precision in ("fp32", "amp"):
        cfg = cfg.replace(dtype="float32")
    if getattr(args, "remat", False):
        cfg = cfg.replace(remat=True)
    if getattr(args, "remat_policy", "none") != "none":
        cfg = cfg.replace(remat_policy=args.remat_policy)
    vocab = ((len(tokenizer) + 127) // 128) * 128
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    device = resolve_device(args.device)
    if not train:
        return from_flax.build_model(cfg, device=device, seed=args.seed, weights=weights,
                                     eval_param_dtype=args.eval_param_dtype, mesh=mesh)
    if trainable_mask is not None:
        return from_flax.build_model(cfg, device=device, seed=args.seed, weights=weights,
                                     train=True, trainable_mask=trainable_mask, mesh=mesh)
    unfreeze = args.unfreeze_backbone
    model = from_flax.build_model(cfg, device=device, seed=args.seed, weights=weights,
                                  train=True, frozen_dtype=frozen_dtype(args), mesh=mesh)
    if unfreeze:
        model.requires_grad_(True)
    return model


def frozen_dtype(args):
    """The frozen tensors' storage under the training flags: "int8"
    (``--frozen_int8``, first, as the JAX CLI decides), bfloat16
    (``--frozen_bf16``), or None (float32, and always under
    ``--unfreeze_backbone``, which freezes nothing)."""
    if args.unfreeze_backbone:
        return None
    if args.frozen_int8:
        return "int8"
    return torch.bfloat16 if args.frozen_bf16 else None


def make_dataset(args, tokenizer, split: str, task=None) -> TaskDataset:
    task = task if task is not None else args.task
    # --img_gen_mode pretrain selects the single-item catalogue variant
    # (rec_dataset.py:536-611; the reference toggles it by editing code)
    if task == "img_gen" and getattr(args, "img_gen_mode", "retrieve") == "pretrain":
        task = "img_gen_pretrain"
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


def make_loader(args, ds, tokenizer, *, train: bool, mesh=None) -> DataLoader:
    """A train loader shuffles (``seed + epoch``) and drops the last partial
    batch, and under ``--fused_accumulation`` yields the accumulation's
    micro-batches at once; an eval loader keeps the order and the last
    partial batch. Each rank reads its data-axis shard (``mesh``, default
    the run's)."""
    mesh = mesh or pmesh.get_mesh()
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
        process_index=mesh.data_rank,
        process_count=mesh.data_size,
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
