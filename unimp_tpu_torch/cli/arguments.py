"""Shared argparse surface: the flags and defaults of ``unimp_tpu/cli/arguments.py``.

Flags mirror the reference's mmrec.py:307-459 plus the live subset of
pipeline/mm_utils/arguments.py; the port adds one, ``--device`` (default
``cuda``: the entry points run on the card unless asked for the CPU).
Flags that cannot go together are refused in
``cli/common.py:check_ported``, before any work.
"""

from __future__ import annotations

import argparse


def build_parser(eval_only: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # ---- reference flags (mmrec.py:307-459) ----
    p.add_argument("--cross_attn_every_n_layers", type=int, default=None,
                   help="override the variant's gated-xattn stride")
    p.add_argument("--external_save_dir", type=str, default=None)
    p.add_argument("--run_name", type=str, default="mm_tpu")
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--logging_steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument(
        "--fused_accumulation", action="store_true",
        help="accumulate gradients over microbatches inside one step "
             "(single grad buffer); training only",
    )
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="4b-instruct",
                   help="variant: debug|small|3b-mpt|4b|4b-instruct|9b")
    p.add_argument("--load_from_original_checkpoint", type=str, default=None,
                   help="torch .pt checkpoint to convert and load")
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--delete_previous_checkpoint", action="store_true")
    p.add_argument("--mmrec_path", type=str, required=True,
                   help="dataset directory (reference file layout)")
    p.add_argument("--task", type=str, default="rec")
    p.add_argument("--config_json", type=str, default=None,
                   help="Otter/Flamingo config.json to build the model "
                        "from (recommender.py:421-422) instead of "
                        "--pretrained_model_name_or_path variants")
    p.add_argument("--img_gen_mode", type=str, default="retrieve",
                   choices=["retrieve", "pretrain"],
                   help="img_gen flavor: history-conditioned retrieval "
                        "(rec_dataset.py:613-720) or single-item pretrain "
                        "(rec_dataset.py:536-611)")
    p.add_argument("--use_semantic", default=False, action="store_true")
    p.add_argument("--use_reweight", default=False, action="store_true")
    p.add_argument("--subset", type=str, default="all")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gamma", type=float, default=2)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--lr_scheduler", default="constant", type=str,
                   help="constant, linear, or cosine")
    p.add_argument("--loss_multiplier_multi_instruct", type=float, default=1.0)
    p.add_argument("--warmup_steps", default=1000, type=int)
    p.add_argument("--warmup_steps_ratio", default=None, type=float)
    p.add_argument("--weight_decay", default=0.1, type=float)
    p.add_argument("--do_eval", default=False, action="store_true")
    p.add_argument("--do_test", default=False, action="store_true")
    p.add_argument("--eval_embed", default=False, action="store_true",
                   help="exp eval: add the hermetic embedding BERTScore "
                        "(reference eval_exp.py:63-67 --eval_embed)")
    p.add_argument("--precision", default="bf16", type=str,
                   choices=["bf16", "fp32", "amp_bf16", "amp_bfloat16", "amp", "fp16"])
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--train_num_samples", type=int, default=None)
    p.add_argument("--mask_lm_head", action="store_true")
    p.add_argument("--unfreeze_backbone", default=False, action="store_true",
                   help="train the vision tower and LM backbone too "
                        "(the reference freezes both: open_flamingo "
                        "factory + mmrec.py:595 resize — only perceiver, "
                        "gated xattn and embeddings/lm head train)")
    p.add_argument("--frozen_bf16", default=False, action="store_true",
                   help="store frozen params in bfloat16 (lossless when "
                        "compute dtype is bf16; halves their HBM use)")
    p.add_argument("--frozen_int8", default=False, action="store_true",
                   help="store frozen matmul kernels weight-only int8 "
                        "(4x less HBM than f32; checkpoints still save "
                        "as float trees)")
    p.add_argument("--cache_vision_latents", default=False,
                   action="store_true",
                   help="precompute the FROZEN CLIP tower's features per "
                        "item once and stream image ids during training "
                        "(train/vision_cache.py) — the tower forward "
                        "(~20%% of the reference-shape step FLOPs) and "
                        "the per-batch image upload leave the hot loop; "
                        "requires the frozen backbone and ~526 KB/item "
                        "HBM at CLIP-L/14 @224")
    p.add_argument("--bf16_opt_state", default=False, action="store_true",
                   help="store gradients and both Adam moments in bf16 "
                        "(f32 master weights kept); training only")
    p.add_argument("--save_hf_model", default=False, action="store_true",
                   help="also export final weights as a torch .pt with "
                        "reference (OpenFlamingo) tensor names")
    p.add_argument("--single_task", default=False, action="store_true")
    p.add_argument("--train_method", type=str, default="multi_task",
                   help="multi_task | continue (curriculum)")
    p.add_argument("--report_to_wandb", default=False, action="store_true")
    p.add_argument("--save_checkpoints_to_wandb", default=False,
                   action="store_true",
                   help="upload final weights as a wandb artifact "
                        "(reference mmrec.py:893-894)")
    p.add_argument("--wandb_project", type=str, default=None)
    p.add_argument("--wandb_entity", type=str, default=None)
    # live data flags (arguments.py:302-360)
    p.add_argument("--patch-image-size", dest="patch_image_size", type=int,
                   default=224)
    p.add_argument("--max-src-length", dest="max_src_length", type=int,
                   default=1024)
    p.add_argument("--max-tgt-length", dest="max_tgt_length", type=int,
                   default=256)
    p.add_argument("--pretrain-seed", dest="pretrain_seed", type=int, default=7)
    if eval_only:
        p.add_argument("--load_weights_name", type=str, default=None)
        p.add_argument("--load_dir", type=str, default=None)
        p.add_argument("--load_run_name", type=str, default=None,
                       help="run to load weights from (reference "
                            "mmrec_prefix.py:612-618); default: run_name")
    # mmrec_prefix transfer flags
    p.add_argument("--transfer_domain", type=str, default=None,
                   help="office | tool (adds item_domain_{i} tokens)")
    p.add_argument("--only_test", default=False, action="store_true")
    # ---- additions of the JAX package ----
    p.add_argument("--tokenizer_path", type=str, default=None,
                   help="tokenizer.json; default builds from corpus.txt")
    p.add_argument("--n_items", type=int, default=None,
                   help="item-vocab size override (else per-subset table)")
    p.add_argument("--history_len", type=int, default=None)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_tp", type=int, default=1)
    p.add_argument("--seq_shard", default=False, action="store_true",
                   help="sequence-parallel (ring) attention over the fsdp "
                        "mesh axis for long-context training")
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--no_eval_latent_cache", default=False,
                   action="store_true",
                   help="re-encode item images per batch at eval instead "
                        "of the encode-once device latent cache")
    p.add_argument("--max_records", type=int, default=None,
                   help="truncate datasets (smoke runs)")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="capture a profiler trace of the first epoch's training "
                        "and evals (mmrec_eval: the evals), the program's spans "
                        "among its events")
    p.add_argument("--num_beams", type=int, default=10)
    p.add_argument("--kv_int8", default=False, action="store_true",
                   help="int8 decode KV caches (prompt + latent + "
                        "generated) with per-position f32 scales: halves "
                        "cache memory and the decode kernels' KV bytes")
    p.add_argument("--remat", default=False, action="store_true",
                   help="checkpoint each LM/xattn block: recompute "
                        "activations in backward, trading FLOPs for HBM")
    p.add_argument("--remat_policy", type=str, default="none",
                   choices=["none", "dots"],
                   help="remat save policy: 'dots' saves matmul outputs "
                        "(dots_with_no_batch_dims_saveable) so backward "
                        "recomputes only cheap elementwise work; 'none' "
                        "recomputes everything (max memory savings)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, or cpu for the plain "
                        "versions of the kernels); no card with cuda raises")
    p.add_argument("--eval_param_dtype", type=str, default="bf16",
                   choices=["bf16", "fp32", "int8"],
                   help="cast params for eval/serving (bf16 halves the "
                        "weight bandwidth of decode; int8 = weight-only "
                        "quantized matmul kernels — the reference worker's "
                        "load_in_8bit equivalent — halving it again and "
                        "freeing HBM for bigger eval batches)")
    return p


def variant_name(args) -> str:
    """Map reference model names onto variant registry keys."""
    name = args.pretrained_model_name_or_path
    aliases = {
        "openflamingo/OpenFlamingo-3B-vitl-mpt1b": "3b-mpt",
        "openflamingo/OpenFlamingo-3B-vitl-mpt1b-langinstruct": "3b-mpt-instruct",
        "openflamingo/OpenFlamingo-4B-vitl-rpj3b": "4b",
        "openflamingo/OpenFlamingo-4B-vitl-rpj3b-langinstruct": "4b-instruct",
        "openflamingo/OpenFlamingo-9B-vitl-mpt7b": "9b",
        "3b": "3b-mpt",
    }
    return aliases.get(name, name)
