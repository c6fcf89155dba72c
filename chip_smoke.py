#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unimp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card check: needs CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port from ``csrc/`` (one
     nvcc per source) and the host Zstandard decoder (``zstd_host.cc``,
     the host c++), all at once, and prints the build seconds;
  3. kernels vs plain: the flash-attention forward (K1), its backward
     dK/dV (K2) and dQ (K3), split-cache beam decode (K4) and single-query
     media read (K5), each of K4/K5 also with int8 KV caches, and the int8
     weight matmul (K6) against their plain PyTorch versions at the 4b
     main-path shapes (eval for K1/K4/K5/K6, training for K2/K3) and at
     extra shapes (head dim 128 + ALiBi, causal + kv_start windows,
     all_previous, fully masked rows, GQA, K1/K2/K3 at 1 x 1 and 65 x 65,
     K2/K3 at 63 keys, decode steps 1 / 17 / 50 with random beam_sel and
     with beams sharing their first 20 ancestors, K4 at 1 / 16 / 17 beams
     and ragged prompt windows, the other tasks' decodes (greedy to 600 positions, 5 beams
     to 256, 2 beams to 40; K5 over 9 media at 5 and 2 beams), K2/K3 at the ViT's
     training shape (257 keys), K5 with one tile of five allowed, K6 at one row, off its
     tiles, at 256 / 300 / 512 rows, split-K over a ragged K, aligned
     and not, and with strided weight rows; phase 11's serving wave: K1's
     4 x 64 prefill with an all-pad row (0, lse -1e30), K4 at 4 slots, one
     query, T 64, 32 gen positions with two empty prompt windows, K5 over one
     medium with a fully masked row, K6 at the 4-row decode and 256-row
     prefill shapes; phase 12's 3b-mpt training: K1 / K2 / K3 at 3 x 16
     heads, 256 x 256, d128, causal + ALiBi + kv_len and the x-attn over
     384 latents, K6 at its 180-row test-pass decode; phase 15's K1
     1,000-row ImageNet forward and its x-attn, K4 / K5 at the 3-beam
     captioning decode; phase 16's ``CausalLM``: K4 at 24 prompts of 128,
     K6 at M = 24 on the fused QKV, o, MLP up, down and the 2560 x 50432
     head; phase 18's 9b (32 heads of 128, ALiBi, width 4096): K1 at its
     prefill, x-attn prefill and training forward, K2 / K3 at its
     training shapes, K4 / K5 (bf16 and int8 KV) at its 10-beam decode, K6
     at its decode widths at 240 and 120 rows (timed) and 24 rows and the
     4096 x 8576 head (checked); and
     ``QuantMatmulFn``'s backward (the int8 frozen backbone's dx) against
     the gradient through the dequantized weight), in bfloat16 and
     float32, with the tolerances below; times each kernel (CUDA events)
     beside its plain version, its bound and a one-call yardstick
     (``scaled_dot_product_attention`` forward, or its backward through
     autograd, with ALiBi as a float bias, and the backend it picks;
     ``torch._weight_int8pack_mm`` and the bf16 matmul for K6; the port
     never calls them);
  4. the ``small`` variant in float32, once on the card (kernels) and once
     on the CPU (plain versions): the beam eval (token agreement, prefill
     logit difference), with float weights and again with int8 weights and
     int8 KV caches; in bfloat16 on the card, the beam eval through K4 / K5
     against the same eval with the plain decode attention (token
     agreement); then one ``Trainer`` step (loss, every trainable
     gradient, skipped flag), and one more with each headline training
     flag alone (``--frozen_int8``, ``--bf16_opt_state``, ``--remat
     --remat_policy dots``) and with all three; then, card vs CPU again,
     the other tasks'
     decodes (exp 5 beams to 256, img_sel 2 beams over 9 images, img_gen
     greedy to 600; token agreement); the CPU sides run in a spawned
     process of their own (``small_cpu_sides``, half the host's cores) from
     the start of the run, with phase 18 (d)'s, and the card sides after
     phase 17;
  5. the ``4b-instruct`` 10-beam rec eval at full width (random seeded
     weights, gates opened): a 256-item catalogue encoded once by the item
     latent cache, two batches of 24 prompts (T=128, 4 images each), beam
     search with 10 beams / 10 returned / 50 new tokens, HR/NDCG/MRR@{3,5,10};
     prints items/s, peak memory and each kernel's launch count;
  6. the ``4b-instruct`` rec training step at full width (random seeded
     weights, gates opened, bf16 frozen backbone, f32 trainable masters):
     micro-batch 3 x accum 2 of synthetic rec prompts (T=256, 6 images of
     224 px each, one <answer> span), focal loss gamma 2 with reweight,
     AdamW at constant lr 1e-4; 2 warm-up then 5 timed steps on one fixed
     batch; prints samples/s, step ms, MFU, peak memory, every loss, the
     K1/K2/K3 launches per step and a profile of one step;
  7. the ``4b-instruct`` rec eval of phase 5 with int8 weights
     (``build_model(eval_param_dtype="int8")``: bf16, then weight-only
     int8) and int8 KV caches: the same weights, catalogue and prompts;
     prints items/s, peak memory, the model's bytes, the batch's model
     FLOPs, each kernel's launches (K6 must run 193 times a decode step
     and once a batch for the prefill head; the float decode kernels not
     at all) and a profile of one batch;
  8. the rec eval from files through the port's own CLI: the port's synth
     writer puts a beauty dataset (4,167 items, 288 users, 64 px JPEGs)
     on disk (phases 8 and 9 share it), then
     ``unimp_tpu_torch.cli.mmrec_eval.main`` runs
     4b-instruct (bf16, seeded weights) over its 48 test users in 2
     batches of 24: tokenizer, prompts, loader, the latent cache, 10-beam
     search, answers, HR/NDCG/MRR, the dump and ``eval_results.json``;
     fails unless both files hold 48 users with metrics in [0, 1], K1
     ran, K4 ran 32 and K5 16 times a decode step, and neither PIL nor
     ``tokenizers`` was imported; prints vocab sizes, prompt T, data /
     catalogue / batch seconds, items/s, peak memory, launches, a
     profile of the second batch's generate;
  9. rec training from the same files through the port's own CLI:
     ``unimp_tpu_torch.cli.mmrec.main`` at 4b-instruct width, 16 of its 32 LM layers
     with the reference's training shape (micro-batch 3 x accum 2 fused,
     gamma 2 with reweight, bf16 frozen backbone, the vision-tower cache
     of all 4,167 items), one epoch of 24 train users (4 updates), the
     10-beam test pass over 24 users and ``final_weights`` (the epoch's
     ``weights_epoch_0`` and ``checkpoint_0`` are not written: nothing
     reads them; phases 12 and 13 write ``checkpoint_0``, and
     ``weights_epoch_0`` is ``final_weights``' writer under another
     name); then ``final_weights`` read
     back and held to the trained tensors bit for bit, and
     ``mmrec_eval --load_weights_name final_weights`` in bf16 (tokens
     agree >= 0.9 with the training run's test pass) and with int8
     weights and int8 KV (K6 97 times a decode step at 16 layers and once a batch);
     fails unless K1 / K2 / K3 ran perceiver + x-attn + LM layers times
     each micro-batch and no ViT layer in a step, the cache ran the ViT
     once a chunk, every loss is finite and no step skipped; with
     ``--save_hf_model`` the run also writes ``final_weights_torch.pt``
     (phase 14 (a)), and ``mmrec_eval --load_weights_name
     final_weights_torch.pt`` must give the bf16 reload's tokens and rec
     metrics from tensors equal to its bit for bit; prints the
     disk and host memory, the cache's seconds and bytes, each step's ms
     and the StepTimer's samples/s, the checkpoint write and read
     seconds and bytes, peak device memory, the host's peak RSS and both
     reload evals' items/s; deletes its run directory;
 10. the other tasks, multi-task training and the transfer entry through
     the port's own CLIs at 4b-instruct width, 16 of its 32 LM layers, on phase 8's
     files with the train split cut to 24 users (``phase_tasks``): (a)
     ``mmrec.main`` on the default four-task list (6 records a task),
     micro-batch 3 x accum 2 fused, bf16 frozen, the pixel path, then the
     rec, exp (with BERTScore), img_sel and search test passes over 24
     users each; (b) ``mmrec_eval --task img_gen`` over 24 users, greedy
     to 600 new tokens; (c) ``mmrec_prefix.main --transfer_domain office``
     on (a)'s ``final_weights``, 4 updates with the tower trained, a rec
     test pass, then ``--only_test``; fails unless each task's metrics
     are present and finite, the dumps exist, K4 ran once a layer and K5
     once a cross-attention layer each decode step, K1 / K2 / K3 ran once
     a layer each micro-batch (the ViT's K2 / K3 in (c) only), the
     restore with growth equals (a)'s weights bit for bit (new rows: the
     fresh init), and after (c)'s steps the resampler and x-attn are
     unchanged and the tower and LM moved; prints each task's seconds,
     decode steps, items/s and launches, checkpoint writes and peak
     memory;
 11. serving at 4b-instruct width and depth (``phase_serve``): a port
     controller and a port worker (built by ``serve/worker.py`` from its
     command line on phase 8's files, seeded weights, gates opened) on
     127.0.0.1 with 4 slots and chunks of 8; a warm-up request, one request
     alone (three inactive slots), then ``benchmarks/serve_bench.py``'s 16
     prompts at concurrency 4 (4 with a JPEG, 4 sampled at temperature 0.9
     with fixed seeds, one of them sent again) through ``cli_chat``'s
     ``stream_request``; then the same with ``--eval_param_dtype int8
     --kv_int8``. Fails unless every stream ends with a ``finish`` chunk and
     error code 0, the repeated sampled request gives one text, each
     wave's launches are what the code counts (K1, K4, K5; int8: K6 at
     every decode and <= 512-row prefill matmul, no float decode kernel),
     and the bf16 greedy tokens agree >= 0.9 with the unbatched
     ``StreamingGenerator`` fed the same tokens; prints TTFT p50 / p90,
     aggregate and per-stream tokens/s, requests/s, ms a decode step and
     a chunk, the device->host copies a chunk (the profiler's count over
     one request), peak memory and the launches; then the same requests
     on ``small`` in float32, whose greedy tokens must equal the unbatched
     streamer's free-running (agreement 1.0);
 12. the JAX package's headline training configuration through the
     port's CLI (``phase_headline_train``): ``mmrec.main`` on 3b-mpt
     (MPT-1B, ALiBi, d128, an x-attn block before every layer) at full
     width and depth on phase 8's files, ``--frozen_int8 --bf16_opt_state
     --remat --remat_policy dots --cache_vision_latents``, micro-batch 3 x
     accum 2 fused, 256 tokens and 6 images of 224 px a sample: (a) 3
     updates, the 10-beam test pass, ``checkpoint_0``, one update of
     epoch 1; (b) ``--resume_from_checkpoint`` and its first update; (c)
     2 updates without ``--remat``; (d) 2 with ``--frozen_bf16`` and float
     state. Fails unless every loss is finite, each update launched K1 /
     K2 / K3 as the code counts them (K1 again in each recompute), K6 ran
     96 times a decode step of the test pass, (b)'s weights, moments and
     int8 payloads equal what (a) saved bit for bit, and (b)'s loss is
     within 1e-3 of (a)'s; prints step ms, samples/s, MFU, busy share,
     launches per update, checkpoint bytes and seconds, and the peak
     memory of (a), (c) and (d);
 13. multi-GPU (``phase_multi_gpu``): phase 12's configuration with the
     train split cut to 24 users and 12 of its 24 LM layers, ``mmrec.main`` in
     ranks launched by ``python -m torch.distributed.run`` (this script's
     rank mode, the parent holding no model): (a) one rank over NCCL at
     micro-batch 6 x accum 2 (2 updates, the test pass and
     ``checkpoint_0``); (b) two ranks
     sharing the card over gloo (dp 2) at 3 x 2, the same global batches;
     (c) (b)'s ``checkpoint_0`` resumed in one rank; fsdp 2 and tp 2 for
     one update each when gloo takes their collectives on CUDA tensors;
     (a) and (b) at once, (c) launched when (a) ends and fsdp 2 / tp 2
     when (b) ends, each waiting for the run before it to pass. Fails unless every update launched K1 / K2 / K3 as counted and the
     test passes K4 / K5 / K6 at every decode step, (b)'s replicas agree
     after every update, (b)'s and fsdp 2's losses are within 1e-4 of
     (a)'s (tp 2's within 1e-3) and their grad norms within one bfloat16
     step, (b)'s test pass covers (a)'s 24 users, and (c)'s state equals
     (b)'s saved one, and each fsdp 2 rank's build peak (the model made
     tensor by tensor into its chunks; reset before the build, read after
     it) is at most its resident bytes plus its largest whole float32
     tensor plus ``BUILD_SLACK_GIB``; prints update ms, losses, the logged
     and the float32 grad norms, peak memory a rank, each rank's build
     peak and the run walls.
 14. the tools (``phase_tools``, after phase 13, on phase 8's files):
     (b) seeded 3b-mpt exported by ``tools/export_torch.py`` (float32,
     "mpt" names), then ``mmrec.main --load_from_original_checkpoint``
     with phase 12's levers, one update and the 10-beam test pass over 6
     users (no checkpoint written); (c) a byte-level BPE
     ``tokenizer.json`` learned here from the synthetic corpus (400
     merges), then ``mmrec_eval --tokenizer_path`` at 4b-instruct over 24
     users; (d) image features of a 640-item synthetic set through (c)'s
     tower (``tools/features.py``), semantic IDs, then ``mmrec_eval
     --use_semantic`` over 24 users; (e) a VQGAN decoder at taming's
     f16-1024 shapes (seeded) on phase 10's img_gen dump. Fails unless
     (b)'s ``[convert]`` report misses nothing and the weights right after
     the load equal ``freeze(source, "int8")`` bit for bit, (c)'s corpus
     round-trips and every added token encodes to its one id, (d)'s K1
     ran 24 layers a batch and card vs CPU features are within 2e-2 of
     max |f|, (e)'s card vs CPU image is within 1e-4 (float32, TF32 off),
     and the evals give 24 users' finite metrics with K4 / K5 at every
     decode step; prints export / convert GiB/s, (b)'s update ms and peak,
     items/s, ms an image;
 15. the few-shot harness (``phase_harness``): ``cli/evaluate.main`` on a
     seeded 4b-instruct checkpoint (``save_params``) with COCO, VQA,
     OK-VQA and 1,000-class ImageNet manifests of 8 records over the
     committed image fixtures (WebP, TIFF, arithmetic and lossless JPEG;
     each first decoded equal to its PIL array) and phase 8's JPEGs,
     ``--shots 0 4``, bf16; fails unless every metric is in range and K1 /
     K4 / K5 ran as the spies' counts of encodes, generates, decode steps
     and class forwards give, then the same harness on ``small`` in float32
     gives the card's and the CPU's tokens, classes and results alike;
     prints items/s a benchmark, the busy share and the peak memory;
 16. ``CausalLM`` at RedPajama-3B width (``phase_causal_lm``): 24 prompts
     of 128 tokens, 32 greedy new, bf16 then int8 weights with int8 KV;
     fails unless K1 ran once a layer, K4 (int8) once a layer a step and
     K6 4 times a layer a step plus the head, and ``small``'s LM gives the
     same tokens on the card and the CPU, logits within 1e-4; prints
     tokens/s and the peak memory.
 17. the JAX package's Orbax checkpoints (``phase_orbax``, after phase 8):
     (a) phase 8's seeded 4b-instruct (bf16, all 32 LM layers) evaluated
     over 24 users, its tree laid out as an Orbax checkpoint on the run's
     tmpfs by ``write_orbax_checkpoint`` (this script's writer: the card's
     machine has no JAX, Orbax or tensorstore), then ``mmrec_eval.main
     --load_weights_name`` on it; (b) every Zstandard-framed value of the
     committed JAX-written checkpoint (``tests/data/orbax``) through the C++
     decoder and ``data/zstd.py``, then the records decoded again and again
     to 256 MB; (c) that checkpoint's ``checkpoint_0`` resumed through
     ``mmrec.main`` for one update on the card and on the CPU. Fails unless
     the restored tree equals the source bit for bit, the beams equal the
     direct run's, K1 / K4 / K5 ran in the eval and K1 / K2 / K3 in the
     resume, the records decode equal, and the card's resume is within
     1e-5 (losses), ``SMALL_GRAD_TOL`` (moments) and 1e-2 LR (weights
     where the averaged gradient exceeds 1e-5; 2.01 LR elsewhere) of the
     CPU's; prints the write and restore GiB/s, items/s, the decoder's
     MB/s and thread count and the phase's seconds.
 18. 9b (CLIP ViT-L/14 + MPT-7B, ``openflamingo/OpenFlamingo-9B-vitl-mpt7b``
     through the CLIs) at full width and depth, seeded, vocab 8,576, on
     phase 8's files (``phase_9b``, in a process of its own beside phases
     5-8, 17 and 4): (d) its structure cut to 4 LM layers and 2 ViT
     layers, float32, card (kernels) vs CPU (plain versions): the 10-beam
     eval of 2 prompts of 64 (token agreement >= 0.9, prefill logits
     within 2e-3) and one ``Trainer`` step (losses within 1e-5, gradients
     and the norm within ``SMALL_GRAD_TOL``), and in bf16 the beam eval
     through K4 / K5 against the plain decode attention; (a)
     ``mmrec_eval.main`` bf16 and (b) int8 weights + int8 KV over 2 x 24
     users, 10 beams / 10 returned / 50 new tokens, launches as
     ``phase_cli`` and ``int8_launches`` count them; (c) ``mmrec.main``
     with phase 12's levers and the vision cache, 2 updates and the
     10-beam test pass over 12 users, no checkpoint (``phase_9b_train``),
     once the main line is past phase 6. Prints items/s, the build's and
     the eval's peaks, step ms, samples/s, MFU, losses, grad norms and
     launches; its gates are raised after its readings.
Phases 9 and 10 run 4b-instruct at 16 of its 32 LM layers, phase 13
3b-mpt at 12 of its 24 (``lm_layers``).
Every path is host-bound, so some phases run in spawned processes of their
own (``PhaseProcess``) beside the main line, which waits for each before
it needs the card's memory back: phase 4's CPU sides from the start of the
run, phase 18 beside phases 5-8, 17 and 4, phases 15-16 beside phases
9-10, phase 14 beside phase 11; each counts its own launches.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from unimp_tpu_torch.data import zstd_host
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.decode.streaming import StreamingGenerator
from unimp_tpu_torch.evals.latent_cache import ItemLatentCache
from unimp_tpu_torch.evals.metrics import rank_metrics_for_hits
from unimp_tpu_torch.models import compute_q_media, get_config
from unimp_tpu_torch.models.flamingo import media_allowed
from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.ops.attention_ref import (
    AttnMask,
    alibi_slopes,
    attention_ref,
    flash_bwd_dkv_ref,
    flash_bwd_dq_ref,
    window_mask,
)
from unimp_tpu_torch.ops.decode_attention import decode_attention_ref, single_query_attention_ref
from unimp_tpu_torch.ops.decode_attention_kernels import (
    decode_attention_cuda,
    single_query_attention_cuda,
)
from unimp_tpu_torch.ops.flash_attention import (
    flash_attention_cuda,
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
)
from unimp_tpu_torch.ops.quant_matmul import (QuantMatmulFn, default_max_rows, quant_matmul_cuda,
                                              quant_matmul_ref)
from unimp_tpu_torch.tools.from_flax import build_model
from unimp_tpu_torch.train.optimizer import ClippedAdamWCast, _square_sums, make_optimizer
from unimp_tpu_torch.train.partition import trainable_params
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.utils.flops import decode_flops, detect_peak_flops, train_step_flops
from unimp_tpu_torch.utils.quant import (
    QuantizedKernel,
    _quantize_leaf,
    count_quantized,
    quantize_kv,
    quantize_params_int8,
    quantized_bytes,
)

# H100 SXM published peaks (dense): memory 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain: float32 differs only by summation order; bfloat16 also
# by where p and the output round to 8 mantissa bits (K6: both sum exact
# products in f32, in another order, and round the scaled sum to bf16)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3
# K2/K3 and K6 vs plain: gradients and matmul outputs are not O(1) like
# attention outputs, so bf16 is held relative to their size: max |kernel -
# plain| <= 2e-2 * max |plain|, per gradient or output; float32 as above
# (atol = rtol = 1e-4)
REL_TOL = 2e-2
# a gradient that is 0 by construction (one visible key: the softmax has
# no gradient there) is f32 rounding noise of dp - delta on both sides
# (about 3e-7 for unit normal inputs at d64): where max |plain| is below
# NOISE_ATOL the kernel's is held to max |kernel| <= NOISE_ATOL instead
NOISE_ATOL = 1e-5
# small training step, card vs CPU, float32: max |d| <= 5e-4 * max |g| per
# trainable gradient. K1's online softmax gives O to about 1e-7 relative,
# and the cross-attention q / k projections' gradients pass through
# ds = p (dp - delta), delta = rowsum(dO * O): near-uniform attention over
# similar latents makes that a small difference of close numbers. On the
# CPU alone, 1e-7 relative noise on O moves those gradients (whole
# tensors, not single entries) by up to 1.5e-4 of max |g|; the card vs the
# CPU differ by 1.3e-4. Phase 3 holds K2 / K3 to their plain versions on
# identical inputs at 1e-4.
SMALL_GRAD_TOL = 5e-4

MEDIA_ID = 50431          # <image>
ITEM_BASE = 50432         # item_i tokens follow the base vocabulary
N_ITEM_TOKENS = 4167      # beauty's item count
EOS_ID = 0
SMALL_MEDIA_ID = 30000    # small variant (vocab 32768): items follow it
# synthetic placements of <answer> and <|endofchunk|> below <image>
ANSWER_ID, EOC_ID = 50430, 50429
SMALL_ANSWER_ID, SMALL_EOC_ID = 29999, 29998

EVAL_KERNELS = ("flash_fwd", "decode_attn", "single_query_attn")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
TASK_KERNELS = EVAL_KERNELS + TRAIN_KERNELS[1:]
INT8_KERNELS = ("flash_fwd", "decode_attn_int8", "single_query_attn_int8", "quant_matmul")
KERNELS = {
    "flash_fwd": ("unimp_tpu_torch/csrc/flash_fwd.cu",
                  "unimp_tpu/ops/flash_attention.py:108"),
    "flash_bwd_dkv": ("unimp_tpu_torch/csrc/flash_bwd.cu",
                      "unimp_tpu/ops/flash_attention.py:225"),
    "flash_bwd_dq": ("unimp_tpu_torch/csrc/flash_bwd.cu",
                     "unimp_tpu/ops/flash_attention.py:336"),
    "decode_attn": ("unimp_tpu_torch/csrc/decode_attn.cu",
                    "unimp_tpu/ops/decode_attention_pallas.py:119"),
    "single_query_attn": ("unimp_tpu_torch/csrc/decode_attn.cu",
                          "unimp_tpu/ops/decode_attention_pallas.py:415"),
    "decode_attn_int8": ("unimp_tpu_torch/csrc/decode_attn.cu",
                         "unimp_tpu/ops/decode_attention_pallas.py:119"),
    "single_query_attn_int8": ("unimp_tpu_torch/csrc/decode_attn.cu",
                               "unimp_tpu/ops/decode_attention_pallas.py:415"),
    "quant_matmul": ("unimp_tpu_torch/csrc/quant_matmul.cu",
                     "unimp_tpu/ops/quant_matmul.py:47"),
}
# the int8 matmuls of one 4b-instruct decode step, (K, N): launches a step
# (32 LM blocks: fused QKV, o, MLP up, down; 16 x-attn blocks: q, o, up,
# down; the lm head)
K6_DECODE = {"qkv_2560x7680": ((2560, 7680), 32), "o_2560x2560": ((2560, 2560), 32 + 2 * 16),
             "up_2560x10240": ((2560, 10240), 48), "down_10240x2560": ((10240, 2560), 48),
             "head_2560x54656": ((2560, 54656), 1)}
K6_PER_STEP = sum(n for _, n in K6_DECODE.values())  # 193
# the int8 matmuls of the serving wave's prefill at 256 rows, (K, N): LM q,
# k, v, o; MLP up, down; x-attn k, v over the latents (1,024 wide);
# perceiver q, o, MLP up, down (phase 11, ``k6_prefill_launches``)
K6_SERVE_PREFILL = {"lm_qkvo_2560x2560": (2560, 2560), "up_2560x10240": (2560, 10240),
                    "down_10240x2560": (10240, 2560), "xattn_kv_1024x2560": (1024, 2560),
                    "perceiver_qo_1024x1024": (1024, 1024),
                    "perceiver_up_1024x4096": (1024, 4096),
                    "perceiver_down_4096x1024": (4096, 1024)}
# phase 12's int8 frozen MPT-1B backbone in its 10-beam test pass (18 users:
# 180 rows), (K, N): the fused q/k/v, o, MLP up, down (the x-attn blocks and
# the tied head are trainable float)
K6_MPT_DECODE = {"qkv_2048x6144": (2048, 6144), "o_2048x2048": (2048, 2048),
                 "up_2048x8192": (2048, 8192), "down_8192x2048": (8192, 2048)}
# QuantMatmulFn's backward at MPT-1B's q and MLP down projections, 256 rows
# phase 18's 9b (MPT-7B backbone, width 4096, 32 layers, x-attn every 4):
# the int8 matmuls of a decode step, (K, N): the LM blocks' fused QKV, o
# (the x-attn blocks' q and o too), MLP up, down (the x-attn blocks' too);
# the test pass of (c) runs the LM blocks' only. 9b's tied head is a
# bfloat16 matmul: its 4096 x 8576 shape is checked, not timed
K6_9B_DECODE = {"qkv_4096x12288": (4096, 12288), "o_4096x4096": (4096, 4096),
                "up_4096x16384": (4096, 16384), "down_16384x4096": (16384, 4096)}
QMM_GRAD_CASES = {"mpt_q_m256_2048x2048": (256, 2048, 2048),
                  "mpt_down_m256_8192x2048": (256, 8192, 2048)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls.
    The device first sleeps for longer than the host needs to enqueue them
    all (1.5x the host time of the warm-up calls), so a kernel shorter
    than its Python wrapper's launch is timed on the device, not at the
    host's launch rate."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * iters * host_s + 1e-3, 0.5) * 2e9))  # cycles, <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50) -> float:
    """Host ms to enqueue one call of ``fn``, with the device held asleep
    meanwhile so that a full launch queue never makes the host wait."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * 2e9))  # 50 ms at <= 2 GHz
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------ phase 3: K1

def media_index(dev, b, sq, n_media, lat, first, gap):
    """(q_media [B, Sq], kv_media [B, n_media * lat]): an <image> every
    ``gap`` tokens from ``first``; queries before it have q_media 0 and see
    nothing under "immediate"."""
    pos = torch.zeros(b, sq, dtype=torch.int32, device=dev)
    for i in range(n_media):
        pos[:, first + i * gap] = 1
    qm = torch.cumsum(pos, 1, dtype=torch.int32)
    km = torch.arange(1, n_media + 1, device=dev, dtype=torch.int32).repeat_interleave(lat)
    return qm, km[None].expand(b, -1).contiguous()


def flash_cases(dev):
    """(name, main_path, q, k, v, kwargs) at the 4b shapes and extras."""
    g = torch.Generator(dev).manual_seed(0)

    def qkv(b, sq, skv, h, hkv, d):
        return [torch.randn(s, generator=g, device=dev) for s in
                ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]

    def media(b, sq, n_media, lat, first):
        return media_index(dev, b, sq, n_media, lat, first, 24)

    cases = []
    # main path (4b-instruct): ViT chunk of 64 images, perceiver, x-attn
    # prefill (4 media x 64 latents, "immediate"), LM prefill (causal,
    # left-padding window)
    cases.append(("vit_257x257_d64", True, *qkv(64, 257, 257, 16, 16, 64), {}))
    cases.append(("perceiver_64x320_d64", True, *qkv(64, 64, 320, 16, 16, 64), {}))
    qm, km = media(24, 128, 4, 64, 10)
    cases.append(("xattn_128x256_d80_immediate", True, *qkv(24, 128, 256, 32, 32, 80),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    kv_start = torch.randint(0, 29, (24,), generator=g, device=dev)
    cases.append(("lm_prefill_128_d80_causal_window", True, *qkv(24, 128, 128, 32, 32, 80),
                  dict(causal=True, kv_start=kv_start)))
    # the serving wave's LM prefill (phase 11): 4 slots left-aligned in a
    # 64-token window, the last an unused slot (all pad, kv_start 64)
    cases.append(("serve_prefill_4x64_d80_causal_pad_row", True, *qkv(4, 64, 64, 32, 32, 80),
                  dict(causal=True, kv_start=torch.tensor([0, 37, 12, 64], device=dev))))
    # phase 12's 3b-mpt training forward (MPT-1B: 16 heads, d128, ALiBi;
    # an x-attn block before every layer): micro-batch 3 of 256 tokens,
    # right padding; 6 images x 64 latents, "immediate"
    cases.append(("mpt_train_3x256_d128_causal_alibi_kvlen", True,
                  *qkv(3, 256, 256, 16, 16, 128),
                  dict(causal=True, alibi_slopes=alibi_slopes(16).to(dev),
                       kv_len=torch.tensor([256, 231, 204], device=dev))))
    qm, km = media_index(dev, 3, 256, 6, 64, 4, 31)
    cases.append(("mpt_xattn_train_3x256x384_d128_immediate", True,
                  *qkv(3, 256, 384, 16, 16, 128),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    # phase 15's ImageNet forward: 1,000 class prompts of 8 tokens (one
    # image each) through the LM's causal self-attention and the x-attn over
    # the image's 64 latents, "immediate"
    cases.append(("cls_1000x8_d80_causal", True, *qkv(1000, 8, 8, 32, 32, 80),
                  dict(causal=True)))
    qm, km = media_index(dev, 1000, 8, 1, 64, 0, 8)
    cases.append(("cls_xattn_1000x8x64_d80_immediate", True, *qkv(1000, 8, 64, 32, 32, 80),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    # phase 18's 9b (MPT-7B: 32 heads, d128, ALiBi): the eval's LM prefill
    # (causal, left-padding window) and x-attn prefill over 4 media, and
    # (c)'s training forward (3 x 256, right padding; 6 images)
    kv_start = torch.randint(0, 29, (24,), generator=g, device=dev)
    cases.append(("9b_lm_prefill_128_d128_causal_window_alibi", True,
                  *qkv(24, 128, 128, 32, 32, 128),
                  dict(causal=True, kv_start=kv_start, alibi_slopes=alibi_slopes(32).to(dev))))
    qm, km = media(24, 128, 4, 64, 10)
    cases.append(("9b_xattn_128x256_d128_immediate", True, *qkv(24, 128, 256, 32, 32, 128),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    cases.append(("9b_train_3x256_d128_causal_alibi_kvlen", True,
                  *qkv(3, 256, 256, 32, 32, 128),
                  dict(causal=True, alibi_slopes=alibi_slopes(32).to(dev),
                       kv_len=torch.tensor([256, 231, 204], device=dev))))
    qm, km = media_index(dev, 3, 256, 6, 64, 4, 31)
    cases.append(("9b_xattn_train_3x256x384_d128_immediate", True,
                  *qkv(3, 256, 384, 32, 32, 128),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    # extras
    cases.append(("mpt_256_d128_alibi_causal", False, *qkv(2, 256, 256, 16, 16, 128),
                  dict(causal=True, alibi_slopes=alibi_slopes(16).to(dev))))
    qm, km = media(4, 128, 4, 64, 40)  # rows before the first media: fully masked
    cases.append(("xattn_all_previous_d80", False, *qkv(4, 128, 256, 32, 32, 80),
                  dict(q_media=qm, kv_media=km, media_mode="all_previous")))
    cases.append(("xattn_immediate_masked_rows_d64", False, *qkv(4, 128, 256, 8, 8, 64),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    cases.append(("gqa_causal_window_d80", False, *qkv(2, 100, 100, 32, 8, 80),
                  dict(causal=True, kv_start=torch.tensor([3, 0], device=dev),
                       kv_len=torch.tensor([100, 77], device=dev))))
    # the tile edges: one query and one key; 65 (one key past a 64-key
    # tile, one row past a 64-row block), causal and not
    cases.append(("one_1x1_d64", False, *qkv(2, 1, 1, 4, 4, 64), {}))
    cases.append(("tile_edge_65_d80", False, *qkv(2, 65, 65, 8, 8, 80), {}))
    cases.append(("tile_edge_65_d128_causal", False, *qkv(2, 65, 65, 4, 4, 128),
                  dict(causal=True)))
    return cases


def flash_mask(kw) -> AttnMask:
    return AttnMask(causal=kw.get("causal", False), q_media=kw.get("q_media"),
                    kv_media=kw.get("kv_media"), media_mode=kw.get("media_mode"))


def flash_plain(q, k, v, kw):
    return attention_ref(q, k, v, flash_mask(kw), kv_len=kw.get("kv_len"),
                         kv_start=kw.get("kv_start"), alibi=kw.get("alibi_slopes"))


def flash_work(q, k, v, kw, out, lse):
    """(bytes, flops) the function needs: inputs read once, outputs
    written once; flops over the allowed (query, key) pairs."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    allowed = allowed_pairs(q, k, kw)
    pairs = b * sq * skv if allowed is None else int(allowed.sum())
    extra = [kw.get(n) for n in ("q_media", "kv_media", "kv_start", "kv_len", "alibi_slopes")]
    return nbytes(q, k, v, out, lse, *extra), 4.0 * d * h * pairs


def allowed_pairs(q, k, kw):
    """[B, Sq, Skv] bool of the (query, key) pairs the masks allow, or None."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    return window_mask(flash_mask(kw), b, skv, q.device, kw.get("kv_len"),
                       kw.get("kv_start")).allowed(b, sq, skv, q.device)


def sdpa_args(q, k, v, kw):
    """Inputs of the one-call yardstick (no GQA at the main-path shapes),
    prepared outside its timing: [B, H, S, D] and a bool mask, or with
    ALiBi a float bias in q's dtype ([B, H, Sq, Skv]: the slope times
    key - query, -inf where not allowed)."""
    allowed = allowed_pairs(q, k, kw)
    mask = None if allowed is None else allowed[:, None].contiguous()
    slopes = kw.get("alibi_slopes")
    if slopes is not None:
        sq, skv = q.shape[1], k.shape[1]
        rel = (torch.arange(skv, device=q.device)[None, :]
               - torch.arange(sq, device=q.device)[:, None]).float()
        bias = slopes.float()[:, None, None] * rel
        if mask is not None:
            bias = torch.where(mask, bias, float("-inf"))
        mask = bias.expand(q.shape[0], -1, -1, -1).to(q.dtype).contiguous()
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    return t(q), t(k), t(v), mask


def sdpa_backend(q, k, v, mask) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask)).name
    except (AttributeError, TypeError, ValueError, RuntimeError) as err:
        return f"not known ({type(err).__name__})"


# ------------------------------------------------------------ phase 3: K2/K3

XATTN_INTERLEAVED = "xattn_train_interleaved_latents"

def bwd_cases(dev):
    """(name, main_path, q, k, v, do, kwargs) at the 4b training shapes
    (LM self-attention, cross-attention, perceiver) and extras."""
    g = torch.Generator(dev).manual_seed(1)

    def qkvo(b, sq, skv, h, hkv, d):
        return [torch.randn(s, generator=g, device=dev) for s in
                ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, h, d))]

    cases = []
    # main path (4b-instruct training, micro-batch 3, T 256, 6 images):
    # LM causal + kv_len (right padding); x-attn over 6 x 64 latents,
    # "immediate", text before the first <image> fully masked; perceiver
    # over 18 images (256 patches + 64 latents)
    kv_len = torch.randint(200, 257, (3,), generator=g, device=dev)
    cases.append(("lm_train_3x256_d80_causal_kvlen", True, *qkvo(3, 256, 256, 32, 32, 80),
                  dict(causal=True, kv_len=kv_len)))
    qm, km = media_index(dev, 3, 256, 6, 64, 4, 31)
    cases.append(("xattn_train_3x256x384_d80_immediate", True,
                  *qkvo(3, 256, 384, 32, 32, 80),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    cases.append(("perceiver_train_18x64x320_d64", True, *qkvo(18, 64, 320, 16, 16, 64), {}))
    # the transfer entry trains the vision tower: 18 images of 257 tokens
    # (256 patches + CLS), 16 heads, d64, unmasked; one key past 4 tiles
    cases.append(("vit_train_18x16_257_d64", True, *qkvo(18, 257, 257, 16, 16, 64), {}))
    # phase 12's 3b-mpt training (16 heads, d128): the LM's causal ALiBi
    # self-attention with right padding, and the x-attn over 6 x 64 latents
    cases.append(("mpt_train_3x256_d128_causal_alibi_kvlen", True,
                  *qkvo(3, 256, 256, 16, 16, 128),
                  dict(causal=True, alibi_slopes=alibi_slopes(16).to(dev),
                       kv_len=torch.tensor([256, 231, 204], device=dev))))
    cases.append(("mpt_xattn_train_3x256x384_d128_immediate", True,
                  *qkvo(3, 256, 384, 16, 16, 128),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    # phase 18 (c)'s 9b training (32 heads, d128): the LM's causal ALiBi
    # self-attention and the x-attn over 6 x 64 latents
    cases.append(("9b_train_3x256_d128_causal_alibi_kvlen", True,
                  *qkvo(3, 256, 256, 32, 32, 128),
                  dict(causal=True, alibi_slopes=alibi_slopes(32).to(dev),
                       kv_len=torch.tensor([256, 231, 204], device=dev))))
    cases.append(("9b_xattn_train_3x256x384_d128_immediate", True,
                  *qkvo(3, 256, 384, 32, 32, 128),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    # the x-attn case with its latents interleaved (key j of image 1 + j %
    # 6): the same number of allowed pairs, but every 64-key tile holds
    # every image, so no warp can skip a tile; timed beside it
    km = (torch.arange(384, device=dev, dtype=torch.int32) % 6 + 1)[None].expand(3, -1)
    cases.append((XATTN_INTERLEAVED, False, *qkvo(3, 256, 384, 32, 32, 80),
                  dict(q_media=qm, kv_media=km.contiguous(), media_mode="immediate")))
    # extras
    cases.append(("mpt_256_d128_alibi_causal", False, *qkvo(2, 256, 256, 16, 16, 128),
                  dict(causal=True, alibi_slopes=alibi_slopes(16).to(dev))))
    qm, km = media_index(dev, 2, 128, 4, 64, 40, 24)
    cases.append(("xattn_all_previous_d80", False, *qkvo(2, 128, 256, 8, 8, 80),
                  dict(q_media=qm, kv_media=km, media_mode="all_previous")))
    cases.append(("kv_start_window_d64", False, *qkvo(2, 100, 140, 4, 4, 64),
                  dict(kv_start=torch.tensor([0, 17], device=dev),
                       kv_len=torch.tensor([140, 121], device=dev))))
    cases.append(("gqa_causal_window_d80", False, *qkvo(2, 100, 100, 32, 8, 80),
                  dict(causal=True, kv_start=torch.tensor([3, 0], device=dev),
                       kv_len=torch.tensor([100, 77], device=dev))))
    qm, km = media_index(dev, 2, 128, 4, 64, 40, 24)  # rows before the first media: fully masked
    cases.append(("xattn_immediate_masked_rows_d80", False, *qkvo(2, 128, 256, 8, 8, 80),
                  dict(q_media=qm, kv_media=km, media_mode="immediate")))
    # the tile edges: one query and one key; 65 (one past a 64-row tile)
    # causal, at d80 (fragments held in registers) and d128 (reloaded);
    # 63 keys (one short of a tile)
    cases.append(("one_1x1_d64", False, *qkvo(2, 1, 1, 4, 4, 64), {}))
    cases.append(("tile_edge_65_d80_causal", False, *qkvo(2, 65, 65, 8, 8, 80),
                  dict(causal=True)))
    cases.append(("tile_edge_65_d128_causal", False, *qkvo(2, 65, 65, 4, 4, 128),
                  dict(causal=True)))
    cases.append(("skv63_d80", False, *qkvo(2, 100, 63, 8, 8, 80), {}))
    return cases


def bwd_plain(kernel, q, k, v, do, lse, delta, kw):
    """The plain version of K2 ((dk, dv)) or K3 (dq)."""
    fn = flash_bwd_dkv_ref if kernel == "flash_bwd_dkv" else flash_bwd_dq_ref
    return fn(q, k, v, do, lse, delta, flash_mask(kw), kv_len=kw.get("kv_len"),
              kv_start=kw.get("kv_start"), alibi=kw.get("alibi_slopes"))


def check_rel(name, got, want, dtype, results, kernel, main):
    """float32: atol = rtol = 1e-4; bfloat16: max |d| <= REL_TOL *
    max |plain| (max |kernel| <= NOISE_ATOL where the plain one is
    rounding noise)."""
    err = (got.float() - want.float()).abs().max().item()
    size = want.float().abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    if dtype == torch.bfloat16 and size < NOISE_ATOL:
        ok, tol = got.float().abs().max().item() <= NOISE_ATOL, f"|kernel|<={NOISE_ATOL:g}"
    elif dtype == torch.bfloat16:
        ok, tol = err <= REL_TOL * size, f"{REL_TOL:g}*{size:.3g}"
    else:
        ok = torch.allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
        tol = f"{TOL[dtype]:g}"
    ok = ok and finite
    log(f"[check] {kernel:17s} {name:40s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
        f"tol={tol} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{kernel} {name} {dtype}: max_abs_err {err} (finite={finite})")
    if main and dtype == torch.bfloat16:
        results[kernel]["max_abs_err"] = max(results[kernel].get("max_abs_err", 0.0), err)


def phase_bwd_kernels(dev, dtype, results, timings):
    """K2 and K3 against their plain versions on the same (q, k, v, dO,
    lse from K1, delta); bf16 main-path shapes are also timed."""
    for name, main, q, k, v, do, kw in bwd_cases(dev):
        q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
        out, lse = flash_attention_cuda(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dk, dv = flash_bwd_dkv_cuda(*args, **kw)
        dq = flash_bwd_dq_cuda(*args, **kw)
        want_dk, want_dv = bwd_plain("flash_bwd_dkv", *args, kw)
        check_rel(f"{name} dk", dk, want_dk, dtype, results, "flash_bwd_dkv", main)
        check_rel(f"{name} dv", dv, want_dv, dtype, results, "flash_bwd_dkv", main)
        check_rel(f"{name} dq", dq, bwd_plain("flash_bwd_dq", *args, kw), dtype, results,
                   "flash_bwd_dq", main)
        if not (dtype == torch.bfloat16 and (main or name == XATTN_INTERLEAVED)):
            continue
        b, sq, h, d = q.shape
        allowed = allowed_pairs(q, k, kw)
        pairs = b * sq * k.shape[1] if allowed is None else int(allowed.sum())
        extra = [kw.get(n) for n in ("q_media", "kv_media", "kv_start", "kv_len")]
        read = nbytes(*args, *extra)
        # SDPA's backward through autograd computes dq, dk and dv in one call
        sq_, sk_, sv_, mask = sdpa_args(q, k, v, kw)
        sq_, sk_, sv_ = (x.requires_grad_() for x in (sq_, sk_, sv_))
        backend = sdpa_backend(sq_, sk_, sv_, mask)
        lib_out = F.scaled_dot_product_attention(sq_, sk_, sv_, attn_mask=mask)
        lib_do = do.transpose(1, 2).contiguous()
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (sq_, sk_, sv_), lib_do,
                                                         retain_graph=True))
        # K2: 4 products (s, dp, dv, dk) and K3: 3 (s, dp, dq), each
        # 2 * D flops per allowed (query, key) pair and head
        for kernel, fn, outs, n_mm in (
                ("flash_bwd_dkv", flash_bwd_dkv_cuda, (dk, dv), 4),
                ("flash_bwd_dq", flash_bwd_dq_cuda, (dq,), 3)):
            b_ms, b_by = bound(read + nbytes(*outs), n_mm * 2.0 * d * h * pairs, dtype)
            timings.append(dict(
                kernel=kernel, case=name,
                ms=cuda_ms(lambda: fn(*args, **kw)),
                plain_ms=cuda_ms(lambda: bwd_plain(kernel, *args, kw), iters=5),
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, sdpa_backend=backend))


# ------------------------------------------------------------ phase 3: K4/K5

def decode_case(dev, b, kb, t, g, h, hkv, d, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    bk = b * kb
    return dict(
        q=torch.randn(bk, h, d, generator=gen, device=dev),
        pk=torch.randn(b, hkv, t, d, generator=gen, device=dev),
        pv=torch.randn(b, hkv, t, d, generator=gen, device=dev),
        gk=torch.randn(bk, hkv, g, d, generator=gen, device=dev),
        gv=torch.randn(bk, hkv, g, d, generator=gen, device=dev),
        kv_start=torch.randint(0, t // 4, (b,), generator=gen, device=dev),
        sel=torch.randint(0, kb, (bk, g), generator=gen, device=dev, dtype=torch.int32),
    )


def check(name, got, want, dtype, results, kernel, main):
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and torch.allclose(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    log(f"[check] {kernel:17s} {name:40s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
        f"tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{kernel} {name} {dtype}: max_abs_err {err} (finite={finite})")
    if main and dtype == torch.bfloat16:
        results[kernel]["max_abs_err"] = max(results[kernel].get("max_abs_err", 0.0), err)


# ------------------------------------------------------------ phase 3: K4/K5

# (name, main path, (b, kb, t, g, h, hkv, d), options, int8 too): the 4b
# decode shape, beams sharing one ancestor for the first 20 positions (as a
# real beam search does), MPT d128 ALiBi, GQA 16/4 with prompt_len windows
# (fixed, and ragged per row with ALiBi at d64 / d128), greedy (K = 1), 16
# beams (one full tile of rows) and 17 (two groups), 130 gen positions (the
# kernel lists them 64 at a time)
K4_SPECS = [
    ("4b_b24_k10_d80", True, (24, 10, 128, 50, 32, 32, 80), {}, True),
    ("4b_b24_k10_d80_shared20", False, (24, 10, 128, 50, 32, 32, 80), dict(share=20), True),
    ("mpt_alibi_d128", False, (4, 10, 128, 50, 16, 16, 128), dict(alibi=True), False),
    ("gqa_prompt_len_d64", False, (3, 4, 64, 50, 16, 4, 64), dict(plen="fixed"), False),
    ("gqa_alibi_ragged_d64", False, (3, 4, 100, 50, 16, 4, 64),
     dict(alibi=True, plen="ragged"), True),
    ("gqa_alibi_ragged_d128", False, (3, 4, 100, 50, 16, 4, 128),
     dict(alibi=True, plen="ragged"), True),
    ("greedy_d80", False, (4, 1, 128, 50, 32, 32, 80), {}, True),
    ("k16_d80", False, (2, 16, 128, 50, 8, 8, 80), {}, True),
    ("k17_d64", False, (2, 17, 64, 30, 4, 4, 64), {}, False),
    ("long_gen_130_d64", False, (2, 5, 64, 130, 4, 4, 64), dict(share=70), True),
    # the other tasks' decodes at the 4b heads: img_gen greedy to 600 new
    # tokens (10 passes of 64 gen positions), exp 5 beams to 256, img_sel 2
    # beams to 40 (prompts with 9 images: T 256)
    ("4b_b24_k1_g600_d80", True, (24, 1, 128, 600, 32, 32, 80), {}, True),
    ("4b_b24_k5_g256_d80", True, (24, 5, 128, 256, 32, 32, 80), dict(share=8), True),
    ("4b_b24_k2_g40_d80", True, (24, 2, 256, 40, 32, 32, 80), dict(share=4), True),
    # the serving wave's decode (phase 11): 4 slots, one query each, a
    # 64-token window, 32 gen positions; two unused slots, whose prompt
    # window is empty (kv_start = T)
    ("serve_b4_k1_t64_g32_d80_two_empty", True, (4, 1, 64, 32, 32, 32, 80), dict(empty=2),
     True),
    # phase 15's captioning decode: one prompt of 4 shots (about 64 tokens),
    # 3 beams, 24 new tokens; phase 16's CausalLM: 24 prompts of 128, greedy
    # to 32
    ("harness_b1_k3_t64_g24_d80", True, (1, 3, 64, 24, 32, 32, 80), dict(share=4), False),
    ("lm_b24_k1_t128_g32_d80", True, (24, 1, 128, 32, 32, 32, 80), {}, True),
    # phase 18's 9b rec eval: 24 prompts of 128, 10 beams, 32 heads of 128,
    # ALiBi, step 50
    ("9b_b24_k10_d128_alibi", True, (24, 10, 128, 50, 32, 32, 128), dict(alibi=True), True),
]
# (name, main path, (b, kb, s, h, hkv, d), mask, int8 too): the 4b x-attn
# decode read (4 media x 64 latents, "immediate": one 64-latent tile in four
# allowed), random masks, one allowed run inside one tile of five, K = 16
# and K = 1; every mask but the main one leaves row 0 with nothing allowed
K5_SPECS = [
    ("4b_b24_k10_s256_d80", True, (24, 10, 256, 32, 32, 80), "immediate", True),
    ("gqa_masked_rows_d128", False, (4, 3, 96, 16, 4, 128), "random", True),
    ("d64", False, (4, 10, 320, 16, 16, 64), "random", False),
    ("one_tile_of_five_d80", False, (4, 10, 320, 32, 32, 80), "one_tile", True),
    ("k16_immediate_d80", False, (2, 16, 256, 8, 8, 80), "immediate", False),
    ("k1_d64", False, (3, 1, 100, 4, 4, 64), "random", False),
    # img_sel's 9 media (576 latents, the last one allowed) at exp's 5 beams
    # and img_sel's 2
    ("4b_b24_k5_s576_d80", True, (24, 5, 576, 32, 32, 80), "immediate", True),
    ("4b_b24_k2_s576_d80", True, (24, 2, 576, 32, 32, 80), "immediate", True),
    # the serving wave's media read (phase 11): one medium, row 0 a slot
    # without an image (nothing allowed)
    ("serve_b4_k1_s64_d80_masked_row", True, (4, 1, 64, 32, 32, 80), "immediate_masked_row",
     True),
    # phase 15's captioning read: 5 images (4 shots and the query), 3 beams
    ("harness_b1_k3_s320_d80", True, (1, 3, 320, 32, 32, 80), "immediate", False),
    # phase 18's 9b x-attn read: 4 media x 64 latents, 32 heads of 128
    ("9b_b24_k10_s256_d128", True, (24, 10, 256, 32, 32, 128), "immediate", True),
]


def k4_gen_rows(sel, kb, g, step, per_block):
    """Gen rows (ancestor, position) with position < step that some beam
    references, per batch row, summed: what the bound counts once. With
    ``per_block``, as the kernel loads them (once per group of 16 beams)."""
    bk = sel.shape[0]
    anc = sel[:, :step].clamp(0, kb - 1).long()
    group = (torch.arange(bk, device=sel.device) % kb // 16 if per_block
             else torch.zeros(bk, dtype=torch.long, device=sel.device))
    row = torch.arange(bk, device=sel.device) // kb
    key = ((row * (kb // 16 + 1) + group)[:, None] * kb + anc) * g \
        + torch.arange(step, device=sel.device)
    return int(torch.unique(key).numel())


def decode_bound(c, got, step, kb, g, h, hkv, d, elt, scale_bytes):
    """(bytes, flops) of K4 at ``step``: q and out once, each valid prompt
    row once (shared by the beams), each referenced gen row once, K and V
    (int8: plus their two f32 scales)."""
    b = c["pk"].shape[0]
    prompt_rows = int((c["hi"] - c["kv_start"]).clamp(min=0).sum())
    gen_rows = k4_gen_rows(c["sel"], kb, g, step, per_block=False)
    by = nbytes(c["q"], got, c["kv_start"]) + c["sel"][:, :step].numel() * 4 \
        + (prompt_rows + gen_rows) * hkv * 2 * (d * elt + scale_bytes)
    return by, 4.0 * d * h * kb * (prompt_rows + b * step), gen_rows


def phase_decode_kernels(dev, dtype, results, timings):
    """K4 and K5 against their plain versions, with float caches of q's
    dtype and with int8 caches; two launches must give the same
    bits, a row with nothing allowed exactly 0. bf16 main-path shapes are
    timed, K5 beside SDPA."""
    for name, main, shape, opt, with_int8 in K4_SPECS:
        b, kb, t, g, h, hkv, d = shape
        c = decode_case(dev, *shape, seed=len(name))
        c["kv_start"][:opt.get("empty", 0)] = t
        gen = torch.Generator(dev).manual_seed(len(name) + 100)
        if opt.get("share"):  # one ancestor for every beam of a row
            first = torch.randint(0, kb, (b, 1), generator=gen, device=dev, dtype=torch.int32)
            c["sel"][:, :opt["share"]] = first.repeat_interleave(kb, 0)
        c["hi"] = torch.full((b,), t, device=dev)
        if opt.get("plen") == "fixed":
            c["hi"] = torch.full((b,), t - 9, device=dev)
        elif opt.get("plen") == "ragged":
            c["hi"] = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
        kw = dict(kv_start=c["kv_start"], beam_sel=c["sel"] if kb > 1 else None,
                  alibi=alibi_slopes(h).to(dev) if opt.get("alibi") else None,
                  prompt_len=c["hi"] if opt.get("plen") else None)
        q = c["q"].to(dtype)
        variants = [("", "decode_attn", [c[n].to(dtype) for n in ("pk", "pv", "gk", "gv")], {})]
        if with_int8:
            (pk, pks), (pv, pvs), (gk, gks), (gv, gvs) = (quantize_kv(c[n]) for n in
                                                          ("pk", "pv", "gk", "gv"))
            variants.append(("_int8", "decode_attn_int8", [pk, pv, gk, gv],
                             dict(prompt_k_scale=pks, prompt_v_scale=pvs, gen_k_scale=gks,
                                  gen_v_scale=gvs)))
        for tag, kernel, caches, skw in variants:
            args, kws = (q, *caches), dict(kw, **skw)
            for step in sorted({1, 17, g}):
                got = decode_attention_cuda(*args, step=step, **kws)
                check(f"{name}_step{step}{tag}", got,
                      decode_attention_ref(*args, step=step, **kws), dtype, results, kernel, main)
            if not torch.equal(got, decode_attention_cuda(*args, step=g, **kws)):
                raise AssertionError(f"{kernel} {name}{tag}: two launches differ")
            if dtype != torch.bfloat16 or not (main or opt.get("share")):
                continue
            step, elt = g, caches[0].element_size()
            by, fl, gen_rows = decode_bound(dict(c, q=q), got, step, kb, g, h, hkv, d, elt,
                                            4 * bool(tag))
            read = k4_gen_rows(c["sel"], kb, g, step, per_block=True) * (h // hkv)
            log(f"[gen-rows] {kernel} {name}{tag} step{step}: the kernel loads {read} gen rows "
                f"({read * hkv * 2 * (d * elt + 4 * bool(tag)) / 1e6:.3f} MB), the bound "
                f"counts {gen_rows}; every ancestor row would be {b * kb * step}")
            if not main:
                continue
            b_ms, b_by = bound(by, fl, dtype)
            # timed with the step on the device, as the model passes it
            n_gen = torch.full((1,), step, dtype=torch.int32, device=dev)
            timings.append(dict(
                kernel=kernel, case=f"{name}_step{step}{tag}",
                ms=cuda_ms(lambda: decode_attention_cuda(*args, step=n_gen, **kws)),
                plain_ms=cuda_ms(lambda: decode_attention_ref(*args, step=step, **kws), iters=5),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))

    for name, main, (b, kb, s, h, hkv, d), mode, with_int8 in K5_SPECS:
        c = decode_case(dev, b, kb, s, 1, h, hkv, d, seed=len(name))
        q = c["q"].to(dtype)
        if mode.startswith("immediate"):
            kv_media = torch.arange(1, s // 64 + 1, device=dev,
                                    dtype=torch.int32).repeat_interleave(64)
            mask = media_allowed(kv_media[None].expand(b, -1),
                                 torch.full((b,), s // 64, device=dev), "immediate").contiguous()
            if mode == "immediate_masked_row":
                mask[0] = False
        else:
            gen = torch.Generator(dev).manual_seed(len(name))
            mask = torch.rand(b, s, generator=gen, device=dev) < 0.6
            if mode == "one_tile":  # latents 130-140: the third 64-latent tile only
                mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
                mask[:, 130:141] = True
            mask[0] = False  # a row with nothing allowed: gives 0
        variants = [("", "single_query_attn", (c["pk"].to(dtype), c["pv"].to(dtype)), {})]
        if with_int8:
            (k8, ks), (v8, vs) = quantize_kv(c["pk"]), quantize_kv(c["pv"])
            variants.append(("_int8", "single_query_attn_int8", (k8, v8),
                             dict(k_scale=ks, v_scale=vs)))
        for tag, kernel, (k, v), skw in variants:
            got = single_query_attention_cuda(q, k, v, mask, **skw)
            check(f"{name}{tag}", got, single_query_attention_ref(q, k, v, mask, **skw), dtype,
                  results, kernel, main)
            if not torch.equal(got, single_query_attention_cuda(q, k, v, mask, **skw)):
                raise AssertionError(f"{kernel} {name}{tag}: two launches differ")
            if not bool(mask[0].any()) and not bool((got[:kb] == 0).all()):
                raise AssertionError(f"{kernel} {name}{tag}: a row with nothing allowed is not 0")
            if not (dtype == torch.bfloat16 and main):
                continue
            n_ok = int(mask.sum())
            by = nbytes(q, got, mask) + n_ok * hkv * 2 * (d * k.element_size() + 4 * bool(tag))
            b_ms, b_by = bound(by, 4.0 * d * h * kb * n_ok, dtype)
            library_ms = None
            if not tag:  # SDPA takes float K / V only
                qs = q.reshape(b, kb, h, d).transpose(1, 2).contiguous()
                am = mask[:, None, None, :]
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, k, v,
                                                                            attn_mask=am))
            timings.append(dict(
                kernel=kernel, case=f"{name}{tag}",
                ms=cuda_ms(lambda: single_query_attention_cuda(q, k, v, mask, **skw)),
                plain_ms=cuda_ms(lambda: single_query_attention_ref(q, k, v, mask, **skw),
                                 iters=5),
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))


# ------------------------------------------------------------ phase 3: K6

def k6_cases():
    """(name, main_path, m, k, n, ldq): every 4b decode shape (M = 240 beam
    rows), the prefill head (M = 24), the serving wave's decode shapes (M =
    4 slots) and prefill shapes (M = 4 x 64 = 256 rows), phase 16's
    ``CausalLM`` decode (M = 24 prompts: the layer shapes and its 2560 x
    50432 head), odd shapes, and the edges of the
    bf16 tiling: a full 256-row block, two blocks (300), ``quant_dot``'s
    largest (512), a split-K shape whose K is neither a multiple of its
    split count nor of 64, the same unaligned (N % 16 != 0: the masked
    loads, the scalar epilogue and reduction), and the down shape's weight
    as a column slice of a wider one (strided rows). ldq None: q is
    contiguous."""
    cases = [(f"4b_decode_m240_{name}", True, 240, k, n, None)
             for name, ((k, n), _) in K6_DECODE.items()]
    cases += [(f"serve_decode_m4_{name}", True, 4, k, n, None)
              for name, ((k, n), _) in K6_DECODE.items()]
    cases += [(f"serve_prefill_m256_{name}", True, 256, k, n, None)
              for name, (k, n) in K6_SERVE_PREFILL.items()]
    cases += [(f"mpt_decode_m180_{name}", True, 180, k, n, None)
              for name, (k, n) in K6_MPT_DECODE.items()]
    cases += [(f"lm_decode_m24_{name}", True, 24, k, n, None)
              for name, ((k, n), _) in K6_DECODE.items() if not name.startswith("head")]
    # phase 18's 9b: every decode shape (M = 240 beam rows) and (c)'s test
    # pass over 12 users (M = 120, the int8 backbone); checked, not timed,
    # off its path: M = 24 (its prefill rows go above quant_dot's 512) and
    # the 4096 x 8576 head at 240 and 24 rows (tied: bfloat16)
    cases += [(f"9b_decode_m{m}_{name}", m != 24, m, k, n, None)
              for m in (240, 120, 24) for name, (k, n) in K6_9B_DECODE.items()]
    cases += [(f"9b_head_m{m}_4096x8576", False, m, 4096, 8576, None) for m in (240, 24)]
    cases += [("lm_head_m24_2560x50432", True, 24, 2560, 50432, None),
              ("4b_prefill_head_m24_2560x54656", True, 24, 2560, 54656, None),
              ("greedy_m1_2560x7680", False, 1, 2560, 7680, None),
              ("odd_m37_100x70", False, 37, 100, 70, None),
              ("odd_m1_72x130", False, 1, 72, 130, None),
              ("m256_down_10240x2560", False, 256, 10240, 2560, None),
              ("m300_down_10240x2560", False, 300, 10240, 2560, None),
              ("m512_qkv_2560x7680", False, 512, 2560, 7680, None),
              ("m512_down_10240x2560", False, 512, 10240, 2560, None),
              ("splitk_ragged_m240_1000x2560", False, 240, 1000, 2560, None),
              ("odd_splitk_m100_1000x130", False, 100, 1000, 130, None),
              ("strided_m240_down_10240x2560_ldq2688", False, 240, 10240, 2560, 2688)]
    return cases


def int8_weight(dev, k, n, seed):
    """A lecun-scaled random [K, N] weight, quantized as the model's are."""
    g = torch.Generator(dev).manual_seed(seed)
    return _quantize_leaf(torch.randn(k, n, generator=g, device=dev) / k**0.5)


def k6_timing(name, x, q, scale, out):
    """K6 against its plain version, its bound and two one-call
    yardsticks: ``torch._weight_int8pack_mm`` (the same function: int8
    weight [N, K], per-channel scale) where this torch runs it on the card,
    and the bf16 matmul against the weight dequantized beforehand (what the
    bf16 eval runs)."""
    m, k = x.shape
    n = q.shape[1]
    b_ms, b_by = bound(nbytes(x, q, scale, out), 2.0 * m * k * n, x.dtype)
    w_nk, lib_scale = q.t().contiguous(), scale.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, w_nk, lib_scale)
        torch.cuda.synchronize()
        library_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, lib_scale))
        library = "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError, TypeError) as err:
        library_ms = None
        library = ("torch._weight_int8pack_mm does not run here: "
                   + str(err).strip().splitlines()[0][:160])
    w_deq = q.to(x.dtype) * scale.to(x.dtype)
    return dict(kernel="quant_matmul", case=name, ms=cuda_ms(lambda: quant_matmul_cuda(x, q, scale)),
                plain_ms=cuda_ms(lambda: quant_matmul_ref(x, q, scale), iters=5),
                library_ms=library_ms, library=library,
                bf16_matmul_ms=cuda_ms(lambda: x @ w_deq), bound_ms=b_ms, bound_by=b_by,
                host_ms=host_ms(lambda: quant_matmul_cuda(x, q, scale)),
                bf16_matmul_host_ms=host_ms(lambda: x @ w_deq))


def phase_int8_kernels(dev, dtype, results, timings):
    """K6 against its plain version; bf16 main-path shapes are also timed."""
    gen = torch.Generator(dev).manual_seed(5)
    for name, main, m, k, n, ldq in k6_cases():
        q, scale = int8_weight(dev, k, ldq or n, seed=k + n)
        q, scale = q[:, :n], scale[:n].contiguous()  # ldq > n: a column slice
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        got = quant_matmul_cuda(x, q, scale)
        check_rel(name, got, quant_matmul_ref(x, q, scale), dtype, results, "quant_matmul", main)
        if dtype == torch.bfloat16 and (main or name == "m512_down_10240x2560"):
            timings.append(k6_timing(name, x, q, scale, got))
        del q, scale
    for name, (m, k, n) in QMM_GRAD_CASES.items():
        # the int8 frozen backbone under autograd (--frozen_int8): dx of
        # QuantMatmulFn (K6 forward, the matmul of the JAX custom VJP
        # backward) against the gradient through the dequantized weight in
        # float32
        q, scale = int8_weight(dev, k, n, seed=k + n)
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype).requires_grad_()
        g = torch.randn(m, n, generator=gen, device=dev).to(dtype)
        (dx,) = torch.autograd.grad(QuantMatmulFn.apply(x, q, scale), x, g)
        x32 = x.detach().float().requires_grad_()
        (want,) = torch.autograd.grad(x32 @ (q.float() * scale), x32, g.float())
        if dx.dtype != dtype:
            raise AssertionError(f"QuantMatmulFn {name}: dx is {dx.dtype}, x {dtype}")
        check_rel(f"{name} dx (QuantMatmulFn backward)", dx, want, torch.bfloat16, results,
                  "quant_matmul", False)


def phase_kernels(dev):
    results = {name: {} for name in KERNELS}
    timings = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, main, q, k, v, kw in flash_cases(dev):
            q, k, v = (x.to(dtype) for x in (q, k, v))
            got, lse = flash_attention_cuda(q, k, v, **kw)
            want, want_lse = flash_plain(q, k, v, kw)
            check(name, got, want, dtype, results, "flash_fwd", main)
            if not torch.allclose(lse, want_lse, atol=LSE_TOL, rtol=LSE_TOL):
                lse_err = (lse - want_lse).abs().max().item()
                raise AssertionError(f"flash_fwd {name} lse: max err {lse_err}")
            if kw.get("kv_start") is not None:  # a row whose window is empty: 0, lse -1e30
                dead = kw["kv_start"] >= k.shape[1]
                if not (bool((got[dead] == 0).all()) and bool((lse[dead] == -1e30).all())):
                    raise AssertionError(f"flash_fwd {name}: an all-pad row is not 0 / -1e30")
            if dtype == torch.bfloat16 and main:
                by, fl = flash_work(q, k, v, kw, got, lse)
                b_ms, b_by = bound(by, fl, dtype)
                sq_, sk_, sv_, mask = sdpa_args(q, k, v, kw)
                timings.append(dict(
                    kernel="flash_fwd", case=name,
                    ms=cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
                    plain_ms=cuda_ms(lambda: flash_plain(q, k, v, kw), iters=5),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        sq_, sk_, sv_, attn_mask=mask)),
                    bound_ms=b_ms, bound_by=b_by,
                    sdpa_backend=sdpa_backend(sq_, sk_, sv_, mask)))

        phase_bwd_kernels(dev, dtype, results, timings)

        phase_decode_kernels(dev, dtype, results, timings)
        phase_int8_kernels(dev, dtype, results, timings)
    for row in timings:
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        extra = "".join(f" {key}={row[key]:.4f}" for key in
                        ("bf16_matmul_ms", "host_ms", "bf16_matmul_host_ms") if key in row)
        if row["library_ms"] is not None:
            extra += f" kernel/library={row['ms'] / row['library_ms']:.2f}"
        if "sdpa_backend" in row:
            extra += f" sdpa={row['sdpa_backend']}"
        log(f"[time] {row['kernel']:22s} {row['case']:36s} kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={lib}{extra} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"kernel/bound={row['ms'] / row['bound_ms']:.1f}")
        if "library" in row and row["library_ms"] is None:
            log(f"[time] {row['kernel']} {row['case']}: {row['library']}")
    return results, timings


# ------------------------------------------------------------ phase 4

def open_gates(model) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("attn_gate", "ff_gate")):
                p.fill_(1.0)


def prompts(rng, b, t, n_media, n_items, min_len, media_id=MEDIA_ID, item_base=ITEM_BASE):
    """Right-padded prompts: random text (ids below media_id) with n_media
    <image> tokens, each followed by its item token; returns (ids,
    seq_len, image_ids, target item ids)."""
    seq_len = rng.integers(min_len, t + 1, size=b)
    ids = rng.integers(1, media_id, size=(b, t))
    image_ids = rng.integers(0, n_items, size=(b, n_media))
    for r in range(b):
        for i in range(n_media):
            p = 4 + i * ((seq_len[r] - 12) // n_media)
            ids[r, p] = media_id
            ids[r, p + 1] = item_base + image_ids[r, i]
        ids[r, seq_len[r]:] = EOS_ID
    return ids, seq_len, image_ids, rng.integers(0, n_items, size=b)


def small_eval_side(device, int8: bool = False) -> tuple:
    """One side of ``phase_small`` (card: kernels; CPU: plain versions):
    small variant, f32, gates open, the beam eval's tokens over both
    batches and the first batch's prefill logits; ``int8``: weight-only
    int8 (every kernel of at least 65,536 elements, f32 compute) and int8
    KV caches."""
    cfg = get_config("small", dtype="float32")
    model = build_model(cfg, device="cpu", seed=1)
    open_gates(model)
    if int8:
        quantize_params_int8(model, dtype=torch.float32)
    model = model.to(device)
    rng = np.random.default_rng(1)
    img = cfg.vision.image_size
    images = rng.integers(0, 256, size=(16, img, img, 3), dtype=np.uint8)
    gen_cfg = GenerationConfig(max_new_tokens=20, eos_id=EOS_ID, pad_id=EOS_ID,
                               num_beams=10, num_return_sequences=10, kv_int8=int8)
    cache = ItemLatentCache(model, lambda i: images[i], 16, chunk=8, device=device)
    gen = Generator(model, gen_cfg, media_id=SMALL_MEDIA_ID)
    rng = np.random.default_rng(2)
    outs, prefill = [], None
    for batch in range(2):
        ids, seq_len, image_ids, _ = prompts(rng, 2, 64, 4, 16, 48, SMALL_MEDIA_ID,
                                             SMALL_MEDIA_ID + 1)
        t_ids = torch.from_numpy(ids).to(device)
        lat = cache.gather(image_ids)
        tok, _ = gen.generate(t_ids, torch.from_numpy(seq_len).to(device), lat)
        outs.append(tok.cpu())
        if batch == 0:
            with torch.no_grad():
                logits, _ = model(t_ids, latents=lat,
                                  q_media=compute_q_media(t_ids, SMALL_MEDIA_ID))
            prefill = logits.cpu()
    return torch.cat(outs), prefill


def phase_small(dev, cpu_side, int8: bool = False):
    """small variant, f32, gates open: the beam eval on the card (kernels)
    against ``cpu_side``, the same eval on the CPU (plain versions; from
    ``SmallCpuSides``)."""
    toks, prefill = small_eval_side(dev, int8)
    cpu_toks, cpu_prefill = cpu_side
    agree = float((toks == cpu_toks).float().mean())
    diff = float((prefill - cpu_prefill).abs().max())
    tag = "[small-int8]" if int8 else "[small]"
    log(f"{tag} card vs cpu: token agreement={agree:.4f} "
        f"prefill max_abs_logit_diff={diff:.3e} (limits: agreement >= 0.9, diff <= 2e-3)")
    if not (agree >= 0.9 and diff <= 2e-3):
        raise AssertionError(f"{tag} small-variant path on the card disagrees with the CPU path")


def phase_small_bf16(dev, cfg=None, media_id=SMALL_MEDIA_ID, tag="[small-bf16]"):
    """small variant, bf16 weights and compute, gates open, on the card: the
    beam eval through K4 / K5 and again with the model's decode attention
    pointed at their plain versions (on the card too): the first check of
    the tensor-core decode kernels under a real beam_sel. ``cfg``: another
    model (phase 18 (d)'s 9b structure), whose items follow ``media_id``.
    Returns the token agreement and the launches."""
    from unimp_tpu_torch.models import layers

    cfg = cfg or get_config("small")
    model = build_model(cfg, device=dev, seed=1, eval_param_dtype="bf16")
    open_gates(model)
    rng = np.random.default_rng(1)
    img = cfg.vision.image_size
    images = rng.integers(0, 256, size=(16, img, img, 3), dtype=np.uint8)
    cache = ItemLatentCache(model, lambda i: images[i], 16, chunk=8, device=dev)
    gen = Generator(model, GenerationConfig(max_new_tokens=20, eos_id=EOS_ID, pad_id=EOS_ID,
                                            num_beams=10, num_return_sequences=10),
                    media_id=media_id)
    rng = np.random.default_rng(2)
    batches = [prompts(rng, 2, 64, 4, 16, 48, media_id, media_id + 1) for _ in range(2)]
    lat = [cache.gather(image_ids) for _, _, image_ids, _ in batches]

    def run():
        return torch.cat([gen.generate(torch.from_numpy(ids).to(dev),
                                       torch.from_numpy(seq_len).to(dev), x)[0].cpu()
                          for (ids, seq_len, _, _), x in zip(batches, lat)])

    kernel_lib.reset_launches()
    toks = run()
    launches = {k: kernel_lib.LAUNCHES[k] for k in ("decode_attn", "single_query_attn")}
    saved = layers.decode_attention, layers.single_query_attention
    layers.decode_attention, layers.single_query_attention = (decode_attention_ref,
                                                              single_query_attention_ref)
    try:
        plain = run()
    finally:
        layers.decode_attention, layers.single_query_attention = saved
    agree = float((toks == plain).float().mean())
    log(f"{tag} card, kernels vs plain decode attention: token agreement={agree:.4f} "
        f"(limit >= 0.9); launches {json.dumps(launches)}")
    if not (agree >= 0.9 and min(launches.values()) > 0):
        raise AssertionError(f"{tag} beam search through K4 / K5 disagrees with the plain "
                             "decode attention on the card")
    return agree, launches


# each task's decode (beams, new tokens) and media a prompt: exp 5 beams to 256,
# img_sel 2 beams to 40 over 9 images, img_gen greedy to 600
SMALL_TASKS = {"exp": (5, 256, 4), "img_sel": (2, 40, 9), "img_gen": (1, 600, 4)}


def small_tasks_side(device) -> dict:
    """One side of ``phase_small_tasks``: small variant, f32, gates open,
    each other task's decode tokens (one returned sequence, one batch of 2
    prompts)."""
    cfg = get_config("small", dtype="float32")
    model = build_model(cfg, device="cpu", seed=1)
    open_gates(model)
    model = model.to(device)
    rng = np.random.default_rng(3)
    img = cfg.vision.image_size
    images = rng.integers(0, 256, size=(16, img, img, 3), dtype=np.uint8)
    cache = ItemLatentCache(model, lambda i: images[i], 16, chunk=8, device=device)
    toks = {}
    for task, (beams, new, n_media) in SMALL_TASKS.items():
        ids, seq_len, image_ids, _ = prompts(rng, 2, 96, n_media, 16, 80, SMALL_MEDIA_ID,
                                             SMALL_MEDIA_ID + 1)
        gen_cfg = GenerationConfig(max_new_tokens=new, eos_id=EOS_ID, pad_id=EOS_ID,
                                   num_beams=beams, num_return_sequences=1)
        gen = Generator(model, gen_cfg, media_id=SMALL_MEDIA_ID)
        tok, _ = gen.generate(torch.from_numpy(ids).to(device),
                              torch.from_numpy(seq_len).to(device), cache.gather(image_ids))
        toks[task] = tok.cpu()
    return toks


def phase_small_tasks(dev, cpu_side):
    """small variant, f32, gates open: the other tasks' decodes on the card
    (kernels) against ``cpu_side``, the same decodes on the CPU (plain
    versions); token agreement as for the rec eval."""
    toks = small_tasks_side(dev)
    for task, (beams, new, n_media) in SMALL_TASKS.items():
        agree = float((toks[task] == cpu_side[task]).float().mean())
        log(f"[small-{task}] card vs cpu, {beams} beam(s), {new} new tokens, {n_media} images: "
            f"token agreement={agree:.4f} over {tuple(toks[task].shape)} (limit >= 0.9)")
        if agree < 0.9:
            raise AssertionError(f"[small-{task}] the card's decode disagrees with the CPU's")


# ------------------------------------------------------------ phase 5

def phase_4b(dev, gpu_line, int8: bool = False, timings=()):
    """The 4b-instruct 10-beam rec eval: bf16 weights (phase 5), or int8
    weights and int8 KV caches (phase 7, ``int8``; ``timings`` are phase
    3's, for K6's time per decode step)."""
    tag = "[4b-int8]" if int8 else "[4b]"
    cfg = get_config("4b-instruct")
    vocab = -(-(ITEM_BASE + N_ITEM_TOKENS) // 128) * 128
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0, eval_param_dtype="int8" if int8 else "bf16")
    open_gates(model)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.state_dict().values())
    log(f"{tag} {n_params / 1e9:.3f} B weights, vocab {vocab}, init {time.perf_counter() - t0:.1f} s, "
        f"model bytes {quantized_bytes(model) / 2**30:.3f} GiB (quantized_bytes), "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if int8:
        k6_step_report(model, timings)

    rng = np.random.default_rng(0)
    n_items, b, t = 256, 24, 128
    catalogue = rng.integers(0, 256, size=(n_items, 224, 224, 3), dtype=np.uint8)
    batches = [prompts(rng, b, t, 4, n_items, 100) for _ in range(2)]
    gen = Generator(model, GenerationConfig(max_new_tokens=50, eos_id=EOS_ID, pad_id=EOS_ID,
                                            num_beams=10, num_return_sequences=10,
                                            kv_int8=int8),
                    media_id=MEDIA_ID)

    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()          # the main path starts here
    t0 = time.perf_counter()
    cache = ItemLatentCache(model, lambda i: catalogue[i], n_items, chunk=64, device=dev)
    cache.gather(np.arange(n_items)[None])  # encode the whole catalogue once
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    per_user, batch_s = [], []
    for ids, seq_len, image_ids, targets in batches:
        t0 = time.perf_counter()
        lat = cache.gather(image_ids)
        tok, scores = gen.generate(torch.from_numpy(ids).to(dev),
                                   torch.from_numpy(seq_len).to(dev), lat)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        tok, scores = tok.cpu().numpy(), scores.cpu().numpy()
        if tok.shape != (b, 10, 50) or not np.isfinite(scores).all() \
                or tok.min() < 0 or tok.max() >= vocab:
            raise AssertionError(f"bad generate output: shape {tok.shape}, "
                                 f"finite={np.isfinite(scores).all()}")
        for row, target in zip(tok, targets):
            hits = (row[:, 0] == ITEM_BASE + target).astype(int)
            per_user.append(rank_metrics_for_hits(hits, ks=(3, 5, 10)))
    launches = dict(kernel_lib.LAUNCHES)  # the main path ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    metrics = {k: float(np.mean([u[k] for u in per_user])) for k in per_user[0]}
    if not all(0.0 <= v <= 1.0 for v in metrics.values()):
        raise AssertionError(f"metrics out of range: {metrics}")
    ips = b / batch_s[1]
    flops = decode_flops(cfg, b, t, 4, 10, 50)
    log(f"{tag} catalogue encode {encode_s:.2f} s; batch seconds {batch_s}")
    log(f"{tag} items/s={ips:.3f} (second batch, host clock) peak_mem={peak_gib:.2f} GiB "
        f"on {gpu_line}")
    log(f"{tag} model FLOPs per batch (decode_flops, 50 steps) {flops / 1e12:.3f} TFLOP; "
        f"{flops / batch_s[1] / 1e12:.2f} TFLOP/s on the second batch's wall")
    log(f"{tag} metrics {json.dumps(metrics)}")
    log(f"{tag} launches {json.dumps(launches)}")
    for name in INT8_KERNELS if int8 else EVAL_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {tag} eval path")
    if int8:
        check_int8_launches(cfg, launches, len(batches))
    ids, seq_len, image_ids, _ = batches[1]

    def run():
        return gen.generate(torch.from_numpy(ids).to(dev), torch.from_numpy(seq_len).to(dev),
                            cache.gather(image_ids))

    profile_run(f"{tag} batch", run, batch_s[1])
    return launches


def int8_launches(cfg, steps: int, n_batches: int) -> dict:
    """The int8 eval path's launches over ``steps`` decode steps: K4 int8
    once per LM layer a step, K5 int8 once per x-attn layer a step, K6 four
    times an LM block and an x-attn block a step, and for an untied head
    once more a step and once a batch at the prefill (193 a step at
    4b-instruct's depth; 160 at 9b's, whose tied head is a bfloat16
    matmul), and none of the float decode kernels."""
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    head = 0 if lm.tie_embeddings else 1
    per_step = 4 * lm.num_layers + 4 * n_xattn + head
    return {"decode_attn_int8": steps * lm.num_layers, "single_query_attn_int8": steps * n_xattn,
            "quant_matmul": steps * per_step + head * n_batches,
            "decode_attn": 0, "single_query_attn": 0}


def check_int8_launches(cfg, launches, n_batches, tag="[4b-int8]") -> None:
    """On the int8 path: the decode steps that ran, read from K4's int8
    launches (one per LM layer a step), and ``int8_launches`` of them."""
    steps, rest = divmod(launches["decode_attn_int8"], cfg.lm.num_layers)
    want = int8_launches(cfg, steps, n_batches)
    log(f"{tag} {steps} decode steps over {n_batches} batches; expected launches "
        f"{json.dumps(want)}")
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if rest or bad:
        raise AssertionError(f"int8 eval launches differ (got, expected): {bad}, rest {rest}")


# ------------------------------------------------------------ phase 6

def train_batch(rng, b, t, n_media, n_items, img, min_len, media_id=MEDIA_ID,
                item_base=ITEM_BASE, answer_id=ANSWER_ID, eoc_id=EOC_ID):
    """Synthetic rec training prompts: ``prompts`` (text, n_media <image>
    + item tokens, right padding) ending in "<answer> item
    <|endofchunk|>", with uint8 images and unit task weights."""
    ids, seq_len, _, targets = prompts(rng, b, t, n_media, n_items, min_len, media_id,
                                       item_base)
    ids[(ids == answer_id) | (ids == eoc_id)] = 1
    for r in range(b):
        n = seq_len[r]
        ids[r, n - 3:n] = (answer_id, item_base + targets[r], eoc_id)
    return {"input_ids": ids, "seq_len": seq_len, "weights": np.ones(b, np.float32),
            "images": rng.integers(0, 256, size=(b, n_media, img, img, 3), dtype=np.uint8)}


def small_train_side(device) -> tuple:
    """One side of ``phase_small_train``: small variant, f32, gates open,
    one Trainer step (accum 2): (loss, every trainable gradient, the
    step's loss, skipped)."""
    cfg = get_config("small", dtype="float32")
    batch = train_batch(np.random.default_rng(3), 4, 64, 2, 16, cfg.vision.image_size, 48,
                        SMALL_MEDIA_ID, SMALL_MEDIA_ID + 1, SMALL_ANSWER_ID, SMALL_EOC_ID)
    model = build_model(cfg, device="cpu", seed=1, train=True).to(device)
    open_gates(model)
    params = trainable_params(model)
    trainer = Trainer(model, make_optimizer(params), media_id=SMALL_MEDIA_ID,
                      answer_id=SMALL_ANSWER_ID, endofchunk_id=SMALL_EOC_ID,
                      pad_id=EOS_ID, gamma=2.0, use_reweight=True, accum_steps=2,
                      device=device)
    loss, _ = trainer.compute_grads(batch)
    grads = {n: p.grad.detach().cpu().clone() for n, p in params.items()}
    metrics = trainer.train_step(batch)
    return (float(loss), grads, float(metrics["loss"]), int(metrics["skipped_nonfinite"]))


def phase_small_train(dev, cpu_side):
    """small variant, f32, gates open: one Trainer step (accum 2) on the
    card against ``cpu_side``, the same step on the CPU from the same
    weights and batch."""
    (l_card, g_card, s_card, k_card), (l_cpu, g_cpu, s_cpu, k_cpu) = (small_train_side(dev),
                                                                      cpu_side)
    loss_rel = max(abs(l_card - l_cpu), abs(s_card - s_cpu)) / abs(l_cpu)
    worst, worst_name = 0.0, None
    for name, g in g_cpu.items():
        rel = float((g_card[name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[small-train] card vs cpu: loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}, "
        f"limit 1e-5); worst gradient {worst_name} max|d|/max|g|={worst:.2e} "
        f"(limit {SMALL_GRAD_TOL:g}); skipped {k_card} vs {k_cpu}")
    if not (loss_rel <= 1e-5 and worst <= SMALL_GRAD_TOL and k_card == k_cpu == 0):
        raise AssertionError("small-variant training step on the card disagrees with the CPU")


SMALL_FLAGS = {"frozen_int8": dict(frozen="int8"), "bf16_opt_state": dict(bf16=True),
               "remat_dots": dict(remat="dots"),
               "all_three": dict(frozen="int8", bf16=True, remat="dots")}
BF16_STEP = 2.0 ** -7  # one step of bfloat16's 8-bit significand, at most


def small_flag_side(label, device) -> tuple:
    """One side of ``phase_small_train_flags`` for one ``SMALL_FLAGS``
    entry: (loss, every gradient as float32, the step's loss, skipped,
    int8 kernels)."""
    kw = SMALL_FLAGS[label]
    cfg = get_config("small", dtype="float32")
    batch = train_batch(np.random.default_rng(3), 2, 64, 2, 16, cfg.vision.image_size, 48,
                        SMALL_MEDIA_ID, SMALL_MEDIA_ID + 1, SMALL_ANSWER_ID, SMALL_EOC_ID)
    if "remat" in kw:
        cfg = cfg.replace(remat=True, remat_policy=kw["remat"])
    bf16 = torch.bfloat16 if kw.get("bf16") else None
    model = build_model(cfg, device="cpu", seed=1, train=True,
                        frozen_dtype=kw.get("frozen")).to(device)
    open_gates(model)
    params = trainable_params(model)
    trainer = Trainer(model, make_optimizer(params, moment_dtype=bf16),
                      media_id=SMALL_MEDIA_ID, answer_id=SMALL_ANSWER_ID,
                      endofchunk_id=SMALL_EOC_ID, pad_id=EOS_ID, gamma=2.0,
                      use_reweight=True, device=device, grad_dtype=bf16)
    loss, _ = trainer.compute_grads(batch)
    grads = {n: g.detach().float().cpu() for n, g in trainer.optimizer.named_grads().items()}
    metrics = trainer.train_step(batch)
    return (float(loss), grads, float(metrics["loss"]), int(metrics["skipped_nonfinite"]),
            count_quantized(model))


def phase_small_train_flags(dev, cpu_sides):
    """small variant, f32, gates open: one Trainer step with each headline
    training flag alone (``--frozen_int8``, ``--bf16_opt_state``, ``--remat
    --remat_policy dots``), then all three, on the card against
    ``cpu_sides`` (the same steps on the CPU from the same weights and
    batch). Limits of ``phase_small_train``: the loss 1e-5 relative, each
    gradient 5e-4 of its largest entry; a bfloat16 gradient also one
    bfloat16 step of the entry (the two sides' float32 gradients may
    straddle a rounding boundary)."""
    for label, kw in SMALL_FLAGS.items():
        bf16 = kw.get("bf16")
        (l_card, g_card, s_card, k_card, q_card), (l_cpu, g_cpu, s_cpu, k_cpu, q_cpu) = (
            small_flag_side(label, dev), cpu_sides[label])
        loss_rel = max(abs(l_card - l_cpu), abs(s_card - s_cpu)) / abs(l_cpu)
        worst, worst_name = 0.0, None
        for name, g in g_cpu.items():
            excess = (g_card[name] - g).abs() - (BF16_STEP * g.abs() if bf16 else 0.0)
            rel = float(excess.max()) / max(float(g.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        log(f"[small-train-flags] {label}: card vs cpu loss {l_card:.6f} vs {l_cpu:.6f} (rel "
            f"{loss_rel:.2e}, limit 1e-5); worst gradient {worst_name} (max|d| - "
            f"{'one bf16 step' if bf16 else '0'}) / max|g| = {worst:.2e} (limit "
            f"{SMALL_GRAD_TOL:g}); int8 kernels {q_card} / {q_cpu}; skipped {k_card} / {k_cpu}")
        if not (loss_rel <= 1e-5 and worst <= SMALL_GRAD_TOL and k_card == k_cpu == 0
                and q_card == q_cpu and (q_card > 0) == ("frozen" in kw)):
            raise AssertionError(f"small-variant {label} training step on the card disagrees "
                                 "with the CPU")


def small_cpu_sides(out_dir) -> dict:
    """The CPU side of every card-vs-CPU check of phase 4 and of phase 18
    (d) (run apart, in a ``PhaseProcess``; (d)'s gradients saved under
    ``out_dir``), tensors as numpy arrays."""
    cpu = torch.device("cpu")
    sides = {"eval": small_eval_side(cpu), "eval_int8": small_eval_side(cpu, int8=True),
             "train": small_train_side(cpu),
             "flags": {label: small_flag_side(label, cpu) for label in SMALL_FLAGS},
             "tasks": small_tasks_side(cpu),
             "9b": nine_b_side(cpu, Path(out_dir) / "9b_weights.pt",
                               Path(out_dir) / "9b_cpu_grads.pt", draw=False)}
    return _tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, sides)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _phase_process_main(conn, fn, args, threads: int) -> None:
    import traceback

    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        msg = {"ok": fn(*args)}
    except BaseException:
        msg = {"error": traceback.format_exc()}
    conn.send(msg)
    conn.close()


class PhaseProcess:
    """``fn(*args)`` in a spawned process of its own with ``threads``
    intra-op threads, started now, so that it runs beside the phases that
    follow (the card and the host are mostly idle in each: the paths are
    host-bound); ``get`` waits for its result and raises its failure;
    ``close`` stops the process (on any exit of the run)."""

    def __init__(self, tag: str, fn, *args, threads: int):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_phase_process_main, args=(child, fn, args, threads))
        self.tag, self.threads, self.t0 = tag, threads, time.perf_counter()
        self.proc.start()
        child.close()
        self._result, self._done = None, False

    def get(self):
        if not self._done:
            t0 = time.perf_counter()
            try:
                msg = self._conn.recv()
            except EOFError:
                self.proc.join()
                raise AssertionError(f"{self.tag} its process exited {self.proc.exitcode} "
                                     f"before sending its result")
            if "error" in msg:
                raise AssertionError(f"{self.tag} failed in its process:\n{msg['error']}")
            self._result, self._done = msg["ok"], True
            log(f"{self.tag} done {time.perf_counter() - self.t0:.1f} s after its start, in a "
                f"process of its own ({self.threads} threads); waited "
                f"{time.perf_counter() - t0:.1f} s for it")
            self.close()
        return self._result

    def close(self) -> None:
        self._conn.close()
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()


def phase_4b_train(dev, gpu_line):
    """4b-instruct training at full width: micro-batch 3 x accum 2, T 256,
    6 images of 224 px per sample; 2 warm-up and 5 timed steps."""
    cfg = get_config("4b-instruct")
    vocab = -(-(ITEM_BASE + N_ITEM_TOKENS) // 128) * 128
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0, train=True, frozen_dtype=torch.bfloat16)
    open_gates(model)
    params = trainable_params(model)
    trainer = Trainer(model, make_optimizer(params), media_id=MEDIA_ID, answer_id=ANSWER_ID,
                      endofchunk_id=EOC_ID, pad_id=EOS_ID, gamma=2.0, use_reweight=True,
                      accum_steps=2, device=dev)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in params.values())
    n_all = sum(p.numel() for p in model.parameters())
    log(f"[4b-train] {n_all / 1e9:.3f} B params, {n_train / 1e9:.3f} B trainable (f32), "
        f"frozen bf16; init {time.perf_counter() - t0:.1f} s")

    b, t, n_media, warmup, timed = 6, 256, 6, 2, 5
    batch = train_batch(np.random.default_rng(4), b, t, n_media, 256, 224, 200)
    torch.cuda.reset_peak_memory_stats()
    kernel_lib.reset_launches()          # the training path starts here
    losses, norms, step_s = [], [], []
    for step in range(warmup + timed):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if int(metrics["skipped_nonfinite"]) or not (np.isfinite(losses[-1])
                                                     and np.isfinite(norms[-1])):
            raise AssertionError(f"step {step}: loss {losses[-1]}, grad norm {norms[-1]}, "
                                 f"skipped {int(metrics['skipped_nonfinite'])}")
        log(f"[4b-train] step {step} loss={losses[-1]:.6f} grad_norm={norms[-1]:.4f} "
            f"ce={float(metrics['ce']):.4f} answer_tokens={float(metrics['n_answer_tokens']):g} "
            f"{step_s[-1] * 1e3:.1f} ms")
    launches = dict(kernel_lib.LAUNCHES)  # the training path ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = warmup + timed
    mean_s = float(np.mean(step_s[warmup:]))
    flops = train_step_flops(cfg, b, t, n_media, frozen_backbone=True)
    mfu = flops / mean_s / detect_peak_flops()
    log(f"[4b-train] samples/s={b / mean_s:.3f} step_ms={mean_s * 1e3:.1f} "
        f"(mean of {timed} timed steps, host clock; each step {[round(x * 1e3, 1) for x in step_s]}"
        f" ms) MFU={100 * mfu:.2f}% ({flops / 1e12:.2f} TFLOP/step, bf16 dense peak) "
        f"peak_mem={peak_gib:.2f} GiB on {gpu_line}")
    log(f"[4b-train] losses {losses}")
    log(f"[4b-train] launches over {steps} steps {json.dumps(launches)}; per step "
        + json.dumps({k: v / steps for k, v in launches.items()}))
    n_xattn = -(-cfg.lm.num_layers // cfg.cross_attn_every_n)
    bwd = cfg.resampler.depth + n_xattn + cfg.lm.num_layers     # per micro-batch
    want = {"flash_fwd": (cfg.vision.num_layers + bwd) * 2 * steps,
            "flash_bwd_dkv": bwd * 2 * steps, "flash_bwd_dq": bwd * 2 * steps}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches on the training path, "
                                 f"expected {n}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    profile_run("4b train step", lambda: trainer.train_step(batch), mean_s)
    return launches


def k6_step_report(model, timings, rows: int = 240) -> None:
    """K6 over one 4b decode step of ``rows`` beam rows: its bound, the
    larger of (the int8 weights, their f32 scales and the bf16 activations
    in and out) over the memory rate and 2 * rows flops per weight over the
    bf16 peak, and its time from phase 3's per-shape times. Checks that
    K6_DECODE holds exactly the int8 weights the model streams a step (LM
    blocks; x-attn q, o and MLP, their K/V being cached; the lm head)."""
    streamed = sum(m.q.numel() for name, m in model.named_modules()
                   if isinstance(m, QuantizedKernel) and m.persistent
                   and (name.startswith("block_") or name == "lm_head.kernel"
                        or (name.startswith("xattn_")
                            and not name.endswith(("k_proj.kernel", "v_proj.kernel")))))
    table = sum(n * k * c for (k, n), c in K6_DECODE.values())
    if streamed != table:
        raise AssertionError(f"int8 weights a step: model {streamed}, K6_DECODE {table}")
    by = sum(c * (k * n + 4 * n + 2 * rows * (k + n)) for (k, n), c in K6_DECODE.values())
    b_ms, b_by = bound(by, 2.0 * rows * table, torch.bfloat16)
    rows_k6 = {r["case"]: r for r in timings if r["kernel"] == "quant_matmul"}

    def per_step(key):
        return sum(c * rows_k6[f"4b_decode_m240_{name}"][key]
                   for name, (_, c) in K6_DECODE.items())

    log(f"[4b-int8] K6 per decode step ({K6_PER_STEP} launches, {table / 1e9:.4f} G int8 "
        f"weights, M={rows}): {per_step('ms'):.3f} ms from phase 3's per-shape times "
        f"(the bf16 matmul on the dequantized weights {per_step('bf16_matmul_ms'):.3f} ms); "
        f"bound {b_ms:.4f} ms ({b_by}; bytes {by / HBM_BYTES_PER_S * 1e3:.4f} ms)")


# ------------------------------------------------------------ phase 8

CLI_USERS, CLI_BATCH = 48, 24


def write_cli_data(data) -> float:
    """The port's synth writer puts a beauty dataset (4,167 items, 64 px
    JPEGs, 288 users a split, 48 in eval and test) under ``data``;
    returns the seconds it took."""
    from unimp_tpu_torch.tools import synth_data

    t0 = time.perf_counter()
    synth_data.generate(str(data), subset="beauty", n_items=N_ITEM_TOKENS, n_users=288,
                        image_size=64, seed=0)
    return time.perf_counter() - t0


def phase_cli(dev, gpu_line, data, run_dir, write_s, variant="4b-instruct", extra=(),
              tag="[cli]", profile=True):
    """The 4b-instruct rec eval from files through the port's own CLI:
    ``unimp_tpu_torch.cli.mmrec_eval.main`` on ``write_cli_data``'s files
    tokenizes, builds prompts, batches, encodes the referenced catalogue
    once and runs the 10-beam search over 2 x 24 test users, bf16, seeded
    weights (gates closed, as an init leaves them). Spies around the
    evaluator's batches, the latent cache and the generator read the
    timings and the decode steps; the launch counts are the kernels'.
    ``variant`` and ``extra`` (more CLI flags; ``--eval_param_dtype int8
    --kv_int8`` checks the int8 path's launches) serve phase 18's 9b, which
    profiles no batch (``profile``)."""
    from unimp_tpu_torch.cli import common, mmrec_eval
    from unimp_tpu_torch.data.tokenizer import UniMPTokenizer
    from unimp_tpu_torch.evals import evaluators

    seen = {"batches": [], "encode_s": 0.0, "steps": 0, "generate_s": []}
    orig_batches = evaluators._generate_batches
    orig_ensure = ItemLatentCache._ensure
    orig_generate = Generator.generate
    orig_step = Generator._decode_step
    orig_build_model = common.build_model

    def batches(*args, **kw):
        for answers, batch, wall in orig_batches(*args, **kw):
            seen["batches"].append((batch["input_ids"].shape, wall))
            yield answers, batch, wall

    def ensure(self, ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_ensure(self, ids)
        torch.cuda.synchronize()
        seen["encode_s"] += time.perf_counter() - t0

    def generate(self, *args):
        t0 = time.perf_counter()
        out = orig_generate(self, *args)
        torch.cuda.synchronize()
        seen["generate_s"].append(time.perf_counter() - t0)
        seen["last"] = (self, args)
        return out

    def decode_step(self, *args, **kw):
        seen["steps"] += 1
        return orig_step(self, *args, **kw)

    def build_model_spy(args, tokenizer, **kw):
        seen["model"], seen["tokenizer"] = orig_build_model(args, tokenizer, **kw), tokenizer
        torch.cuda.synchronize()  # the eval's peak memory starts after the build's
        seen["build_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        seen["build_alloc_gib"] = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        return seen["model"]

    argv = ["--mmrec_path", str(data), "--external_save_dir", str(run_dir),
            "--run_name", "cli", "--pretrained_model_name_or_path", variant,
            "--subset", "beauty", "--task", "rec", "--single_task",
            "--n_items", str(N_ITEM_TOKENS), "--history_len", "5",
            "--patch-image-size", "224", "--eval_batch_size", str(CLI_BATCH),
            "--num_beams", "10", "--max_records", str(CLI_USERS), "--workers", "2",
            "--do_test", "--device", "cuda", *extra]
    int8 = "--kv_int8" in extra
    evaluators._generate_batches, ItemLatentCache._ensure = batches, ensure
    Generator.generate, Generator._decode_step = generate, decode_step
    common.build_model = build_model_spy
    try:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        kernel_lib.reset_launches()      # the main path starts here
        mmrec_eval.main(argv)
        torch.cuda.synchronize()
        launches = dict(kernel_lib.LAUNCHES)  # the main path ends here
        main_s = time.perf_counter() - t0
    finally:
        evaluators._generate_batches, ItemLatentCache._ensure = orig_batches, orig_ensure
        Generator.generate, Generator._decode_step = orig_generate, orig_step
        common.build_model = orig_build_model
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out_dir = run_dir / "cli"
    results = json.loads((out_dir / "eval_results.json").read_text())
    dump = json.loads((out_dir / "results" / "cli_rec_test_epoch_0_rank_0.json").read_text())
    corpus = (data / "corpus.txt").read_text().splitlines()
    base_vocab = len(UniMPTokenizer.from_corpus(corpus))

    metrics = results["rec"]
    rank = {k: v for k, v in metrics.items() if k.split("@")[0] in ("hr", "ndcg", "mrr")}
    cfg = seen["model"].cfg
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    steps = seen["steps"]
    want = {"decode_attn": lm.num_layers * steps, "single_query_attn": n_xattn * steps}
    if int8:
        want = int8_launches(cfg, steps, len(seen["batches"]))
    shapes = [shape for shape, _ in seen["batches"]]
    # the evaluator's wall at each batch's end, from the first batch's fetch
    wall = [w for _, w in seen["batches"]]
    batch_s = [b - a for a, b in zip([0.0] + wall[:-1], wall)]
    n_params = sum(t.numel() for t in seen["model"].state_dict().values())
    log(f"{tag} {variant}: {n_params / 1e9:.3f} B weights ({'int8 + int8 KV' if int8 else 'bf16'})"
        f"; vocab: base {base_vocab} (corpus), extended {len(seen['tokenizer'])}, "
        f"LM {lm.vocab_size} (padded to 128); prompt T {[s[1] for s in shapes]} (collate), "
        f"batches {[s[0] for s in shapes]}")
    log(f"{tag} data write {write_s:.2f} s (synth_data, {N_ITEM_TOKENS} JPEGs of 64 px); "
        f"main {main_s:.2f} s; catalogue encode {seen['encode_s']:.2f} s "
        f"(latent cache misses, decode + resize + ViT + perceiver)")
    log(f"{tag} batch seconds {batch_s} (fetch + encode misses + generate); generate seconds "
        f"{seen['generate_s']}; {steps} decode steps")
    log(f"{tag} items/s: evaluator {metrics['items_per_sec']:.3f} (users over the loop's wall, "
        f"the first batch's misses included), second batch {CLI_BATCH / batch_s[1]:.3f}; "
        f"peak_mem={peak_gib:.2f} GiB (the eval, after the build; the build, made tensor by tensor, "
        f"{seen['build_peak_gib']:.2f} GiB for {seen['build_alloc_gib']:.2f} GiB allocated after "
        f"it: {quantized_bytes(seen['model']) / 2**30:.2f} GiB of weights, the rest the fused "
        f"int8 decode QKV) on {gpu_line}")
    log(f"{tag} metrics {json.dumps(rank)}")
    log(f"{tag} launches {json.dumps(launches)}; expected {json.dumps(want)}")
    # the gates, after the readings
    if len(rank) != 9 or not all(0.0 <= v <= 1.0 for v in rank.values()):
        raise AssertionError(f"{tag} rec metrics missing or out of range: {metrics}")
    if metrics["n_users"] != CLI_USERS or not metrics["items_per_sec"] > 0 \
            or len(dump) != CLI_USERS:
        raise AssertionError(f"{tag} want {CLI_USERS} users scored and items/s > 0: "
                             f"{metrics}, {len(dump)} dump entries")
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if launches["flash_fwd"] <= 0 or bad or not 0 < steps <= 50 * len(seen["batches"]):
        raise AssertionError(f"{tag} launches differ (got, expected): {bad}; K1 "
                             f"{launches['flash_fwd']}; {steps} decode steps")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "tokenizers"))
    if loaded:
        raise AssertionError(f"{tag} modules the card's machine lacks were imported: {loaded}")
    log(f"{tag} launches as expected; PIL / tokenizers not imported")
    if profile:
        gen, args = seen["last"]
        profile_run(f"{tag} batch 2 generate", lambda: gen.generate(*args),
                    seen["generate_s"][-1])
    return launches


# ------------------------------------------------------------ phase 9

TRAIN_CLI_RECORDS = 24  # train users (4 updates of 3 x 2) and test users (one batch)
# phases 9 and 10 run 4b-instruct at full width and 16 of its 32 LM layers
# (8 of its 16 x-attn blocks; all 32 until phases 15-16 took their time)
LM_LAYERS_9_10 = 16


@contextlib.contextmanager
def lm_layers(n: int, variant: str = "4b-instruct"):
    """The CLIs' variant lookup (``cli/common.py``) gives ``variant`` with
    its first ``n`` LM layers: depth cut, width kept."""
    from unimp_tpu_torch.cli import common

    orig = common.get_config

    def cut(name, **kw):
        cfg = orig(name, **kw)
        if name == variant:
            cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, num_layers=n))
        return cfg

    common.get_config = cut
    try:
        yield
    finally:
        common.get_config = orig
# phase 9's checkpoints that nothing reads again: not written, to keep the
# script within its time (phases 12 and 13 write checkpoint_0;
# weights_epoch_0 is final_weights' writer under another name)
UNREAD_CHECKPOINTS = ("weights_epoch_0", "checkpoint_0")


@contextlib.contextmanager
def unread_checkpoints(names):
    """While entered, the port's checkpoints named in ``names`` (ones that
    nothing reads again) are not written: ``save_params`` under such a
    name and ``save_train_state`` of such a ``checkpoint_{e}`` return
    their path having built and written nothing. Yields {"unwritten": n},
    the checkpoints skipped. Phases 9, 12, 13 and 14 use it."""
    from unimp_tpu_torch.train import checkpoint as ckpt

    orig = {"params": ckpt.save_params, "state": ckpt.save_train_state}
    seen = {"unwritten": 0}

    def skipped(save_dir, name):
        seen["unwritten"] += 1
        return os.path.join(os.path.abspath(save_dir), name)

    def save_params(save_dir, model, name="final_weights"):
        if name in names:
            return skipped(save_dir, name)
        return orig["params"](save_dir, model, name)

    def save_train_state(save_dir, trainer, epoch):
        if f"checkpoint_{epoch}" in names:
            return skipped(save_dir, f"checkpoint_{epoch}")
        return orig["state"](save_dir, trainer, epoch)

    ckpt.save_params, ckpt.save_train_state = save_params, save_train_state
    try:
        yield seen
    finally:
        ckpt.save_params, ckpt.save_train_state = orig["params"], orig["state"]


def start_item_memo(data, size: int = 224):
    """Starts decoding and resizing to ``size`` every item of phase 8's
    files that ``ITEM_IMAGES`` lacks, by one process a host core; returns
    the function that waits for them and fills the memo."""
    import multiprocessing

    from unimp_tpu_torch.data.transforms import load_resized_uint8

    keys = [(os.path.join(str(data), "beauty", f"{i}.jpg"), size)
            for i in range(N_ITEM_TOKENS)]
    todo = [k for k in keys if k not in ITEM_IMAGES]
    if not todo:
        return lambda: None
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    pool = multiprocessing.get_context("spawn").Pool(workers)
    pending = pool.starmap_async(load_resized_uint8, todo, chunksize=32)

    def finish():
        try:
            for key, img in zip(todo, pending.get()):
                ITEM_IMAGES[key] = img
        finally:
            pool.terminate()
            pool.join()
        log(f"[memo] {len(todo)} item images decoded and resized to {size} px in "
            f"{time.perf_counter() - t0:.2f} s on {workers} host processes")
    return finish


def fill_item_memo(data, size: int = 224) -> None:
    """``ITEM_IMAGES`` filled with every item of phase 8's files (as
    ``start_item_memo``), waiting for them."""
    start_item_memo(data, size)()


@contextlib.contextmanager
def item_decode_memo(data, size: int = 224):
    """The datasets' item decode memoized in ``ITEM_IMAGES`` (the same file
    and size give the same image), so phases 9-14 decode the catalogue of
    phase 8's files once; the memo is filled first, by one process a host
    core (phase 9's vision cache then reads decoded items)."""
    from unimp_tpu_torch.data import dataset as dataset_mod

    fill_item_memo(data, size)
    orig = dataset_mod.load_resized_uint8

    def image(path, size):
        if (path, size) not in ITEM_IMAGES:
            ITEM_IMAGES[path, size] = orig(path, size)
        return ITEM_IMAGES[path, size]

    dataset_mod.load_resized_uint8 = image
    try:
        yield
    finally:
        dataset_mod.load_resized_uint8 = orig


RUN_TREE_PREFIX = "unimp_chip_smoke-"  # + the pid of the run that owns the tree
# the phases write about 90 GiB of checkpoints and .pt files in all, each
# deleted once read; the most alive at once is phase 9's final_weights
# (9.9 GiB) and final_weights_torch.pt (15.2 GiB), with the data files:
# a root needs this much free
RUN_TREE_GIB = 30


def _is_tmpfs(path: Path) -> bool:
    """Whether ``path`` lies on a tmpfs (its longest mount point's type)."""
    path, best = str(path.resolve()), ("", "")
    with open("/proc/mounts") as f:
        for line in f:
            point, kind = line.split()[1:3]
            if (path == point or path.startswith(point.rstrip("/") + "/")) \
                    and len(point) > len(best[0]):
                best = (point, kind)
    return best[1] == "tmpfs"


@contextlib.contextmanager
def run_tree():
    """The directory the phases write their files in: under ``$TMPDIR``
    when that is a tmpfs with ``RUN_TREE_GIB`` free, else under
    ``/dev/shm`` when it is one, else the checkout's ``runs/``. The card's
    machine takes at most 45 GiB of disk writes a run, deleted files
    included, so the tree wants a tmpfs, which holds it in host memory and
    frees it on deletion. The tree is ``RUN_TREE_PREFIX`` + this pid and
    is removed on the way out, on SIGTERM too (``main`` turns it into
    ``SystemExit``); a tree left by a run that was killed outright (its
    pid gone) is removed when the next run starts."""
    roots = [Path(tempfile.gettempdir()), Path("/dev/shm")]
    root = next((r for r in roots if r.is_dir() and _is_tmpfs(r)
                 and shutil.disk_usage(r).free >= RUN_TREE_GIB * 2**30), None)
    if root is None:
        root = Path(__file__).resolve().parent / "runs"
        root.mkdir(exist_ok=True)
    for old in root.glob(RUN_TREE_PREFIX + "*"):
        pid = old.name[len(RUN_TREE_PREFIX):]
        if pid.isdigit() and not Path("/proc", pid).exists():
            shutil.rmtree(old, ignore_errors=True)
    tree = root / f"{RUN_TREE_PREFIX}{os.getpid()}"
    tree.mkdir()
    try:
        yield str(tree)
    finally:
        shutil.rmtree(tree, ignore_errors=True)


def host_memory_line(path) -> str:
    """The disk under ``path`` and the host's memory, as the card's machine
    reports them."""
    du = shutil.disk_usage(path)
    mem = {line.split(":")[0]: line.split()[1] for line in open("/proc/meminfo")
           if line.startswith(("MemTotal", "MemAvailable"))}
    return (f"disk under {path}: {du.total / 2**30:.1f} GiB, {du.free / 2**30:.1f} GiB free; "
            f"host memory {int(mem['MemTotal']) / 2**20:.1f} GiB, "
            f"{int(mem['MemAvailable']) / 2**20:.1f} GiB available")


def counts() -> dict:
    """The launch counts, once the card has run what was enqueued."""
    torch.cuda.synchronize()
    return dict(kernel_lib.LAUNCHES)


def between(before: dict) -> dict:
    """Launches since ``before`` (a ``counts()``)."""
    after = counts()
    return {k: after[k] - before[k] for k in after}


def phase_train_cli(dev, gpu_line, data, run_dir):
    """Rec training from files through the port's own CLI, at 4b-instruct
    width, 16 of its 32 LM layers: ``unimp_tpu_torch.cli.mmrec.main`` on
    ``write_cli_data``'s files with the reference's training shape (micro-
    batch 3 x accum 2 fused, focal loss gamma 2 with reweight, bf16 frozen
    backbone, the vision-tower cache), one epoch over 24 train users (4
    updates), the 10-beam test pass over 24 users, and ``final_weights``
    (``UNREAD_CHECKPOINTS`` are not written).
    Then ``final_weights`` is read back and held to the trained tensors bit
    for bit, and ``mmrec_eval --load_weights_name final_weights`` runs in
    bf16 (its tokens held to the training run's test pass, agreement >=
    0.9) and with int8 weights and int8 KV (phase 7's launch check)."""
    import resource

    from unimp_tpu_torch.cli import common, mmrec, mmrec_eval
    from unimp_tpu_torch.evals import evaluators
    from unimp_tpu_torch.train import checkpoint as ckpt

    log(f"[train-cli] {host_memory_line(run_dir.parent)}")
    seen = {"steps": [], "writes": [], "generates": [], "decode_steps": 0}
    orig = {"cache": mmrec.build_tower_cache, "epoch": mmrec.train_one_epoch,
            "evals": mmrec.run_evals, "write": ckpt._write, "step": Trainer.train_step,
            "generate": Generator.generate, "decode_step": Generator._decode_step,
            "build": common.build_model, "export": mmrec.save_torch_checkpoint,
            "convert": mmrec_eval.load_torch_checkpoint}

    def export(model, path, family):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["export"](model, path, family)
        seen["export"] = (time.perf_counter() - t0, Path(path).stat().st_size, family)
        return out

    def convert(path, target):
        t0 = time.perf_counter()
        out = orig["convert"](path, target)
        seen["convert"] = (time.perf_counter() - t0, Path(path).stat().st_size)
        return out

    def cache(model, *args, **kw):
        before, t0 = counts(), time.perf_counter()
        out = orig["cache"](model, *args, **kw)
        torch.cuda.synchronize()
        seen["cache"] = (time.perf_counter() - t0, out.nbytes, tuple(out.shape), between(before))
        return out

    def epoch(*args, **kw):
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        orig["epoch"](*args, **kw)
        seen["train_launches"] = between(before)
        seen["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    def evals(*args, **kw):
        before, steps = counts(), seen["decode_steps"]
        out = orig["evals"](*args, **kw)
        seen["eval_launches"] = between(before)
        seen["eval_decode_steps"] = seen["decode_steps"] - steps
        return out

    def write(path, obj):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig["write"](path, obj)
        seen["writes"].append((Path(path).parent.name + "/" + Path(path).name,
                               time.perf_counter() - t0, Path(path).stat().st_size))

    def step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = orig["step"](self, batch)
        torch.cuda.synchronize()
        seen["steps"].append((time.perf_counter() - t0, float(metrics["loss"]),
                              float(metrics["grad_norm"]), int(metrics["skipped_nonfinite"])))
        return metrics

    def generate(self, *args):
        t0 = time.perf_counter()
        tok, scores = orig["generate"](self, *args)
        torch.cuda.synchronize()
        seen["generates"].append((time.perf_counter() - t0, tok.cpu().numpy()))
        return tok, scores

    def decode_step(self, *args, **kw):
        seen["decode_steps"] += 1
        return orig["decode_step"](self, *args, **kw)

    def build(args, tokenizer, **kw):
        seen["model"] = orig["build"](args, tokenizer, **kw)
        return seen["model"]

    common_argv = ["--mmrec_path", str(data), "--external_save_dir", str(run_dir),
                   "--pretrained_model_name_or_path", "4b-instruct", "--subset", "beauty",
                   "--task", "rec", "--single_task", "--n_items", str(N_ITEM_TOKENS),
                   "--history_len", "5", "--patch-image-size", "224",
                   "--max_records", str(TRAIN_CLI_RECORDS), "--eval_batch_size",
                   str(TRAIN_CLI_RECORDS), "--num_beams", "10", "--do_test",
                   "--workers", "2", "--device", "cuda"]
    train_argv = common_argv + ["--run_name", "train", "--batch_size", "3",
                                "--gradient_accumulation_steps", "2", "--fused_accumulation",
                                "--use_reweight", "--gamma", "2", "--frozen_bf16",
                                "--cache_vision_latents", "--num_epochs", "1",
                                "--logging_steps", "1", "--save_hf_model"]
    train_dir = run_dir / "train"

    def reload_argv(run_name, *extra, name="final_weights"):
        return common_argv + ["--run_name", run_name, "--load_dir", str(train_dir),
                              "--load_weights_name", name, *extra]

    (mmrec.build_tower_cache, mmrec.train_one_epoch, mmrec.run_evals, ckpt._write,
     Trainer.train_step, Generator.generate, Generator._decode_step, common.build_model,
     mmrec.save_torch_checkpoint, mmrec_eval.load_torch_checkpoint) = (
        cache, epoch, evals, write, step, generate, decode_step, build, export, convert)
    try:
        kernel_lib.reset_launches()          # the main path starts here
        t0 = time.perf_counter()
        with unread_checkpoints(UNREAD_CHECKPOINTS) as unread:
            trainer, state = mmrec.main(train_argv)
        torch.cuda.synchronize()
        train_main_s = time.perf_counter() - t0
        train_generates = list(seen["generates"])
        evals_after_training = seen["eval_launches"], seen["eval_decode_steps"]

        t0 = time.perf_counter()
        saved = ckpt.restore_params(str(train_dir), "final_weights")
        live = ckpt.model_tree(trainer.model)
        read_bytes, differ = 0, []
        for name, t in live.items():
            got = saved[name].to(dev)
            read_bytes += got.numel() * got.element_size()
            if got.dtype != t.dtype or not torch.equal(got, t):
                differ.append(name)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        n_tensors = len(live)
        extra = sorted(set(saved) - set(live))
        cfg = trainer.model.cfg
        n_trainable = sum(p.numel() for p in trainer.params.values())
        del trainer, saved, live, got, t
        gc.collect()
        torch.cuda.empty_cache()

        reload, pt_differ = {}, None
        # the bf16 reload of final_weights, then of final_weights_torch.pt
        # (phase 14 (a): the exporter's float32 of the same bf16 / float32
        # tensors, converted back), then int8 weights and int8 KV
        for label, dtype_args, name in (
                ("bf16", (), "final_weights"), ("pt", (), "final_weights_torch.pt"),
                ("int8", ("--eval_param_dtype", "int8", "--kv_int8"), "final_weights")):
            seen["generates"], seen["decode_steps"] = [], 0
            before = counts()
            t0 = time.perf_counter()
            results = mmrec_eval.main(reload_argv(f"reload_{label}", *dtype_args, name=name))
            torch.cuda.synchronize()
            reload[label] = (time.perf_counter() - t0, results["rec"], list(seen["generates"]),
                             between(before), seen["decode_steps"])
            tensors = seen.pop("model").state_dict()
            if label == "bf16":  # host copies, held to the .pt reload's tensors bit for bit
                bf16_tensors = {k: t.cpu() for k, t in tensors.items()}
            elif label == "pt":
                pt_differ = sorted(k for k, t in tensors.items() if k not in bf16_tensors
                                   or t.dtype != bf16_tensors[k].dtype
                                   or not torch.equal(t.cpu(), bf16_tensors[k]))
                pt_compared = len(tensors)
                del bf16_tensors
            del tensors
            gc.collect()
            torch.cuda.empty_cache()
        launches = counts()                  # the main path ends here
    finally:
        (mmrec.build_tower_cache, mmrec.train_one_epoch, mmrec.run_evals, ckpt._write,
         Trainer.train_step, Generator.generate, Generator._decode_step,
         common.build_model, mmrec.save_torch_checkpoint,
         mmrec_eval.load_torch_checkpoint) = (
            orig["cache"], orig["epoch"], orig["evals"], orig["write"], orig["step"],
            orig["generate"], orig["decode_step"], orig["build"], orig["export"],
            orig["convert"])
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    jsonl = [json.loads(line) for line in
             (train_dir / "train_metrics.jsonl").read_text().splitlines()]
    shutil.rmtree(run_dir)

    # --- checks
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    bwd = cfg.resampler.depth + n_xattn + lm.num_layers        # per micro-batch
    n_steps = len(seen["steps"])
    if n_steps != TRAIN_CLI_RECORDS // 6 or state["step"] != n_steps:
        raise AssertionError(f"[train-cli] {n_steps} steps, trainer step {state['step']}; "
                             f"want {TRAIN_CLI_RECORDS // 6}")
    bad_steps = [s for s in seen["steps"] if s[3] or not (np.isfinite(s[1]) and
                                                           np.isfinite(s[2]))]
    if bad_steps:
        raise AssertionError(f"[train-cli] non-finite or skipped steps: {bad_steps}")
    want_train = {"flash_fwd": bwd * 2 * n_steps, "flash_bwd_dkv": bwd * 2 * n_steps,
                  "flash_bwd_dq": bwd * 2 * n_steps}
    got_train = {k: seen["train_launches"][k] for k in want_train}
    cache_s, cache_bytes, cache_shape, cache_launches = seen["cache"]
    chunks = -(-N_ITEM_TOKENS // 64)
    if got_train != want_train or cache_launches["flash_fwd"] != cfg.vision.num_layers * chunks:
        raise AssertionError(f"[train-cli] training launches {got_train}, expected "
                             f"{want_train}; cache K1 {cache_launches['flash_fwd']}, expected "
                             f"{cfg.vision.num_layers * chunks}")
    ev_launches, ev_steps = evals_after_training
    want_ev = {"decode_attn": lm.num_layers * ev_steps, "single_query_attn": n_xattn * ev_steps}
    if ev_launches["flash_fwd"] <= 0 or any(ev_launches[k] != n for k, n in want_ev.items()) \
            or not 0 < ev_steps <= 50:
        raise AssertionError(f"[train-cli] test-pass launches {ev_launches}, expected "
                             f"{want_ev}; {ev_steps} decode steps")
    if differ or extra:
        raise AssertionError(f"[train-cli] final_weights differ from the trained model: "
                             f"{differ[:8]}, extra {extra[:8]}")
    train_tok = train_generates[-1][1]
    bf16_tok = reload["bf16"][2][-1][1]
    agree = float((train_tok == bf16_tok).mean())
    if agree < 0.9:
        raise AssertionError(f"[train-cli] bf16 reload agrees with the training run's test "
                             f"pass on {agree:.3f} of tokens (< 0.9)")
    for label, (_, metrics, _, _, _) in reload.items():
        if metrics["n_users"] != TRAIN_CLI_RECORDS or not metrics["items_per_sec"] > 0:
            raise AssertionError(f"[train-cli] {label} reload: {metrics}")
    pt_tokens = [g[1] for g in reload["pt"][2]]
    bf16_tokens = [g[1] for g in reload["bf16"][2]]
    pt_metrics = {k: v for k, v in reload["pt"][1].items() if k != "items_per_sec"}
    bf16_metrics = {k: v for k, v in reload["bf16"][1].items() if k != "items_per_sec"}
    if (pt_differ or len(pt_tokens) != len(bf16_tokens)
            or not all(np.array_equal(a, b) for a, b in zip(pt_tokens, bf16_tokens))
            or pt_metrics != bf16_metrics):
        raise AssertionError(f"[tools] (a) the .pt reload differs from the final_weights "
                             f"reload: tensors {pt_differ[:8] if pt_differ else pt_differ}, "
                             f"metrics {pt_metrics} vs {bf16_metrics}")
    _, _, _, int8_launches, int8_steps = reload["int8"]
    check_int8_launches(cfg, int8_launches, 1, tag="[train-cli]")
    if int8_launches["decode_attn_int8"] != lm.num_layers * int8_steps:
        raise AssertionError(f"[train-cli] int8 reload: K4 int8 {int8_launches} for "
                             f"{int8_steps} decode steps")

    # --- report
    writes = seen["writes"]
    log(f"[train-cli] 4b-instruct, vocab {lm.vocab_size}, {n_trainable / 1e9:.3f} B "
        f"trainable (f32), frozen bf16; main {train_main_s:.1f} s (build, cache, "
        f"{TRAIN_CLI_RECORDS // 6} steps, "
        f"the test pass, checkpoints) on {gpu_line}")
    log(f"[train-cli] vision cache: {cache_shape[0]} items in {cache_s:.2f} s (the ViT; the "
        f"items read from the memo), {cache_bytes / 2**30:.3f} GiB {list(cache_shape)} on "
        f"{gpu_line}")
    step_ms = [round(s[0] * 1e3, 1) for s in seen["steps"]]
    timer_sps = [r["samples_per_second"] for r in jsonl if "samples_per_second" in r]
    log(f"[train-cli] step ms {step_ms} (host clock, synchronized); StepTimer "
        f"samples_per_second {timer_sps} (micro-batch 3 over the step, as JAX logs it; "
        f"{6 / np.mean([s[0] for s in seen['steps'][1:]]):.3f} samples/s over steps 2-4) "
        f"on {gpu_line}")
    log(f"[train-cli] losses {[s[1] for s in seen['steps']]}; grad norms "
        f"{[round(s[2], 4) for s in seen['steps']]}")
    log(f"[train-cli] checkpoint writes (file, s, bytes): "
        f"{[(n, round(t, 2), b) for n, t, b in writes]}; total {sum(w[1] for w in writes):.2f} "
        f"s, {sum(w[2] for w in writes) / 2**30:.2f} GiB; {unread['unwritten']} of "
        f"{', '.join(UNREAD_CHECKPOINTS)} not written (nothing here reads them; phases 12 "
        f"and 13 write checkpoint_0) on {gpu_line}")
    log(f"[train-cli] final_weights read back: {n_tensors} tensors, "
        f"{read_bytes / 2**30:.2f} GiB in {read_s:.2f} s (mmap + copy to the card), every "
        f"tensor equal to the trained one bit for bit")
    log(f"[train-cli] peak device memory: training epoch {seen['train_peak_gib']:.2f} GiB; "
        f"host peak RSS {rss_gib:.2f} GiB (the whole script so far) on {gpu_line}")
    log(f"[train-cli] training run: test pass launches {json.dumps(ev_launches)} over "
        f"{ev_steps} decode steps; training launches {json.dumps(seen['train_launches'])}")
    for label, (sec, metrics, gens, lnch, steps) in reload.items():
        gen_s = gens[-1][0]
        log(f"[train-cli] {label} reload eval: main {sec:.1f} s; items/s "
            f"{metrics['items_per_sec']:.3f} (evaluator: its one batch with the catalogue misses), "
            f"{TRAIN_CLI_RECORDS / gen_s:.3f} over the generate ({gen_s:.2f} s); "
            f"{steps} decode steps on {gpu_line}")
    log(f"[train-cli] bf16 reload tokens agree with the training run's test pass on "
        f"{agree:.4f}; int8 reload launches {json.dumps(reload['int8'][3])}")
    ex_s, ex_bytes, family = seen["export"]
    cv_s, cv_bytes = seen["convert"]
    log(f"[tools] (a) --save_hf_model: final_weights_torch.pt ({family}) written in {ex_s:.2f} "
        f"s, {ex_bytes / 2**30:.2f} GiB ({ex_bytes / 2**30 / ex_s:.2f} GiB/s: the float32 tree "
        f"gathered on the host, then torch.save) on {gpu_line}")
    log(f"[tools] (a) mmrec_eval --load_weights_name final_weights_torch.pt: read and converted "
        f"in {cv_s:.2f} s ({cv_bytes / 2**30 / cv_s:.2f} GiB/s, mapped, not copied); "
        f"{pt_compared} tensors equal the final_weights reload's bit for bit, "
        f"{len(pt_tokens)} generates' tokens and the rec metrics equal; main "
        f"{reload['pt'][0]:.1f} s on {gpu_line}")
    return launches



# ------------------------------------------------------------ phase 10

TASK_USERS = 24  # train users kept; test users a task (one batch of 24)
IMG_GEN_DUMP = "img_gen_dump.json"  # phase 10's img_gen dump, kept for phase 14
MULTI_TASKS = ("img_sel", "search", "rec", "exp")  # the reference's multi-task order
# the metrics each evaluator must give, finite
TASK_METRICS = {
    "rec": [f"{m}@{k}" for k in (3, 5, 10) for m in ("hr", "ndcg", "mrr")],
    "exp": ["mae", "rmse", "bleu", "rouge1", "rouge2", "rougeL", "meteor", "bertscore"],
    "img_sel": ["recall", "precision", "f1"],
    "img_gen": ["n_generated"],
}
TASK_METRICS["search"] = TASK_METRICS["rec"]


def write_task_data(src, dst) -> None:
    """``src``'s dataset with its train split cut to its first TASK_USERS
    users in each task's train file (users, exp, img_sel, img_gen
    sequences); every other file and the images are links to ``src``'s."""
    dst.mkdir()
    cut = {"train_users.json", "train_beauty_exp.json", "train_beauty_img_sel.json",
           "search_merge_train.txt"}
    for path in src.iterdir():
        if path.name not in cut:
            (dst / path.name).symlink_to(path)
    for name in sorted(cut):
        records = json.loads((src / name).read_text())
        keep = (records[:TASK_USERS] if isinstance(records, list)
                else dict(list(records.items())[:TASK_USERS]))
        (dst / name).write_text(json.dumps(keep))


class TaskSpies:
    """Launches, decode steps, seconds and metrics of each evaluator call,
    launches and peak memory of each training epoch, the tasks of its
    records, and each checkpoint write, through the port's own entry
    points; ``undo`` puts the originals back. ``keep`` (checkpoint names),
    when given, writes only those checkpoints' files: the phase reads no
    other (each skipped file is counted in ``skipped``)."""

    def __init__(self, keep=None):
        from unimp_tpu_torch.cli import mmrec, mmrec_prefix
        from unimp_tpu_torch.evals import evaluators
        from unimp_tpu_torch.train import checkpoint as ckpt

        self.evals, self.epochs, self.writes, self.steps = [], [], [], 0
        self.skipped = 0
        self._undo = []

        def patch(owner, name, fn):
            self._undo.append((owner, name, getattr(owner, name)))
            setattr(owner, name, fn)

        for task, fn in list(evaluators.EVALUATORS.items()):
            self._undo.append((evaluators.EVALUATORS, task, fn))
            evaluators.EVALUATORS[task] = self._evaluator(task, fn)
        orig_step, orig_epoch, orig_write = (Generator._decode_step, mmrec.train_one_epoch,
                                             ckpt._write)

        def decode_step(gen, *args, **kw):
            self.steps += 1
            return orig_step(gen, *args, **kw)

        def epoch(args, trainer, loader, *rest, **kw):
            before = counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            orig_epoch(args, trainer, loader, *rest, **kw)
            self.epochs.append(dict(
                s=time.perf_counter() - t0, launches=between(before),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                tasks={t: loader.dataset.tasks.count(t) for t in set(loader.dataset.tasks)},
                n_batches=len(loader), micro=trainer.accum_steps * len(loader)))

        def write(path, obj):
            if keep is not None and Path(path).parent.name not in keep:
                self.skipped += 1
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig_write(path, obj)
            self.writes.append((time.perf_counter() - t0, Path(path).stat().st_size))

        patch(Generator, "_decode_step", decode_step)
        patch(mmrec, "train_one_epoch", epoch)
        patch(mmrec_prefix, "train_one_epoch", epoch)
        patch(ckpt, "_write", write)

    def _evaluator(self, task, fn):
        def spy(*args, **kw):
            before, steps = counts(), self.steps
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.evals.append(dict(task=task, s=time.perf_counter() - t0, metrics=out,
                                   launches=between(before), steps=self.steps - steps))
            return out
        return spy

    def undo(self):
        for owner, name, orig in reversed(self._undo):
            if isinstance(owner, dict):
                owner[name] = orig
            else:
                setattr(owner, name, orig)


def check_evals(tag, spies, cfg, max_new, gpu_line) -> None:
    """Each evaluator call: its metrics present and finite, K4 launched once a
    layer and K5 once a cross-attention layer each decode step, and no more
    steps than the task's new tokens."""
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    for ev in spies.evals:
        task, steps, launches = ev["task"], ev["steps"], ev["launches"]
        bad = [k for k in TASK_METRICS[task]
               if not (k in ev["metrics"] and np.isfinite(ev["metrics"][k]))]
        want = {"decode_attn": lm.num_layers * steps, "single_query_attn": n_xattn * steps}
        got = {k: launches[k] for k in want}
        if bad or got != want or not 0 < steps <= max_new[task] or launches["flash_fwd"] <= 0:
            raise AssertionError(f"{tag} {task}: metrics missing or not finite {bad}; launches "
                                 f"{got}, expected {want}; {steps} decode steps (at most "
                                 f"{max_new[task]}); K1 {launches['flash_fwd']}")
        if task != "img_gen" and ev["metrics"]["n_users"] != TASK_USERS:
            raise AssertionError(f"{tag} {task}: {ev['metrics']['n_users']} users scored")
        log(f"{tag} {task}: {ev['s']:.2f} s, {steps} decode steps, items/s "
            f"{ev['metrics']['items_per_sec']:.3f} (evaluator); K4 {got['decode_attn']}, K5 "
            f"{got['single_query_attn']}, K1 {launches['flash_fwd']}; metrics "
            + json.dumps({k: round(ev["metrics"][k], 6) for k in TASK_METRICS[task]})
            + f" on {gpu_line}")


def check_epoch(tag, epoch, cfg, tower_trained: bool, gpu_line) -> None:
    """K1 once a layer of the ViT, perceiver, cross-attention and LM each
    micro-batch; K2 and K3 once a trained layer (the ViT too where the
    tower trains)."""
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    fwd = cfg.vision.num_layers + cfg.resampler.depth + n_xattn + lm.num_layers
    bwd = fwd - (0 if tower_trained else cfg.vision.num_layers)
    want = {"flash_fwd": fwd * epoch["micro"], "flash_bwd_dkv": bwd * epoch["micro"],
            "flash_bwd_dq": bwd * epoch["micro"]}
    got = {k: epoch["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{tag} training launches {got}, expected {want}")
    log(f"{tag} epoch: {epoch['n_batches']} updates of {epoch['micro'] // epoch['n_batches']} "
        f"micro-batches in {epoch['s']:.2f} s; records by task {json.dumps(epoch['tasks'])}; "
        f"launches {json.dumps(got)} as expected; peak {epoch['peak_gib']:.2f} GiB on {gpu_line}")


def phase_tasks(dev, gpu_line, data, run_dir):
    """The other tasks, multi-task training and the transfer entry through the
    port's own CLIs at 4b-instruct width, 16 of its 32 LM layers, bf16 compute, on
    ``write_cli_data``'s files with the train split cut to 24 users:
    (a) ``mmrec.main`` on the default four-task list (img_sel, search, rec,
    exp; 6 records each: ``--max_records 24`` of the 25% subsamples and
    exp), micro-batch 3 x accum 2 fused, bf16 frozen backbone, the pixel
    path (no vision cache), then the test pass of the four default tasks
    over 24 users each (exp with BERTScore); (b) ``mmrec_eval --task img_gen``
    over 24 users, greedy to 600 new tokens; (c) ``mmrec_prefix.main
    --transfer_domain office`` on (a)'s ``final_weights``: the restore with
    growth held to the checkpoint bit for bit, 4 updates with the tower
    trained, resampler and x-attn frozen bit for bit, a rec test pass, then
    ``--only_test``. Returns the launches of (a)-(c). The checkpoints
    that no step reads ((a)'s ``weights_epoch_0`` and ``checkpoint_0``,
    (c)'s) are not written: phases 9 and 12 measure the writes."""
    from unimp_tpu_torch.cli import mmrec, mmrec_eval, mmrec_prefix
    from unimp_tpu_torch.train import checkpoint as ckpt

    task_data = run_dir.parent / "task_data"
    write_task_data(data, task_data)
    common_argv = ["--mmrec_path", str(task_data), "--external_save_dir", str(run_dir),
                   "--pretrained_model_name_or_path", "4b-instruct", "--subset", "beauty",
                   "--n_items", str(N_ITEM_TOKENS), "--history_len", "5",
                   "--patch-image-size", "224", "--max_records", str(TASK_USERS),
                   "--eval_batch_size", str(TASK_USERS), "--num_beams", "10",
                   "--workers", "2", "--device", "cuda"]
    train_argv = ["--batch_size", "3", "--gradient_accumulation_steps", "2",
                  "--fused_accumulation", "--use_reweight", "--gamma", "2", "--num_epochs", "1",
                  "--logging_steps", "1", "--do_test"]
    max_new = {"rec": 50, "search": 20, "exp": 256, "img_sel": 40, "img_gen": 600}
    launches = {}

    # --- (a) multi-task training and the four default evals
    # only final_weights is read again: the run's other checkpoints are not
    # written (their write times are phases 9 and 12's)
    spies = TaskSpies(keep=("final_weights",))
    try:
        kernel_lib.reset_launches()          # the main path (a) starts here
        t0 = time.perf_counter()
        trainer, _ = mmrec.main(common_argv + train_argv + ["--run_name", "multi",
                                                            "--frozen_bf16", "--eval_embed"])
        torch.cuda.synchronize()
        launches["tasks"] = dict(kernel_lib.LAUNCHES)  # ... and ends here
        main_s = time.perf_counter() - t0
    finally:
        spies.undo()
    cfg = trainer.model.cfg
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    multi_dir = run_dir / "multi"
    for name in ("weights_epoch_0", "checkpoint_0"):  # only final_weights is read again
        shutil.rmtree(multi_dir / name)
    (epoch,) = spies.epochs
    if set(epoch["tasks"]) != set(MULTI_TASKS) or epoch["n_batches"] != TASK_USERS // 6:
        raise AssertionError(f"[tasks] the epoch's records {epoch['tasks']}, "
                             f"{epoch['n_batches']} updates")
    check_epoch("[tasks]", epoch, cfg, False, gpu_line)
    if sorted(ev["task"] for ev in spies.evals) != sorted(MULTI_TASKS):
        raise AssertionError(f"[tasks] evaluated {[ev['task'] for ev in spies.evals]}")
    check_evals("[tasks]", spies, cfg, max_new, gpu_line)
    dumps = [multi_dir / "results_exp.txt", multi_dir / "save_gen" / "gen_exps_0.json",
             multi_dir / "save_gen" / "real_exps_0.json"]
    if not all(p.is_file() and p.stat().st_size > 0 for p in dumps):
        raise AssertionError(f"[tasks] missing dumps: {[str(p) for p in dumps if not p.is_file()]}")
    log(f"[tasks] 4b-instruct, vocab {cfg.lm.vocab_size}; main {main_s:.1f} s (build, "
        f"{epoch['n_batches']} updates, 4 test passes, checkpoints {sum(w[0] for w in spies.writes):.2f} "
        f"s for {sum(w[1] for w in spies.writes) / 2**30:.2f} GiB; {spies.skipped} unread files "
        f"not written) on {gpu_line}")

    # --- (b) img_gen: greedy to 600 new tokens
    spies = TaskSpies()
    try:
        kernel_lib.reset_launches()          # the main path (b) starts here
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = mmrec_eval.main(common_argv + ["--run_name", "img_gen", "--task", "img_gen",
                                                 "--single_task"])
        torch.cuda.synchronize()
        launches["img_gen"] = dict(kernel_lib.LAUNCHES)  # ... and ends here
        main_s = time.perf_counter() - t0
    finally:
        spies.undo()
    gc.collect()
    torch.cuda.empty_cache()
    check_evals("[img_gen]", spies, cfg, max_new, gpu_line)
    dump = json.loads(Path(results["img_gen"]["dump_path"]).read_text())
    if len(dump) != TASK_USERS or not all(isinstance(g["generated"], str) for g in dump):
        raise AssertionError(f"[img_gen] dump of {len(dump)} generations")
    # phase 14 (e) decodes it through the VQGAN decoder
    (run_dir.parent / IMG_GEN_DUMP).write_text(json.dumps(dump))
    (ev,) = spies.evals
    log(f"[img_gen] main {main_s:.1f} s; {ev['steps']} greedy steps in {ev['s']:.2f} s "
        f"({ev['s'] / ev['steps'] * 1e3:.1f} ms a step), items/s "
        f"{results['img_gen']['items_per_sec']:.3f}; {len(dump)} generations dumped; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {gpu_line}")

    # --- (c) the transfer entry on (a)'s final weights
    restored = ckpt.restore_params(str(multi_dir), "final_weights")
    seen = {"bad": [], "grown": {}}
    orig_merge, orig_load = ckpt.merge_with_growth, mmrec_prefix.load_flax_params

    def expected(path, t):
        """(a)'s tensor, cast to the model's dtype; a grown table is the
        fresh init with (a)'s table over its leading corner."""
        r = restored[path].to(dev, t.dtype)
        if path not in seen["grown"]:
            return r
        want = seen["grown"][path].clone()
        want[tuple(slice(0, d) for d in r.shape)] = r
        return want

    def merge(restored_tree, target):
        for path, t in target.items():  # each grown table's fresh init
            if path in restored_tree and tuple(restored_tree[path].shape) != tuple(t.shape):
                seen["grown"][path] = t.clone()
        return orig_merge(restored_tree, target)

    def load(model, flat):
        orig_load(model, flat)
        seen["bad"] += [path for path, t in ckpt.model_tree(model).items()
                        if not torch.equal(t, expected(path, t))]

    xfer_argv = common_argv + train_argv + ["--run_name", "xfer", "--task", "rec",
                                            "--single_task", "--transfer_domain", "office",
                                            "--load_run_name", "multi",
                                            "--load_weights_name", "final_weights"]
    spies = TaskSpies(keep=())  # the transfer's checkpoints are not read: not written
    ckpt.merge_with_growth, mmrec_prefix.load_flax_params = merge, load
    try:
        kernel_lib.reset_launches()          # the main path (c) starts here
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, state = mmrec_prefix.main(xfer_argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        model = trainer.model
        n_trainable = sum(p.numel() for p in trainer.params.values())
        n_params = sum(p.numel() for p in model.parameters())
        frozen_same, moved = [], {}
        for name, p in model.named_parameters():
            path = name.replace(".", "/")
            same = torch.equal(p.detach(), expected(path, p))
            group = path.split("/")[0].split("_")[0]  # vision, resampler, xattn, block, ...
            if p.requires_grad:
                moved.setdefault(group, [0, 0])[0] += not same
                moved[group][1] += 1
            else:
                frozen_same.append(same and (group in ("resampler", "xattn")))
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        only = mmrec_prefix.main(xfer_argv + ["--only_test"])
        torch.cuda.synchronize()
        only_s = time.perf_counter() - t1
        launches["transfer"] = dict(kernel_lib.LAUNCHES)  # ... and ends here
    finally:
        spies.undo()
        ckpt.merge_with_growth, mmrec_prefix.load_flax_params = orig_merge, orig_load
    grown = {path: tuple(t.shape) for path, t in seen.pop("grown").items()}
    del restored
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir)

    if seen["bad"] or not grown:
        raise AssertionError(f"[transfer] the restore with growth differs from (a)'s weights "
                             f"at {seen['bad'][:8]}; grown {grown}")
    if not (frozen_same and all(frozen_same)):
        raise AssertionError("[transfer] a frozen tensor outside resampler / xattn, or one "
                             "that moved")
    if not all(moved.get(g, [0])[0] > 0 for g in ("vision", "block", "embed")):
        raise AssertionError(f"[transfer] the tower or the LM did not move: {moved}")
    (epoch,) = spies.epochs
    check_epoch("[transfer]", epoch, cfg, True, gpu_line)
    check_evals("[transfer]", spies, cfg, max_new, gpu_line)
    if state["step"] != TASK_USERS // 6 or sorted(only) != ["rec"]:
        raise AssertionError(f"[transfer] state {state}; --only_test gave {sorted(only)}")
    log(f"[transfer] office: {len(grown)} tables grown {json.dumps(grown)}, every tensor equal "
        f"to (a)'s final_weights bit for bit (new rows: the fresh init); {n_trainable / 1e9:.3f} "
        f"B of {n_params / 1e9:.3f} B float32 parameters trainable; after {state['step']} "
        f"updates {len(frozen_same)} frozen (resampler, xattn) unchanged bit for bit, trainable "
        f"tensors moved / all by group {json.dumps(moved)}")
    log(f"[transfer] main {main_s:.1f} s (build, restore, {state['step']} updates, the test "
        f"pass; {spies.skipped} unread checkpoint files not written); --only_test "
        f"{only_s:.1f} s; "
        f"peak {peak_gib:.2f} GiB (AdamW on {n_trainable / 1e9:.3f} B float32: "
        f"{16 * n_trainable / 2**30:.1f} GiB of weights, gradients and moments) on {gpu_line}")
    return launches


# ------------------------------------------------------------ phase 11

SERVE_SLOTS, SERVE_NEW = 4, 32
SERVE_IMAGES = (1, 5, 9, 13)  # requests carrying one of phase 8's JPEGs
# request -> seed, sampled at SERVE_TEMPERATURE; request 13 also carries an
# image and is sent twice: every wave it lands in then has the same shapes
# (4 slots, T 64, one medium), so its text must not change. A text-only row
# in a wave with an image would not be held to that: the gated FF of the
# x-attn blocks runs on every row of such a wave, in JAX too
SERVE_SAMPLED = {3: 11, 7: 12, 11: 13, 13: 7}
SERVE_TEMPERATURE = 0.9
SERVE_REPEAT = 13


def serve_requests(data) -> list:
    """The 16 requests of ``benchmarks/serve_bench.py:98-101`` (32 new
    tokens), 4 with a base64 JPEG of phase 8's files and ``<image>`` in the
    prompt, 4 sampled with fixed seeds, then request 13 again."""
    import base64

    reqs = []
    for i in range(16):
        prompt = f"I bought item_{3 + i} and item_{7 + i}. What should I buy next?"
        req = {"model": "serve", "prompt": prompt, "max_new_tokens": SERVE_NEW}
        if i in SERVE_IMAGES:
            jpg = (data / "beauty" / f"{10 * i}.jpg").read_bytes()
            req.update(prompt="<image>" + prompt, images=[base64.b64encode(jpg).decode()])
        if i in SERVE_SAMPLED:
            req.update(temperature=SERVE_TEMPERATURE, seed=SERVE_SAMPLED[i])
        reqs.append(req)
    return reqs + [dict(reqs[SERVE_REPEAT])]


def k6_prefill_launches(cfg, slots: int, t: int, media: int) -> int:
    """K6 launches of one serving prefill, from ``quant_dot``'s rule (an int8
    kernel at <= 512 rows streams through K6, more rows dequantize): per LM
    block q, k, v, o and the MLP's (up, down; SwiGLU also gate) at slots * t
    rows; an untied head at the last position (slots rows); with media, per
    x-attn block q, o, up, down at slots * t rows and k, v over the latents
    (slots * media * L rows), per perceiver block q, o, up, down over its
    latents and k, v over patches + latents (slots * media * (P + L) rows),
    per ViT block q, k, v, o, up, down at slots * media * (P + 1) rows (its
    patch embedding never streams)."""
    def fits(rows):
        return int(rows <= default_max_rows())

    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    text = slots * t
    n = (4 + lm_mlp_matmuls(lm)) * fits(text) * lm.num_layers + fits(slots) * (
        not lm.tie_embeddings)
    if media:
        lat = slots * media * cfg.resampler.num_latents
        patches = slots * media * cfg.vision.num_patches
        n += n_xattn * (4 * fits(text) + 2 * fits(lat))
        n += cfg.resampler.depth * (4 * fits(lat) + 2 * fits(patches + lat))
        n += cfg.vision.num_layers * 6 * fits(patches + slots * media)
    return n


def lm_mlp_matmuls(lm) -> int:
    return 3 if lm.act == "silu" else 2  # SwiGLU: gate, up, down


def serve_wave_launches(cfg, wave: dict, int8: bool) -> dict:
    """What one wave launches (the code's count): K1 once per LM layer, plus
    once per x-attn, ViT and perceiver layer when the wave has media; a
    decode step K4 once per LM layer and K5 once per x-attn layer with
    media; int8: K6 at every decode matmul (the fused QKV, o and the MLP's
    per LM block; q, o, up, down per x-attn block with media; an untied
    head: 193 a step at 4b with media, 129 without) and at
    ``k6_prefill_launches``, the float decode kernels never."""
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    steps, media = wave["steps"], wave["media"]
    k4, k5 = ("decode_attn_int8", "single_query_attn_int8") if int8 else \
        ("decode_attn", "single_query_attn")
    want = {name: 0 for name in kernel_lib.LAUNCHES}
    want["flash_fwd"] = lm.num_layers + bool(media) * (
        n_xattn + cfg.vision.num_layers + cfg.resampler.depth)
    want[k4] = lm.num_layers * steps
    want[k5] = n_xattn * steps * bool(media)
    if int8:
        per_step = (2 + lm_mlp_matmuls(lm)) * lm.num_layers + 4 * n_xattn * bool(media) + (
            not lm.tie_embeddings)
        want["quant_matmul"] = per_step * steps + k6_prefill_launches(
            cfg, wave["slots"], wave["t"], media)
    return want


class ServeSpy:
    """Around the engine's waves: each wave's requests, launches (read with
    the card synchronized before and after), wall, decode calls and the
    time of its first one."""

    def __init__(self, engine):
        self.engine, self.waves, self.cur = engine, [], None
        run_wave, model = engine._run_wave, engine.model
        forward = model.forward

        def wave(reqs):
            before = counts()
            self.cur = {"first": None, "decode_calls": 0}
            t0 = time.perf_counter()
            try:
                run_wave(reqs)
            finally:
                end = time.perf_counter()
                info, self.cur = self.cur, None
            self.waves.append(dict(engine.last_wave, **info, reqs=list(reqs), wall=end - t0,
                                   end=end, launches=between(before)))

        def spied_forward(*args, **kw):
            if self.cur is not None and kw.get("decode_state") is not None:
                self.cur["first"] = self.cur["first"] or time.perf_counter()
                self.cur["decode_calls"] += 1
            return forward(*args, **kw)

        engine._run_wave, model.forward = wave, spied_forward


def serve_one(addr, req) -> dict:
    """One streamed request through the controller: TTFT (to the first
    chunk with text), wall, the chunks."""
    from unimp_tpu_torch.serve.cli_chat import stream_request

    t0 = time.perf_counter()
    ttft, chunks = None, []
    for ch in stream_request(addr, req):
        if ttft is None and ch.get("text"):
            ttft = time.perf_counter() - t0
        chunks.append(ch)
    wall = time.perf_counter() - t0
    return {"req": req, "ttft": ttft if ttft is not None else wall, "wall": wall,
            "chunks": chunks, "tokens": max(len(chunks) - 1, 0),
            "text": chunks[-1]["text"] if chunks else None}


def serve_traffic(addr, reqs, concurrency: int):
    """``reqs`` at ``concurrency`` client threads; returns (results in
    request order, wall seconds)."""
    import concurrent.futures

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        results = list(pool.map(lambda r: serve_one(addr, r), reqs))
    return results, time.perf_counter() - t0


def count_dtoh(label, run, chunks_of) -> tuple:
    """Device->host copies the card made during ``run`` (torch.profiler,
    CUDA activity) and its busy ms; ``chunks_of()`` gives the chunks run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dtoh, busy_ms = 0, 0.0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
            continue
        if "DtoH" in ev.name():
            dtoh += 1
        busy_ms += ev.duration_ns() / 1e6
    chunks = chunks_of()
    log(f"{label} profiled lone request: {dtoh} device->host copies over {chunks} chunks "
        f"({dtoh / max(chunks, 1):.2f} a chunk); device busy {busy_ms:.1f} ms of "
        f"{wall_ms:.1f} ms wall under the profiler")
    return dtoh, chunks


def agreement(pairs) -> float:
    """Token agreement of (got, want) id lists: equal positions over the
    longer list's length, summed over the pairs."""
    same = sum(sum(a == b for a, b in zip(g, w)) for g, w in pairs)
    return same / max(sum(max(len(g), len(w)) for g, w in pairs), 1)


def phase_serve(dev, gpu_line, data) -> dict:
    """Serving at 4b-instruct width and depth (phase 11): a port controller
    and a port worker (``serve/worker.py:build_worker`` from its command
    line, phase 8's tokenizer and files, seeded weights, gates opened) on
    127.0.0.1, 4 slots (``--limit-model-concurrency 4``), chunks of 8.
    Traffic: a warm-up request, one request alone (three inactive slots),
    then ``serve_requests`` at concurrency 4; first bf16, then with
    ``--eval_param_dtype int8 --kv_int8``. Checks every chunk stream, the
    repeated sampled text, each wave's launches, and (bf16) the greedy
    tokens against the unbatched ``StreamingGenerator`` on the card."""
    import threading
    from http.server import ThreadingHTTPServer

    from unimp_tpu_torch.serve import controller as controller_mod
    from unimp_tpu_torch.serve import worker as worker_mod
    from unimp_tpu_torch.serve.cli_chat import post_json

    reqs = serve_requests(data)
    out, bf16_ids, f32_ids = {}, {}, {}
    for name, extra in (("serve", []), ("serve_int8", ["--eval_param_dtype", "int8",
                                                       "--kv_int8"]),
                        ("serve_small_f32", ["--pretrained_model_name_or_path", "small",
                                             "--precision", "fp32"])):
        tag = f"[{name}]"
        # a controller of its own: the first worker's entry would outlive it
        ctrl = controller_mod.Controller()
        csrv = ThreadingHTTPServer(("127.0.0.1", 0), controller_mod.make_handler(ctrl))
        threading.Thread(target=csrv.serve_forever, daemon=True).start()
        caddr = f"http://127.0.0.1:{csrv.server_address[1]}"
        argv = ["--mmrec_path", str(data), "--subset", "beauty", "--task", "rec",
                "--n_items", str(N_ITEM_TOKENS), "--pretrained_model_name_or_path",
                "4b-instruct", "--patch-image-size", "224", "--run_name", "serve",
                "--device", "cuda", "--host", "127.0.0.1", "--port", "0",
                "--controller-address", caddr, "--limit-model-concurrency",
                str(SERVE_SLOTS), *extra]
        t0 = time.perf_counter()
        args = worker_mod.build_parser().parse_args(argv)
        worker = worker_mod.build_worker(args)
        open_gates(worker.model)
        wsrv = worker_mod.make_server(worker, args.host, args.port)
        threading.Thread(target=wsrv.serve_forever, daemon=True).start()
        stop = threading.Event()
        worker.register()
        threading.Thread(target=worker.heartbeat_loop, args=(stop,), daemon=True).start()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        engine, cfg = worker.engine, worker.model.cfg
        spy = ServeSpy(engine)
        try:
            if post_json(caddr + "/list_models", {})["models"] != ["serve"]:
                raise AssertionError(f"{tag} the worker did not register")
            torch.cuda.reset_peak_memory_stats()
            kernel_lib.reset_launches()  # the main path starts here
            warm = serve_one(caddr, reqs[0])
            alone = serve_one(caddr, reqs[2])
            results, wall = serve_traffic(caddr, reqs, SERVE_SLOTS)
            launches = counts()  # the main path ends here
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            waves = list(spy.waves)
            count_dtoh(tag, lambda: serve_one(caddr, dict(reqs[0], max_new_tokens=16)),
                       lambda: spy.waves[-1]["steps"] // spy.waves[-1]["chunk"])
            checks = serve_checks(tag, cfg, name == "serve_int8", warm, alone, results,
                                  waves, worker, f32_ids if name == "serve_small_f32"
                                  else bf16_ids)
            if name == "serve_small_f32" and not checks["forced"] == checks["free"] == 1.0:
                # float32 leaves no bf16 near-ties: the wave engine and the
                # unbatched streamer must give the same greedy tokens
                raise AssertionError(f"{tag} float32 greedy tokens agree {checks['forced']} "
                                     f"(fed) / {checks['free']} (free-running) with the "
                                     f"unbatched streamer; first differences "
                                     f"{checks['first_differences']}")
        finally:
            stop.set()
            for srv in (wsrv, csrv):
                srv.shutdown()
                srv.server_close()
            engine.stop()
        serve_report(tag, gpu_line, build_s, warm, alone, results, wall, waves, peak_gib,
                     launches, checks)
        out[name] = launches
        del worker, engine, spy, wsrv
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_checks(tag, cfg, int8, warm, alone, results, waves, worker, bf16_ids):
    """Fails unless every stream ends with a ``finish`` chunk and error code
    0, the repeated sampled request gave one text, and every wave launched
    what the code says; bf16: the greedy tokens agree >= 0.9 with the
    unbatched ``StreamingGenerator`` on the same prompt and frames (the
    request's image, or its wave's zero frames, as the engine gives a
    text-only row) token for token: the streamer's own pick before each of
    the engine's tokens, fed the engine's tokens (an EOS where the engine
    ended early). Where a pick differs, its first difference (step, the
    streamer's top-2 logit gap there) and the streamer's free-running
    agreement are reported. Returns the numbers to report."""
    every = [warm, alone] + results
    bad = [r["req"]["prompt"] for r in every if not r["chunks"]
           or r["chunks"][-1].get("finish") is not True
           or any(c["error_code"] != 0 for c in r["chunks"])]
    if bad:
        raise AssertionError(f"{tag} streams without a clean finish: {bad}")
    if results[SERVE_REPEAT]["text"] != results[-1]["text"]:
        raise AssertionError(f"{tag} the repeated sampled request changed its text: "
                             f"{results[SERVE_REPEAT]['text']!r} / {results[-1]['text']!r}")
    for i, wave in enumerate(waves):
        want = serve_wave_launches(cfg, wave, int8)
        diff = {k: (wave["launches"][k], n) for k, n in want.items()
                if wave["launches"][k] != n}
        if diff:
            raise AssertionError(f"{tag} wave {i} ({wave['rows']} rows, media {wave['media']}, "
                                 f"{wave['steps']} steps) launches differ (got, want): {diff}")
    tok = worker.tokenizer
    prompts = {tuple(tok.encode(r["req"]["prompt"], add_bos=True)): r["req"]["prompt"]
               for r in every}
    streamer = StreamingGenerator(worker.model, tok, SERVE_NEW)
    forced, free, gaps, vs_bf16, seen = [], [], [], [], set()
    for wave in waves:
        for r in wave["reqs"]:
            if r.temperature > 0:
                continue
            own = r.vision is not None
            key = (tuple(r.prompt_ids), -1 if own else wave["media"])
            if key in bf16_ids:
                vs_bf16.append((r.out_ids, bf16_ids[key]))
            if int8:
                continue
            bf16_ids[key] = r.out_ids
            vision = (r.vision[None] if own else np.zeros(
                (1, wave["media"], worker.image_size, worker.image_size, 3), np.float32)
                if wave["media"] else None)
            tokens = r.out_ids + [tok.eos_token_id] * (len(r.out_ids) < SERVE_NEW)
            if (key, tuple(tokens)) in seen:  # the same request decoded alike before
                continue
            seen.add((key, tuple(tokens)))
            logits, state, gen, t = streamer._prefill(prompts[key[0]], vision, SERVE_NEW)
            picks, top2 = [], []
            for i, token in enumerate(tokens):
                picks.append(int(torch.argmax(logits, dim=-1)[0]))
                top2.append(torch.topk(logits[0].float(), 2).values.tolist())
                if i + 1 < len(tokens):
                    logits, gen = streamer._step(torch.tensor([token], device=logits.device),
                                                 state, gen, i, t)
            forced.append((picks, tokens))
            if picks == tokens:  # the free-running streamer follows the same tokens
                free.append((r.out_ids, r.out_ids))
                continue
            first = next(i for i, (a, b) in enumerate(zip(picks, tokens)) if a != b)
            top, second = top2[first]
            ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7)  # bf16's spacing at top
            gaps.append((first, round(top - second, 6), round((top - second) / ulp, 2)))
            rec = IdRecorder(tok)
            for _ in StreamingGenerator(worker.model, rec, SERVE_NEW).stream(
                    None, prompts[key[0]], vision_x=vision):
                pass
            free.append((r.out_ids, rec.ids))
    result = {"greedy_requests": len(forced) or len(vs_bf16),
              "forced": agreement(forced) if forced else None,
              "free": agreement(free) if free else None, "first_differences": gaps,
              "vs_bf16": agreement(vs_bf16) if vs_bf16 else None}
    if not int8 and not (forced and result["forced"] >= 0.9):
        raise AssertionError(f"{tag} greedy tokens agree {result['forced']} < 0.9 with the "
                             f"unbatched streamer over {len(forced)} requests")
    return result


class IdRecorder:
    """A tokenizer whose ``decode`` keeps the ids it was last given."""

    def __init__(self, tok):
        self.tok, self.ids = tok, []

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def decode(self, ids, **kw):
        self.ids = list(ids)
        return self.tok.decode(ids, **kw)


def serve_report(tag, gpu_line, build_s, warm, alone, results, wall, waves, peak_gib,
                 launches, checks):
    ttft = np.array([r["ttft"] for r in results]) * 1e3
    tokens = sum(r["tokens"] for r in results)
    stream_rate = [(r["tokens"] - 1) / (r["wall"] - r["ttft"]) for r in results
                   if r["tokens"] > 1]
    decode = [w for w in waves if w["decode_calls"]]
    step_ms = [(w["end"] - w["first"]) / w["decode_calls"] * 1e3 for w in decode]
    log(f"{tag} worker built in {build_s:.1f} s; warm-up request {warm['wall']:.2f} s "
        f"(TTFT {warm['ttft'] * 1e3:.1f} ms); one request alone {alone['wall']:.2f} s "
        f"(TTFT {alone['ttft'] * 1e3:.1f} ms, {alone['tokens']} tokens)")
    log(f"{tag} {len(results)} requests at concurrency {SERVE_SLOTS}: wall {wall:.2f} s, "
        f"TTFT p50 {np.percentile(ttft, 50):.1f} ms p90 {np.percentile(ttft, 90):.1f} ms, "
        f"{tokens} tokens, aggregate {tokens / wall:.2f} tokens/s, per stream (median, after "
        f"the first token) {np.median(stream_rate):.2f} tokens/s, "
        f"{len(results) / wall:.3f} requests/s; peak_mem={peak_gib:.2f} GiB on {gpu_line}")
    log(f"{tag} {len(waves)} waves (rows {[w['rows'] for w in waves]}, media "
        f"{[w['media'] for w in waves]}, steps {[w['steps'] for w in waves]}); ms per decode "
        f"step (host clock, first decode call to the wave's end) median "
        f"{np.median(step_ms):.2f} [{min(step_ms):.2f}, {max(step_ms):.2f}], per chunk of "
        f"{waves[-1]['chunk']} {np.median(step_ms) * waves[-1]['chunk']:.1f}; device->host "
        f"copies of tokens {sum(w['copies'] for w in waves)} over "
        f"{sum(w['steps'] // w['chunk'] for w in waves)} chunks (the engine's count)")
    log(f"{tag} greedy requests {checks['greedy_requests']} (distinct decodes held to the "
        f"streamer); token agreement with the unbatched streamer: fed the engine's tokens "
        f"{checks['forced']}, free-running {checks['free']}; first differences (step, "
        f"top-2 gap, in bf16 ulps of the top logit) {checks['first_differences']}; with the "
        f"bf16 worker {checks['vs_bf16']}; repeated sampled request: same text")
    log(f"{tag} launches {json.dumps(launches)}; every wave as the code counts")


# ------------------------------------------------------------ phase 12

HEADLINE_RECORDS = 18  # train users: 3 updates of 3 x 2 an epoch; test users: one batch
HEADLINE_EPOCHS = 4    # under --train_method continue epochs 0 and 1 train on rec alone
HEADLINE_LEVERS = ("--frozen_int8", "--bf16_opt_state", "--remat", "--remat_policy", "dots")


class StopRun(Exception):
    """Ends a phase-12 run after the updates it was asked for."""


def train_state_tensors(trainer) -> dict:
    """The trainable weights, both moments and every int8 payload of a
    trainer, by name."""
    opt = trainer.optimizer
    tensors = {f"param {n}": p.detach() for n, p in trainer.params.items()}
    tensors.update({f"mu {n}": t for n, t in opt.mu.items()})
    tensors.update({f"nu {n}": t for n, t in opt.nu.items()})
    tensors.update({f"q {n}": m.q for n, m in trainer.model.named_modules()
                    if isinstance(m, QuantizedKernel) and m.persistent})
    return tensors


def state_differences(trainer, saved: dict) -> list:
    """Names of ``train_state_tensors(trainer)`` whose dtype, shape or bits
    differ from ``saved`` (host copies), or that only one side has."""
    views = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    now = train_state_tensors(trainer)
    differ = sorted(set(now) ^ set(saved))
    for name in sorted(set(now) & set(saved)):
        a, b = now[name].cpu(), saved[name]
        if (a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.contiguous().view(views[a.element_size()]),
                b.contiguous().view(views[b.element_size()]))):
            differ.append(name)
    return differ


def k6_per_decode_step(model) -> int:
    """K6 launches of one decode step: each decoder block's fused int8 q/k/v
    (or its int8 q, k, v), o and MLP kernels."""
    from unimp_tpu_torch.models.lm import DecoderBlock

    n = 0
    for block in model.modules():
        if isinstance(block, DecoderBlock):
            attn = block.attn
            qkv = [attn.q_proj.kernel, attn.k_proj.kernel, attn.v_proj.kernel]
            n += 1 if attn.qkv_int8 is not None else sum(isinstance(k, QuantizedKernel)
                                                         for k in qkv)
            n += sum(isinstance(m.kernel, QuantizedKernel) for m in
                     (attn.o_proj, *[c for c in block.mlp.children() if hasattr(c, "kernel")]))
    return n


def phase_headline_train(gpu_line, data, run_dir):
    """The JAX package's headline training configuration through the port's
    CLI (phase 12): ``mmrec.main`` on 3b-mpt (CLIP ViT-L/14, MPT-1B with
    ALiBi and head dim 128, an x-attn block before every layer) at full
    width and depth, seeded weights, on phase 8's files, with
    ``--frozen_int8 --bf16_opt_state --remat --remat_policy dots
    --cache_vision_latents`` and the reference's shape (micro-batch 3 x
    accum 2 fused, 256 tokens and 6 images of 224 px a sample: 6 history
    items with their text, ``--use_semantic``; focal loss gamma 2 with
    reweight),
    ``--train_method continue`` (each epoch's prompts drawn from the seed,
    so a resumed epoch sees the batches of a straight one):

      (a) epoch 0 (3 updates), the 10-beam test pass over 18 users,
          ``checkpoint_0`` (``weights_epoch_0``, which nothing reads, is
          not written), then the first update
          of epoch 1, where the run is stopped;
      (b) the same command with ``--resume_from_checkpoint``: its first
          update (epoch 1's first), then stopped;
      (c) 2 updates without ``--remat``, and (d) 2 more without
          ``--frozen_int8`` and ``--bf16_opt_state``, with
          ``--frozen_bf16``: what each lever saves in device memory.

    Fails unless every loss is finite and no update skipped, K1 / K2 / K3
    launched what the code counts in every update (K1 again for each
    checkpointed block's recompute), K6 launched at every decode step of
    the test pass (its int8 backbone) and nowhere in training (768 rows a
    micro-batch: the dequantized matmul), (b)'s weights, both moments and
    int8 payloads equal what (a) saved bit for bit, and (b)'s loss is
    within 1e-3 relative of (a)'s at the same update. The decode of each
    item image is memoized (``item_decode_memo``, from phase 9 on), so the
    catalogue is read once."""
    import resource

    from unimp_tpu_torch.cli import mmrec
    from unimp_tpu_torch.train import checkpoint as ckpt
    from unimp_tpu_torch.utils.flops import vision_forward_flops

    log(f"[headline] {host_memory_line(run_dir.parent)}")
    seen = {"run": None, "steps": {}, "writes": [], "decode_steps": 0}
    orig = {"cache": mmrec.build_tower_cache, "epoch": mmrec.train_one_epoch,
            "evals": mmrec.run_evals, "write": ckpt._write, "state": ckpt.save_train_state,
            "step": Trainer.train_step, "decode_step": Generator._decode_step}
    stop_after = {}

    def cache(model, *args, **kw):
        before, t0 = counts(), time.perf_counter()
        out = orig["cache"](model, *args, **kw)
        torch.cuda.synchronize()
        seen.setdefault("cache", {})[seen["run"]] = (time.perf_counter() - t0, out.nbytes,
                                                     tuple(out.shape), between(before))
        return out

    def epoch(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            orig["epoch"](*args, **kw)
        finally:
            peak = seen.setdefault("peak_gib", {})
            peak[seen["run"]] = max(peak.get(seen["run"], 0.0),
                                    torch.cuda.max_memory_allocated() / 2**30)

    def evals(args_, model, *args, **kw):
        seen["k6_per_step"] = k6_per_decode_step(model)
        before, steps, t0 = counts(), seen["decode_steps"], time.perf_counter()
        out = orig["evals"](args_, model, *args, **kw)
        seen["eval"] = (time.perf_counter() - t0, between(before),
                        seen["decode_steps"] - steps, out)
        return out

    def write(path, obj):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig["write"](path, obj)
        seen["writes"].append((Path(path).parent.name + "/" + Path(path).name,
                               time.perf_counter() - t0, Path(path).stat().st_size))

    def save_state(save_dir, trainer, ep):
        # host copies, held to the resumed state bit for bit
        seen["rss_before_copy"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        seen["saved"] = {k: t.cpu() for k, t in train_state_tensors(trainer).items()}
        seen["saved_gib"] = sum(t.nbytes for t in seen["saved"].values()) / 2**30
        return orig["state"](save_dir, trainer, ep)

    def step(self, batch):
        run = seen["run"]
        steps = seen["steps"].setdefault(run, [])
        seen["cfg"] = self.model.cfg
        if run == "resume" and not steps:
            saved = seen.pop("saved")
            seen["compared"] = len(saved)
            seen["differ"] = state_differences(self, saved)
            del saved
        before = counts()
        t0 = time.perf_counter()
        if run == "main" and len(steps) == 2:  # the last update of epoch 0, profiled
            out = []
            profile_run("3b-mpt headline training step (update 3 of run (a))",
                        lambda: out.append(orig["step"](self, batch)), steps[1][0])
            metrics = out[0]
        else:
            metrics = orig["step"](self, batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, float(metrics["loss"]),
                      float(metrics["grad_norm"]), int(metrics["skipped_nonfinite"]),
                      between(before), tuple(np.shape(batch["input_ids"])),
                      tuple(np.shape(batch["image_ids"]))))
        if len(steps) == stop_after[run]:
            raise StopRun(run)
        return metrics

    def decode_step(self, *args, **kw):
        seen["decode_steps"] += 1
        return orig["decode_step"](self, *args, **kw)

    base = ["--mmrec_path", str(data), "--external_save_dir", str(run_dir),
            "--pretrained_model_name_or_path", "3b-mpt", "--subset", "beauty", "--task",
            "rec", "--single_task", "--n_items", str(N_ITEM_TOKENS), "--history_len", "6",
            "--use_semantic", "--patch-image-size", "224", "--max_records", str(HEADLINE_RECORDS),
            "--eval_batch_size", str(HEADLINE_RECORDS), "--num_beams", "10", "--workers", "2",
            "--device", "cuda", "--batch_size", "3", "--gradient_accumulation_steps", "2",
            "--fused_accumulation", "--use_reweight", "--gamma", "2",
            "--cache_vision_latents", "--logging_steps", "1", "--train_method", "continue",
            "--num_epochs", str(HEADLINE_EPOCHS)]
    updates = HEADLINE_RECORDS // 6
    runs = {"main": (["--run_name", "headline", *HEADLINE_LEVERS, "--do_test"], updates + 1),
            "resume": (["--run_name", "headline", *HEADLINE_LEVERS, "--do_test",
                        "--resume_from_checkpoint"], 1),
            "no_remat": (["--run_name", "no_remat", "--frozen_int8", "--bf16_opt_state"], 2),
            "bf16_frozen": (["--run_name", "bf16_frozen", "--frozen_bf16"], 2)}
    (mmrec.build_tower_cache, mmrec.train_one_epoch, mmrec.run_evals, ckpt._write,
     ckpt.save_train_state, Trainer.train_step, Generator._decode_step) = (
        cache, epoch, evals, write, save_state, step, decode_step)
    wall = {}
    try:
        kernel_lib.reset_launches()          # the main path starts here
        for run, (extra, n_updates) in runs.items():
            seen["run"], stop_after[run] = run, n_updates
            t0 = time.perf_counter()
            try:
                with unread_checkpoints(("weights_epoch_0",)) as unread:
                    mmrec.main(base + extra)
                raise AssertionError(f"[headline] run {run} ended before {n_updates} updates")
            except StopRun:
                pass
            seen["unwritten"] = seen.get("unwritten", 0) + unread["unwritten"]
            gc.collect()
            torch.cuda.empty_cache()
            wall[run] = time.perf_counter() - t0
            if run == "resume":  # (b) read checkpoint_0: it is not needed any more
                shutil.rmtree(run_dir / "headline")
        launches = counts()                  # the main path ends here
    finally:
        (mmrec.build_tower_cache, mmrec.train_one_epoch, mmrec.run_evals, ckpt._write,
         ckpt.save_train_state, Trainer.train_step, Generator._decode_step) = (
            orig["cache"], orig["epoch"], orig["evals"], orig["write"], orig["state"],
            orig["step"], orig["decode_step"])
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    shutil.rmtree(run_dir, ignore_errors=True)

    # --- checks
    cfg = seen["cfg"]
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    fwd = cfg.resampler.depth + n_xattn + lm.num_layers      # K1 / K2 / K3 a micro-batch
    recompute = n_xattn + lm.num_layers                      # checkpointed blocks
    for run, steps in seen["steps"].items():
        remat = run in ("main", "resume")
        # no K6 in training: 3 x 256 rows a micro-batch take the dequantized
        # matmul (K6 streams <= 512 rows)
        want = {"flash_fwd": 2 * (fwd + (recompute if remat else 0)),
                "flash_bwd_dkv": 2 * fwd, "flash_bwd_dq": 2 * fwd, "quant_matmul": 0}
        for i, (ms, loss, gnorm, skipped, lnch, ids_shape, img_shape) in enumerate(steps):
            if skipped or not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"[headline] {run} update {i}: loss {loss}, grad norm "
                                     f"{gnorm}, skipped {skipped}")
            got = {k: lnch[k] for k in want}
            if got != want:
                raise AssertionError(f"[headline] {run} update {i}: launches {got}, expected "
                                     f"{want}")
            if ids_shape != (6, 256) or img_shape != (6, 6):
                raise AssertionError(f"[headline] {run} update {i}: batch {ids_shape}, images "
                                     f"{img_shape}; want 6 rows of 256 tokens and 6 images")
    eval_s, eval_launches, eval_steps, eval_out = seen["eval"]
    k6_step = seen["k6_per_step"]
    if not 0 < eval_steps <= 50 or not 0 < eval_launches["quant_matmul"] == k6_step * eval_steps \
            or \
            eval_launches["decode_attn"] != lm.num_layers * eval_steps or \
            eval_launches["single_query_attn"] != n_xattn * eval_steps:
        raise AssertionError(f"[headline] test pass launches {eval_launches} over {eval_steps} "
                             f"decode steps ({k6_step} int8 matmuls a step)")
    if seen["differ"]:
        raise AssertionError(f"[headline] the resumed state differs from the saved one: "
                             f"{seen['differ'][:8]} ({len(seen['differ'])} tensors)")
    straight = seen["steps"]["main"][updates][1]
    resumed = seen["steps"]["resume"][0][1]
    resume_rel = abs(resumed - straight) / abs(straight)
    if resume_rel > 1e-3:
        raise AssertionError(f"[headline] resumed loss {resumed} vs {straight} straight "
                             f"(rel {resume_rel:.2e} > 1e-3)")

    # --- report
    main_steps = seen["steps"]["main"]
    t = main_steps[0][5][1]
    flops = train_step_flops(cfg, 6, t, 6, frozen_backbone=True) - vision_forward_flops(cfg, 36)
    steady = [main_steps[1][0], main_steps[updates][0]]  # update 1 of epoch 0 and 0 of 1
    step_s = float(np.mean(steady))
    cache_s, cache_bytes, cache_shape, cache_launches = seen["cache"]["main"]
    log(f"[headline] 3b-mpt, T {t}, 6 images a sample, micro-batch 3 x accum 2 fused, "
        f"{' '.join(HEADLINE_LEVERS)} --cache_vision_latents; run walls (s) "
        f"{ {k: round(v, 1) for k, v in wall.items()} } on {gpu_line}")
    log(f"[headline] step ms {[round(s[0] * 1e3, 1) for s in main_steps]} (run (a); update 3 "
        f"under the profiler); {step_s * 1e3:.1f} ms a step, {6 / step_s:.3f} samples/s, the "
        f"mean of two updates (2 and 4); MFU {100 * flops / step_s / PEAK_FLOPS[torch.bfloat16]:.2f}% "
        f"({flops / 1e12:.3f} TFLOP a step from utils/flops.py without the cached tower's "
        f"forward, against 989 TFLOP/s) on {gpu_line}")
    log(f"[headline] losses (a) {[round(s[1], 6) for s in main_steps]}, (b) "
        f"{[round(s[1], 6) for s in seen['steps']['resume']]}; resumed update vs straight: "
        f"{resumed:.6f} vs {straight:.6f} (rel {resume_rel:.2e}, limit 1e-3); weights, "
        f"moments and int8 payloads restored bit for bit ({seen['compared']} tensors, "
        f"{seen['saved_gib']:.2f} GiB, held to host copies taken at the save)")
    log(f"[headline] launches per update (a): {json.dumps(main_steps[1][4])}; (c) "
        f"{json.dumps(seen['steps']['no_remat'][1][4])}")
    log(f"[headline] vision cache: {cache_shape[0]} items in {cache_s:.2f} s, "
        f"{cache_bytes / 2**30:.3f} GiB, launches {json.dumps(cache_launches)} on {gpu_line}")
    log(f"[headline] test pass: {eval_s:.1f} s, {eval_steps} decode steps ({k6_step} K6 a "
        f"step: the int8 backbone), rec "
        f"{ {k: v for k, v in eval_out['rec'].items() if isinstance(v, (int, float))} }; "
        f"launches {json.dumps(eval_launches)} on {gpu_line}")
    writes = seen["writes"]
    log(f"[headline] checkpoint writes (file, s, bytes): "
        f"{[(n, round(w, 2), b) for n, w, b in writes]}; total "
        f"{sum(w[1] for w in writes):.2f} s, {sum(w[2] for w in writes) / 2**30:.2f} GiB "
        f"({seen.get('unwritten', 0)} weights_epoch_0 not written: nothing reads it) "
        f"on {gpu_line}")
    peak = seen["peak_gib"]
    log(f"[headline] peak device memory over the training updates: all four levers "
        f"{peak['main']:.2f} GiB (resumed {peak['resume']:.2f}), without --remat "
        f"{peak['no_remat']:.2f}, --frozen_bf16 with neither int8 nor bf16 state "
        f"{peak['bf16_frozen']:.2f}; host peak RSS {rss_gib:.2f} GiB (the whole script so far; "
        f"{seen['rss_before_copy']:.2f} before the resume check's host copies) "
        f"on {gpu_line}")
    return launches


MULTI_RECORDS = 24     # train users: 2 updates of global batch 12; test users: 2 x 12
# phase 13 runs 3b-mpt at full width and 12 of its 24 LM layers (all 24
# until phase 18 took its time; 198-270 s a call at 24)
LM_LAYERS_13 = 12
MULTI_UPDATES = MULTI_RECORDS // 12
SHARDED_UPDATES = 1    # fsdp 2 / tp 2 runs (depth: one update each)
# (b)'s and fsdp 2's losses vs (a)'s: each micro-batch's float32 gradient is
# summed in another order before its bfloat16 cast, which moves the loss
# after two updates by 5.9e-6 relative (H100 run, 700 W): 17 times below
# this bar. tp 2 also sums the row-parallel blocks' bfloat16 partials and
# runs the pixel path, not the vision cache: its first loss, before any
# update, sits 2.0e-4 from (a)'s (same run).
MULTI_LOSS_REL = 1e-4
TP_LOSS_REL = 1e-3
# each update's logged gradient norm (bfloat16 under --bf16_opt_state) vs
# (a)'s: at most one bfloat16 step apart, 2**-7 of the larger. Adam with
# clipping moves the same for any scale of the gradient, so the losses
# alone would pass a reduction off by a factor of 2; the norm would not.
NORM_REL = 2.0 ** -7
MULTI_DRAW_SEED = 13   # phase 13 keys each training sample's prompt draws by its index
RANK_WAIT_S = 900      # the longest a rank started early waits for the run before it
ITEM_IMAGES = {}       # (path, size) -> decoded item image, filled from phase 9 on


def replica_digest(t: torch.Tensor) -> torch.Tensor:
    """A 64-bit checksum of a tensor's bits: the sum of its elements' bit
    patterns times odd position weights, modulo 2**64. Two tensors that
    differ in one element always differ here (an odd weight is a unit mod
    2**64); several differences cancel with probability about 2**-64."""
    views = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = t.detach().contiguous().view(views[t.element_size()]).reshape(-1).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) * 2654435761 * 2 + 1
    return (v * w).sum()


def state_digests(trainer, names=None) -> dict:
    """{name: digest} of ``train_state_tensors(trainer)`` (or its ``names``)."""
    tensors = train_state_tensors(trainer)
    return {k: int(replica_digest(t)) for k, t in tensors.items()
            if names is None or k in names}


def predicted_zero_bytes(cfg, fsdp: int, frozen) -> dict:
    """ZeRO-3's resident parameter bytes a rank, from the shapes alone: the
    model built on the meta device (no memory, no weights), frozen as the
    training CLI freezes it (``frozen``: "int8" under ``--frozen_int8``),
    and the port's copy of the JAX rule table over its whole shapes
    (``parallel/sharding.py:predicted_resident_bytes``)."""
    from unimp_tpu_torch.models import UniMPModel
    from unimp_tpu_torch.parallel.sharding import predicted_resident_bytes
    from unimp_tpu_torch.train.partition import backbone_trainable_mask, freeze

    with torch.device("meta"):
        model = UniMPModel(cfg)
        freeze(model, backbone_trainable_mask(model), frozen)
    shapes = {k.replace(".", "/"): (tuple(t.shape), t.element_size())
              for k, t in model.state_dict().items()}
    return {**predicted_resident_bytes(shapes, fsdp), "tensors": len(shapes)}


def rank_main(spec_path: str) -> int:
    """One rank of phase 13, launched by ``torch.distributed.run``: runs
    ``mmrec.main`` with the spies the phase reads and writes
    ``{out}/{tag}_rank{r}.json``. Gloo ranks join their group here (NCCL
    ones in ``mmrec.main``) and first try the collectives fsdp and tp need
    on CUDA tensors."""
    import torch.distributed as dist

    from unimp_tpu_torch.cli import mmrec
    from unimp_tpu_torch.data import dataset as dataset_mod
    from unimp_tpu_torch.parallel.mesh import process_device
    from unimp_tpu_torch.train import checkpoint as ckpt

    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    dev = process_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "device": str(dev), "updates": [], "failures": []}
    if spec["backend"] == "gloo":
        dist.init_process_group("gloo")
        out["probe"] = probe_gloo(dev)
    world = int(os.environ["WORLD_SIZE"])
    # each sample's prompt draws keyed by its index: the dataset's own
    # generator runs in the order a process reads, and a rank reads its
    # shard, so without this (a) and (b) would train on other windows of
    # the same users
    orig_get = dataset_mod.TaskDataset.__getitem__

    def keyed_get(self, index):
        own, self.rng = self.rng, np.random.default_rng([MULTI_DRAW_SEED, int(index)])
        try:
            return orig_get(self, index)
        finally:
            self.rng = own

    dataset_mod.TaskDataset.__getitem__ = keyed_get
    if spec.get("image_memo"):
        memo = torch.load(spec["image_memo"], weights_only=False)
        orig_image = dataset_mod.load_resized_uint8

        def image(path, size):
            hit = memo.get((path, size))
            return hit if hit is not None else orig_image(path, size)

        dataset_mod.load_resized_uint8 = image
    # checkpoints this run's reader never opens: not written (the rank's
    # spies below wrap the skipping versions)
    stack = contextlib.ExitStack()
    stack.enter_context(unread_checkpoints(spec.get("unread", ())))
    if spec.get("lm_layers"):
        stack.enter_context(lm_layers(spec["lm_layers"], "3b-mpt"))
    orig = {"step": Trainer.train_step, "state": ckpt.save_train_state,
            "params": ckpt.save_params, "evals": mmrec.run_evals,
            "epoch": mmrec.train_one_epoch, "norm": ClippedAdamWCast.grad_norm}
    seen = {}

    def grad_norm(self):
        # the logged norm, and beside it the clip's: the float32 sum of every
        # tensor's float32 sum of squares (``ClippedAdamWCast.step``), a
        # reading of how far the gradients themselves moved
        if self.norm_reduce is None:
            sq = sum((g.float() * g.float()).sum() for g in self.grads())
        else:
            sq = self.norm_reduce(_square_sums(self.grad, self.named)).sum()
        seen["norm_f32"] = float(torch.sqrt(sq))
        return orig["norm"](self)

    def step(self, batch):
        zero = self.zero
        if zero is not None:
            zero.reset_counters()
        before, t0 = counts(), time.perf_counter()
        metrics = orig["step"](self, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"ms": ms, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "norm_f32": seen.pop("norm_f32"),
               "skipped": int(metrics["skipped_nonfinite"]), "launches": between(before),
               "rows": list(np.shape(batch["input_ids"]))}
        if zero is not None:
            # ZeRO-3's traffic over the update, and the gathered whole tensors
            # alive at once at the worst moment (``ZeroShards`` counters)
            rec["zero"] = {"gathered_gib": zero.gathered_bytes / 2**30,
                           "scattered_gib": zero.scattered_bytes / 2**30,
                           "gathers": zero.gathers, "gather_s": zero.gather_s,
                           "peak_alive_gib": zero.peak_alive_bytes / 2**30}
        if world > 1:
            # the replicas' whole tensors after the update: one digest each,
            # gathered from every rank and compared
            layout = self.model.tp_layout
            names = [f"param {n}" for n in self.params if n.replace(".", "/") not in layout
                     and not (zero is not None and zero.sharded(n))]
            if self.zero is None and not layout:
                names += [f"{m} {n}" for m in ("mu", "nu") for n in self.params]
            mine = torch.tensor(list(state_digests(self, set(names)).values()),
                                dtype=torch.int64)
            every = torch.empty(world * mine.numel(), dtype=torch.int64)
            dist.all_gather_into_tensor(every, mine)
            every = every.reshape(world, -1)
            rec["replicas_equal"] = bool((every == every[0]).all())
            rec["compared"] = int(mine.numel())
            if not rec["replicas_equal"]:
                out["failures"].append(f"update {len(out['updates'])}: the ranks' tensors "
                                       "differ")
        out["updates"].append(rec)
        if len(out["updates"]) == spec.get("stop_after_updates"):
            raise StopRun("updates")
        return metrics

    def epoch(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            orig["epoch"](*args, **kw)
        finally:
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    def evals(args_, model, *args, **kw):
        before, t0 = counts(), time.perf_counter()
        steps0 = seen.get("decode_steps", 0)
        res = orig["evals"](args_, model, *args, **kw)
        out["eval"] = {"s": time.perf_counter() - t0, "launches": between(before),
                       "decode_steps": seen.get("decode_steps", 0) - steps0,
                       "k6_per_step": k6_per_decode_step(model),
                       "rec": {k: v for k, v in res["rec"].items()
                               if isinstance(v, (int, float))}}
        return res

    def decode_step(self, *args, **kw):
        seen["decode_steps"] = seen.get("decode_steps", 0) + 1
        return orig_decode(self, *args, **kw)

    orig_decode = Generator._decode_step

    def save_state(save_dir, trainer, ep):
        t0 = time.perf_counter()
        path = orig["state"](save_dir, trainer, ep)
        out["checkpoint"] = {"path": path, "s": time.perf_counter() - t0}
        if rank == 0 and spec.get("digests_out"):
            Path(spec["digests_out"]).write_text(json.dumps(state_digests(trainer)))
            # the int8 payloads, which the checkpoint holds dequantized: host
            # copies for (c)
            torch.save({k: t.cpu() for k, t in train_state_tensors(trainer).items()
                        if k.startswith("q ")}, spec["digests_out"] + ".payloads.pt")
        raise StopRun("checkpoint")

    def save_params(save_dir, model, name="final_weights"):
        if name != "final_weights" or not spec.get("resume_check"):
            return orig["params"](save_dir, model, name)
        # (c): the run resumed and trained nothing; hold its state to what
        # (b) saved (the checkpoint's weights and moments and (b)'s int8
        # payloads, exactly; every tensor by digest), then stop before
        # writing
        trainer = seen["trainer_ref"]
        saved = json.loads(Path(spec["resume_check"]).read_text())
        now = state_digests(trainer)
        differ = sorted(k for k in set(now) | set(saved) if now.get(k) != saved.get(k))
        params = ckpt.restore_params(save_dir, "checkpoint_0")
        state = ckpt.restore_train_state(save_dir, "checkpoint_0")["opt_state"]
        exact = 0
        for n, p in trainer.params.items():
            exact += 1
            if not torch.equal(p.detach().cpu(), params[n.replace(".", "/")]):
                differ.append(f"file param {n}")
        for m in ("mu", "nu"):
            for n, t in getattr(trainer.optimizer, m).items():
                exact += 1
                if not torch.equal(t.cpu(), state[m][n]):
                    differ.append(f"file {m} {n}")
        payloads = torch.load(spec["resume_check"] + ".payloads.pt")
        mine = {k: t for k, t in train_state_tensors(trainer).items() if k.startswith("q ")}
        differ += sorted(set(payloads) ^ set(mine))
        for k in set(payloads) & set(mine):
            exact += 1
            if not torch.equal(mine[k].cpu(), payloads[k]):
                differ.append(f"saved {k}")
        out["resume"] = {"digests": len(now), "exact_vs_file": exact, "differ": differ[:8],
                         "n_differ": len(differ)}
        if differ:
            out["failures"].append(f"resumed state differs: {differ[:8]}")
        raise StopRun("resumed")

    from unimp_tpu_torch.cli import common
    from unimp_tpu_torch.models import UniMPModel

    orig_build = common.build_model

    def build(args, tokenizer, **kw):
        # the build's own peak: the model made tensor by tensor, each rank's
        # straight into its chunks; beside it what the rank keeps and the
        # largest whole float32 tensor of the model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = orig_build(args, tokenizer, **kw)
        torch.cuda.synchronize()
        with torch.device("meta"):
            whole = UniMPModel(model.cfg)
        out["build"] = {
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "resident_gib": sum(t.numel() * t.element_size()
                                for t in model.state_dict().values()) / 2**30,
            "largest_f32_gib": max(p.numel() for p in whole.parameters()) * 4 / 2**30}
        return model

    common.build_model = build
    orig_trainer_init = Trainer.__init__

    def trainer_init(self, *args, **kw):
        orig_trainer_init(self, *args, **kw)
        seen["trainer_ref"] = self
        if self.zero is not None:
            from unimp_tpu_torch.parallel.sharding import resident_bytes

            units = self.zero.unit_bytes()
            out["zero"] = {
                "resident": resident_bytes(self.model),
                "predicted": predicted_zero_bytes(
                    self.model.cfg, self.mesh.fsdp,
                    "int8" if "--frozen_int8" in spec["argv"] else None),
                "sharded_tensors": len(self.zero.entries),
                "pad_bytes": sum((e.chunk * self.zero.n - e.numel) * e.itemsize
                                 for e in self.zero.entries.values()),
                "two_units_gib": sum(sorted(units.values())[-2:]) / 2**30,
                "largest_units": sorted(units.items(), key=lambda kv: kv[1])[-2:]}

    (Trainer.train_step, ckpt.save_train_state, ckpt.save_params, mmrec.run_evals,
     mmrec.train_one_epoch, Generator._decode_step, Trainer.__init__,
     ClippedAdamWCast.grad_norm) = (
        step, save_state, save_params, evals, epoch, decode_step, trainer_init, grad_norm)
    if spec.get("wait_for"):
        # started before the run it follows has ended, so that this start-up
        # overlaps it: the phase writes this file when that run has passed
        t0, go = time.perf_counter(), Path(spec["wait_for"])
        while not go.exists():
            if time.perf_counter() - t0 > RANK_WAIT_S:
                raise TimeoutError(f"({spec['tag']}) rank {rank}: no {go} after {RANK_WAIT_S} s")
            time.sleep(0.1)
        out["wait_s"] = time.perf_counter() - t0
    kernel_lib.reset_launches()
    t0 = time.perf_counter()
    try:
        mmrec.main(spec["argv"])
        out["failures"].append("mmrec.main returned before the phase stopped it")
    except StopRun as e:
        out["stopped"] = str(e)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = counts()
    trainer = seen.get("trainer_ref")
    if trainer is not None:
        out["k_fwd"] = flash_per_micro_batch(trainer.model.cfg, trainer.zero is not None)
    Path(spec["out"], f"{spec['tag']}_rank{rank}.json").write_text(json.dumps(out))
    stack.close()
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def probe_gloo(dev) -> dict:
    """Which collectives gloo takes on CUDA tensors here: {name: "ok" or
    the error}."""
    import torch.distributed as dist

    world = dist.get_world_size()
    tries = {
        "all_reduce f32": lambda: dist.all_reduce(torch.ones(4, device=dev)),
        "all_reduce bf16": lambda: dist.all_reduce(torch.ones(4, device=dev,
                                                              dtype=torch.bfloat16)),
        "all_gather_into_tensor f32": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), torch.ones(4, device=dev)),
        # ZeRO-3's int8 frozen payloads
        "all_gather_into_tensor int8": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev, dtype=torch.int8),
            torch.ones(4, device=dev, dtype=torch.int8)),
        "reduce_scatter_tensor f32": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * world, device=dev)),
    }
    result = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            result[name] = "ok"
        except Exception as e:  # a refused collective is this probe's answer
            result[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return result


def flash_per_micro_batch(cfg, zero=False) -> dict:
    """(forward blocks, checkpointed blocks) of one micro-batch: K1 / K2 /
    K3 run once a block, K1 again for each recomputed block (under ZeRO-3,
    ``zero``, the perceiver's blocks recompute too)."""
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    return {"fwd": cfg.resampler.depth + n_xattn + lm.num_layers,
            "recompute": n_xattn + lm.num_layers + (cfg.resampler.depth if zero else 0),
            "n_xattn": n_xattn,
            "layers": lm.num_layers, "vision": cfg.vision.num_layers}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_start(tag: str, nproc: int, spec: dict, out_dir: Path) -> dict:
    """Start ``python -m torch.distributed.run --nproc_per_node nproc`` of
    this script's rank mode on a free local port, in a session of its own;
    ``torchrun_finish`` waits for it."""
    spec = {**spec, "tag": tag, "out": str(out_dir)}
    spec_path = out_dir / f"{tag}.json"
    spec_path.write_text(json.dumps(spec))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           str(Path(__file__).resolve()), "--multi-gpu-rank", str(spec_path)]
    log_path = out_dir / f"{tag}.log"
    logf = open(log_path, "w")
    proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, start_new_session=True,
                            cwd=str(Path(__file__).resolve().parent))
    return {"tag": tag, "nproc": nproc, "proc": proc, "log": log_path, "logf": logf,
            "out": out_dir, "t0": time.perf_counter()}


def torchrun_finish(run: dict, timeout: float) -> list:
    """Wait for a ``torchrun_start``; returns each rank's report. The whole
    session (the launcher and its ranks) is killed at ``timeout`` seconds
    from the start."""
    import signal

    tag, proc, log_path, out_dir = run["tag"], run["proc"], run["log"], run["out"]
    try:
        rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - run["t0"])))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    finally:
        run["logf"].close()
    nproc = run["nproc"]
    if rc != 0:
        tail = log_path.read_text()[-4000:]
        raise AssertionError(f"[multi-gpu] ({tag}) torchrun exited {rc}:\n{tail}")
    reports = [json.loads((out_dir / f"{tag}_rank{r}.json").read_text()) for r in range(nproc)]
    for rep in reports:
        if rep["failures"]:
            raise AssertionError(f"[multi-gpu] ({tag}) rank {rep['rank']}: {rep['failures']}")
    return reports


def check_updates(tag, rep, n_updates, rows, want=None, pixels=False,
                  loss_rel=MULTI_LOSS_REL) -> list:
    """Every update finite and not skipped, a batch of ``rows`` rows of 256
    tokens, K1 / K2 / K3 at what the model counts (2 micro-batches; K1
    again for each recomputed block, and for each ViT layer on the pixel
    path), no K6 (the dequantized matmul above 512 rows); with ``want``
    ((a)'s losses and grad norms) each loss within ``loss_rel`` and each
    norm within ``NORM_REL`` of (a)'s. Returns the losses."""
    k = rep["k_fwd"]
    vit = k["vision"] if pixels else 0
    counts = {"flash_fwd": 2 * (k["fwd"] + k["recompute"] + vit),
              "flash_bwd_dkv": 2 * k["fwd"], "flash_bwd_dq": 2 * k["fwd"], "quant_matmul": 0}
    ups = rep["updates"]
    if len(ups) != n_updates:
        raise AssertionError(f"[multi-gpu] ({tag}) rank {rep['rank']}: {len(ups)} updates, "
                             f"expected {n_updates}")
    for i, u in enumerate(ups):
        if u["skipped"] or not (np.isfinite(u["loss"]) and np.isfinite(u["grad_norm"])):
            raise AssertionError(f"[multi-gpu] ({tag}) update {i}: {u}")
        got = {name: u["launches"][name] for name in counts}
        if got != counts or u["rows"] != [rows, 256]:
            raise AssertionError(f"[multi-gpu] ({tag}) update {i}: launches {got} (want "
                                 f"{counts}), rows {u['rows']}")
    losses = [u["loss"] for u in ups]
    if want is not None:
        norms = [u["grad_norm"] for u in ups]
        rel = [abs(x - y) / abs(y) for x, y in zip(losses, want["losses"])]
        rel_norm = [abs(x - y) / max(abs(x), abs(y)) for x, y in zip(norms, want["norms"])]
        if max(rel) > loss_rel or max(rel_norm) > NORM_REL:
            raise AssertionError(f"[multi-gpu] ({tag}) losses {losses} vs (a) {want['losses']}"
                                 f": rel {rel} (limit {loss_rel}); grad norms {norms} vs (a) "
                                 f"{want['norms']}: rel {rel_norm} (limit {NORM_REL})")
    return losses


def check_test_pass(tag, rep, n_users) -> dict:
    ev = rep["eval"]
    k, steps = rep["k_fwd"], ev["decode_steps"]
    ln = ev["launches"]
    if (not 0 < steps or ln["quant_matmul"] != ev["k6_per_step"] * steps
            or ln["decode_attn"] != k["layers"] * steps
            or ln["single_query_attn"] != k["n_xattn"] * steps):
        raise AssertionError(f"[multi-gpu] ({tag}) test pass launches {ln} over {steps} "
                             f"decode steps")
    rec = ev["rec"]
    if rec["n_users"] != n_users or not all(np.isfinite(v) for v in rec.values()):
        raise AssertionError(f"[multi-gpu] ({tag}) test metrics {rec}, want {n_users} users")
    return rec


# a rank's build peak may pass its resident bytes and the largest whole
# float32 tensor by this much: the tensor's tp block and fsdp chunk copies,
# a cast chunk, the quantizer's column blocks and the allocator's rounding
BUILD_SLACK_GIB = 0.25


def check_zero(reps, b_reps, gpu_line) -> None:
    """fsdp 2's ZeRO-3 gates, each rank: resident parameter bytes equal to
    what the table predicts from the shapes (the sharded ones within the
    padding, at most fsdp - 1 elements a tensor), the gathered whole
    tensors alive at once at or under the two largest units' bytes in every
    update, a peak below every rank of (b) (dp 2, the same rows a rank) in
    the same call, and a build peak at most the rank's resident bytes plus
    its largest whole float32 tensor plus ``BUILD_SLACK_GIB``. Prints the
    readings first."""
    b_peak = min(rep["peak_gib"] for rep in b_reps)
    failed = []
    for rep in reps:
        z = rep["zero"]
        res, pred = z["resident"], z["predicted"]
        ups = [u["zero"] for u in rep["updates"]]
        log(f"[multi-gpu] (fsdp2) rank {rep['rank']} ZeRO-3: resident parameters "
            f"{res['sharded'] / 2**30:.4f} GiB sharded + {res['replicated'] / 2**30:.4f} GiB "
            f"replicated; predicted from the shapes {pred['sharded'] / 2**30:.4f} + "
            f"{pred['replicated'] / 2**30:.4f} GiB ({z['sharded_tensors']} of "
            f"{pred['tensors']} tensors sharded, {z['pad_bytes']} B of padding); peak "
            f"{rep['peak_gib']:.2f} GiB vs (b)'s dp-2 ranks "
            f"{[round(r['peak_gib'], 2) for r in b_reps]} GiB; per update gathered {[round(u['gathered_gib'], 3) for u in ups]} GiB in "
            f"{[u['gathers'] for u in ups]} gathers, {[round(u['gather_s'], 2) for u in ups]} s, "
            f"reduce-scattered {[round(u['scattered_gib'], 3) for u in ups]} GiB; whole tensors "
            f"alive at most {[round(u['peak_alive_gib'], 4) for u in ups]} GiB (two largest "
            f"units {z['two_units_gib']:.4f} GiB: {z['largest_units']}) on {gpu_line}")
        pad = res["sharded"] - pred["sharded"]
        if res["replicated"] != pred["replicated"] or not (
                0 <= pad == z["pad_bytes"] <= 4 * z["sharded_tensors"]):
            failed.append(f"rank {rep['rank']} resident {res} vs predicted {pred}")
        if any(u["peak_alive_gib"] > z["two_units_gib"] for u in ups):
            failed.append(f"rank {rep['rank']} whole tensors alive "
                          f"{[u['peak_alive_gib'] for u in ups]} GiB > two units "
                          f"{z['two_units_gib']} GiB")
        if not rep["peak_gib"] < b_peak:
            failed.append(f"rank {rep['rank']} peak {rep['peak_gib']:.2f} GiB not below (b)'s "
                          f"{b_peak:.2f} GiB")
        bld = rep["build"]
        if bld["peak_gib"] > bld["resident_gib"] + bld["largest_f32_gib"] + BUILD_SLACK_GIB:
            failed.append(f"rank {rep['rank']} build peak {bld['peak_gib']:.3f} GiB above "
                          f"{bld['resident_gib']:.3f} resident + {bld['largest_f32_gib']:.3f} "
                          f"(the largest whole float32 tensor) + {BUILD_SLACK_GIB} GiB")
    if failed:
        raise AssertionError(f"[multi-gpu] (fsdp2) ZeRO-3: {failed}")


def phase_multi_gpu(gpu_line, data, run_dir) -> dict:
    """Multi-GPU through the port's CLI (phase 13): ``mmrec.main`` under
    ``torch.distributed.run``, each rank a process, on phase 12's
    configuration (3b-mpt, ``--frozen_int8 --bf16_opt_state --remat
    --remat_policy dots --cache_vision_latents``, T 256, 6 images, a
    10-beam test pass) with the train split cut to 24 users:

      (a) one rank over NCCL (no one-rank shortcut: every collective of the
          distributed path runs), micro-batch 6 x accum 2 fused: 2 updates
          of the global batch 12, the test pass over 24 users,
          ``checkpoint_0`` (``weights_epoch_0``, which nothing reads, is
          not written), then stopped;
      (b) two ranks sharing the card over gloo (dp 2), micro-batch 3 x
          accum 2 fused from the same seed: the same global batches,
          ``checkpoint_0`` as (a);
      (c) (b)'s ``checkpoint_0`` resumed in one rank (NCCL).

    (a) and (b) run at once. NCCL refuses two ranks on one
    device, so (b) runs gloo, which moves CUDA tensors through the host.
    (c) starts when (a) ends, so that its process start-up overlaps (b),
    and waits for a go file that the phase writes once (b) has passed its
    gates; fsdp 2 and tp 2 start then too, and run beside (c).
    Every rank draws each sample's prompt window from a generator keyed by
    the sample's index (``rank_main``),
    so that (a) and (b) train on the same prompts, not only on the same
    users. Fails unless every update is finite,
    K1 / K2 / K3 ran what the model counts in every update and K4 / K5 / K6
    at every decode step, (b)'s ranks hold the same tensors after every
    update (``replica_digest``), each of (b)'s losses is within 1e-4 of
    (a)'s and each grad norm within one bfloat16 step (``MULTI_LOSS_REL``,
    ``NORM_REL``), (b)'s test pass covers (a)'s users, and (c)'s weights,
    bf16 moments and int8 payloads equal (b)'s: host copies (the
    checkpoint's weights and moments, (b)'s payloads written at its save)
    bit for bit, and every tensor's digest against (b)'s live state at its
    save. When gloo takes all-gather and reduce-scatter on CUDA tensors,
    fsdp 2 and tp 2 run one update each (``SHARDED_UPDATES``) under the
    same gates (tp 2's losses within ``TP_LOSS_REL``), both at once (their
    update times share the card and the host), tp 2 without the vision
    cache; otherwise the refused collective is printed. Each update also
    reports the clip's float32 gradient norm beside the logged bfloat16
    one."""
    run_dir.mkdir(parents=True, exist_ok=True)
    log(f"[multi-gpu] {host_memory_line(run_dir)}")
    memo_path = run_dir / "item_images.pt"
    torch.save(dict(ITEM_IMAGES), memo_path)
    base = ["--mmrec_path", str(data), "--pretrained_model_name_or_path", "3b-mpt",
            "--subset", "beauty", "--task", "rec", "--single_task", "--n_items",
            str(N_ITEM_TOKENS), "--history_len", "6", "--use_semantic", "--patch-image-size",
            "224", "--max_records", str(MULTI_RECORDS), "--eval_batch_size",
            str(MULTI_RECORDS // 2),
            "--num_beams", "10", "--workers", "2", "--device", "cuda",
            "--gradient_accumulation_steps", "2", "--fused_accumulation", "--use_reweight",
            "--gamma", "2", "--cache_vision_latents", "--logging_steps", "1",
            "--num_epochs", "1", *HEADLINE_LEVERS]
    common = {"image_memo": str(memo_path), "lm_layers": LM_LAYERS_13}
    walls, reports = {}, {}

    def start(tag, nproc, argv, **spec):
        return torchrun_start(tag, nproc, {**common, **spec, "argv": argv}, run_dir)

    def finish(run, timeout):
        reps = torchrun_finish(run, timeout)
        walls[run["tag"]] = time.perf_counter() - run["t0"]
        reports[run["tag"]] = reps
        return reps

    a_dir, b_dir = run_dir / "a", run_dir / "b"
    digests = run_dir / "b_digests.json"
    c_go = run_dir / "c.go"
    # (c) trains nothing: no vision cache
    uncached = [a for a in base if a != "--cache_vision_latents"]
    pending = []  # runs started and not finished: killed if the phase fails

    def begin(tag, nproc, argv, **spec):
        run = start(tag, nproc, argv, **spec)
        pending.append(run)
        return run

    def end(run, timeout):
        pending.remove(run)
        return finish(run, timeout)

    probe, sharded, sharded_failed = {}, {}, []
    try:
        # nothing reads the runs' weights_epoch_0: not written. (a) and (b)
        # run at once (their update times share the card and the host)
        run_a = begin("a", 1, base + ["--external_save_dir", str(a_dir), "--run_name", "a",
                                      "--batch_size", "6", "--do_test"], backend="nccl",
                      unread=["weights_epoch_0"])
        run_b = begin("b", 2, base + ["--external_save_dir", str(b_dir), "--run_name", "b",
                                      "--batch_size", "3", "--do_test"], backend="gloo",
                      digests_out=str(digests), unread=["weights_epoch_0"])
        (a,) = end(run_a, 600)
        losses_a = check_updates("a", a, MULTI_UPDATES, 12)
        want_a = {"losses": losses_a, "norms": [u["grad_norm"] for u in a["updates"]]}
        rec_a = check_test_pass("a", a, MULTI_RECORDS)
        if not Path(a["checkpoint"]["path"], "train_state.pt").exists():
            raise AssertionError("[multi-gpu] (a) wrote no checkpoint_0")
        shutil.rmtree(a_dir)
        # (c) starts while (b) ends and waits for its go file (``rank_main``);
        # fsdp 2 and tp 2 start once (b) has passed, beside (c)
        run_c = begin("c", 1, uncached + ["--external_save_dir", str(b_dir), "--run_name", "b",
                                          "--batch_size", "6", "--resume_from_checkpoint"],
                      backend="nccl", resume_check=str(digests), wait_for=str(c_go))
        b = end(run_b, 900)
        losses_b = [check_updates("b", rep, MULTI_UPDATES, 6, want_a) for rep in b]
        if losses_b[0] != losses_b[1]:
            raise AssertionError(f"[multi-gpu] (b) the ranks' losses differ: {losses_b}")
        rec_b = [check_test_pass("b", rep, MULTI_RECORDS) for rep in b]
        if not Path(b[0]["checkpoint"]["path"], "train_state.pt").exists():
            raise AssertionError("[multi-gpu] (b) rank 0 wrote no checkpoint_0")
        c_go.write_text("")
        probe = b[0]["probe"]
        runs = {}
        if all(probe[name] == "ok" for name in probe):
            # both at once on the card (4 ranks): tp 2 on the pixel path, since
            # a vision cache of every item through a tp-sharded tower would
            # all-reduce each ViT layer's activations through the host
            runs = {tag: begin(tag, 2, (base if tag == "fsdp2" else uncached) + [
                        "--external_save_dir", str(run_dir / tag), "--run_name", tag,
                        "--batch_size", "3" if tag == "fsdp2" else "6", *flags],
                        backend="gloo", stop_after_updates=SHARDED_UPDATES)
                    for tag, flags in (("fsdp2", ["--mesh_fsdp", "2"]),
                                       ("tp2", ["--mesh_tp", "2"]))}
        (c,) = end(run_c, 600)
        if not c.get("resume") or c["resume"]["n_differ"]:
            raise AssertionError(f"[multi-gpu] (c) resume: {c.get('resume')}")
        shutil.rmtree(b_dir)
        for tag, handle in runs.items():
            reps = end(handle, 600)
            shutil.rmtree(run_dir / tag, ignore_errors=True)
            try:  # a failed gate is raised after the readings below are printed
                sharded[tag] = [check_updates(tag, rep, SHARDED_UPDATES,
                                              6 if tag == "fsdp2" else 12, want_a,
                                              pixels=tag == "tp2",
                                              loss_rel=TP_LOSS_REL if tag == "tp2" else
                                              MULTI_LOSS_REL)
                                for rep in reps]
                if tag == "fsdp2":
                    check_zero(reps, b, gpu_line)
            except AssertionError as e:
                sharded_failed.append(str(e))
    finally:
        for run in pending:  # no run outlives a failed phase
            os.killpg(run["proc"].pid, signal.SIGKILL)
            run["proc"].wait()
            run["logf"].close()
    if not sharded and not sharded_failed:
        refused = {k: v for k, v in probe.items() if v != "ok"}
        log(f"[multi-gpu] fsdp 2 and tp 2 not run on the card: gloo refused {refused} on "
            f"CUDA tensors (torch {torch.__version__}); tests/test_torch_parallel.py holds "
            f"them to the JAX package on the CPU")

    # --- report
    log(f"[multi-gpu] runs (s, from each start; (c), fsdp 2 and tp 2 start early and wait "
        f"for the run before them) { {k: round(v, 1) for k, v in walls.items()} }; ranks' "
        f"waits (s) { {k: round(r[0].get('wait_s', 0.0), 1) for k, r in reports.items()} } "
        f"on {gpu_line}; NCCL above one rank not measured (one card: NCCL refuses two ranks "
        f"on one device)")
    log(f"[multi-gpu] gloo on CUDA tensors: {json.dumps(probe)}")
    for tag, reps in reports.items():
        for rep in reps:
            ups = rep["updates"]
            log(f"[multi-gpu] ({tag}) rank {rep['rank']} {rep['device']}: update ms "
                f"{[round(u['ms'], 1) for u in ups]}, losses {[round(u['loss'], 6) for u in ups]}"
                f", grad norms {[round(u['grad_norm'], 4) for u in ups]} (float32 "
                f"{[u['norm_f32'] for u in ups]}), replicas equal "
                f"{[u.get('replicas_equal') for u in ups]} ({ups[0].get('compared') if ups else 0}"
                f" tensors), peak {rep.get('peak_gib', 0):.2f} GiB, wall {rep['wall_s']:.1f} s"
                f", checkpoint {rep.get('checkpoint', {}).get('s', 0):.2f} s on {gpu_line}")
            bld = rep.get("build")
            if bld:
                log(f"[multi-gpu] ({tag}) rank {rep['rank']} build: peak {bld['peak_gib']:.3f} "
                    f"GiB (reset before the build, read after it) for {bld['resident_gib']:.3f} "
                    f"GiB resident, largest whole float32 tensor {bld['largest_f32_gib']:.3f} GiB"
                    f"; the update's peak {rep.get('peak_gib', 0):.2f} GiB on {gpu_line}")
    rel = [abs(x - y) / abs(y) for x, y in zip(losses_b[0], losses_a)]
    norms_b = [u["grad_norm"] for u in b[0]["updates"]]
    log(f"[multi-gpu] losses (a) {losses_a} vs (b) {losses_b[0]}: rel {rel} (limit "
        f"{MULTI_LOSS_REL}); grad norms (a) {want_a['norms']} vs (b) {norms_b} (limit one "
        f"bfloat16 step, {NORM_REL} of the larger); test pass (a) {rec_a}, (b) rank 0 {rec_b[0]}, eval s "
        f"(a) {a['eval']['s']:.1f} / (b) {b[0]['eval']['s']:.1f}")
    log(f"[multi-gpu] (c) resumed (b)'s checkpoint_0 in one rank: {c['resume']['digests']} "
        f"tensors equal (b)'s at its save by digest, and {c['resume']['exact_vs_file']} "
        f"exactly (host copies: the checkpoint's weights and moments, (b)'s int8 payloads)")
    if sharded:
        log(f"[multi-gpu] sharded losses vs (a): {json.dumps(sharded)}")
    # the logged norm is a bfloat16 sum over the tensors, rounded at each
    # add (optax.global_norm's rounding); the float32 norm beside it shows
    # how far the gradients themselves moved
    f32 = {tag: [u["norm_f32"] for u in reps[0]["updates"]] for tag, reps in reports.items()
           if reps[0]["updates"]}
    log(f"[multi-gpu] first update's grad norm vs (a): "
        + json.dumps({tag: {"logged": reports[tag][0]["updates"][0]["grad_norm"],
                            "float32": v[0], "float32_rel": abs(v[0] - f32["a"][0]) / f32["a"][0]}
                      for tag, v in f32.items()}))
    if sharded_failed:
        raise AssertionError("; ".join(sharded_failed))
    launches = {}
    for reps in reports.values():
        for rep in reps:
            for name, n in rep["launches"].items():
                launches[name] = launches.get(name, 0) + n
    return launches


# ------------------------------------------------------------ phase 14

TOOLS_USERS = 24        # (c) and (d): test users, one batch
FEATURE_ITEMS = 640     # (d): its own synthetic set (depth), more items than the 512
                        # codes of a semantic-ID level, so that k-means merges some
BPE_MERGES = 400        # (c): merges learned from the synthetic corpus
FEATURE_TOL = 2e-2      # (d): card (bf16) vs CPU features, of max |f|
VQGAN_TOL = 1e-4        # (e): card vs CPU float32, absolute
# taming-transformers configs/vqgan_imagenet_f16_1024.yaml
VQGAN_F16_1024 = dict(ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2, attn_resolutions=(16,),
                      z_channels=256, embed_dim=256, n_embed=1024, resolution=256)


def taming_decoder_state_dict(seed, ch, ch_mult, num_res_blocks, attn_resolutions, z_channels,
                              embed_dim, n_embed, resolution, out_ch=3) -> dict:
    """A seeded state dict under taming-transformers' VQModel names (the
    quantizer, ``post_quant_conv`` and the decoder): torch's default conv
    init, GroupNorm affine near 1 / 0, a unit-normal codebook scaled down."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cin, cout, k):
        bound = 1 / math.sqrt(cin * k * k)
        sd[f"{name}.weight"] = (torch.rand(cout, cin, k, k, generator=gen) * 2 - 1) * bound
        sd[f"{name}.bias"] = (torch.rand(cout, generator=gen) * 2 - 1) * bound

    def norm(name, c):
        sd[f"{name}.weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)

    def resnet(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout, 3)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.nin_shortcut", cin, cout, 1)

    def attn(name, c):
        norm(f"{name}.norm", c)
        for part in ("q", "k", "v", "proj_out"):
            conv(f"{name}.{part}", c, c, 1)

    sd["quantize.embedding.weight"] = torch.randn(n_embed, embed_dim, generator=gen) * 0.1
    conv("post_quant_conv", embed_dim, z_channels, 1)
    block_in = ch * ch_mult[-1]
    res = resolution // 2 ** (len(ch_mult) - 1)
    conv("decoder.conv_in", z_channels, block_in, 3)
    resnet("decoder.mid.block_1", block_in, block_in)
    attn("decoder.mid.attn_1", block_in)
    resnet("decoder.mid.block_2", block_in, block_in)
    for level in reversed(range(len(ch_mult))):
        block_out = ch * ch_mult[level]
        for j in range(num_res_blocks + 1):
            resnet(f"decoder.up.{level}.block.{j}", block_in, block_out)
            block_in = block_out
            if res in attn_resolutions:
                attn(f"decoder.up.{level}.attn.{j}", block_in)
        if level != 0:
            conv(f"decoder.up.{level}.upsample.conv", block_in, block_in, 3)
            res *= 2
    norm("decoder.norm_out", block_in)
    conv("decoder.conv_out", block_in, out_ch, 3)
    return sd


def train_bpe_json(corpus, n_merges: int) -> dict:
    """A byte-level BPE ``tokenizer.json`` in the ``tokenizers`` library's
    format, learned here from ``corpus`` (the card's machine has no
    ``tokenizers``): GPT-2's byte alphabet, then the most frequent pair of
    the pre-tokenized corpus merged ``n_merges`` times (ties: the pair seen
    first); the NFC normalizer, the ByteLevel pre-tokenizer without a
    prefix space and its decoder; the framework's six specials added."""
    from collections import Counter

    from unimp_tpu_torch.data import tokenizer as tokmod

    words = Counter("".join(tokmod.BYTE_CHAR[b] for b in w.encode("utf-8"))
                    for line in corpus for w in tokmod.byte_level_split(line))
    split = {w: list(w) for w in words}
    alphabet = sorted(tokmod.BYTE_CHAR.values(), key=lambda c: tokmod.CHAR_BYTE[c])
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, syms in split.items():
            for pair in zip(syms, syms[1:]):
                pairs[pair] += words[w]
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append([a, b])
        vocab.setdefault(a + b, len(vocab))
        for w, syms in split.items():
            k, out = 0, []
            while k < len(syms):
                if k + 1 < len(syms) and syms[k] == a and syms[k + 1] == b:
                    out.append(a + b)
                    k += 2
                else:
                    out.append(syms[k])
                    k += 1
            split[w] = out
    added = [{"id": len(vocab) + i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate((tokmod.PAD, tokmod.UNK, tokmod.BOS, tokmod.EOS,
                                    tokmod.MEDIA_TOKEN, tokmod.ENDOFCHUNK_TOKEN))]
    level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": True}
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "NFC"}, "pre_tokenizer": level, "post_processor": level,
            "decoder": level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}


class _Tower(torch.nn.Module):
    """A vision tower as ``extract_image_features`` takes a model."""

    def __init__(self, vision):
        super().__init__()
        self.vision = vision


def phase_tools(dev, gpu_line, data, run_dir):
    """The tools through the port's CLIs at full width (phase 14; (a) runs
    inside phase 9): (b) seeded 3b-mpt exported by ``export_torch``, then
    ``mmrec --load_from_original_checkpoint`` with phase 12's levers, one
    update and the test pass; (c) a byte-level BPE ``tokenizer.json``
    through ``mmrec_eval --tokenizer_path`` at 4b-instruct; (d) image
    features of a synthetic set's items through (c)'s tower, semantic IDs,
    then ``mmrec_eval --use_semantic``; (e) a VQGAN decoder at taming's
    f16-1024 shapes on phase 10's img_gen dump."""
    from unimp_tpu_torch.cli import common, mmrec, mmrec_eval
    from unimp_tpu_torch.cli.arguments import build_parser
    from unimp_tpu_torch.tools import convert_torch, export_torch, features, from_flax
    from unimp_tpu_torch.tools import synth_data, vqgan_decoder
    from unimp_tpu_torch.train import checkpoint as ckpt

    log(f"[tools] {host_memory_line(run_dir.parent)}")
    run_dir.mkdir(parents=True, exist_ok=True)
    seen = {"reports": [], "decode_steps": 0}
    orig = {"convert": convert_torch.convert_state_dict,
            "step": Trainer.train_step, "build": common.build_model,
            "decode_step": Generator._decode_step,
            "load": mmrec.load_torch_checkpoint, "requant": mmrec.apply_frozen_storage}
    def convert(state_dict, target):
        out, report = orig["convert"](state_dict, target)
        seen["reports"].append(report)
        return out, report

    def load(path, target):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["load"](path, target)
        seen["load_s"] = time.perf_counter() - t0
        return out

    def requant(model, names):
        t0 = time.perf_counter()
        out = orig["requant"](model, names)
        torch.cuda.synchronize()
        seen["requant_s"] = time.perf_counter() - t0
        return out

    def step(self, batch):
        if "loaded" not in seen:  # right after the load: held to freeze() of the source
            want = from_flax.build_model(self.model.cfg, device=dev, train=True,
                                         frozen_dtype="int8", weights=seen.pop("source_tree"))
            got_state, want_state = self.model.state_dict(), want.state_dict()
            seen["loaded"] = (len(want_state), sorted(
                k for k in set(got_state) | set(want_state)
                if k not in got_state or k not in want_state
                or got_state[k].dtype != want_state[k].dtype
                or not torch.equal(got_state[k], want_state[k])),
                count_quantized(self.model))
            del want, got_state, want_state
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        metrics = orig["step"](self, batch)
        torch.cuda.synchronize()
        seen.setdefault("steps", []).append((time.perf_counter() - t0, float(metrics["loss"]),
                                             int(metrics["skipped_nonfinite"]),
                                             torch.cuda.max_memory_allocated() / 2**30))
        return metrics

    def build(args, tokenizer, **kw):
        seen["model"] = orig["build"](args, tokenizer, **kw)
        return seen["model"]

    def decode_step(self, *args, **kw):
        seen["decode_steps"] += 1
        return orig["decode_step"](self, *args, **kw)

    def eval_argv(mmrec_path, run_name, n_items, *extra):
        return ["--mmrec_path", str(mmrec_path), "--external_save_dir", str(run_dir),
                "--run_name", run_name, "--pretrained_model_name_or_path", "4b-instruct",
                "--subset", "beauty", "--task", "rec", "--single_task", "--n_items",
                str(n_items), "--history_len", "5", "--patch-image-size", "224",
                "--max_records", str(TOOLS_USERS), "--eval_batch_size", str(TOOLS_USERS),
                "--num_beams", "10", "--do_test", "--workers", "2", "--device", "cuda", *extra]

    pt = run_dir / "reference_3b_mpt.pt"
    mpt_argv = ["--mmrec_path", str(data), "--external_save_dir", str(run_dir),
                "--run_name", "convert", "--pretrained_model_name_or_path", "3b-mpt",
                "--subset", "beauty", "--task", "rec", "--single_task", "--n_items",
                str(N_ITEM_TOKENS), "--history_len", "6", "--use_semantic",
                "--patch-image-size", "224", "--max_records", "6", "--eval_batch_size", "6",
                "--num_beams", "10", "--workers", "2", "--device", "cuda", "--batch_size", "3",
                "--gradient_accumulation_steps", "2", "--fused_accumulation", "--use_reweight",
                "--gamma", "2", "--cache_vision_latents", "--logging_steps", "1",
                "--num_epochs", "1", "--do_test", *HEADLINE_LEVERS]
    results, walls = {}, {}
    (convert_torch.convert_state_dict, Trainer.train_step, common.build_model,
     Generator._decode_step, mmrec.load_torch_checkpoint, mmrec.apply_frozen_storage) = (
        convert, step, build, decode_step, load, requant)
    try:
        kernel_lib.reset_launches()          # the main path starts here
        # --- (b) a seeded 3b-mpt exported, then loaded by the training CLI
        t0 = time.perf_counter()
        args = build_parser().parse_args(mpt_argv)
        tok = common.build_tokenizer(args)
        cfg = get_config("3b-mpt")
        cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=-(-len(tok) // 128) * 128))
        source = from_flax.build_model(cfg, device=dev, seed=11)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        export_torch.save_torch_checkpoint(source, str(pt), export_torch.family_of(
            cfg.lm.positions))
        export_s, export_bytes = time.perf_counter() - t0, pt.stat().st_size
        seen["source_tree"] = ckpt.model_tree(source)
        del source
        t0 = time.perf_counter()
        # (b) writes no checkpoint: phase 12 times them
        with unread_checkpoints(("weights_epoch_0", "checkpoint_0", "final_weights")):
            mmrec.main(mpt_argv + ["--load_from_original_checkpoint", str(pt)])
        torch.cuda.synchronize()
        walls["b"] = time.perf_counter() - t0
        pt.unlink()
        b_steps = seen.pop("steps")
        seen.pop("model", None)
        gc.collect()
        torch.cuda.empty_cache()
        b_launches = counts()

        # --- (c) a byte-level BPE tokenizer.json through --tokenizer_path
        corpus = (Path(data) / "corpus.txt").read_text().splitlines()
        tok_path = run_dir / "tokenizer.json"
        t0 = time.perf_counter()
        tok_path.write_text(json.dumps(train_bpe_json(corpus, BPE_MERGES), ensure_ascii=False))
        bpe_train_s = time.perf_counter() - t0
        argv = eval_argv(data, "bpe", N_ITEM_TOKENS, "--tokenizer_path", str(tok_path))
        bpe = common.build_tokenizer(build_parser(eval_only=True).parse_args(argv))
        t0 = time.perf_counter()
        bad_round = [line for line in corpus if bpe.decode(bpe.encode(line), False) != line]
        n_tokens = sum(len(bpe.encode(line)) for line in corpus)
        bad_atomic = [t for t, tid in bpe._added.items() if bpe.encode(t) != [tid]]
        bpe_check_s = time.perf_counter() - t0
        steps = seen["decode_steps"]
        t0 = time.perf_counter()
        results["c"] = mmrec_eval.main(argv)["rec"]
        torch.cuda.synchronize()
        walls["c"] = time.perf_counter() - t0
        c_steps, tower_model = seen["decode_steps"] - steps, seen.pop("model")
        c_launches = between(b_launches)

        # --- (d) item features -> semantic IDs -> --use_semantic
        small = run_dir / "features_data"
        synth_data.generate(str(small), subset="beauty", n_items=FEATURE_ITEMS,
                            n_users=6 * TOOLS_USERS, image_size=64, seed=3)
        items = list(range(FEATURE_ITEMS))
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        size = tower_model.cfg.vision.image_size
        feats = features.extract_image_features(tower_model, str(small), "beauty", items,
                                                image_size=size, batch_size=64)
        torch.cuda.synchronize()
        feat_s, feat_launches = time.perf_counter() - t0, between(before)
        cpu = _Tower(copy.deepcopy(tower_model.vision).to("cpu"))
        del tower_model
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cpu_feats = features.extract_image_features(cpu, str(small), "beauty", items[:4],
                                                    image_size=size, batch_size=4)
        cpu_s = time.perf_counter() - t0
        del cpu
        feat_err = float(np.abs(feats[:4] - cpu_feats).max())
        feat_scale = float(np.abs(cpu_feats).max())
        t0 = time.perf_counter()
        mapping = features.build_semantic_ids(feats, items, str(small / "id2semantic.json"))
        sem_s = time.perf_counter() - t0
        steps = seen["decode_steps"]
        t0 = time.perf_counter()
        results["d"] = mmrec_eval.main(eval_argv(small, "semantic", FEATURE_ITEMS,
                                                 "--use_semantic"))["rec"]
        torch.cuda.synchronize()
        walls["d"] = time.perf_counter() - t0
        d_steps = seen["decode_steps"] - steps
        seen.pop("model", None)
        gc.collect()
        torch.cuda.empty_cache()

        # --- (e) the VQGAN decoder on phase 10's img_gen dump
        sd = taming_decoder_state_dict(5, **VQGAN_F16_1024)
        decoder = vqgan_decoder.VQGANDecoder.from_state_dict(sd).to(dev)
        cpu_decoder = vqgan_decoder.VQGANDecoder.from_state_dict(sd)
        codes = torch.from_numpy(np.random.default_rng(6).integers(0, 1024, (4, 256)))
        with torch.no_grad():
            card = decoder(codes[:1].to(dev)).cpu()
            vq_err = float((card - cpu_decoder(codes[:1])).abs().max())
            vq_ms = cuda_ms(lambda: decoder(codes.to(dev)), iters=5, warmup=2) / len(codes)
        dump_path = run_dir.parent / IMG_GEN_DUMP
        t0 = time.perf_counter()
        n_dumped = vqgan_decoder.decode_img_gen_dump(str(dump_path), decoder,
                                                     str(run_dir / "img_gen_png"))
        dump_s = time.perf_counter() - t0
        vq_params = sum(t.numel() for t in sd.values())
        del decoder, cpu_decoder, sd
        launches = counts()                  # the main path ends here
    finally:
        (convert_torch.convert_state_dict, Trainer.train_step, common.build_model,
         Generator._decode_step, mmrec.load_torch_checkpoint, mmrec.apply_frozen_storage) = (
            orig["convert"], orig["step"], orig["build"], orig["decode_step"], orig["load"],
            orig["requant"])
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir, ignore_errors=True)

    # --- checks
    (report,) = seen["reports"]
    n_compared, differ, n_int8 = seen["loaded"]
    if report["missed"] or not report["matched"] or differ or not n_int8:
        raise AssertionError(f"[tools] (b) missed {report['missed'][:8]}, state differs from "
                             f"freeze(source, int8) at {differ[:8]}; {n_int8} int8 kernels")
    if len(b_steps) != 1 or b_steps[0][2] or not np.isfinite(b_steps[0][1]):
        raise AssertionError(f"[tools] (b) updates {b_steps}")
    if b_launches["quant_matmul"] <= 0 or b_launches["flash_bwd_dkv"] <= 0:
        raise AssertionError(f"[tools] (b) launches {b_launches}")
    if bad_round or bad_atomic:
        raise AssertionError(f"[tools] (c) BPE round trip fails on {bad_round[:3]}; task "
                             f"tokens not atomic: {bad_atomic[:8]}")
    for tag, n_steps in (("c", c_steps), ("d", d_steps)):
        rec = results[tag]
        bad = {k: v for k, v in rec.items() if not np.isfinite(v)}
        if rec["n_users"] != TOOLS_USERS or bad or not 0 < n_steps <= 50:
            raise AssertionError(f"[tools] ({tag}) eval {rec} over {n_steps} decode steps")
    cfg4 = get_config("4b-instruct")
    n_x = -(-cfg4.lm.num_layers // cfg4.cross_attn_every_n)
    want_c = {"decode_attn": cfg4.lm.num_layers * c_steps, "single_query_attn": n_x * c_steps}
    if any(c_launches[k] != n for k, n in want_c.items()) or c_launches["flash_fwd"] <= 0:
        raise AssertionError(f"[tools] (c) launches {c_launches}, want {want_c}")
    want_k1 = cfg4.vision.num_layers * -(-FEATURE_ITEMS // 64)
    if feat_launches["flash_fwd"] != want_k1 or feats.shape != (FEATURE_ITEMS,
                                                                 cfg4.vision.hidden_size):
        raise AssertionError(f"[tools] (d) features {feats.shape}, K1 "
                             f"{feat_launches['flash_fwd']} (want {want_k1})")
    if not feat_err <= FEATURE_TOL * feat_scale or len(mapping) != FEATURE_ITEMS:
        raise AssertionError(f"[tools] (d) card vs CPU features {feat_err} > {FEATURE_TOL} x "
                             f"{feat_scale}; {len(mapping)} semantic IDs")
    if not vq_err <= VQGAN_TOL or not np.isfinite(vq_ms):
        raise AssertionError(f"[tools] (e) VQGAN card vs CPU {vq_err} > {VQGAN_TOL}")

    # --- report
    b_s, b_loss, _, b_peak = b_steps[0]
    log(f"[tools] (b) 3b-mpt source (seed 11, float32) built in {build_s:.1f} s, exported "
        f"({export_torch.family_of(cfg.lm.positions)} names) in {export_s:.2f} s: "
        f"{export_bytes / 2**30:.2f} GiB, {export_bytes / 2**30 / export_s:.2f} GiB/s on "
        f"{gpu_line}")
    log(f"[tools] (b) [convert] report: {len(report['matched'])} tensors matched, "
        f"{len(report['missed'])} missed, {len(report['skipped'])} skipped; read + convert "
        f"{seen['load_s']:.2f} s ({export_bytes / 2**30 / seen['load_s']:.2f} GiB/s), int8 "
        f"again in {seen['requant_s']:.2f} s; {n_compared} tensors equal freeze(source, "
        f"int8) bit for bit ({n_int8} int8 kernels)")
    log(f"[tools] (b) mmrec main {walls['b']:.1f} s (the cache, 1 update, the test pass; no "
        f"checkpoint written): update {b_s * 1e3:.1f} ms, loss {b_loss:.6f}, peak "
        f"{b_peak:.2f} GiB; launches {json.dumps(b_launches)} on {gpu_line}")
    log(f"[tools] (c) BPE tokenizer.json: {len(bpe._bpe.ranks)} merges learned in "
        f"{bpe_train_s:.2f} s; vocabulary {len(bpe)} with the task tokens; the corpus's "
        f"{len(corpus)} lines round-trip exactly ({n_tokens} tokens, {bpe_check_s:.2f} s with "
        f"the {len(bpe._added)} added tokens' atomicity); rec eval of {TOOLS_USERS} users "
        f"{walls['c']:.1f} s, {c_steps} decode steps, items/s "
        f"{results['c']['items_per_sec']:.3f} on {gpu_line}")
    log(f"[tools] (d) features: {FEATURE_ITEMS} items in {feat_s:.2f} s "
        f"({FEATURE_ITEMS / feat_s:.1f} items/s: host decode + resize, the ViT), K1 "
        f"{feat_launches['flash_fwd']}; card vs CPU (4 items, {cpu_s:.1f} s on the CPU) max "
        f"|d| {feat_err:.3e} of max |f| {feat_scale:.3f}; semantic IDs in {sem_s:.2f} s; "
        f"--use_semantic eval {walls['d']:.1f} s, {d_steps} decode steps, items/s "
        f"{results['d']['items_per_sec']:.3f} on {gpu_line}")
    log(f"[tools] (e) VQGAN f16-1024 decoder ({vq_params / 1e6:.1f} M parameters), float32: "
        f"{vq_ms:.2f} ms an image (batch of 4, 16 x 16 codes -> 256 x 256); card vs CPU max "
        f"|d| {vq_err:.3e}; phase 10's dump: {n_dumped} images in {dump_s:.2f} s on {gpu_line}")
    log(f"[tools] rec (c) {json.dumps(results['c'])}; (d) {json.dumps(results['d'])}")
    return launches


# ------------------------------------------------------------ phase 15

HARNESS_RECORDS = 8        # records a manifest
HARNESS_CLASSES = 1000     # ImageNet's class count: one forward of 1,000 rows an image
HARNESS_SHOTS = (0, 4)
SMALL_HARNESS_RECORDS = 1  # the small card-vs-CPU run: records a benchmark
SMALL_HARNESS_CLASSES = 100
FIXTURE_DIR = Path(__file__).resolve().parent / "tests" / "data" / "images"


def image_fixtures() -> list:
    """(image file, its PIL array) of each committed fixture: ``name.ext``
    beside ``name.npy``, the array PIL's ``convert("RGB")`` gave."""
    return sorted((p, p.with_suffix(".npy")) for p in FIXTURE_DIR.iterdir()
                  if p.suffix != ".npy" and p.with_suffix(".npy").exists())


def check_fixtures() -> list:
    """Decode every fixture with the port's decoders and hold it equal to
    its committed PIL array (the card's machine has no PIL)."""
    from unimp_tpu_torch.data import transforms

    fixtures = image_fixtures()
    if not fixtures:
        raise AssertionError(f"[harness] no image fixtures under {FIXTURE_DIR}")
    for img, arr in fixtures:
        got = transforms.load_image_rgb(str(img))
        want = np.load(arr)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"[harness] {img.name} decodes unlike PIL's array "
                                 f"({got.shape} vs {want.shape})")
    log(f"[harness] {len(fixtures)} image fixtures decode equal to their PIL arrays: "
        + ", ".join(p.name for p, _ in fixtures))
    return [p for p, _ in fixtures]


def write_harness_data(data, out) -> dict:
    """COCO-, VQA-, OK-VQA- and ImageNet-style manifests of HARNESS_RECORDS
    records over the committed fixtures and phase 8's JPEGs, captions and
    answers from the synth corpus, HARNESS_CLASSES class names (pairs of
    corpus words); returns the paths."""
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(15)
    corpus = (data / "corpus.txt").read_text().splitlines()
    words = sorted({w for line in corpus for w in line.split() if not w.isdigit()})
    fixtures = [str(p) for p in check_fixtures()]
    synth = [str(data / "beauty" / f"{i}.jpg") for i in range(HARNESS_RECORDS)]
    # fixtures and JPEGs alternate: the first 8 records (the queries) hold both
    recs = [p for pair in itertools.zip_longest(fixtures, synth) for p in pair if p]

    def title(i):
        return " ".join(corpus[i].split()[:-1])

    cap = [{"image": p, "captions": [title(2 * i), title(2 * i + 1)]} for i, p in enumerate(recs)]
    vqa = [{"image": p, "question": f"what is the {words[i % len(words)]}",
            "answers": [str(a) for a in rng.choice(corpus[i].split()[:-1], 10)]}
           for i, p in enumerate(recs)]
    pairs = [f"{a} {b}" for a in words for b in words if a != b]
    classes = [pairs[i] for i in rng.permutation(len(pairs))[:HARNESS_CLASSES]]
    if len(classes) != HARNESS_CLASSES:
        raise AssertionError(f"[harness] {len(classes)} class names, want {HARNESS_CLASSES}")
    cls = [{"image": p, "label": int(rng.integers(HARNESS_CLASSES))} for p in recs]
    paths = {}
    for name, rows in (("coco", cap), ("vqa", vqa), ("ok_vqa", vqa), ("imagenet", cls),
                       ("classes", classes), ("small_classes", classes[:SMALL_HARNESS_CLASSES])):
        paths[name] = out / f"{name}.json"
        paths[name].write_text(json.dumps(rows))
    return paths


def harness_argv(ckpt_dir, tok_path, paths, variant, precision, device, shots, n, classes):
    return ["--checkpoint_dir", str(ckpt_dir), "--checkpoint_name", "final_weights",
            "--variant", variant, "--tokenizer_path", str(tok_path),
            "--shots", *map(str, shots), "--trial_seeds", "0", "--num_samples", str(n),
            "--image_size", "224", "--precision", precision, "--device", device,
            "--eval_coco", "--coco_manifest", str(paths["coco"]),
            "--eval_vqa", "--vqa_manifest", str(paths["vqa"]),
            "--eval_ok_vqa", "--ok_vqa_manifest", str(paths["ok_vqa"]),
            "--eval_imagenet", "--imagenet_manifest", str(paths["imagenet"]),
            "--imagenet_classes", str(paths[classes])]


class HarnessSpies:
    """Around ``cli/evaluate.main``: seconds and records of each benchmark
    call, the vision encodes, generates and decode steps (the launch counts
    follow from them), each generate's tokens and each image's class."""

    def __init__(self):
        from unimp_tpu_torch.cli import evaluate
        from unimp_tpu_torch.evals import benchmark_harness as bh
        from unimp_tpu_torch.models import UniMPModel

        self.bh, self.model_cls, self.cli = bh, UniMPModel, evaluate
        self.orig = {"cap": bh.evaluate_captioning, "vqa": bh.evaluate_vqa,
                     "cls": bh.evaluate_classification, "enc": UniMPModel.encode_vision,
                     "gen": Generator.generate, "step": Generator._decode_step,
                     "build": evaluate.build_model}
        self.calls, self.tokens, self.classes = [], [], []
        self.encodes = self.generates = self.steps = 0
        self.model = None

    def __enter__(self):
        bh, o = self.bh, self.orig

        def timed(name, fn, **extra):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw, **extra)
                torch.cuda.synchronize()
                label = "ok_vqa" if kw.get("ok_vqa") else name
                self.calls.append((label, kw.get("num_shots", 0), out["n"],
                                   time.perf_counter() - t0, out))
                return out
            return run

        def encode(model, *args):
            self.encodes += 1
            return o["enc"](model, *args)

        def generate(gen, *args):
            self.generates += 1
            toks, scores = o["gen"](gen, *args)
            self.tokens.append(toks.cpu())
            return toks, scores

        def step(gen, *args, **kw):
            self.steps += 1
            return o["step"](gen, *args, **kw)

        def build(*args, **kw):
            self.model = o["build"](*args, **kw)
            return self.model

        self.cli.build_model = build
        bh.evaluate_captioning = timed("coco", o["cap"])
        bh.evaluate_vqa = timed("vqa", o["vqa"])
        bh.evaluate_classification = timed("imagenet", o["cls"], predictions=self.classes)
        self.model_cls.encode_vision = encode
        Generator.generate, Generator._decode_step = generate, step
        return self

    def __exit__(self, *exc):
        bh, o = self.bh, self.orig
        bh.evaluate_captioning, bh.evaluate_vqa = o["cap"], o["vqa"]
        bh.evaluate_classification = o["cls"]
        self.model_cls.encode_vision = o["enc"]
        Generator.generate, Generator._decode_step = o["gen"], o["step"]
        self.cli.build_model = o["build"]


def seeded_checkpoint(variant, vocab, ckpt_dir, dev, dtype: str) -> float:
    """A seeded ``variant`` (gates opened, vocabulary ``vocab``) written by
    the port's ``save_params`` as ``final_weights``; its matrices in
    ``dtype`` ("bf16" or "fp32"). Returns the write's seconds."""
    from unimp_tpu_torch.train import checkpoint as ckpt

    cfg = get_config(variant)
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    model = build_model(cfg, device=dev, seed=15, eval_param_dtype=dtype)
    open_gates(model)
    t0 = time.perf_counter()
    ckpt.save_params(str(ckpt_dir), model)
    write_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return write_s


def phase_harness(dev, gpu_line, data, run_dir) -> dict:
    """The few-shot harness through ``cli/evaluate.main`` (phase 15): a
    seeded 4b-instruct checkpoint (bf16 matrices, gates opened) written by
    the port's ``save_params``, the synth corpus' tokenizer as a
    ``tokenizer.json``, COCO / VQA / OK-VQA / ImageNet manifests of 8
    records (the committed WebP, TIFF, arithmetic and lossless JPEG
    fixtures among their images, each decoded equal to its PIL array
    first), ``--shots 0 4``, one trial seed, bf16. Gates: every metric in
    range, K1 / K4 / K5 launches as the spies' counts give them (no K6, no
    int8 kernel), PIL not imported; then the same harness on ``small`` in
    float32 on the card and on the CPU (1 record, 100 classes): the same
    tokens, classes and results."""
    from unimp_tpu_torch.cli import evaluate
    from unimp_tpu_torch.tools import synth_data

    run_dir.mkdir(parents=True, exist_ok=True)
    paths = write_harness_data(data, run_dir / "manifests")
    tok = synth_data.build_tokenizer(str(data), n_items=N_ITEM_TOKENS)
    tok_path = run_dir / "tokenizer.json"
    tok.save(str(tok_path))
    vocab = -(-len(tok) // 128) * 128
    write_s = seeded_checkpoint("4b-instruct", vocab, run_dir / "4b", dev, "bf16")
    argv = harness_argv(run_dir / "4b", tok_path, paths, "4b-instruct", "bf16", "cuda",
                        HARNESS_SHOTS, HARNESS_RECORDS, "classes")
    with HarnessSpies() as spy:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kernel_lib.reset_launches()  # the main path starts here
        results = evaluate.main(argv + ["--results_file", str(run_dir / "results.json")])
        torch.cuda.synchronize()
        launches = dict(kernel_lib.LAUNCHES)  # the main path ends here
        main_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = get_config("4b-instruct")
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    n_cls = sum(c[2] for c in spy.calls if c[0] == "imagenet")
    per_encode = cfg.vision.num_layers + cfg.resampler.depth
    want = {"flash_fwd": spy.encodes * per_encode + (spy.generates + n_cls) * (lm.num_layers
                                                                              + n_xattn),
            "decode_attn": spy.steps * lm.num_layers, "single_query_attn": spy.steps * n_xattn}
    want.update({k: 0 for k in launches if k not in want})
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    keys = [f"{b}_shots_{s}" for b in ("coco_cider", "vqa_accuracy", "ok_vqa_accuracy")
            for s in HARNESS_SHOTS] + ["imagenet_top1"]
    if list(results) != keys or not all(math.isfinite(v) and v >= 0 for v in results.values()) \
            or any(results[k] > 1 for k in keys if "cider" not in k):
        raise AssertionError(f"[harness] results out of range or missing: {results}")
    if bad or not spy.steps:
        raise AssertionError(f"[harness] launches differ (got, expected): {bad}; "
                             f"{spy.steps} decode steps")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "tokenizers"))
    if loaded:
        raise AssertionError(f"[harness] modules the card's machine lacks were imported: {loaded}")
    log(f"[harness] 4b-instruct bf16, vocab {vocab}: checkpoint written in {write_s:.2f} s; "
        f"main {main_s:.2f} s, peak_mem={peak_gib:.2f} GiB on {gpu_line}")
    for name, shots, n, secs, out in spy.calls:
        log(f"[harness] {name} shots={shots}: {n} records in {secs:.3f} s = {n / secs:.3f} "
            f"items/s; {json.dumps(out)}")
    log(f"[harness] results {json.dumps(results)}")
    log(f"[harness] {spy.encodes} vision encodes, {spy.generates} generates, {spy.steps} decode "
        f"steps, {n_cls} classification forwards of {HARNESS_CLASSES} rows; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; expected "
        f"{json.dumps({k: v for k, v in want.items() if v})}")
    # the device's share of one VQA answer (4 shots) and one 1,000-row
    # classification, on the main run's model, under the profiler
    tokenizer = evaluate.UniMPTokenizer.load(str(tok_path))
    args = evaluate.build_parser().parse_args(argv)
    model = spy.model
    classes = json.loads(paths["classes"].read_text())

    def sample():
        evaluate.bh.evaluate_vqa(model, tokenizer, str(paths["vqa"]), num_shots=4, limit=1,
                                 image_size=args.image_size)
        evaluate.bh.evaluate_classification(model, tokenizer, str(paths["imagenet"]), classes,
                                            limit=1, image_size=args.image_size)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample()
    torch.cuda.synchronize()
    profile_run("[harness] 1 VQA answer at 4 shots + 1 classification", sample,
                time.perf_counter() - t0)
    del model, spy
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir / "4b")

    # small, float32: the card against the CPU
    seeded_checkpoint("small", vocab, run_dir / "small", torch.device("cpu"), "fp32")
    seen = {}
    for device in ("cuda", "cpu"):
        with HarnessSpies() as spy:
            t0 = time.perf_counter()
            res = evaluate.main(harness_argv(run_dir / "small", tok_path, paths, "small", "fp32",
                                             device, HARNESS_SHOTS, SMALL_HARNESS_RECORDS,
                                             "small_classes"))
            seen[device] = (res, spy.tokens, spy.classes, time.perf_counter() - t0)
    (res_c, tok_c, cls_c, s_c), (res_h, tok_h, cls_h, s_h) = seen["cuda"], seen["cpu"]
    same_tokens = len(tok_c) == len(tok_h) and all(torch.equal(a, b) for a, b in zip(tok_c, tok_h))
    log(f"[harness] small fp32, card {s_c:.2f} s vs CPU {s_h:.2f} s: {len(tok_c)} generates "
        f"{'equal' if same_tokens else 'DIFFER'} token for token; classes {cls_c} vs {cls_h}; "
        f"results card {json.dumps(res_c)} cpu {json.dumps(res_h)}")
    if not same_tokens or cls_c != cls_h or res_c != res_h:
        raise AssertionError("[harness] small float32 on the card differs from the CPU")
    shutil.rmtree(run_dir)
    return launches


# ------------------------------------------------------------ phase 16

LM_PROMPTS, LM_PROMPT_LEN, LM_NEW = 24, 128, 32
K6_PER_LM_STEP = 4  # the fused q/k/v, o, MLP up and down a layer, M = 24 rows


def lm_generate(model, ids, new, kv_int8=False):
    gen = Generator(model, GenerationConfig(max_new_tokens=new, eos_id=-1, pad_id=EOS_ID,
                                            kv_int8=kv_int8), media_id=-1)
    seq_len = torch.full((ids.shape[0],), ids.shape[1], device=ids.device)
    return gen.generate(ids, seq_len)[0][:, 0]


def phase_causal_lm(dev, gpu_line) -> dict:
    """The pure-text ``CausalLM`` at RedPajama-3B width (phase 16): seeded
    weights, 24 prompts of 128 tokens, 32 greedy new tokens through the
    port's ``Generator``, bf16 (K1 once a layer for the prefill, K4 once a
    layer a step); then int8 weights with int8 KV (K6 four times a layer a
    step and once for the head, plus the prefill head once; K4 int8 once a
    layer a step); then ``small``'s LM in float32 on the card and on the CPU:
    the same tokens, prefill logits within 1e-4."""
    from unimp_tpu_torch.models import CausalLM

    lm = get_config("4b-instruct").lm
    rng = np.random.default_rng(16)
    ids = torch.from_numpy(rng.integers(1, lm.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN))).to(dev)
    out = {}
    for tag, int8 in (("bf16", False), ("int8", True)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = build_model(lm, device=dev, seed=16, eval_param_dtype="int8" if int8 else "bf16")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if not isinstance(model, CausalLM):
            raise AssertionError(f"[lm] build_model gave a {type(model).__name__}")
        lm_generate(model, ids[:2], 2, int8)  # warm-up, not counted
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kernel_lib.reset_launches()  # the main path starts here
        toks = lm_generate(model, ids, LM_NEW, int8)
        torch.cuda.synchronize()
        launches = dict(kernel_lib.LAUNCHES)  # the main path ends here
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        k4 = "decode_attn_int8" if int8 else "decode_attn"
        # K6 a step: each layer's int8 matmuls and the head; the prefill's
        # rows go to K6 up to 512 (the head's alone: last_logit_only)
        per_layer = k6_per_decode_step(model)
        head = int(isinstance(getattr(model, "lm_head", None) and model.lm_head.kernel,
                              QuantizedKernel))
        prefill = (per_layer if LM_PROMPTS * LM_PROMPT_LEN <= default_max_rows() else 0) + head
        want = {"flash_fwd": lm.num_layers, k4: lm.num_layers * LM_NEW,
                "quant_matmul": LM_NEW * (per_layer + head) + prefill}
        if int8 and per_layer != K6_PER_LM_STEP * lm.num_layers:
            raise AssertionError(f"[lm] {per_layer} int8 matmuls a step, want "
                                 f"{K6_PER_LM_STEP * lm.num_layers}")
        want.update({k: 0 for k in launches if k not in want})
        bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
        if bad or tuple(toks.shape) != (LM_PROMPTS, LM_NEW):
            raise AssertionError(f"[lm] {tag}: launches differ (got, expected) {bad}; tokens "
                                 f"{tuple(toks.shape)}")
        log(f"[lm] RedPajama-3B CausalLM {tag}{' + int8 KV' if int8 else ''}: build "
            f"{build_s:.2f} s; {LM_PROMPTS} x {LM_PROMPT_LEN} prompt tokens, {LM_NEW} greedy new "
            f"in {secs:.3f} s = {LM_PROMPTS * LM_NEW / secs:.1f} tokens/s; peak_mem={peak:.2f} "
            f"GiB on {gpu_line}; launches {json.dumps({k: v for k, v in launches.items() if v})}")
        out[tag] = launches
        del model
    gc.collect()
    torch.cuda.empty_cache()

    small = get_config("small").lm
    sids = torch.from_numpy(rng.integers(1, small.vocab_size, (LM_PROMPTS, LM_PROMPT_LEN)))
    got = {}
    # one seeded init (on the CPU: a generator's stream differs by device),
    # copied to the card
    cpu_model = build_model(small, device="cpu", seed=16, dtype=torch.float32)
    for label, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = copy.deepcopy(cpu_model).to(device) if label == "card" else cpu_model
        with torch.no_grad():
            logits, _ = model(sids.to(device))
        got[label] = (lm_generate(model, sids.to(device), LM_NEW).cpu(), logits.cpu())
    (tc, lc), (th, lh) = got["card"], got["cpu"]
    diff = float((lc - lh).abs().max())
    agree = float((tc == th).float().mean())
    log(f"[lm] small LM fp32 card vs CPU: token agreement {agree:.4f}, prefill max |logit diff| "
        f"{diff:.3e} (gates: 1.0, 1e-4)")
    if agree != 1.0 or diff > 1e-4:
        raise AssertionError("[lm] small float32 CausalLM on the card differs from the CPU")
    return out


# ------------------------------------------------------------ phase 17

ORBAX_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "orbax"
ORBAX_USERS = 24  # one eval batch
ORBAX_DECODE_MB = 256  # the decoder's rate is read over at least this much content


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


ZSTD_BLOCK = 1 << 17  # a block's largest content


def zstd_raw_frame_size(n: int) -> int:
    return 4 + 1 + 8 + 3 * max(1, -(-n // ZSTD_BLOCK)) + n


def write_zstd_raw_frame(f, payload) -> None:
    """One Zstandard frame of ``payload`` (a bytes-like) in raw blocks: a
    single-segment header with the 8-byte content size, no checksum. It is
    what a writer with no encoder can give; any decoder reads it."""
    mv = memoryview(payload).cast("B")
    n = len(mv)
    f.write(struct.pack("<IBQ", 0xFD2FB528, 0xE0, n))
    starts = range(0, n, ZSTD_BLOCK) if n else [0]
    for i, start in enumerate(starts):
        size = min(ZSTD_BLOCK, n - start)
        last = i == len(starts) - 1
        f.write(struct.pack("<I", (size << 3) | int(last))[:3])
        f.write(mv[start:start + size])


def _ocdbt_file(magic: int, body: bytes) -> bytes:
    """An OCDBT manifest or node: magic, length, version 0, Zstandard
    compression (one raw-block frame), the body, CRC-32C."""
    import io

    frame = io.BytesIO()
    write_zstd_raw_frame(frame, body)
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(1) + frame.getvalue()
    total = len(head) + 8 + len(rest) + 4
    out = head + struct.pack("<Q", total) + rest
    return out + struct.pack("<I", zstd_host.crc32c(out))


def _file_table(paths) -> bytes:
    out = _varint(len(paths))
    out += b"".join(_varint(0) for _ in paths[1:])  # no shared prefixes
    out += b"".join(_varint(len(p)) for p in paths)
    out += b"".join(_varint(0) for _ in paths)  # no base paths
    return out + b"".join(p.encode() for p in paths)


ZARR_DTYPES = {torch.float32: "<f4", torch.bfloat16: "bfloat16", torch.float16: "<f2",
               torch.int32: "<i4", torch.int64: "<i8", torch.int8: "|i1", torch.uint8: "|u1",
               torch.bool: "|b1"}


def write_orbax_checkpoint(tree: dict, path, scalars: dict = None, seed: int = 0) -> int:
    """Write ``tree`` ({flat path "a/b": tensor}, any device; copied to the
    host one tensor at a time) and ``scalars`` ({path: Python number}) as
    ``ocp.StandardCheckpointer`` lays a checkpoint out: ``_METADATA``,
    ``_CHECKPOINT_METADATA``, ``array_metadatas/process_0``, ``_sharding``,
    and an OCDBT database whose manifest points at one B-tree leaf holding
    each array's zarr v2 ``.zarray`` inline and a reference to each chunk
    (the whole array, one Zstandard frame of raw blocks) in one data file.
    The card's machine has no JAX, Orbax or tensorstore; this is the
    fixture writer. Returns the bytes written."""
    import base64
    import uuid

    path = Path(path)
    (path / "d").mkdir(parents=True, exist_ok=True)
    (path / "array_metadatas").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    data_name = "d/" + rng.bytes(16).hex()
    node_name = "d/" + rng.bytes(16).hex()
    scalars = scalars or {}
    entries, tree_meta, array_meta, sharding = [], {}, [], {}
    offset = 0
    with open(path / data_name, "wb") as f:
        for key, t in list(tree.items()) + [(k, torch.tensor(v)) for k, v in scalars.items()]:
            keys = key.split("/")
            name = ".".join(keys)
            host = t.detach().to("cpu").contiguous()
            shape = list(host.shape)
            zarray = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": ZARR_DTYPES[host.dtype],
                      "fill_value": None, "filters": None, "order": "C", "shape": shape,
                      "zarr_format": 2}
            entries.append(((name + "/.zarray").encode(),
                            json.dumps(zarray, separators=(",", ":")).encode()))
            raw = host.reshape(-1).view(torch.uint8).numpy() if host.numel() else b""
            write_zstd_raw_frame(f, raw)
            size = zstd_raw_frame_size(host.numel() * host.element_size())
            entries.append(((name + "/" + (".".join("0" for _ in shape) or "0")).encode(),
                            (offset, size)))
            offset += size
            scalar = key in scalars
            tree_meta[str(tuple(keys))] = {
                "key_metadata": [{"key": k, "key_type": 2} for k in keys],
                "value_metadata": ({"value_type": "scalar", "skip_deserialize": False}
                                   if scalar else
                                   {"value_type": "jax.Array", "skip_deserialize": False,
                                    "write_shape": shape})}
            if not scalar:
                array_meta.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                                      "chunk_shape": shape,
                                                      "ext_metadata": None}})
                sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
                    {"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
            del host, raw
    entries.sort(key=lambda e: e[0])
    kinds = [int(isinstance(v, tuple)) for _, v in entries]
    refs = [v for _, v in entries if isinstance(v, tuple)]
    node = (bytes([0]) + _file_table([data_name]) + _varint(len(entries))
            + b"".join(_varint(0) for _ in entries[1:])
            + b"".join(_varint(len(k)) for k, _ in entries) + b"".join(k for k, _ in entries)
            + b"".join(_varint(v[1] if isinstance(v, tuple) else len(v)) for _, v in entries)
            + b"".join(_varint(k) for k in kinds)
            + b"".join(_varint(0) for _ in refs) + b"".join(_varint(o) for o, _ in refs)
            + b"".join(v for _, v in entries if not isinstance(v, tuple)))
    node_file = _ocdbt_file(0x0CDB20DE, node)
    (path / node_name).write_bytes(node_file)
    now = time.time_ns()
    manifest = (uuid.UUID(bytes=rng.bytes(16)).bytes + _varint(0) + _varint(1024)
                + _varint(100_000_000) + bytes([4]) + _varint(1) + _varint(0)
                + _varint(0) * 3 + _file_table([node_name])
                + _varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(0)
                + _varint(len(node_file)) + _varint(len(entries)) + _varint(len(node_file))
                + _varint(offset) + struct.pack("<Q", now) + _varint(0))
    (path / "manifest.ocdbt").write_bytes(_ocdbt_file(0x0CDB3A2A, manifest))
    (path / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (path / "array_metadatas" / "process_0").write_text(json.dumps(
        {"array_metadatas": array_meta}))
    (path / "_sharding").write_text(json.dumps(sharding))
    (path / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                         "StandardCheckpointHandler",
        "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": now,
        "commit_timestamp_nsecs": now, "custom_metadata": {}}))
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


ORBAX_SPEC = json.loads((ORBAX_FIXTURE / "config.json").read_text()) \
    if (ORBAX_FIXTURE / "config.json").exists() else None
ORBAX_LR = 1e-4  # the fixture's learning rate (the CLI's default)
ORBAX_B1 = 0.9  # AdamW's first-moment decay (the CLI's default)


@contextlib.contextmanager
def orbax_fixture_config():
    """The CLIs' variant lookup gives the committed checkpoint's variant at
    the widths of ``tests/data/orbax/config.json`` (debug cut to one layer,
    head dim 64, so the card's kernels take it)."""
    from unimp_tpu_torch.cli import common

    orig = common.get_config

    def get(name, **kw):
        cfg = orig(name, **kw)
        if name == ORBAX_SPEC["base"]:
            cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **ORBAX_SPEC[k])
                                 for k in ("vision", "resampler", "lm")},
                              cross_attn_every_n=ORBAX_SPEC["cross_attn_every_n"])
        return cfg

    common.get_config = get
    try:
        yield
    finally:
        common.get_config = orig


def orbax_resume_side(device: str, data, run_dir) -> dict:
    """``mmrec.main --resume_from_checkpoint`` from the committed JAX
    ``checkpoint_0`` (the JAX CLI's command line, epoch 1 of 2) on
    ``device``, stopped after its first update (two micro-batches, MultiSteps
    over 2): the losses, the weights and both moments then."""
    from unimp_tpu_torch.cli import mmrec
    from unimp_tpu_torch.train import checkpoint as ckpt

    run = Path(run_dir) / device / "resume"
    run.mkdir(parents=True)
    shutil.copytree(ORBAX_FIXTURE / "checkpoint_0", run / "checkpoint_0")
    argv = ["--mmrec_path", str(data), "--external_save_dir", str(run.parent), "--run_name",
            "resume", "--pretrained_model_name_or_path", ORBAX_SPEC["base"], "--subset",
            "beauty", "--task", "rec", "--single_task", "--n_items", "40", "--history_len",
            "5", "--patch-image-size", "28", "--batch_size", "2",
            "--gradient_accumulation_steps", "2", "--eval_batch_size", "4", "--num_epochs", "2",
            "--logging_steps", "1", "--warmup_steps", "0", "--workers", "0", "--num_beams", "3",
            "--max_records", "8", "--precision", "fp32", "--use_reweight",
            "--resume_from_checkpoint", "--device", device]
    seen = {"losses": []}
    orig = Trainer.train_step

    def step(self, batch):
        metrics = orig(self, batch)
        seen["losses"].append(float(metrics["loss"]))
        if len(seen["losses"]) == 2:
            seen["trainer"] = self
            raise StopRun
        return metrics

    Trainer.train_step = step
    try:
        with orbax_fixture_config():
            try:
                mmrec.main(argv)
            except StopRun:
                pass
    finally:
        Trainer.train_step = orig
    tr = seen["trainer"]
    opt = tr.optimizer.state_dict()
    out = {"losses": seen["losses"], "step": tr.step,
           "params": {k: t.detach().float().cpu() for k, t in ckpt.model_tree(tr.model).items()}}
    for m in ("mu", "nu"):
        out[m] = {n: t.detach().float().cpu() for n, t in opt[m].items()}
    return out


def orbax_update_gap(card: dict, cpu: dict):
    """How far one resumed update differs between two sides of
    ``orbax_resume_side``: (max |d weights| over the entries whose averaged
    gradient, from the CPU's new mu and the checkpoint's, exceeds 1e-5; the
    count of those entries; max |d weights| over all). The first is held
    at 1e-2 LR, as tests/test_torch_train.py holds the port to JAX."""
    from unimp_tpu_torch.train import checkpoint as ckpt

    mu0 = ckpt.restore_train_state(str(ORBAX_FIXTURE), "checkpoint_0")["opt_state"]["mu"]
    sure_d, n_sure, moved = 0.0, 0, 0.0
    for k, t in cpu["params"].items():
        d = (card["params"][k] - t).abs()
        moved = max(moved, float(d.max()))
        name = k.replace("/", ".")
        if name in mu0:
            grad = (cpu["mu"][name] - ORBAX_B1 * mu0[name].float()) / (1 - ORBAX_B1)
            sure = grad.abs() > 1e-5
            n_sure += int(sure.sum())
            if sure.any():
                sure_d = max(sure_d, float(d[sure].max()))
    return sure_d, n_sure, moved


def phase_orbax(dev, gpu_line, data, run_dir) -> dict:
    """The JAX package's Orbax checkpoints through the port (phase 17).
    (a) 4b-instruct at full width and depth, seeded, bf16: the 10-beam rec
    eval of phase 8 over 24 users, its model's tree laid out by
    ``write_orbax_checkpoint`` on the run's tmpfs, then ``mmrec_eval.main
    --load_weights_name`` on it: the restored tree equals the source bit for
    bit and the beams equal the direct run's; the directory is deleted at
    once. (b) Every Zstandard record of the committed JAX-written
    checkpoint's values (``tests/data/orbax``) through the C++ decoder and
    ``data/zstd.py``, equal; then its records decoded over and over, to
    ``ORBAX_DECODE_MB`` of content, for the decoder's rate. (c) The
    committed ``checkpoint_0`` resumed through ``mmrec.main`` for one update
    on the card and on the CPU: losses within 1e-5 relative, moments within
    ``SMALL_GRAD_TOL`` of their largest entry, weights within 1e-2 LR where
    the averaged gradient exceeds 1e-5 and within 2.01 LR elsewhere."""
    from unimp_tpu_torch.cli import common, mmrec_eval
    from unimp_tpu_torch.data import zstd
    from unimp_tpu_torch.evals import evaluators
    from unimp_tpu_torch.tools import synth_data
    from unimp_tpu_torch.train import checkpoint as ckpt
    from unimp_tpu_torch.train import orbax

    t_phase = time.perf_counter()
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    log(f"[orbax] {host_memory_line(run_dir)}")
    # (a) full width
    answers = {"direct": [], "orbax": []}
    seen = {}
    orig_batches, orig_build = evaluators._generate_batches, common.build_model
    orig_restore = ckpt.restore_params

    def batches(*args, **kw):
        for rows, batch, wall in orig_batches(*args, **kw):
            answers[seen["side"]].append(rows)
            users = sum(len(r) for r in answers[seen["side"]])
            seen.setdefault("ips", {})[seen["side"]] = users / wall
            yield rows, batch, wall

    def build(args, tokenizer, **kw):
        model = orig_build(args, tokenizer, **kw)
        if seen["side"] == "direct":
            seen["model"] = model
        return model

    def restore(save_dir, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = orig_restore(save_dir, name)
        seen["restore_s"] = time.perf_counter() - t0
        source = ckpt.model_tree(seen.pop("model"))
        bad = sorted(set(tree) ^ set(source))
        for path, t in tree.items():
            src = source.get(path)
            if src is None or t.dtype != src.dtype or t.shape != src.shape or \
                    not torch.equal(t.to(src.device), src):
                bad.append(path)
        if bad:
            raise AssertionError(f"[orbax] restored tree differs from the source: {bad[:8]}")
        seen["restored_bytes"] = sum(t.numel() * t.element_size() for t in tree.values())
        seen["tensors"] = len(tree)
        del source
        return tree

    argv = ["--mmrec_path", str(data), "--external_save_dir", str(run_dir),
            "--pretrained_model_name_or_path", "4b-instruct",
            "--subset", "beauty", "--task", "rec", "--single_task",
            "--n_items", str(N_ITEM_TOKENS), "--history_len", "5",
            "--patch-image-size", "224", "--eval_batch_size", str(ORBAX_USERS),
            "--num_beams", "10", "--max_records", str(ORBAX_USERS), "--workers", "2",
            "--do_test", "--device", "cuda"]
    ck_dir = run_dir / "orbax_4b"
    evaluators._generate_batches, common.build_model = batches, build
    ckpt.restore_params = restore
    try:
        seen["side"] = "direct"
        t0 = time.perf_counter()
        mmrec_eval.main(argv + ["--run_name", "direct"])
        direct_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = write_orbax_checkpoint(ckpt.model_tree(seen["model"]), ck_dir)
        write_s = time.perf_counter() - t0
        seen["side"] = "orbax"
        t0 = time.perf_counter()
        kernel_lib.reset_launches()  # the main path starts here
        results = mmrec_eval.main(argv + ["--run_name", "orbax", "--load_dir", str(run_dir),
                                          "--load_weights_name", ck_dir.name])
        eval_launches = counts()  # the main path ends here
        orbax_s = time.perf_counter() - t0
    finally:
        evaluators._generate_batches, common.build_model = orig_batches, orig_build
        ckpt.restore_params = orig_restore
        seen.pop("model", None)
        shutil.rmtree(ck_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if answers["orbax"] != answers["direct"] or len(answers["orbax"]) != 1:
        raise AssertionError("[orbax] the beams from the Orbax checkpoint differ from the "
                             "direct load's")
    missing = [k for k in EVAL_KERNELS if eval_launches[k] <= 0]
    if missing or results["rec"]["n_users"] != ORBAX_USERS:
        raise AssertionError(f"[orbax] eval: kernels not launched {missing}; {results}")
    gib = nbytes / 2**30
    log(f"[orbax] 4b-instruct bf16 tree, {seen['tensors']} tensors, "
        f"{seen['restored_bytes'] / 2**30:.3f} GiB: write {write_s:.2f} s "
        f"({gib / write_s:.3f} GiB/s, {gib:.3f} GiB on disk, raw-block frames), restore "
        f"{seen['restore_s']:.2f} s ({gib / seen['restore_s']:.3f} GiB/s, "
        f"{zstd_host.default_threads()} decoder threads); equal to the source bit for bit")
    log(f"[orbax] eval from Orbax: {orbax_s:.2f} s (restore, build, encode, generate), "
        f"items/s {seen['ips']['orbax']:.3f} (direct load {seen['ips']['direct']:.3f}, run "
        f"{direct_s:.2f} s); beams equal the direct load's over {ORBAX_USERS} users; "
        f"launches {json.dumps(eval_launches)} on {gpu_line}")

    # (b) the committed JAX-written checkpoint's records
    records = []
    for name in ("final_weights", "checkpoint_0"):
        records += orbax.zstd_records(str(ORBAX_FIXTURE / name))
    t0 = time.perf_counter()
    plain = [zstd.decompress(r) for r in records]
    plain_s = time.perf_counter() - t0
    native = zstd_host.decompress_batch([(r, 0, len(r)) for r in records])
    if native != plain:
        bad = [i for i, (a, b) in enumerate(zip(native, plain)) if a != b]
        raise AssertionError(f"[orbax] records decode differently in C++ and Python: {bad[:8]}")
    content = sum(map(len, plain))
    reps = -(-ORBAX_DECODE_MB * 10**6 // content)
    batch = [(r, 0, len(r)) for r in records] * reps
    threads = zstd_host.default_threads()
    t0 = time.perf_counter()
    zstd_host.decompress_batch(batch, threads=threads)
    native_s = time.perf_counter() - t0
    log(f"[orbax] committed checkpoint: {len(records)} Zstandard records "
        f"({sum(map(len, records))} bytes -> {content}) equal through C++ and data/zstd.py; "
        f"C++ {reps * content / native_s / 1e6:.1f} MB/s of content over "
        f"{reps * content / 1e6:.1f} MB on {threads} threads ({len(batch)} records); "
        f"data/zstd.py {content / plain_s / 1e6:.3f} MB/s (one thread)")

    # (c) the committed checkpoint_0 resumed, card vs CPU
    fx_data = run_dir / "fixture_data"
    synth_data.generate(str(fx_data), n_items=40, n_users=48, image_size=28, seed=0)
    t0 = time.perf_counter()
    cpu = orbax_resume_side("cpu", fx_data, run_dir)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernel_lib.reset_launches()  # the main path starts here
    card = orbax_resume_side("cuda", fx_data, run_dir)
    resume_launches = counts()  # the main path ends here
    card_s = time.perf_counter() - t0
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    worst = {}
    for m in ("mu", "nu"):
        if set(card[m]) != set(cpu[m]) or not cpu[m]:
            raise AssertionError(f"[orbax] resumed {m} names differ card vs CPU")
        worst[m] = max(float((card[m][n] - t).abs().max()) / max(float(t.abs().max()), 1e-30)
                       for n, t in cpu[m].items())
    sure_d, n_sure, moved = orbax_update_gap(card, cpu)
    missing = [k for k in TRAIN_KERNELS if resume_launches[k] <= 0]
    log(f"[orbax] resume of the committed checkpoint_0, one update: losses card "
        f"{card['losses']} vs CPU {cpu['losses']} (rel {loss_rel:.2e}, limit 1e-5); worst "
        f"moment mu {worst['mu']:.2e}, nu {worst['nu']:.2e} of max (limit {SMALL_GRAD_TOL:g}); "
        f"weights max|d| {sure_d:.2e} over the {n_sure} entries with |g| > 1e-5 (limit "
        f"{1e-2 * ORBAX_LR:g}), {moved:.2e} over all (limit {2.01 * ORBAX_LR:g}); step "
        f"{card['step']} vs {cpu['step']}; card {card_s:.2f} s, CPU {cpu_s:.2f} s; launches "
        f"{json.dumps(resume_launches)}")
    if not (loss_rel <= 1e-5 and max(worst.values()) <= SMALL_GRAD_TOL and n_sure > 0
            and sure_d <= 1e-2 * ORBAX_LR and moved <= 2.01 * ORBAX_LR
            and card["step"] == cpu["step"] == 6) or missing:
        raise AssertionError(f"[orbax] the card's resume disagrees with the CPU's "
                             f"(kernels not launched: {missing})")
    shutil.rmtree(run_dir, ignore_errors=True)
    log(f"[orbax] phase 17 done in {time.perf_counter() - t_phase:.1f} s")
    return {"eval": eval_launches, "resume": resume_launches}


# ------------------------------------------------------------ phase 18

NINE_B = "openflamingo/OpenFlamingo-9B-vitl-mpt7b"  # the CLI name of 9b
NINE_B_RECORDS = 12  # (c): train users, 2 updates of 3 x 2; test users, one batch
# (d): 9b's structure at full width, vocab 8,576; items follow <image>
NINE_B_MEDIA_ID, NINE_B_ANSWER_ID, NINE_B_EOC_ID = 8000, 7999, 7998


def nine_b_structure():
    """9b at full width (CLIP ViT-L/14, the perceiver, MPT-7B: 4096 wide, 32
    heads of 128, ALiBi, x-attn every 4 layers) with its LM cut to 4 layers
    (one x-attn block), its ViT to 2, its vocabulary to 8,576; float32."""
    cfg = get_config("9b", dtype="float32")
    return cfg.replace(vision=dataclasses.replace(cfg.vision, num_layers=2),
                       lm=dataclasses.replace(cfg.lm, num_layers=4, vocab_size=8576))


def nine_b_side(device, weights_path, grads_path, draw: bool) -> dict:
    """One side of phase 18 (d) (card: kernels; CPU: plain versions; the
    CPU side in ``small_cpu_sides``' process): ``nine_b_structure`` built
    for training, gates open, on ``device``: with ``draw`` (the card side)
    drawn there from seed 1 and its tree written to ``weights_path``,
    else built from that file once it is there, so both sides hold the
    same weights and neither draws 1.1 B numbers on the host. Then the 10-beam eval of
    2 prompts of 64 tokens (2 images, 8 new tokens) and its prefill
    logits; one ``Trainer`` gradient (accum 1, the same 2 rows as a rec
    batch): its loss, the optimizer's gradient norm and every trainable
    gradient, saved to ``grads_path`` (a file is read in a moment where a
    pipe takes tens of seconds for 287 M entries)."""
    cfg = nine_b_structure()
    img = cfg.vision.image_size
    rng = np.random.default_rng(18)
    images = rng.integers(0, 256, size=(8, img, img, 3), dtype=np.uint8)
    ids, seq_len, image_ids, _ = prompts(rng, 2, 64, 2, 8, 48, NINE_B_MEDIA_ID,
                                         NINE_B_MEDIA_ID + 1)
    weights_path = Path(weights_path)
    if draw:
        model = build_model(cfg, device=device, seed=1, train=True)
        open_gates(model)
        tmp = weights_path.with_suffix(".tmp")
        torch.save({n.replace(".", "/"): t.detach().cpu() for n, t in model.state_dict().items()},
                   tmp)
        tmp.rename(weights_path)
    else:
        t0 = time.perf_counter()
        while not weights_path.exists():
            if time.perf_counter() - t0 > RANK_WAIT_S:
                raise TimeoutError(f"[9b-parity] no {weights_path} after {RANK_WAIT_S} s")
            time.sleep(0.5)
        model = build_model(cfg, device=device, train=True,
                            weights=torch.load(weights_path, mmap=True))
        weights_path.unlink()
    model.eval()
    cache = ItemLatentCache(model, lambda i: images[i], 8, chunk=8, device=device)
    gen = Generator(model, GenerationConfig(max_new_tokens=8, eos_id=EOS_ID, pad_id=EOS_ID,
                                            num_beams=10, num_return_sequences=10),
                    media_id=NINE_B_MEDIA_ID)
    t_ids = torch.from_numpy(ids).to(device)
    lat = cache.gather(image_ids)
    tok, _ = gen.generate(t_ids, torch.from_numpy(seq_len).to(device), lat)
    with torch.no_grad():
        logits, _ = model(t_ids, latents=lat, q_media=compute_q_media(t_ids, NINE_B_MEDIA_ID))
    out = {"tokens": tok.cpu(), "prefill": logits.float().cpu()}
    del cache, gen, lat, logits
    model.train()
    params = trainable_params(model)
    trainer = Trainer(model, make_optimizer(params), media_id=NINE_B_MEDIA_ID,
                      answer_id=NINE_B_ANSWER_ID, endofchunk_id=NINE_B_EOC_ID, pad_id=EOS_ID,
                      gamma=2.0, use_reweight=True, accum_steps=1, device=device)
    batch = train_batch(np.random.default_rng(19), 2, 64, 2, 8, img, 48, NINE_B_MEDIA_ID,
                        NINE_B_MEDIA_ID + 1, NINE_B_ANSWER_ID, NINE_B_EOC_ID)
    loss, _ = trainer.compute_grads(batch)
    norm = trainer.optimizer.grad_norm()
    torch.save({n: p.grad.detach().cpu() for n, p in params.items()}, grads_path)
    out["train"] = (float(loss), str(grads_path), float(norm),
                    int(not (torch.isfinite(loss) and torch.isfinite(norm))))
    return out


def phase_9b_parity(card: dict, cpu: dict) -> None:
    """Phase 18 (d), card against CPU at 9b's structure: phase 4's bars
    (token agreement >= 0.9, prefill logits within 2e-3; the loss within
    1e-5 relative and each trainable gradient within ``SMALL_GRAD_TOL`` of
    its largest entry, the gradient norm within the same)."""
    agree = float((card["tokens"] == cpu["tokens"]).float().mean())
    diff = float((card["prefill"] - cpu["prefill"]).abs().max())
    (l_card, g_card, n_card, k_card), (l_cpu, g_cpu, n_cpu, k_cpu) = card["train"], cpu["train"]
    g_card, g_cpu = (torch.load(p, mmap=True) for p in (g_card, g_cpu))
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    norm_rel = abs(n_card - n_cpu) / max(abs(n_cpu), 1e-30)
    worst, worst_name = 0.0, None
    for name, g in g_cpu.items():
        rel = float((g_card[name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    n_grad = sum(g.numel() for g in g_cpu.values())
    log(f"[9b-parity] card vs cpu, 9b structure (width 4096, 32 heads of 128, ALiBi, 4 LM "
        f"layers, one x-attn block, 2 ViT layers), float32: token agreement={agree:.4f} over "
        f"{tuple(card['tokens'].shape)}, prefill max_abs_logit_diff={diff:.3e} (limits >= 0.9, "
        f"<= 2e-3)")
    log(f"[9b-parity] gradient: loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}, limit "
        f"1e-5); grad norm {n_card:.6f} vs {n_cpu:.6f} (rel {norm_rel:.2e}); worst gradient "
        f"{worst_name} max|d|/max|g|={worst:.2e} over {len(g_cpu)} tensors, {n_grad / 1e6:.1f} M "
        f"entries (limit {SMALL_GRAD_TOL:g}); not finite {k_card} vs {k_cpu}")
    for path in (card["train"][1], cpu["train"][1]):
        Path(path).unlink()
    if not (agree >= 0.9 and diff <= 2e-3):
        raise AssertionError("[9b-parity] the 9b structure's eval on the card disagrees with the "
                             "CPU's")
    if not (loss_rel <= 1e-5 and worst <= SMALL_GRAD_TOL and norm_rel <= SMALL_GRAD_TOL
            and k_card == k_cpu == 0):
        raise AssertionError("[9b-parity] the 9b structure's gradient on the card "
                             "disagrees with the CPU's")


def phase_9b_train(gpu_line, data, run_dir) -> dict:
    """Phase 18 (c): ``mmrec.main`` on 9b at full width and depth (8.27 B
    parameters at vocab 8,576), seeded, on phase 8's files, with README's
    headline levers as phase 12 passes them (``--frozen_int8
    --bf16_opt_state --remat --remat_policy dots --cache_vision_latents``)
    at phase 12's shape (micro-batch 3 x accum 2 fused, 256 tokens and 6
    images a sample; no warm-up, so that the first update moves the
    weights): 2 updates and the 10-beam test pass over 12 users; no
    checkpoint is written (``unread_checkpoints``). Fails unless each
    update's loss and gradient norm are finite, the norm above zero, no
    update skipped, the gates and the embedding changed by each update,
    K1 / K2 / K3 launched what the code counts, and K4 / K5 / K6 what the
    test pass' decode steps give. Returns the launches."""
    from unimp_tpu_torch.cli import common, mmrec
    from unimp_tpu_torch.utils.flops import vision_forward_flops

    seen = {"steps": [], "decode_steps": 0}
    orig = {"build": common.build_model, "epoch": mmrec.train_one_epoch,
            "evals": mmrec.run_evals, "step": Trainer.train_step,
            "decode_step": Generator._decode_step}

    def build(args, tokenizer, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = orig["build"](args, tokenizer, **kw)
        torch.cuda.synchronize()
        seen["build"] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30,
                         torch.cuda.memory_allocated() / 2**30, quantized_bytes(model) / 2**30)
        return model

    def epoch(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            orig["epoch"](*args, **kw)
        finally:
            seen["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    def step(self, batch):
        digests = {n: replica_digest(p) for n, p in self.params.items()}
        before, t0 = counts(), time.perf_counter()
        metrics = orig["step"](self, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        changed = {n for n, p in self.params.items() if not torch.equal(replica_digest(p),
                                                                         digests[n])}
        seen["cfg"] = self.model.cfg
        seen["trainable"] = (len(self.params), sum(p.numel() for p in self.params.values()))
        seen["steps"].append(dict(
            ms=ms, loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
            skipped=int(metrics["skipped_nonfinite"]), launches=between(before),
            changed=len(changed), rows=tuple(np.shape(batch["input_ids"])),
            images=tuple(np.shape(batch["image_ids"])),
            unchanged_must=sorted(n for n in self.params if (n.endswith("_gate") or n ==
                                  "embed.embedding") and n not in changed)))
        return metrics

    def evals(args_, model, *args, **kw):
        seen["k6_per_step"] = k6_per_decode_step(model)
        before, steps, t0 = counts(), seen["decode_steps"], time.perf_counter()
        out = orig["evals"](args_, model, *args, **kw)
        seen["eval"] = (time.perf_counter() - t0, between(before),
                        seen["decode_steps"] - steps, out)
        return out

    def decode_step(self, *args, **kw):
        seen["decode_steps"] += 1
        return orig["decode_step"](self, *args, **kw)

    argv = ["--mmrec_path", str(data), "--external_save_dir", str(run_dir),
            "--pretrained_model_name_or_path", NINE_B, "--run_name", "9b_train", "--subset",
            "beauty", "--task", "rec", "--single_task", "--n_items", str(N_ITEM_TOKENS),
            "--history_len", "6", "--use_semantic", "--patch-image-size", "224",
            "--max_records", str(NINE_B_RECORDS), "--eval_batch_size", str(NINE_B_RECORDS),
            "--num_beams", "10", "--workers", "2", "--device", "cuda", "--batch_size", "3",
            "--gradient_accumulation_steps", "2", "--fused_accumulation", "--use_reweight",
            "--gamma", "2", "--cache_vision_latents", "--logging_steps", "1", "--num_epochs",
            "1", "--warmup_steps", "0", "--do_test", *HEADLINE_LEVERS]
    (common.build_model, mmrec.train_one_epoch, mmrec.run_evals, Trainer.train_step,
     Generator._decode_step) = (build, epoch, evals, step, decode_step)
    try:
        t0 = time.perf_counter()
        kernel_lib.reset_launches()          # the main path starts here
        with unread_checkpoints(("weights_epoch_0", "checkpoint_0", "final_weights")) as unread:
            mmrec.main(argv)
        launches = counts()                  # the main path ends here
        wall = time.perf_counter() - t0
    finally:
        (common.build_model, mmrec.train_one_epoch, mmrec.run_evals, Trainer.train_step,
         Generator._decode_step) = (orig["build"], orig["epoch"], orig["evals"], orig["step"],
                                    orig["decode_step"])
    shutil.rmtree(run_dir, ignore_errors=True)

    cfg, steps = seen["cfg"], seen["steps"]
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    fwd = cfg.resampler.depth + n_xattn + lm.num_layers      # K1 / K2 / K3 a micro-batch
    want = {"flash_fwd": 2 * (fwd + n_xattn + lm.num_layers),  # with the blocks' recompute
            "flash_bwd_dkv": 2 * fwd, "flash_bwd_dq": 2 * fwd, "quant_matmul": 0}
    t = steps[0]["rows"][1]
    flops = train_step_flops(cfg, 6, t, 6, frozen_backbone=True) - vision_forward_flops(cfg, 36)
    step_s = steps[-1]["ms"] / 1e3
    build_s, build_peak, build_alloc, weights_gib = seen["build"]
    eval_s, eval_launches, eval_steps, eval_out = seen["eval"]
    k6_step = seen["k6_per_step"]
    n_tensors, n_trainable = seen["trainable"]
    log(f"[9b-train] 9b ({NINE_B}), vocab {lm.vocab_size}, T {t}, 6 images a sample, "
        f"micro-batch 3 x accum 2 fused, {' '.join(HEADLINE_LEVERS)} --cache_vision_latents: "
        f"build {build_s:.1f} s, peak {build_peak:.2f} GiB for {build_alloc:.2f} GiB allocated "
        f"after it ({weights_gib:.2f} GiB of weights, the rest the fused int8 decode QKV; "
        f"{n_trainable / 1e9:.3f} B trainable in {n_tensors} tensors); wall {wall:.1f} s "
        f"({unread['unwritten']} checkpoints not written) on {gpu_line}")
    log(f"[9b-train] step ms {[round(x['ms'], 1) for x in steps]}; the second: "
        f"{6 / step_s:.3f} samples/s, MFU {100 * flops / step_s / PEAK_FLOPS[torch.bfloat16]:.2f}% "
        f"({flops / 1e12:.3f} TFLOP a step from utils/flops.py without the cached tower's "
        f"forward, against 989 TFLOP/s); peak device memory over the updates "
        f"{seen['peak_gib']:.2f} GiB on {gpu_line}")
    log(f"[9b-train] losses {[round(x['loss'], 6) for x in steps]}, grad norms "
        f"{[x['grad_norm'] for x in steps]}, tensors changed {[x['changed'] for x in steps]} of "
        f"{n_tensors}; launches an update {json.dumps(steps[-1]['launches'])}, expected "
        f"{json.dumps(want)}")
    log(f"[9b-train] test pass: {eval_s:.1f} s, {eval_steps} decode steps ({k6_step} K6 a step: "
        f"the int8 backbone), rec "
        f"{ {k: v for k, v in eval_out['rec'].items() if isinstance(v, (int, float))} }; "
        f"launches {json.dumps(eval_launches)} on {gpu_line}")
    # the gates, after the readings
    if len(steps) != NINE_B_RECORDS // 6:
        raise AssertionError(f"[9b-train] {len(steps)} updates, want {NINE_B_RECORDS // 6}")
    for i, x in enumerate(steps):
        if x["skipped"] or not (np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                                and x["grad_norm"] > 0) or x["unchanged_must"]:
            raise AssertionError(f"[9b-train] update {i}: loss {x['loss']}, grad norm "
                                 f"{x['grad_norm']}, skipped {x['skipped']}, unchanged "
                                 f"{x['unchanged_must'][:4]}")
        got = {k: x["launches"][k] for k in want}
        if got != want or x["rows"] != (6, 256) or x["images"] != (6, 6):
            raise AssertionError(f"[9b-train] update {i}: launches {got}, expected {want}; "
                                 f"batch {x['rows']}, images {x['images']}")
    if not 0 < eval_steps <= 50 or eval_launches["quant_matmul"] != k6_step * eval_steps or \
            eval_launches["decode_attn"] != lm.num_layers * eval_steps or \
            eval_launches["single_query_attn"] != n_xattn * eval_steps or k6_step <= 0:
        raise AssertionError(f"[9b-train] test pass launches {eval_launches} over {eval_steps} "
                             f"decode steps ({k6_step} int8 matmuls a step)")
    return launches


def phase_9b(dev, gpu_line, data, run_dir, write_s, memo_path, go) -> dict:
    """Phase 18, run apart (a ``PhaseProcess``): 9b through the port's own
    entry points at full width and depth, seeded, on phase 8's files: (d)'s
    card side (``nine_b_side``; the main line compares it with the CPU's)
    and its bf16 beam eval through K4 / K5 against the plain decode
    attention; (a) ``mmrec_eval.main`` bf16 and (b) int8 weights + int8 KV,
    2 x 24 users, 10 beams / 10 returned / 50 new tokens; then, once the
    main line has set ``go`` (its training phase is over, so the two peaks
    do not meet), (c) ``phase_9b_train``. The item decodes come from the
    main line's memo (``memo_path``)."""
    t0 = time.perf_counter()
    card = nine_b_side(dev, run_dir.parent / "9b_weights.pt", run_dir.parent / "9b_card_grads.pt",
                       draw=True)
    card["bf16"] = phase_small_bf16(dev, nine_b_structure().replace(dtype="bfloat16"),
                                    NINE_B_MEDIA_ID, "[9b-bf16]")
    log(f"[9b-parity] card side in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    ITEM_IMAGES.update(torch.load(memo_path, weights_only=False))
    out = {"parity": _tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, card)}
    with item_decode_memo(data):
        for key, tag, extra in (("eval", "[9b]", ()),
                                ("eval_int8", "[9b-int8]", ("--eval_param_dtype", "int8",
                                                            "--kv_int8"))):
            t0 = time.perf_counter()
            out[key] = phase_cli(dev, gpu_line, data, run_dir / key, write_s, NINE_B, extra, tag,
                                 profile=False)
            log(f"{tag} done in {time.perf_counter() - t0:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if not go.wait(RANK_WAIT_S):
            raise TimeoutError(f"[9b-train] the main line did not signal in {RANK_WAIT_S} s")
        waited = time.perf_counter() - t0
        out["train"] = phase_9b_train(gpu_line, data, run_dir / "train")
        log(f"[9b-train] done in {time.perf_counter() - t0:.1f} s ({waited:.1f} s waiting for "
            f"the main line)")
    return out


def kernel_name(ptxas_line: str) -> str:
    """The kernel's name and its mangled template arguments, as in
    'flash_fwd_mma_kernel ILi80ELb1EE' (80, true), from ptxas's
    "Compiling entry function '<mangled>'" line."""
    # overlapping matches: a length-prefixed name that ends in _kernel
    for m in re.finditer(r"(?=(\d{1,2})([A-Za-z_]\w*?_kernel)(I\w*?EE|E))", ptxas_line):
        if int(m.group(1)) == len(m.group(2)):
            return m.group(2) + ("" if m.group(3) == "E" else " " + m.group(3))
    return ptxas_line.strip()[:80]


# the port's kernels as the profiler names them (each name ends "_kernel")
PORT_KERNELS = ("flash_fwd_kernel", "flash_fwd_mma_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkv_mma_kernel", "flash_bwd_dq_mma_kernel",
                "decode_attn_kernel", "single_query_kernel", "decode_attn_mma_kernel",
                "single_query_mma_kernel", "qmm_bf16_kernel", "qmm_splitk_reduce_kernel",
                "qmm_f32_kernel")


def profile_run(label: str, run, unprofiled_s: float) -> None:
    """Where one more run spends its time (torch.profiler over the card's
    activity only, after the launch counts are read): device busy share and
    the top kernels, summed from the profiler's raw kernel events (the same
    sums as ``key_averages()``, in a tenth of its time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        # user annotations (AdamW's "Optimizer.step") span kernels counted
        # on their own
        if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
            continue
        ms, count = by_name.get(ev.name(), (0.0, 0))
        by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, count + 1)
    kernels = [(ms, count, name) for name, (ms, count) in by_name.items()]
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] {label}: wall {wall_ms:.1f} ms under the profiler, "
        f"{unprofiled_s * 1e3:.1f} ms without; device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / (unprofiled_s * 1e3):.1f}% of the unprofiled wall; "
        f"{sum(k[1] for k in kernels)} kernels")
    groups = {"port kernels": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    port = {}  # device ms by port kernel
    for ms, _, name in kernels:
        kernel = next((k for k in PORT_KERNELS if k in name), None)
        if kernel:
            groups["port kernels"] += ms
            port[kernel] = port.get(kernel, 0.0) + ms
        elif any(k in name.lower() for k in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
            groups["matmul (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    log("[profile] device ms by group: " + ", ".join(f"{k} {v:.1f}" for k, v in groups.items()))
    log("[profile] port kernels, device ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(port.items(), key=lambda kv: -kv[1])))
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        log(f"[profile] {ms:9.2f} ms {count:7d}x {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # a SIGTERM unwinds, so run_tree removes its files
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # processes that run phases apart, beside the main line: stopped on any
    # exit of the run
    apart = []
    try:
        with run_tree() as tmp:
            return run_phases(dev, gpu_line, apart, tmp)
    finally:
        for proc in apart:
            proc.close()


def phases_15_16(dev, gpu_line, data, run_dir) -> dict:
    """Phases 15 and 16, run apart (a ``PhaseProcess``)."""
    harness = phase_harness(dev, gpu_line, data, run_dir)
    gc.collect()  # the harness' models are gone: give their memory back
    torch.cuda.empty_cache()
    return {"harness": harness, "lm": phase_causal_lm(dev, gpu_line)}


def phase_tools_apart(dev, gpu_line, data, run_dir, memo_path) -> dict:
    """Phase 14, run apart (a ``PhaseProcess``) on the main line's item
    decode memo (``memo_path``)."""
    ITEM_IMAGES.update(torch.load(memo_path, weights_only=False))
    with item_decode_memo(data):
        return phase_tools(dev, gpu_line, data, run_dir)


def run_phases(dev, gpu_line, apart, tmp) -> int:
    import multiprocessing

    half = max(1, (os.cpu_count() or 2) // 2)
    # phase 4's CPU sides (and phase 18 (d)'s) from here, while the card
    # builds and runs phases 3, 5-8 and 17
    small_cpu = PhaseProcess("[small] CPU sides", small_cpu_sides, tmp, threads=half)
    apart.append(small_cpu)
    # phase 8's files are written while nvcc builds (the main thread only
    # waits for its processes), and the catalogue is decoded while phase 3
    # runs (its processes beside phase 3's device-timed checks)
    data, written = Path(tmp) / "data", {}

    def write():
        try:
            written["s"] = write_cli_data(data)
        except BaseException as err:  # raised again on the main thread
            written["error"] = err

    writer = threading.Thread(target=write)
    writer.start()
    t0 = time.perf_counter()
    try:
        libs = kernel_lib.build_all()
    finally:
        writer.join()
    if "error" in written:
        raise written["error"]
    write_s = written["s"]
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))
    for name in libs:
        info = (kernel_lib.BUILD_DIR / f"{name}.ptxas.txt")
        if info.exists():
            fn = "?"
            for line in info.read_text().splitlines():
                if "Compiling entry function" in line:
                    fn = kernel_name(line)
                elif "registers" in line or "spill" in line:
                    log(f"[ptxas] {name}: {fn}: {line.replace('ptxas info    :', '').strip()}")

    finish_memo = start_item_memo(data)  # phases 9-14 and 18 decode the catalogue once
    t0 = time.perf_counter()
    results, timings = phase_kernels(dev)
    log(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")
    finish_memo()
    memo_path = Path(tmp) / "item_images.pt"
    torch.save(dict(ITEM_IMAGES), memo_path)
    # phase 18 apart, beside phases 5-8, 17 and 4 (peak card memory:
    # 9b's eval about 25 GiB beside phase 6's 34; its training, up to 45
    # GiB, starts once ``after_training`` is set, beside phases up to 15)
    after_training = multiprocessing.get_context("spawn").Event()
    nine_b = PhaseProcess("[9b] phase 18", phase_9b, dev, gpu_line, data, Path(tmp) / "9b",
                          write_s, memo_path, after_training, threads=half)
    apart.append(nine_b)
    t0 = time.perf_counter()
    eval_launches = phase_4b(dev, gpu_line)
    log(f"[4b] done in {time.perf_counter() - t0:.1f} s")
    gc.collect()  # the eval model is gone: give its memory back before training
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches = phase_4b_train(dev, gpu_line)
    log(f"[4b-train] done in {time.perf_counter() - t0:.1f} s")
    gc.collect()  # the training model is gone: give its memory back
    torch.cuda.empty_cache()
    after_training.set()
    t0 = time.perf_counter()
    int8_launches = phase_4b(dev, gpu_line, int8=True, timings=timings)
    log(f"[4b-int8] done in {time.perf_counter() - t0:.1f} s")
    gc.collect()  # the int8 model is gone: give its memory back
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli_launches = phase_cli(dev, gpu_line, data, Path(tmp) / "runs", write_s)
    log(f"[cli] done in {time.perf_counter() - t0:.1f} s")
    gc.collect()  # the CLI's eval model is gone: give its memory back
    torch.cuda.empty_cache()
    orbax_launches = phase_orbax(dev, gpu_line, data, Path(tmp) / "orbax")
    gc.collect()  # phase 17's models are gone: give their memory back
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_small_bf16(dev)
    cpu_sides = _tree_map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
                          small_cpu.get())
    phase_small(dev, cpu_sides["eval"])
    phase_small(dev, cpu_sides["eval_int8"], int8=True)
    phase_small_train(dev, cpu_sides["train"])
    phase_small_train_flags(dev, cpu_sides["flags"])
    phase_small_tasks(dev, cpu_sides["tasks"])
    log(f"[small] done in {time.perf_counter() - t0:.1f} s")
    nine_b_out = _tree_map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
                           nine_b.get())
    phase_9b_parity(nine_b_out["parity"], cpu_sides.pop("9b"))
    del cpu_sides
    gc.collect()
    # phases 15-16 apart, beside phases 9-10 (peak card memory 15.5 + 36.1
    # GiB at most)
    late = PhaseProcess("[harness+lm] phases 15-16", phases_15_16, dev, gpu_line, data,
                        Path(tmp) / "harness", threads=half)
    apart.append(late)
    with item_decode_memo(data):  # phases 9-14 decode the catalogue once
        t0 = time.perf_counter()
        with lm_layers(LM_LAYERS_9_10):
            train_cli_launches = phase_train_cli(dev, gpu_line, data, Path(tmp) / "train")
        log(f"[train-cli] done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # the training CLI's models are gone: give their memory back
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with lm_layers(LM_LAYERS_9_10):
            task_launches = phase_tasks(dev, gpu_line, data, Path(tmp) / "tasks")
        log(f"[tasks] phase 10 done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # phase 10's models are gone: give their memory back
        torch.cuda.empty_cache()
        late_launches = late.get()
        # phase 14 apart (after phase 10: it decodes phase 10's img_gen
        # dump), beside phase 11 (peak card memory 19.9 + 7.9 GiB)
        torch.save(dict(ITEM_IMAGES), memo_path)
        tools = PhaseProcess("[tools] phase 14", phase_tools_apart, dev, gpu_line, data,
                             Path(tmp) / "tools", memo_path, threads=half)
        apart.append(tools)
        t0 = time.perf_counter()
        serve_launches = phase_serve(dev, gpu_line, data)
        log(f"[serve] phase 11 done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # the workers are gone: give their memory back
        torch.cuda.empty_cache()
        tools_launches = tools.get()
        memo_path.unlink()
        t0 = time.perf_counter()
        headline_launches = phase_headline_train(gpu_line, data, Path(tmp) / "headline")
        log(f"[headline] phase 12 done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # phase 12's models are gone: the ranks get the card
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        multi_launches = phase_multi_gpu(gpu_line, data, Path(tmp) / "multi")
        log(f"[multi-gpu] phase 13 done in {time.perf_counter() - t0:.1f} s")
    ITEM_IMAGES.clear()
    harness_launches, lm_launches = late_launches["harness"], late_launches["lm"]

    # one headline shape per kernel: LM prefill, the LM self-attention
    # backward of training, decode at step 50, x-attn read, the MLP
    # up-projection of a decode step (48 launches a step)
    headline = {"flash_fwd": "lm_prefill_128_d80_causal_window",
                "flash_bwd_dkv": "lm_train_3x256_d80_causal_kvlen",
                "flash_bwd_dq": "lm_train_3x256_d80_causal_kvlen",
                "decode_attn": "4b_b24_k10_d80_step50",
                "single_query_attn": "4b_b24_k10_s256_d80",
                "decode_attn_int8": "4b_b24_k10_d80_step50_int8",
                "single_query_attn_int8": "4b_b24_k10_s256_d80_int8",
                "quant_matmul": "4b_decode_m240_up_2560x10240"}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        tm = next(r for r in timings if r["kernel"] == name and r["case"] == headline[name])
        by_path = {path: n[name] for path, n, kernels in (
            ("eval", eval_launches, EVAL_KERNELS), ("train", train_launches, TRAIN_KERNELS),
            ("eval_int8", int8_launches, INT8_KERNELS), ("cli", cli_launches, EVAL_KERNELS),
            ("train_cli", train_cli_launches, tuple(KERNELS)),
            ("tasks", task_launches["tasks"], TASK_KERNELS),
            ("img_gen", task_launches["img_gen"], EVAL_KERNELS),
            ("transfer", task_launches["transfer"], TASK_KERNELS),
            ("serve", serve_launches["serve"], EVAL_KERNELS),
            ("serve_int8", serve_launches["serve_int8"], INT8_KERNELS),
            ("serve_small_f32", serve_launches["serve_small_f32"], EVAL_KERNELS),
            ("headline_train", headline_launches, TASK_KERNELS + ("quant_matmul",)),
            ("multi_gpu", multi_launches, TASK_KERNELS + ("quant_matmul",)),
            ("tools", tools_launches, TASK_KERNELS + ("quant_matmul",)),
            ("harness", harness_launches, EVAL_KERNELS),
            ("causal_lm", lm_launches["bf16"], ("flash_fwd", "decode_attn")),
            ("causal_lm_int8", lm_launches["int8"], ("flash_fwd", "decode_attn_int8",
                                                     "quant_matmul")),
            ("orbax_eval", orbax_launches["eval"], EVAL_KERNELS),
            ("orbax_resume", orbax_launches["resume"], TRAIN_KERNELS),
            ("9b_eval", nine_b_out["eval"], EVAL_KERNELS),
            ("9b_eval_int8", nine_b_out["eval_int8"], INT8_KERNELS),
            ("9b_train", nine_b_out["train"], TASK_KERNELS + ("quant_matmul",)))
            if name in kernels}
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(by_path.values()), "launches_by_path": by_path,
               "max_abs_err": results[name]["max_abs_err"],
               "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
               "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
               "shape": headline[name]}
        for key in ("library", "bf16_matmul_ms"):
            if key in tm:
                row[key] = tm[key]
        rows.append(row)
    print(gpu_line, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-gpu-rank"]:  # one rank of phase 13, under torchrun
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
