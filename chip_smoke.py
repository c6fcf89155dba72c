#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unimp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card check: needs CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port from ``csrc/`` (one
     nvcc per source, all at once) and prints the build seconds;
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
     384 latents, K6 at its 180-row test-pass decode, and
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
     greedy to 600; token agreement);
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
     profile of the second batch's generate, that generate again with the
     garbage collector's seconds (``[gc]``, as after phase 5's profile),
     and a control: phase 5's kind of prompts through the CLI's model;
  9. rec training from the same files through the port's own CLI:
     ``unimp_tpu_torch.cli.mmrec.main`` at 4b-instruct width and depth
     with the reference's training shape (micro-batch 3 x accum 2 fused,
     gamma 2 with reweight, bf16 frozen backbone, the vision-tower cache
     of all 4,167 items), one epoch of 24 train users (4 updates), the
     10-beam test pass over 24 users, ``weights_epoch_0``,
     ``checkpoint_0`` and ``final_weights``; then ``final_weights`` read
     back and held to the trained tensors bit for bit, and
     ``mmrec_eval --load_weights_name final_weights`` in bf16 (tokens
     agree >= 0.9 with the training run's test pass) and with int8
     weights and int8 KV (K6 193 times a decode step and once a batch);
     fails unless K1 / K2 / K3 ran perceiver + x-attn + LM layers times
     each micro-batch and no ViT layer in a step, the cache ran the ViT
     once a chunk, every loss is finite and no step skipped; prints the
     disk and host memory, the cache's seconds and bytes, each step's ms
     and the StepTimer's samples/s, the checkpoint write and read
     seconds and bytes, peak device memory, the host's peak RSS and both
     reload evals' items/s; deletes its run directory;
 10. the other tasks, multi-task training and the transfer entry through
     the port's own CLIs at 4b-instruct width and depth, on phase 8's
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
     train split cut to 36 users, ``mmrec.main`` in ranks launched by
     ``python -m torch.distributed.run`` (this script's rank mode, the
     parent holding no model): (a) one rank over NCCL at micro-batch 6 x
     accum 2 (3 updates, the test pass, ``checkpoint_0``); (b) two ranks
     sharing the card over gloo (dp 2) at 3 x 2, the same global batches;
     (c) (b)'s ``checkpoint_0`` resumed in one rank; fsdp 2 and tp 2 for 2
     updates each when gloo takes their collectives on CUDA tensors.
     Fails unless every update launched K1 / K2 / K3 as counted and the
     test passes K4 / K5 / K6 at every decode step, (b)'s replicas agree
     after every update, (b)'s losses are within 1e-4 of (a)'s and its
     grad norms within one bfloat16 step, (b)'s test
     pass covers (a)'s 36 users, and (c)'s state equals (b)'s saved one;
     prints update ms, losses, peak memory a rank and the run walls.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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
from unimp_tpu_torch.ops.quant_matmul import QuantMatmulFn, quant_matmul_cuda, quant_matmul_ref
from unimp_tpu_torch.tools.from_flax import build_model
from unimp_tpu_torch.train.optimizer import make_optimizer
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
            timings.append(dict(
                kernel=kernel, case=f"{name}_step{step}{tag}",
                ms=cuda_ms(lambda: decode_attention_cuda(*args, step=step, **kws)),
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
    4 slots) and prefill shapes (M = 4 x 64 = 256 rows), odd shapes, and the edges of the
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
    cases += [("4b_prefill_head_m24_2560x54656", True, 24, 2560, 54656, None),
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


def phase_small(dev, int8: bool = False):
    """small variant, f32, gates open: the same beam eval on the card
    (kernels) and on the CPU (plain versions); ``int8``: weight-only int8
    (every kernel of at least 65,536 elements, f32 compute) and int8 KV
    caches."""
    cfg = get_config("small", dtype="float32")
    models = []
    for _ in range(2):
        model = build_model(cfg, device="cpu", seed=1)
        open_gates(model)
        if int8:
            quantize_params_int8(model, dtype=torch.float32)
        models.append(model)
    cpu_model, card_model = models[0], models[1].to(dev)
    rng = np.random.default_rng(1)
    img = cfg.vision.image_size
    images = rng.integers(0, 256, size=(16, img, img, 3), dtype=np.uint8)
    gen_cfg = GenerationConfig(max_new_tokens=20, eos_id=EOS_ID, pad_id=EOS_ID,
                               num_beams=10, num_return_sequences=10, kv_int8=int8)
    toks, prefill = {}, {}
    for label, model, device in (("card", card_model, dev), ("cpu", cpu_model, torch.device("cpu"))):
        cache = ItemLatentCache(model, lambda i: images[i], 16, chunk=8, device=device)
        gen = Generator(model, gen_cfg, media_id=SMALL_MEDIA_ID)
        rng = np.random.default_rng(2)
        outs = []
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
                prefill[label] = logits.cpu()
        toks[label] = torch.cat(outs)
    agree = float((toks["card"] == toks["cpu"]).float().mean())
    diff = float((prefill["card"] - prefill["cpu"]).abs().max())
    tag = "[small-int8]" if int8 else "[small]"
    log(f"{tag} card vs cpu: token agreement={agree:.4f} "
        f"prefill max_abs_logit_diff={diff:.3e} (limits: agreement >= 0.9, diff <= 2e-3)")
    if not (agree >= 0.9 and diff <= 2e-3):
        raise AssertionError(f"{tag} small-variant path on the card disagrees with the CPU path")


def phase_small_bf16(dev):
    """small variant, bf16 weights and compute, gates open, on the card: the
    beam eval through K4 / K5 and again with the model's decode attention
    pointed at their plain versions (on the card too): the first check of
    the tensor-core decode kernels under a real beam_sel."""
    from unimp_tpu_torch.models import layers

    cfg = get_config("small")
    model = build_model(cfg, device=dev, seed=1, eval_param_dtype="bf16")
    open_gates(model)
    rng = np.random.default_rng(1)
    img = cfg.vision.image_size
    images = rng.integers(0, 256, size=(16, img, img, 3), dtype=np.uint8)
    cache = ItemLatentCache(model, lambda i: images[i], 16, chunk=8, device=dev)
    gen = Generator(model, GenerationConfig(max_new_tokens=20, eos_id=EOS_ID, pad_id=EOS_ID,
                                            num_beams=10, num_return_sequences=10),
                    media_id=SMALL_MEDIA_ID)
    rng = np.random.default_rng(2)
    batches = [prompts(rng, 2, 64, 4, 16, 48, SMALL_MEDIA_ID, SMALL_MEDIA_ID + 1)
               for _ in range(2)]
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
    log(f"[small-bf16] card, kernels vs plain decode attention: token agreement={agree:.4f} "
        f"(limit >= 0.9); launches {json.dumps(launches)}")
    if not (agree >= 0.9 and min(launches.values()) > 0):
        raise AssertionError("[small-bf16] beam search through K4 / K5 disagrees with the plain "
                             "decode attention on the card")


# each task's decode (beams, new tokens) and media a prompt: exp 5 beams to 256,
# img_sel 2 beams to 40 over 9 images, img_gen greedy to 600
SMALL_TASKS = {"exp": (5, 256, 4), "img_sel": (2, 40, 9), "img_gen": (1, 600, 4)}


def phase_small_tasks(dev):
    """small variant, f32, gates open: the other tasks' decodes, one returned
    sequence each, on the card (kernels) and on the CPU (plain versions),
    one batch of 2 prompts each; token agreement as for the rec eval."""
    cfg = get_config("small", dtype="float32")
    cpu_model = build_model(cfg, device="cpu", seed=1)
    open_gates(cpu_model)
    card_model = build_model(cfg, device="cpu", seed=1)
    open_gates(card_model)
    card_model = card_model.to(dev)
    rng = np.random.default_rng(3)
    img = cfg.vision.image_size
    images = rng.integers(0, 256, size=(16, img, img, 3), dtype=np.uint8)
    caches = {label: ItemLatentCache(model, lambda i: images[i], 16, chunk=8, device=device)
              for label, model, device in (("card", card_model, dev),
                                           ("cpu", cpu_model, torch.device("cpu")))}
    for task, (beams, new, n_media) in SMALL_TASKS.items():
        ids, seq_len, image_ids, _ = prompts(rng, 2, 96, n_media, 16, 80, SMALL_MEDIA_ID,
                                             SMALL_MEDIA_ID + 1)
        gen_cfg = GenerationConfig(max_new_tokens=new, eos_id=EOS_ID, pad_id=EOS_ID,
                                   num_beams=beams, num_return_sequences=1)
        toks = {}
        for label, model, device in (("card", card_model, dev),
                                     ("cpu", cpu_model, torch.device("cpu"))):
            gen = Generator(model, gen_cfg, media_id=SMALL_MEDIA_ID)
            tok, _ = gen.generate(torch.from_numpy(ids).to(device),
                                  torch.from_numpy(seq_len).to(device),
                                  caches[label].gather(image_ids))
            toks[label] = tok.cpu()
        agree = float((toks["card"] == toks["cpu"]).float().mean())
        log(f"[small-{task}] card vs cpu, {beams} beam(s), {new} new tokens, {n_media} images: "
            f"token agreement={agree:.4f} over {tuple(toks['card'].shape)} (limit >= 0.9)")
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
    if not int8:
        gc_report(f"{tag} batch 2 again", run)
    return launches


def check_int8_launches(cfg, launches, n_batches, tag="[4b-int8]") -> None:
    """On the int8 path: the decode steps that ran, read from K4's int8
    launches (one per LM layer a step); then K5 int8 once per x-attn layer
    a step, K6 193 times a step plus the prefill head once a batch, and
    none of the float decode kernels."""
    lm = cfg.lm
    steps, rest = divmod(launches["decode_attn_int8"], lm.num_layers)
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    want = {"decode_attn_int8": steps * lm.num_layers, "single_query_attn_int8": steps * n_xattn,
            "quant_matmul": steps * K6_PER_STEP + n_batches,
            "decode_attn": 0, "single_query_attn": 0}
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


def phase_small_train(dev):
    """small variant, f32, gates open: one Trainer step (accum 2) on the
    card and on the CPU from the same weights and batch."""
    cfg = get_config("small", dtype="float32")
    batch = train_batch(np.random.default_rng(3), 4, 64, 2, 16, cfg.vision.image_size, 48,
                        SMALL_MEDIA_ID, SMALL_MEDIA_ID + 1, SMALL_ANSWER_ID, SMALL_EOC_ID)
    got = {}
    for label, device in (("card", dev), ("cpu", torch.device("cpu"))):
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
        got[label] = (float(loss), grads, float(metrics["loss"]),
                      int(metrics["skipped_nonfinite"]))
    (l_card, g_card, s_card, k_card), (l_cpu, g_cpu, s_cpu, k_cpu) = got["card"], got["cpu"]
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


def phase_small_train_flags(dev):
    """small variant, f32, gates open: one Trainer step with each headline
    training flag alone (``--frozen_int8``, ``--bf16_opt_state``, ``--remat
    --remat_policy dots``), then all three, on the card and on the CPU from
    the same weights and batch. Limits of ``phase_small_train``: the loss
    1e-5 relative, each gradient 5e-4 of its largest entry; a bfloat16
    gradient also one bfloat16 step of the entry (the two sides' float32
    gradients may straddle a rounding boundary)."""
    cfg0 = get_config("small", dtype="float32")
    batch = train_batch(np.random.default_rng(3), 2, 64, 2, 16, cfg0.vision.image_size, 48,
                        SMALL_MEDIA_ID, SMALL_MEDIA_ID + 1, SMALL_ANSWER_ID, SMALL_EOC_ID)
    for label, kw in SMALL_FLAGS.items():
        cfg = cfg0.replace(remat=True, remat_policy=kw["remat"]) if "remat" in kw else cfg0
        bf16 = torch.bfloat16 if kw.get("bf16") else None
        got = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            model = build_model(cfg, device="cpu", seed=1, train=True,
                                frozen_dtype=kw.get("frozen")).to(device)
            open_gates(model)
            params = trainable_params(model)
            trainer = Trainer(model, make_optimizer(params, moment_dtype=bf16),
                              media_id=SMALL_MEDIA_ID, answer_id=SMALL_ANSWER_ID,
                              endofchunk_id=SMALL_EOC_ID, pad_id=EOS_ID, gamma=2.0,
                              use_reweight=True, device=device, grad_dtype=bf16)
            loss, _ = trainer.compute_grads(batch)
            grads = {n: g.detach().float().cpu() for n, g in
                     trainer.optimizer.named_grads().items()}
            metrics = trainer.train_step(batch)
            got[where] = (float(loss), grads, float(metrics["loss"]),
                          int(metrics["skipped_nonfinite"]), count_quantized(model))
        (l_card, g_card, s_card, k_card, q_card), (l_cpu, g_cpu, s_cpu, k_cpu, q_cpu) = (
            got["card"], got["cpu"])
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


def phase_cli(dev, gpu_line, data, run_dir, write_s):
    """The 4b-instruct rec eval from files through the port's own CLI:
    ``unimp_tpu_torch.cli.mmrec_eval.main`` on ``write_cli_data``'s files
    tokenizes, builds prompts, batches, encodes the referenced catalogue
    once and runs the 10-beam search over 2 x 24 test users, bf16, seeded
    weights (gates closed, as an init leaves them). Spies around the
    evaluator's batches, the latent cache and the generator read the
    timings and the decode steps; the launch counts are the kernels'."""
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
        for answers, batch, ips in orig_batches(*args, **kw):
            seen["batches"].append((batch["input_ids"].shape, ips))
            seen["image_ids"] = batch["image_ids"]
            yield answers, batch, ips

    def ensure(self, ids):
        seen["cache"] = self
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
        torch.cuda.reset_peak_memory_stats()
        return seen["model"]

    argv = ["--mmrec_path", str(data), "--external_save_dir", str(run_dir),
            "--run_name", "cli", "--pretrained_model_name_or_path", "4b-instruct",
            "--subset", "beauty", "--task", "rec", "--single_task",
            "--n_items", str(N_ITEM_TOKENS), "--history_len", "5",
            "--patch-image-size", "224", "--eval_batch_size", str(CLI_BATCH),
            "--num_beams", "10", "--max_records", str(CLI_USERS), "--workers", "2",
            "--do_test", "--device", "cuda"]
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
    if len(rank) != 9 or not all(0.0 <= v <= 1.0 for v in rank.values()):
        raise AssertionError(f"[cli] rec metrics missing or out of range: {metrics}")
    if metrics["n_users"] != CLI_USERS or not metrics["items_per_sec"] > 0 \
            or len(dump) != CLI_USERS:
        raise AssertionError(f"[cli] want {CLI_USERS} users scored and items/s > 0: "
                             f"{metrics}, {len(dump)} dump entries")
    cfg = seen["model"].cfg
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    steps = seen["steps"]
    want = {"decode_attn": lm.num_layers * steps, "single_query_attn": n_xattn * steps}
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if launches["flash_fwd"] <= 0 or bad or not 0 < steps <= 50 * len(seen["batches"]):
        raise AssertionError(f"[cli] launches differ (got, expected): {bad}; K1 "
                             f"{launches['flash_fwd']}; {steps} decode steps")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "tokenizers"))
    if loaded:
        raise AssertionError(f"[cli] modules the card's machine lacks were imported: {loaded}")
    shapes = [shape for shape, _ in seen["batches"]]
    batch_s = [shape[0] / ips for shape, ips in seen["batches"]]
    log(f"[cli] vocab: base {base_vocab} (corpus), extended {len(seen['tokenizer'])}, "
        f"LM {lm.vocab_size} (padded to 128); prompt T {[s[1] for s in shapes]} (collate), "
        f"batches {[s[0] for s in shapes]}")
    log(f"[cli] data write {write_s:.2f} s (synth_data, {N_ITEM_TOKENS} JPEGs of 64 px); "
        f"main {main_s:.2f} s; catalogue encode {seen['encode_s']:.2f} s "
        f"(latent cache misses, decode + resize + ViT + perceiver)")
    log(f"[cli] batch seconds {batch_s} (fetch + encode misses + generate); generate seconds "
        f"{seen['generate_s']}; {steps} decode steps")
    log(f"[cli] items/s: evaluator {metrics['items_per_sec']:.3f} (mean over batches, the first "
        f"with its misses), second batch {CLI_BATCH / batch_s[1]:.3f}; peak_mem={peak_gib:.2f} "
        f"GiB (the eval, after the build; the build, a float32 init then the bf16 cast, "
        f"{seen['build_peak_gib']:.2f} GiB) on {gpu_line}; not comparable to phase 5 (vocab "
        f"{lm.vocab_size} not 54,656, real prompts)")
    log(f"[cli] metrics {json.dumps(rank)}")
    log(f"[cli] launches {json.dumps(launches)}; expected {json.dumps(want)}; "
        f"PIL / tokenizers not imported")
    gen, args = seen["last"]
    profile_run("[cli] batch 2 generate", lambda: gen.generate(*args), seen["generate_s"][-1])
    gc_report("[cli] batch 2 generate again", lambda: gen.generate(*args))
    # control: phase 5's kind of prompts (random text, 100-128 tokens) through
    # the CLI's model and generator, on the second batch's (cached) items
    tok = seen["tokenizer"]
    ids, seq_len, _, _ = prompts(np.random.default_rng(0), CLI_BATCH, 128, 4, N_ITEM_TOKENS,
                                 100, tok.media_token_id, tok.convert_tokens_to_ids("item_0"))
    latents = seen["cache"].gather(seen["image_ids"])
    gc_report("[cli] phase 5's prompts, the CLI's model",
              lambda: gen.generate(torch.from_numpy(ids).to(dev), torch.from_numpy(seq_len).to(dev),
                                   latents))
    return launches


# ------------------------------------------------------------ phase 9

TRAIN_CLI_RECORDS = 24  # train users (4 updates of 3 x 2) and test users (one batch)


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
    width and depth: ``unimp_tpu_torch.cli.mmrec.main`` on
    ``write_cli_data``'s files with the reference's training shape (micro-
    batch 3 x accum 2 fused, focal loss gamma 2 with reweight, bf16 frozen
    backbone, the vision-tower cache), one epoch over 24 train users (4
    updates), the 10-beam test pass over 24 users, and its checkpoints.
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
            "build": common.build_model}

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
                                "--logging_steps", "1"]
    train_dir = run_dir / "train"

    def reload_argv(run_name, *extra):
        return common_argv + ["--run_name", run_name, "--load_dir", str(train_dir),
                              "--load_weights_name", "final_weights", *extra]

    (mmrec.build_tower_cache, mmrec.train_one_epoch, mmrec.run_evals, ckpt._write,
     Trainer.train_step, Generator.generate, Generator._decode_step, common.build_model) = (
        cache, epoch, evals, write, step, generate, decode_step, build)
    try:
        kernel_lib.reset_launches()          # the main path starts here
        t0 = time.perf_counter()
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

        reload = {}
        for label, dtype_args in (("bf16", ()), ("int8", ("--eval_param_dtype", "int8",
                                                         "--kv_int8"))):
            seen["generates"], seen["decode_steps"] = [], 0
            before = counts()
            t0 = time.perf_counter()
            results = mmrec_eval.main(reload_argv(f"reload_{label}", *dtype_args))
            torch.cuda.synchronize()
            reload[label] = (time.perf_counter() - t0, results["rec"], list(seen["generates"]),
                             between(before), seen["decode_steps"])
            del seen["model"]
            gc.collect()
            torch.cuda.empty_cache()
        launches = counts()                  # the main path ends here
    finally:
        (mmrec.build_tower_cache, mmrec.train_one_epoch, mmrec.run_evals, ckpt._write,
         Trainer.train_step, Generator.generate, Generator._decode_step,
         common.build_model) = (orig["cache"], orig["epoch"], orig["evals"], orig["write"],
                                orig["step"], orig["generate"], orig["decode_step"],
                                orig["build"])
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
    _, _, _, int8_launches, int8_steps = reload["int8"]
    check_int8_launches(cfg, int8_launches, 1, tag="[train-cli]")
    if int8_launches["decode_attn_int8"] != lm.num_layers * int8_steps:
        raise AssertionError(f"[train-cli] int8 reload: K4 int8 {int8_launches} for "
                             f"{int8_steps} decode steps")

    # --- report
    writes = seen["writes"]
    log(f"[train-cli] 4b-instruct, vocab {lm.vocab_size}, {n_trainable / 1e9:.3f} B "
        f"trainable (f32), frozen bf16; main {train_main_s:.1f} s (build, cache, 4 steps, "
        f"the test pass, checkpoints) on {gpu_line}")
    log(f"[train-cli] vision cache: {cache_shape[0]} items in {cache_s:.2f} s (host JPEG "
        f"decode + resize, ViT), {cache_bytes / 2**30:.3f} GiB {list(cache_shape)} on {gpu_line}")
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
        f"s, {sum(w[2] for w in writes) / 2**30:.2f} GiB on {gpu_line}")
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
    return launches



# ------------------------------------------------------------ phase 10

TASK_USERS = 24  # train users kept; test users a task (one batch of 24)
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
    port's own CLIs at 4b-instruct width and depth, bf16 compute, on
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
        return int(rows <= 512)

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
          ``weights_epoch_0`` and ``checkpoint_0``, then the first update
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
    item image is memoized across the four runs (same files, same
    result), so the catalogue is read once."""
    import resource

    from unimp_tpu_torch.cli import mmrec
    from unimp_tpu_torch.data import dataset as dataset_mod
    from unimp_tpu_torch.train import checkpoint as ckpt
    from unimp_tpu_torch.utils.flops import vision_forward_flops

    log(f"[headline] {host_memory_line(run_dir.parent)}")
    seen = {"run": None, "steps": {}, "writes": [], "decode_steps": 0}
    orig = {"cache": mmrec.build_tower_cache, "epoch": mmrec.train_one_epoch,
            "evals": mmrec.run_evals, "write": ckpt._write, "state": ckpt.save_train_state,
            "step": Trainer.train_step, "decode_step": Generator._decode_step,
            "image": dataset_mod.load_resized_uint8}
    memo, stop_after = ITEM_IMAGES, {}  # phase 13 reuses the decode

    def image(path, size):
        if (path, size) not in memo:
            memo[path, size] = orig["image"](path, size)
        return memo[path, size]

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
     ckpt.save_train_state, Trainer.train_step, Generator._decode_step,
     dataset_mod.load_resized_uint8) = (cache, epoch, evals, write, save_state, step,
                                        decode_step, image)
    wall = {}
    try:
        kernel_lib.reset_launches()          # the main path starts here
        for run, (extra, n_updates) in runs.items():
            seen["run"], stop_after[run] = run, n_updates
            t0 = time.perf_counter()
            try:
                mmrec.main(base + extra)
                raise AssertionError(f"[headline] run {run} ended before {n_updates} updates")
            except StopRun:
                pass
            gc.collect()
            torch.cuda.empty_cache()
            wall[run] = time.perf_counter() - t0
            if run == "resume":  # (b) read checkpoint_0: it is not needed any more
                shutil.rmtree(run_dir / "headline")
        launches = counts()                  # the main path ends here
    finally:
        (mmrec.build_tower_cache, mmrec.train_one_epoch, mmrec.run_evals, ckpt._write,
         ckpt.save_train_state, Trainer.train_step, Generator._decode_step,
         dataset_mod.load_resized_uint8) = (orig["cache"], orig["epoch"], orig["evals"],
                                            orig["write"], orig["state"], orig["step"],
                                            orig["decode_step"], orig["image"])
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
        f"{sum(w[1] for w in writes):.2f} s, {sum(w[2] for w in writes) / 2**30:.2f} GiB on "
        f"{gpu_line}")
    peak = seen["peak_gib"]
    log(f"[headline] peak device memory over the training updates: all four levers "
        f"{peak['main']:.2f} GiB (resumed {peak['resume']:.2f}), without --remat "
        f"{peak['no_remat']:.2f}, --frozen_bf16 with neither int8 nor bf16 state "
        f"{peak['bf16_frozen']:.2f}; host peak RSS {rss_gib:.2f} GiB (the whole script so far; "
        f"{seen['rss_before_copy']:.2f} before the resume check's host copies) "
        f"on {gpu_line}")
    return launches


MULTI_RECORDS = 36     # train users: 3 updates of global batch 12; test users: 2 x 18
MULTI_UPDATES = MULTI_RECORDS // 12
SHARDED_UPDATES = 2    # fsdp 2 / tp 2 runs, when gloo takes their collectives
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
ITEM_IMAGES = {}       # (path, size) -> decoded item image, filled by phase 12


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
    orig = {"step": Trainer.train_step, "state": ckpt.save_train_state,
            "params": ckpt.save_params, "evals": mmrec.run_evals,
            "epoch": mmrec.train_one_epoch}
    seen = {}

    def step(self, batch):
        before, t0 = counts(), time.perf_counter()
        metrics = orig["step"](self, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"ms": ms, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "skipped": int(metrics["skipped_nonfinite"]), "launches": between(before),
               "rows": list(np.shape(batch["input_ids"]))}
        if world > 1:
            # the replicas' whole tensors after the update: one digest each,
            # gathered from every rank and compared
            layout = self.model.tp_layout
            names = [f"param {n}" for n in self.params if n.replace(".", "/") not in layout]
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

    orig_trainer_init = Trainer.__init__

    def trainer_init(self, *args, **kw):
        orig_trainer_init(self, *args, **kw)
        seen["trainer_ref"] = self

    (Trainer.train_step, ckpt.save_train_state, ckpt.save_params, mmrec.run_evals,
     mmrec.train_one_epoch, Generator._decode_step, Trainer.__init__) = (
        step, save_state, save_params, evals, epoch, decode_step, trainer_init)
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
        out["k_fwd"] = flash_per_micro_batch(trainer.model.cfg)
    Path(spec["out"], f"{spec['tag']}_rank{rank}.json").write_text(json.dumps(out))
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


def flash_per_micro_batch(cfg) -> dict:
    """(forward blocks, checkpointed blocks) of one micro-batch: K1 / K2 /
    K3 run once a block, K1 again for each recomputed block."""
    lm = cfg.lm
    n_xattn = -(-lm.num_layers // cfg.cross_attn_every_n)
    return {"fwd": cfg.resampler.depth + n_xattn + lm.num_layers,
            "recompute": n_xattn + lm.num_layers, "n_xattn": n_xattn,
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


def phase_multi_gpu(gpu_line, data, run_dir) -> dict:
    """Multi-GPU through the port's CLI (phase 13): ``mmrec.main`` under
    ``torch.distributed.run``, each rank a process, on phase 12's
    configuration (3b-mpt, ``--frozen_int8 --bf16_opt_state --remat
    --remat_policy dots --cache_vision_latents``, T 256, 6 images, a
    10-beam test pass) with the train split cut to 36 users:

      (a) one rank over NCCL (no one-rank shortcut: every collective of the
          distributed path runs), micro-batch 6 x accum 2 fused: 3 updates
          of the global batch 12, the test pass over 36 users,
          ``weights_epoch_0`` and ``checkpoint_0``, then stopped;
      (b) two ranks sharing the card over gloo (dp 2), micro-batch 3 x
          accum 2 fused from the same seed: the same global batches;
      (c) (b)'s ``checkpoint_0`` resumed in one rank (NCCL).

    NCCL refuses two ranks on one device, so (b) runs gloo, which moves
    CUDA tensors through the host. Every rank draws each sample's prompt
    window from a generator keyed by the sample's index (``rank_main``),
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
    fsdp 2 and tp 2 run 2 updates each under the same gates (tp 2's losses
    within ``TP_LOSS_REL``), both at once (their update times share the
    card and the host), tp 2 without the vision cache; otherwise the
    refused collective is printed."""
    run_dir.mkdir(parents=True, exist_ok=True)
    log(f"[multi-gpu] {host_memory_line(run_dir)}")
    memo_path = run_dir / "item_images.pt"
    torch.save(dict(ITEM_IMAGES), memo_path)
    base = ["--mmrec_path", str(data), "--pretrained_model_name_or_path", "3b-mpt",
            "--subset", "beauty", "--task", "rec", "--single_task", "--n_items",
            str(N_ITEM_TOKENS), "--history_len", "6", "--use_semantic", "--patch-image-size",
            "224", "--max_records", str(MULTI_RECORDS), "--eval_batch_size", "18",
            "--num_beams", "10", "--workers", "2", "--device", "cuda",
            "--gradient_accumulation_steps", "2", "--fused_accumulation", "--use_reweight",
            "--gamma", "2", "--cache_vision_latents", "--logging_steps", "1",
            "--num_epochs", "1", *HEADLINE_LEVERS]
    common = {"image_memo": str(memo_path)}
    walls, reports = {}, {}

    def start(tag, nproc, argv, **spec):
        return torchrun_start(tag, nproc, {**common, **spec, "argv": argv}, run_dir)

    def finish(run, timeout):
        reps = torchrun_finish(run, timeout)
        walls[run["tag"]] = time.perf_counter() - run["t0"]
        reports[run["tag"]] = reps
        return reps

    def run(tag, nproc, argv, timeout, **spec):
        return finish(start(tag, nproc, base + argv, **spec), timeout)

    a_dir, b_dir = run_dir / "a", run_dir / "b"
    (a,) = run("a", 1, ["--external_save_dir", str(a_dir), "--run_name", "a",
                        "--batch_size", "6", "--do_test"], 600, backend="nccl")
    losses_a = check_updates("a", a, MULTI_UPDATES, 12)
    want_a = {"losses": losses_a, "norms": [u["grad_norm"] for u in a["updates"]]}
    rec_a = check_test_pass("a", a, MULTI_RECORDS)
    if not Path(a["checkpoint"]["path"], "train_state.pt").exists():
        raise AssertionError("[multi-gpu] (a) wrote no checkpoint_0")
    shutil.rmtree(a_dir)
    digests = run_dir / "b_digests.json"
    b = run("b", 2, ["--external_save_dir", str(b_dir), "--run_name", "b", "--batch_size", "3",
                     "--do_test"], 900, backend="gloo", digests_out=str(digests))
    losses_b = [check_updates("b", rep, MULTI_UPDATES, 6, want_a) for rep in b]
    if losses_b[0] != losses_b[1]:
        raise AssertionError(f"[multi-gpu] (b) the ranks' losses differ: {losses_b}")
    rec_b = [check_test_pass("b", rep, MULTI_RECORDS) for rep in b]
    if not Path(b[0]["checkpoint"]["path"], "train_state.pt").exists():
        raise AssertionError("[multi-gpu] (b) rank 0 wrote no checkpoint_0")
    # (c) trains nothing: no vision cache
    uncached = [a for a in base if a != "--cache_vision_latents"]
    (c,) = finish(start("c", 1, uncached + ["--external_save_dir", str(b_dir), "--run_name",
                                            "b", "--batch_size", "6",
                                            "--resume_from_checkpoint"],
                        backend="nccl", resume_check=str(digests)), 600)
    if not c.get("resume") or c["resume"]["n_differ"]:
        raise AssertionError(f"[multi-gpu] (c) resume: {c.get('resume')}")
    shutil.rmtree(b_dir)
    probe = b[0]["probe"]
    sharded = {}
    if all(probe[name] == "ok" for name in probe):
        # both at once on the card (4 ranks): tp 2 on the pixel path, since
        # a vision cache of every item through a tp-sharded tower would
        # all-reduce each ViT layer's activations through the host
        runs = {tag: start(tag, 2, (base if tag == "fsdp2" else uncached) + [
                    "--external_save_dir", str(run_dir / tag), "--run_name", tag,
                    "--batch_size", "3" if tag == "fsdp2" else "6", *flags],
                    backend="gloo", stop_after_updates=SHARDED_UPDATES)
                for tag, flags in (("fsdp2", ["--mesh_fsdp", "2"]), ("tp2", ["--mesh_tp", "2"]))}
        for tag, handle in runs.items():
            reps = finish(handle, 600)
            sharded[tag] = [check_updates(tag, rep, SHARDED_UPDATES, 6 if tag == "fsdp2" else 12,
                                          want_a, pixels=tag == "tp2",
                                          loss_rel=TP_LOSS_REL if tag == "tp2" else
                                          MULTI_LOSS_REL)
                            for rep in reps]
            shutil.rmtree(run_dir / tag, ignore_errors=True)
    else:
        refused = {k: v for k, v in probe.items() if v != "ok"}
        log(f"[multi-gpu] fsdp 2 and tp 2 not run on the card: gloo refused {refused} on "
            f"CUDA tensors (torch {torch.__version__}); tests/test_torch_parallel.py holds "
            f"them to the JAX package on the CPU")

    # --- report
    log(f"[multi-gpu] runs (s) { {k: round(v, 1) for k, v in walls.items()} } on {gpu_line}; "
        f"NCCL above one rank not measured (one card: NCCL refuses two ranks on one device)")
    log(f"[multi-gpu] gloo on CUDA tensors: {json.dumps(probe)}")
    for tag, reps in reports.items():
        for rep in reps:
            ups = rep["updates"]
            log(f"[multi-gpu] ({tag}) rank {rep['rank']} {rep['device']}: update ms "
                f"{[round(u['ms'], 1) for u in ups]}, losses {[round(u['loss'], 6) for u in ups]}"
                f", grad norms {[round(u['grad_norm'], 4) for u in ups]}, replicas equal "
                f"{[u.get('replicas_equal') for u in ups]} ({ups[0].get('compared') if ups else 0}"
                f" tensors), peak {rep.get('peak_gib', 0):.2f} GiB, wall {rep['wall_s']:.1f} s"
                f", checkpoint {rep.get('checkpoint', {}).get('s', 0):.2f} s on {gpu_line}")
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
    launches = {}
    for reps in reports.values():
        for rep in reps:
            for name, n in rep["launches"].items():
                launches[name] = launches.get(name, 0) + n
    return launches


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


def gc_report(label: str, run) -> None:
    """One more run of ``run`` (after the launch counts are read), timed
    with the seconds the garbage collector spent inside it, by generation,
    and the number of objects it tracks: the host's share that the
    collector takes on this path."""
    spent, count, start = [0.0] * 3, [0] * 3, {}

    def on_gc(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        else:
            spent[info["generation"]] += time.perf_counter() - start["t"]
            count[info["generation"]] += 1

    torch.cuda.synchronize()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    log(f"[gc] {label}: wall {wall:.3f} s; collector {sum(spent):.3f} s (by generation "
        f"{[round(x, 3) for x in spent]} s over {count} passes); "
        f"{len(gc.get_objects())} objects tracked")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = kernel_lib.build_all()
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

    t0 = time.perf_counter()
    results, timings = phase_kernels(dev)
    log(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_small(dev)
    phase_small(dev, int8=True)
    phase_small_bf16(dev)
    phase_small_train(dev)
    phase_small_train_flags(dev)
    phase_small_tasks(dev)
    log(f"[small] done in {time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    int8_launches = phase_4b(dev, gpu_line, int8=True, timings=timings)
    log(f"[4b-int8] done in {time.perf_counter() - t0:.1f} s")
    gc.collect()  # the int8 model is gone: give its memory back
    torch.cuda.empty_cache()
    runs = Path(__file__).resolve().parent / "runs"
    runs.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=runs) as tmp:
        data = Path(tmp) / "data"
        write_s = write_cli_data(data)
        t0 = time.perf_counter()
        cli_launches = phase_cli(dev, gpu_line, data, Path(tmp) / "runs", write_s)
        log(f"[cli] done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # the CLI's eval model is gone: give its memory back
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train_cli_launches = phase_train_cli(dev, gpu_line, data, Path(tmp) / "train")
        log(f"[train-cli] done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # the training CLI's models are gone: give their memory back
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        task_launches = phase_tasks(dev, gpu_line, data, Path(tmp) / "tasks")
        log(f"[tasks] phase 10 done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # phase 10's models are gone: give their memory back
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        serve_launches = phase_serve(dev, gpu_line, data)
        log(f"[serve] phase 11 done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # the workers are gone: give their memory back
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        headline_launches = phase_headline_train(gpu_line, data, Path(tmp) / "headline")
        log(f"[headline] phase 12 done in {time.perf_counter() - t0:.1f} s")
        gc.collect()  # phase 12's models are gone: the ranks get the card
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        multi_launches = phase_multi_gpu(gpu_line, data, Path(tmp) / "multi")
        ITEM_IMAGES.clear()
        log(f"[multi-gpu] phase 13 done in {time.perf_counter() - t0:.1f} s")

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
            ("multi_gpu", multi_launches, TASK_KERNELS + ("quant_matmul",)))
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
