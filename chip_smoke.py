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
     and ragged prompt windows, K5 with one tile of five allowed, K6 at one row, off its
     tiles, at 256 / 300 / 512 rows, split-K over a ragged K, aligned
     and not, and with strided weight rows), in bfloat16 and float32, with the tolerances
     below; times each kernel (CUDA events)
     beside its plain version, its bound and a one-call yardstick
     (``scaled_dot_product_attention`` forward, or its backward through
     autograd; ``torch._weight_int8pack_mm`` and the bf16 matmul for K6;
     the port never calls them);
  4. the ``small`` variant in float32, once on the card (kernels) and once
     on the CPU (plain versions): the beam eval (token agreement, prefill
     logit difference), with float weights and again with int8 weights and
     int8 KV caches; in bfloat16 on the card, the beam eval through K4 / K5
     against the same eval with the plain decode attention (token
     agreement); then one ``Trainer`` step (loss, every trainable
     gradient, skipped flag);
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
     reload evals' items/s; deletes its run directory.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
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
from unimp_tpu_torch.ops.quant_matmul import quant_matmul_cuda, quant_matmul_ref
from unimp_tpu_torch.tools.from_flax import build_model
from unimp_tpu_torch.train.optimizer import make_optimizer
from unimp_tpu_torch.train.partition import trainable_params
from unimp_tpu_torch.train.trainer import Trainer
from unimp_tpu_torch.utils.flops import decode_flops, detect_peak_flops, train_step_flops
from unimp_tpu_torch.utils.quant import (
    QuantizedKernel,
    _quantize_leaf,
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
    """Inputs of the one-call yardstick (no ALiBi, no GQA at the main-path
    shapes), prepared outside its timing: [B, H, S, D] and a bool mask."""
    allowed = allowed_pairs(q, k, kw)
    mask = None if allowed is None else allowed[:, None].contiguous()
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    return t(q), t(k), t(v), mask


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
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))


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
        if mode == "immediate":
            kv_media = torch.arange(1, s // 64 + 1, device=dev,
                                    dtype=torch.int32).repeat_interleave(64)
            mask = media_allowed(kv_media[None].expand(b, -1),
                                 torch.full((b,), s // 64, device=dev), "immediate").contiguous()
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
    rows), the prefill head (M = 24), odd shapes, and the edges of the
    bf16 tiling: a full 256-row block, two blocks (300), ``quant_dot``'s
    largest (512), a split-K shape whose K is neither a multiple of its
    split count nor of 64, the same unaligned (N % 16 != 0: the masked
    loads, the scalar epilogue and reduction), and the down shape's weight
    as a column slice of a wider one (strided rows). ldq None: q is
    contiguous."""
    cases = [(f"4b_decode_m240_{name}", True, 240, k, n, None)
             for name, ((k, n), _) in K6_DECODE.items()]
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
                    bound_ms=b_ms, bound_by=b_by))

        phase_bwd_kernels(dev, dtype, results, timings)

        phase_decode_kernels(dev, dtype, results, timings)
        phase_int8_kernels(dev, dtype, results, timings)
    for row in timings:
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        extra = "".join(f" {key}={row[key]:.4f}" for key in
                        ("bf16_matmul_ms", "host_ms", "bf16_matmul_host_ms") if key in row)
        if row["library_ms"] is not None:
            extra += f" kernel/library={row['ms'] / row['library_ms']:.2f}"
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

    def counts():
        torch.cuda.synchronize()
        return dict(kernel_lib.LAUNCHES)

    def between(before):
        after = counts()
        return {k: after[k] - before[k] for k in after}

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
            ("train_cli", train_cli_launches, tuple(KERNELS)))
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
    sys.exit(main())
