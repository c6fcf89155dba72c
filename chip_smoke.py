#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``unimp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card check: needs CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port from ``csrc/`` (one
     nvcc per source, all at once) and prints the build seconds;
  3. kernels vs plain: the flash-attention forward (K1), split-cache beam
     decode (K4) and single-query media read (K5) against their plain
     PyTorch versions at the 4b main-path shapes and at extra shapes
     (head dim 128 + ALiBi, causal + kv_start windows, all_previous, fully
     masked rows, GQA, decode steps 1 / 17 / 50 with random beam_sel), in
     bfloat16 and float32, with the tolerances below; times each kernel
     (CUDA events) beside its plain version, its bound and the
     ``scaled_dot_product_attention`` yardstick (which the port never calls);
  4. the ``small`` variant's beam eval in float32, once on the card
     (kernels) and once on the CPU (plain versions): token agreement and
     prefill logit difference;
  5. the ``4b-instruct`` 10-beam rec eval at full width (random seeded
     weights, gates opened): a 256-item catalogue encoded once by the item
     latent cache, two batches of 24 prompts (T=128, 4 images each), beam
     search with 10 beams / 10 returned / 50 new tokens, HR/NDCG/MRR@{3,5,10};
     prints items/s, peak memory and each kernel's launch count.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.evals.latent_cache import ItemLatentCache
from unimp_tpu_torch.evals.metrics import rank_metrics_for_hits
from unimp_tpu_torch.models import compute_q_media, get_config
from unimp_tpu_torch.models.flamingo import media_allowed
from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.ops.attention_ref import AttnMask, alibi_slopes, attention_ref, window_mask
from unimp_tpu_torch.ops.decode_attention import decode_attention_ref, single_query_attention_ref
from unimp_tpu_torch.ops.decode_attention_kernels import (
    decode_attention_cuda,
    single_query_attention_cuda,
)
from unimp_tpu_torch.ops.flash_attention import flash_attention_cuda
from unimp_tpu_torch.tools.from_flax import build_model

# H100 SXM published peaks (dense): memory 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain: float32 differs only by summation order; bfloat16 also
# by where p and the output round to 8 mantissa bits
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3

MEDIA_ID = 50431          # <image>
ITEM_BASE = 50432         # item_i tokens follow the base vocabulary
N_ITEM_TOKENS = 4167      # beauty's item count
EOS_ID = 0
SMALL_MEDIA_ID = 30000    # small variant (vocab 32768): items follow it

KERNELS = {
    "flash_fwd": ("unimp_tpu_torch/csrc/flash_fwd.cu",
                  "unimp_tpu/ops/flash_attention.py:108"),
    "decode_attn": ("unimp_tpu_torch/csrc/decode_attn.cu",
                    "unimp_tpu/ops/decode_attention_pallas.py:119"),
    "single_query_attn": ("unimp_tpu_torch/csrc/decode_attn.cu",
                          "unimp_tpu/ops/decode_attention_pallas.py:415"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------ phase 3: K1

def flash_cases(dev):
    """(name, main_path, q, k, v, kwargs) at the 4b shapes and extras."""
    g = torch.Generator(dev).manual_seed(0)

    def qkv(b, sq, skv, h, hkv, d):
        return [torch.randn(s, generator=g, device=dev) for s in
                ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]

    def media(b, sq, n_media, lat, first):
        pos = torch.zeros(b, sq, dtype=torch.int32, device=dev)
        for i in range(n_media):
            pos[:, first + i * 24] = 1
        qm = torch.cumsum(pos, 1, dtype=torch.int32)
        km = torch.arange(1, n_media + 1, device=dev, dtype=torch.int32).repeat_interleave(lat)
        return qm, km[None].expand(b, -1).contiguous()

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

        # K4: 4b decode (B24 K10 H32 d80 T128 G50) at three fills, + extras
        specs = [("4b_b24_k10_d80", True, (24, 10, 128, 50, 32, 32, 80), False, None),
                 ("mpt_alibi_d128", False, (4, 10, 128, 50, 16, 16, 128), True, None),
                 ("gqa_prompt_len_d64", False, (3, 4, 64, 50, 16, 4, 64), False, "plen"),
                 ("greedy_d80", False, (4, 1, 128, 50, 32, 32, 80), False, None)]
        for name, main, shape, use_alibi, extra in specs:
            c = decode_case(dev, *shape, seed=len(name))
            c = {n: (x.to(dtype) if x.is_floating_point() else x) for n, x in c.items()}
            b, kb, t, g, h = shape[:5]
            kw = dict(kv_start=c["kv_start"], beam_sel=c["sel"] if kb > 1 else None,
                      alibi=alibi_slopes(h).to(dev) if use_alibi else None,
                      prompt_len=torch.full((b,), t - 9, device=dev) if extra else None)
            args = (c["q"], c["pk"], c["pv"], c["gk"], c["gv"])
            for step in (1, 17, 50):
                got = decode_attention_cuda(*args, step=step, **kw)
                want = decode_attention_ref(*args, step=step, **kw)
                check(f"{name}_step{step}", got, want, dtype, results, "decode_attn", main)
            if dtype == torch.bfloat16 and main:
                step = 50
                hkv, d = shape[5], shape[6]
                lo = c["kv_start"]
                prompt_rows = int((t - lo).sum())
                rows = (torch.arange(b * kb, device=dev) // kb * kb)[:, None] + c["sel"][:, :step]
                gen_rows = int(torch.unique(rows * g + torch.arange(step, device=dev)).numel())
                elt = c["q"].element_size()
                # each valid prompt row once (shared by the beams), each
                # referenced ancestor gen row once
                by = nbytes(c["q"], got, c["kv_start"]) + c["sel"][:, :step].numel() * 4 \
                    + 2 * (prompt_rows + gen_rows) * hkv * d * elt
                fl = 4.0 * d * h * kb * (prompt_rows + b * step)
                b_ms, b_by = bound(by, fl, dtype)
                timings.append(dict(
                    kernel="decode_attn", case=f"{name}_step{step}",
                    ms=cuda_ms(lambda: decode_attention_cuda(*args, step=step, **kw)),
                    plain_ms=cuda_ms(lambda: decode_attention_ref(*args, step=step, **kw), iters=5),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by))

        # K5: 4b x-attn decode (S = 4 media x 64 latents, "immediate")
        specs = [("4b_b24_k10_s256_d80", True, (24, 10, 256, 32, 32, 80)),
                 ("gqa_masked_rows_d128", False, (4, 3, 96, 16, 4, 128)),
                 ("d64", False, (4, 10, 320, 16, 16, 64))]
        for name, main, (b, kb, s, h, hkv, d) in specs:
            c = decode_case(dev, b, kb, s, 1, h, hkv, d, seed=len(name))
            q, k, v = (c[n].to(dtype) for n in ("q", "pk", "pv"))
            if main:
                kv_media = torch.arange(1, 5, device=dev, dtype=torch.int32).repeat_interleave(64)
                mask = media_allowed(kv_media[None].expand(b, -1),
                                     torch.full((b,), 4, device=dev), "immediate")
            else:
                mask = torch.rand(b, s, device=dev) < 0.6
                mask[0] = False  # a row with no media: gives 0
            got = single_query_attention_cuda(q, k, v, mask)
            want = single_query_attention_ref(q, k, v, mask)
            check(name, got, want, dtype, results, "single_query_attn", main)
            if dtype == torch.bfloat16 and main:
                n_ok = int(mask.sum())
                by = nbytes(q, got, mask) + 2 * n_ok * hkv * d * q.element_size()
                fl = 4.0 * d * h * kb * n_ok
                b_ms, b_by = bound(by, fl, dtype)
                qs = q.reshape(b, kb, h, d).transpose(1, 2).contiguous()
                am = mask[:, None, None, :]
                timings.append(dict(
                    kernel="single_query_attn", case=name,
                    ms=cuda_ms(lambda: single_query_attention_cuda(q, k, v, mask)),
                    plain_ms=cuda_ms(lambda: single_query_attention_ref(q, k, v, mask), iters=5),
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        qs, k, v, attn_mask=am)),
                    bound_ms=b_ms, bound_by=b_by))
    for row in timings:
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(f"[time] {row['kernel']:17s} {row['case']:36s} kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={lib} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']})")
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


def phase_small(dev):
    """small variant, f32, gates open: the same beam eval on the card
    (kernels) and on the CPU (plain versions)."""
    cfg = get_config("small", dtype="float32")
    cpu_model = build_model(cfg, device="cpu", seed=1)
    open_gates(cpu_model)
    card_model = build_model(cfg, device="cpu", seed=1).to(dev)
    open_gates(card_model)
    rng = np.random.default_rng(1)
    img = cfg.vision.image_size
    images = rng.integers(0, 256, size=(16, img, img, 3), dtype=np.uint8)
    gen_cfg = GenerationConfig(max_new_tokens=20, eos_id=EOS_ID, pad_id=EOS_ID,
                               num_beams=10, num_return_sequences=10)
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
    log(f"[small] card vs cpu: token agreement={agree:.4f} "
        f"prefill max_abs_logit_diff={diff:.3e} (limits: agreement >= 0.9, diff <= 2e-3)")
    if not (agree >= 0.9 and diff <= 2e-3):
        raise AssertionError("small-variant path on the card disagrees with the CPU path")


# ------------------------------------------------------------ phase 5

def phase_4b(dev, gpu_line):
    cfg = get_config("4b-instruct")
    vocab = -(-(ITEM_BASE + N_ITEM_TOKENS) // 128) * 128
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0, inference_dtype=torch.bfloat16)
    open_gates(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[4b] {n_params / 1e9:.3f} B params, vocab {vocab}, init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    n_items, b, t = 256, 24, 128
    catalogue = rng.integers(0, 256, size=(n_items, 224, 224, 3), dtype=np.uint8)
    batches = [prompts(rng, b, t, 4, n_items, 100) for _ in range(2)]
    gen = Generator(model, GenerationConfig(max_new_tokens=50, eos_id=EOS_ID, pad_id=EOS_ID,
                                            num_beams=10, num_return_sequences=10),
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
    log(f"[4b] catalogue encode {encode_s:.2f} s; batch seconds {batch_s}")
    log(f"[4b] items/s={ips:.3f} (second batch, host clock) peak_mem={peak_gib:.2f} GiB "
        f"on {gpu_line}")
    log(f"[4b] metrics {json.dumps(metrics)}")
    log(f"[4b] launches {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    ids, seq_len, image_ids, _ = batches[1]
    profile_batch(lambda: gen.generate(torch.from_numpy(ids).to(dev),
                                       torch.from_numpy(seq_len).to(dev),
                                       cache.gather(image_ids)), batch_s[1])
    return launches


def profile_batch(run, unprofiled_s: float) -> None:
    """Where one more 4b batch spends its time (torch.profiler, after the
    launch counts are read): device busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        kernels.append((dev_us / 1e3, ev.count, ev.key))
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] 4b batch: wall {wall_ms:.1f} ms under the profiler, "
        f"{unprofiled_s * 1e3:.1f} ms without; device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / (unprofiled_s * 1e3):.1f}% of the unprofiled wall; "
        f"{sum(k[1] for k in kernels)} kernels")
    groups = {"port attention kernels": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for ms, _, name in kernels:
        if any(k in name for k in ("flash_fwd_kernel", "decode_attn_kernel",
                                   "single_query_kernel")):
            groups["port attention kernels"] += ms
        elif any(k in name.lower() for k in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
            groups["matmul (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    log("[profile] device ms by group: " + ", ".join(f"{k} {v:.1f}" for k, v in groups.items()))
    for ms, count, name in sorted(kernels, reverse=True)[:10]:
        log(f"[profile] {ms:9.2f} ms {count:7d}x {name[:100]}")


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
            for line in info.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[ptxas] {name}: {line.strip()}")

    t0 = time.perf_counter()
    results, timings = phase_kernels(dev)
    log(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_small(dev)
    log(f"[small] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = phase_4b(dev, gpu_line)
    log(f"[4b] done in {time.perf_counter() - t0:.1f} s")

    # one headline shape per kernel: LM prefill, decode at step 50, x-attn read
    headline = {"flash_fwd": "lm_prefill_128_d80_causal_window",
                "decode_attn": "4b_b24_k10_d80_step50",
                "single_query_attn": "4b_b24_k10_s256_d80"}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        tm = next(r for r in timings if r["kernel"] == name and r["case"] == headline[name])
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
                     "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                     "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
                     "shape": headline[name]})
    print(gpu_line, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
