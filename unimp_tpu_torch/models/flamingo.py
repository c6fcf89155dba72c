"""UniMP model: CLIP-ViT -> perceiver resampler -> gated-xattn decoder.

Counterpart of ``unimp_tpu/models/flamingo.py``. Every Nth decoder block
is preceded by a tanh-gated cross-attention block over the resampled
media latents (gates initialise to 0, so cross-attention is invisible
until trained or opened).

``forward`` modes:
  * full forward:                 logits, None
  * prefill (return_kv=True):     logits, {"self": [...], "xattn": [...]}
  * decode (decode_state=...):    logits, [gen caches, updated in place]
  * hidden (return_hidden=True):  final-norm hidden states, None

Media masking: each text token cross-attends only to the latents of the
most recent preceding <image> ("immediate") or of all preceding media
("all_previous"); ``compute_q_media`` gives each token's media index.

Activation checkpointing (``cfg.remat``, ``--remat``): the full forward
with gradients on runs each decoder block and each x-attn block under
``torch.utils.checkpoint`` (non-reentrant), as the JAX model wraps them in
``nn.remat`` (``unimp_tpu/models/flamingo.py:277-313``). With
``remat_policy="dots"`` the outputs of matmuls with no batch dims
(``aten.mm`` / ``aten.addmm``) are saved and the rest is recomputed:
JAX's ``dots_with_no_batch_dims_saveable``. The attention kernels sit in
their own autograd function, so the backward recomputes their forward (K1
launches again) as it does the Pallas call in JAX.

Spans (``utils/profiling.py``): ``model.embed``, ``model.block`` (each
decoder block), ``model.xattn`` (each gated cross-attention block),
``model.logits`` (final norm and head), ``vision.tower`` and
``vision.perceiver``. Under remat the block spans sit inside the
checkpointed function, so the backward's recomputation records them again.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint
from torch import nn

from unimp_tpu_torch.models.config import UniMPConfig
from unimp_tpu_torch.models.layers import (Attention, DenseWeights, LayerNorm, Mlp,
                                           decode_step_tensors, make_norm)
from unimp_tpu_torch.models.lm import DecoderBlock, init_gen_cache
from unimp_tpu_torch.models.perceiver import PerceiverResampler
from unimp_tpu_torch.models.vit import VisionTower
from unimp_tpu_torch.ops import AttnMask
from unimp_tpu_torch.parallel.sharding import copy_to_tp, gather_from_tp, reduce_from_tp
from unimp_tpu_torch.utils import profiling


def compute_q_media(input_ids: torch.Tensor, media_token_id: int) -> torch.Tensor:
    """Per-token index of the most recent media at/preceding each position
    (the <image> token itself belongs to its media)."""
    return torch.cumsum((input_ids == media_token_id).to(torch.int32), dim=1,
                        dtype=torch.int32)


def media_allowed(kv_media, n_media, mode: str):
    """[B, S] decode-time latent mask: generated tokens attend the last
    media ("immediate") or all media ("all_previous")."""
    if mode == "immediate":
        return kv_media == n_media[:, None]
    if mode == "all_previous":
        return (kv_media <= n_media[:, None]) & (kv_media > 0)
    raise ValueError(mode)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective checkpointing policy: keep 2-D matmul outputs (no batch
    dims), recompute everything else."""
    if op in _SAVED_DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str = "none"):
    """``fn`` run under non-reentrant activation checkpointing, saving what
    ``policy`` ("none" or "dots") says."""
    if policy not in ("none", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_saveable)

    def run(*args, **kwargs):
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)

    return run


class Embed(nn.Module):
    """Flax ``nn.Embed``: param ``embedding`` [V, D]."""

    def __init__(self, vocab: int, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(vocab, dim))
        # vocabulary-parallel under tp: this rank's rows start here
        self.tp_group, self.vocab_start = None, 0

    def forward(self, ids):
        # F.embedding, not advanced indexing: its CPU backward sums each
        # row's gradient in one thread, in order (indexing's accumulating
        # index_put differs run to run with several threads), so a resumed
        # run can equal a straight one bit for bit
        if self.tp_group is None:
            return F.embedding(ids, self.embedding).to(self.dtype)
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.embedding.shape[0])
        x = F.embedding(torch.where(outside, 0, local), self.embedding)
        x = reduce_from_tp(torch.where(outside[..., None], 0.0, x), self.tp_group)
        return x.to(self.dtype)


class GatedCrossAttnBlock(nn.Module):
    """tanh-gated cross-attention + gated FF (Flamingo). Its LayerNorms use
    Flax's default epsilon, 1e-6."""

    def __init__(self, d: int, media_dim: int, num_heads: int, head_dim: int,
                 ff_mult: int = 4, media_mode: str = "immediate",
                 dtype=torch.bfloat16):
        super().__init__()
        self.media_mode, self.dtype = media_mode, dtype
        self.attn_gate = nn.Parameter(torch.zeros(()))
        self.ff_gate = nn.Parameter(torch.zeros(()))
        self.ln_attn = LayerNorm(d, 1e-6, dtype)
        self.xattn = Attention(d, num_heads, head_dim, kv_in_dim=media_dim,
                               use_bias=False, dtype=dtype)
        self.ln_ff = LayerNorm(d, 1e-6, dtype)
        self.mlp = Mlp(d, ff_mult * d, act="gelu", use_bias=False, dtype=dtype)

    def forward(self, x, latents_flat=None, q_media=None, kv_media=None, *,
                return_cache: bool = False, xattn_cache: Optional[dict] = None,
                allowed=None):
        h = self.ln_attn(x)
        if xattn_cache is not None:
            attn_out, cache = self.xattn(h, xattn_cache=xattn_cache,
                                         xattn_allowed=allowed)
        else:
            mask = AttnMask(q_media=q_media, kv_media=kv_media,
                            media_mode=self.media_mode)
            attn_out, cache = self.xattn(h, latents_flat, mask=mask,
                                         return_cache=return_cache)
        x = x + torch.tanh(self.attn_gate.float()).to(self.dtype) * attn_out
        ff_out = self.mlp(self.ln_ff(x))
        return x + torch.tanh(self.ff_gate.float()).to(self.dtype) * ff_out, cache


class UniMPModel(nn.Module):
    def __init__(self, cfg: UniMPConfig):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, cfg.compute_dtype
        dt = cfg.compute_dtype
        lm = cfg.lm
        dv = cfg.vision.hidden_size
        self.vision = VisionTower(cfg.vision, dt)
        self.resampler = PerceiverResampler(cfg.resampler, dv, dt)
        self.embed = Embed(lm.vocab_size, lm.hidden_size, dt)
        for i in range(lm.num_layers):
            if i % cfg.cross_attn_every_n == 0:
                self.add_module(f"xattn_{i}", GatedCrossAttnBlock(
                    lm.hidden_size, dv, lm.num_heads, lm.head_dim,
                    media_mode=cfg.media_mode, dtype=dt))
            self.add_module(f"block_{i}", DecoderBlock(lm, dt))
        self.final_ln = make_norm(lm.norm, lm.hidden_size, lm.layernorm_eps, dt)
        if not lm.tie_embeddings:
            self.lm_head = DenseWeights(lm.hidden_size, lm.vocab_size, use_bias=False)
        # tensor parallelism (``parallel/sharding.py:shard_model_tp``): the
        # tp layout of the tensors ({flat path: dimension}) and the group that
        # gathers the logits
        self.tp_layout, self.logits_tp_group = {}, None
        self.tp_group, self.tp_rank, self.tp_size = None, 0, 1
        # ZeRO-3 over fsdp (``parallel/sharding.py:ZeroShards``)
        self.zero = None

    def _layers(self):
        for i in range(self.cfg.lm.num_layers):
            yield getattr(self, f"block_{i}"), getattr(self, f"xattn_{i}", None)

    def encode_vision(self, vision_x: torch.Tensor) -> torch.Tensor:
        """[B, M, H, W, 3] CLIP-normalized -> latents [B, M, L, Dv]."""
        return self.resample_tower(self.encode_vision_tower(vision_x))

    def encode_vision_tower(self, vision_x: torch.Tensor) -> torch.Tensor:
        """The frozen half of ``encode_vision``: [B, M, H, W, 3] -> ViT
        patch features [B, M, P, Dv], before the trainable perceiver. With
        the tower frozen these are constants of training
        (``train/vision_cache.py`` encodes each item once)."""
        b, m = vision_x.shape[:2]
        with profiling.span("vision.tower"):
            feats = self.vision(vision_x.reshape((b * m,) + vision_x.shape[2:]))
        return feats.reshape(b, m, feats.shape[1], feats.shape[2])

    def resample_tower(self, tower_feats: torch.Tensor) -> torch.Tensor:
        """The trainable half: tower features [B, M, P, Dv] -> media latents
        [B, M, L, Dv]."""
        b, m = tower_feats.shape[:2]
        with profiling.span("vision.perceiver"):
            lat = self.resampler(tower_feats.reshape((b * m,) + tower_feats.shape[2:]))
        return lat.reshape(b, m, lat.shape[1], lat.shape[2])

    def _logits(self, x):
        with profiling.span("model.logits"):
            x = self.final_ln(x)
            # under tp the head's matrix holds this rank's vocabulary block: the
            # block's logits are all-gathered
            group = self.logits_tp_group
            x = copy_to_tp(x, group)
            if self.cfg.lm.tie_embeddings:
                # f32 logits, as the JAX package's f32-accumulating dot
                return gather_from_tp((x @ self.embed.embedding.to(x.dtype).t()).float(),
                                      group)
            # untied head: logits in the compute dtype; an int8 head streams
            # through K6 at decode rows and at the prefill's last position
            # (called as a module, so that ZeRO-3 gathers its kernel)
            return gather_from_tp(self.lm_head(x), group)

    @staticmethod
    def kv_media_for(latents) -> torch.Tensor:
        b, m, l, _ = latents.shape
        ids = torch.arange(1, m + 1, dtype=torch.int32, device=latents.device)
        return ids.repeat_interleave(l)[None, :].expand(b, m * l)

    def forward(self, input_ids, *, latents=None, vision_x=None, tower_x=None, q_media=None,
                kv_len=None, kv_start=None, positions=None,
                return_kv: bool = False, last_logit_only: bool = False,
                return_hidden: bool = False, decode_state: Optional[dict] = None):
        """Full forward, prefill, or single-token decode (see module doc).
        ``return_hidden``: the final-norm hidden states and no lm head
        (contextual token embeddings: the BERTScore encoder,
        ``evals/bertscore.py``).

        decode_state: {"self": [...], "xattn": [...], "gen": [...], "step",
        "kv_start", "n_media", "kv_media", "gen_index"}.
        """
        cfg = self.cfg
        if decode_state is not None:
            with profiling.span("model.embed"):
                x = self.embed(input_ids)
            allowed = None
            if decode_state.get("kv_media") is not None:
                allowed = media_allowed(decode_state["kv_media"],
                                        decode_state["n_media"], cfg.media_mode)
            # the step on the device once for every layer
            step_tensors = decode_step_tensors(decode_state["step"], x.device)
            new_gen = []
            xi = 0
            for i, (block, xattn) in enumerate(self._layers()):
                if xattn is not None:
                    if allowed is not None:
                        with profiling.span("model.xattn"):
                            x, _ = xattn(x, xattn_cache=decode_state["xattn"][xi],
                                         allowed=allowed)
                    xi += 1
                layer_ds = {
                    "prompt": decode_state["self"][i],
                    "gen": decode_state["gen"][i],
                    "step": decode_state["step"],
                    "step_tensors": step_tensors,
                    "kv_start": decode_state.get("kv_start"),
                    "gen_index": decode_state.get("gen_index"),
                }
                with profiling.span("model.block"):
                    x, gc = block(x, positions=positions, decode_state=layer_ds)
                new_gen.append(gc)
            return self._logits(x), new_gen

        if latents is None and vision_x is not None:
            latents = self.encode_vision(vision_x)
        elif latents is None and tower_x is not None:
            # cached-vision training: the frozen tower's features arrive
            # precomputed; only the trainable perceiver runs
            latents = self.resample_tower(tower_x)
        latents_flat = kv_media = None
        if latents is not None:
            b, m, l, dv = latents.shape
            latents_flat = latents.reshape(b, m * l, dv)
            kv_media = self.kv_media_for(latents)
            if q_media is None:
                raise ValueError("q_media required when media is present")

        with profiling.span("model.embed"):
            x = self.embed(input_ids)
        causal = input_ids.shape[1] > 1
        self_caches, xattn_caches = [], []
        # the training forward only: a prefill keeps its caches and an
        # inference forward has no backward to recompute for
        use_remat = cfg.remat and not return_kv and torch.is_grad_enabled()

        def run_block(mdl, h):
            with profiling.span("model.block"):
                return mdl(h, kv_len=kv_len, kv_start=kv_start, positions=positions,
                           causal=causal)[0]

        def run_xattn(mdl, h):
            with profiling.span("model.xattn"):
                return mdl(h, latents_flat, q_media, kv_media)[0]

        if use_remat:
            run_block = remat(run_block, cfg.remat_policy)
            run_xattn = remat(run_xattn, cfg.remat_policy)
        for block, xattn in self._layers():
            if xattn is not None and latents_flat is not None:
                if return_kv:
                    with profiling.span("model.xattn"):
                        x, xc = xattn(x, latents_flat, q_media, kv_media, return_cache=True)
                    xattn_caches.append(xc)
                else:
                    x = run_xattn(xattn, x)
            if return_kv:
                with profiling.span("model.block"):
                    x, sc = block(x, kv_len=kv_len, kv_start=kv_start, positions=positions,
                                  causal=causal, return_cache=True)
            else:
                x, sc = run_block(block, x), None
            self_caches.append(sc)
        if return_hidden:
            return self.final_ln(x), None
        if last_logit_only:
            x = x[:, -1:]
        logits = self._logits(x)
        if return_kv:
            return logits, {"self": self_caches, "xattn": xattn_caches}
        return logits, None

    def init_gen_caches(self, batch: int, max_new: int, device=None,
                        quantized: bool = False):
        device = device or self.embed.embedding.device
        # this rank's KV heads (fewer under tp)
        lm = dataclasses.replace(self.cfg.lm, num_kv_heads=self.block_0.attn.num_kv_heads)
        return [init_gen_cache(batch, max_new, lm, self.cfg.compute_dtype,
                               device, quantized) for _ in range(self.cfg.lm.num_layers)]
