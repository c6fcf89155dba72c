"""Decoder blocks and the pure-text ``CausalLM`` (counterpart of
``unimp_tpu/models/lm.py``).

One parameterized block covers MPT (layernorm + ALiBi, sequential
residual, no biases), GPT-NeoX / RedPajama (layernorm + partial RoPE,
parallel attention + MLP residual, biases) and LLaMA-style (RMSNorm +
RoPE + SwiGLU).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unimp_tpu_torch.models.config import LMConfig
from unimp_tpu_torch.models.layers import Attention, Mlp, decode_step_tensors, make_norm
from unimp_tpu_torch.ops import AttnMask
from unimp_tpu_torch.utils import profiling


class DecoderBlock(nn.Module):
    def __init__(self, cfg: LMConfig, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.ln1 = make_norm(cfg.norm, d, cfg.layernorm_eps, dtype)
        self.attn = Attention(
            d, cfg.num_heads, cfg.head_dim, num_kv_heads=cfg.kv_heads,
            use_bias=cfg.use_bias, positions_mode=cfg.positions,
            rotary_pct=cfg.rotary_pct, rope_theta=cfg.rope_theta, dtype=dtype,
        )
        self.ln2 = make_norm(cfg.norm, d, cfg.layernorm_eps, dtype)
        self.mlp = Mlp(d, cfg.mlp_dim, act=cfg.act, use_bias=cfg.use_bias, dtype=dtype)

    def forward(self, x, *, kv_len=None, kv_start=None, positions=None,
                causal: bool = True, return_cache: bool = False,
                decode_state: Optional[dict] = None):
        """Returns (x, cache): prompt KV when return_cache, the updated gen
        cache in decode mode, else None."""
        kwargs = dict(
            mask=AttnMask(causal=causal and decode_state is None),
            kv_len=kv_len, kv_start=kv_start, positions=positions,
            return_cache=return_cache, decode_state=decode_state,
        )
        if self.cfg.parallel_block:
            # NeoX: x + attn(ln1 x) + mlp(ln2 x)
            attn_out, cache = self.attn(self.ln1(x), **kwargs)
            return x + attn_out + self.mlp(self.ln2(x)), cache
        attn_out, cache = self.attn(self.ln1(x), **kwargs)
        x = x + attn_out
        return x + self.mlp(self.ln2(x)), cache


def init_gen_cache(batch: int, max_new: int, cfg: LMConfig, dtype=torch.bfloat16,
                   device=None, quantized: bool = False) -> dict:
    """Per-layer generated-token KV cache, split K and V, heads-major
    [B*, Hkv, max_new, D] (the layout the decode kernel reads).
    ``quantized``: int8 K and V with f32 scales [B*, Hkv, max_new], one per
    (row, head, position)."""
    shape = (batch, cfg.kv_heads, max_new, cfg.head_dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class CausalLM(nn.Module):
    """Pure-text causal LM (counterpart of ``unimp_tpu/models/lm.py:CausalLM``;
    the multimodal model in ``flamingo.py`` builds its own interleaved
    stack): embed, the ``DecoderBlock``s, ``final_ln``, then the tied
    embedding product or an ``lm_head`` through ``quant_dot`` (K6 when the
    head is int8).

    ``forward`` modes, as the JAX module's:
      * full forward:              logits, None
      * prefill (return_kv=True):  logits, {"self": [prompt caches]}
      * decode (decode_state=...): logits, [gen caches, updated in place]
    with ``decode_state`` {"self", "gen", "step", "kv_start", "gen_index"}.
    Logits are float32. It also takes the keywords ``decode/sampler.py``'s
    ``Generator`` passes (``latents`` / ``q_media`` must be None;
    ``last_logit_only``), so the Generator decodes it greedily or by beams.
    Spans, as ``UniMPModel``'s: ``model.embed``, ``model.block``,
    ``model.logits``.
    """

    def __init__(self, cfg: LMConfig, dtype=torch.bfloat16):
        super().__init__()
        from unimp_tpu_torch.models.flamingo import Embed
        from unimp_tpu_torch.models.layers import DenseWeights

        self.cfg, self.compute_dtype = cfg, dtype
        self.embed = Embed(cfg.vocab_size, cfg.hidden_size, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", DecoderBlock(cfg, dtype))
        self.final_ln = make_norm(cfg.norm, cfg.hidden_size, cfg.layernorm_eps, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = DenseWeights(cfg.hidden_size, cfg.vocab_size, use_bias=False)
        self.zero = None  # a CausalLM runs on one device

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.num_layers)]

    def forward(self, input_ids, *, kv_len=None, kv_start=None, positions=None,
                return_kv: bool = False, decode_state: Optional[dict] = None,
                latents=None, q_media=None, last_logit_only: bool = False):
        if latents is not None or q_media is not None:
            raise ValueError("CausalLM takes no media")
        with profiling.span("model.embed"):
            x = self.embed(input_ids)
        caches = []
        if decode_state is not None:  # the step on the device once for every layer
            step_tensors = decode_step_tensors(decode_state["step"], x.device)
        for i, block in enumerate(self.blocks()):
            layer_ds = None
            if decode_state is not None:
                layer_ds = {"prompt": decode_state["self"][i], "gen": decode_state["gen"][i],
                            "step": decode_state["step"], "step_tensors": step_tensors,
                            "kv_start": decode_state.get("kv_start"),
                            "gen_index": decode_state.get("gen_index")}
            with profiling.span("model.block"):
                x, cache = block(x, kv_len=kv_len, kv_start=kv_start, positions=positions,
                                 causal=input_ids.shape[1] > 1, return_cache=return_kv,
                                 decode_state=layer_ds)
            caches.append(cache)
        if last_logit_only:
            x = x[:, -1:]
        with profiling.span("model.logits"):
            x = self.final_ln(x)
            if self.cfg.tie_embeddings:
                logits = (x @ self.embed.embedding.to(x.dtype).t()).float()
            else:
                logits = self.lm_head(x.to(self.compute_dtype)).float()
        if return_kv:
            return logits, {"self": caches}
        if decode_state is not None:
            return logits, caches  # updated gen caches
        return logits, None

    def init_gen_caches(self, batch: int, max_new: int, device=None,
                        quantized: bool = False):
        device = device or self.embed.embedding.device
        return [init_gen_cache(batch, max_new, self.cfg, self.compute_dtype, device, quantized)
                for _ in range(self.cfg.num_layers)]
