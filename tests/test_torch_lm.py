"""The port's pure-text ``CausalLM`` against the JAX package's, on the CPU.

Weights come from a seeded JAX ``CausalLM.init`` and load into the port
through ``load_flax_params``; the same numpy token ids go to both. LM
families at debug size: LLaMA-style (RMSNorm, RoPE, SwiGLU) tied and
untied, NeoX (parallel block, partial RoPE, biases, untied head) and
MPT (ALiBi) tied and untied. Prefill logits are held within 1e-5 in
float32; a 16-step greedy decode through the gen cache (the port's
``Generator``, a hand loop of the JAX module's ``decode_state`` calls)
gives the same tokens; int8 weights quantized by the JAX quantizer give
JAX's int8 logits and tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.decode.sampler import left_align as j_left_align
from unimp_tpu.models import CausalLM as JCausalLM
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.models.lm import init_gen_cache as j_init_gen_cache
from unimp_tpu.utils.quant import quantize_params_int8 as j_quantize_params_int8
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.models import CausalLM, get_config
from unimp_tpu_torch.tools.from_flax import build_model
from unimp_tpu_torch.utils.quant import QuantizedKernel, count_quantized

torch.set_num_threads(2)  # six test workers share the cores

FAMILIES = {
    "llama_tied": {},
    "llama_untied": dict(tie_embeddings=False),
    "neox": dict(hidden_size=160, num_heads=2, norm="layernorm", positions="rope",
                 rotary_pct=0.25, act="gelu", parallel_block=True, use_bias=True,
                 tie_embeddings=False),
    "mpt_tied": dict(norm="layernorm", positions="alibi", act="gelu", use_bias=False,
                     tie_embeddings=True),
    "mpt_untied": dict(norm="layernorm", positions="alibi", act="gelu", use_bias=False,
                       tie_embeddings=False),
}
LOGITS_ATOL = 1e-5  # float32, the same sums in another order over two layers
INT8_ATOL = 1e-4    # int8 weights dequantized to float32 on both sides
NEW_TOKENS = 16


def _lm_configs(name):
    jl = dataclasses.replace(j_get_config("debug").lm, **FAMILIES[name])
    tl = dataclasses.replace(get_config("debug").lm, **FAMILIES[name])
    return jl, tl


_CACHE = {}


def _pair(name, int8=False):
    """(JAX module, JAX params, port model with the same weights)."""
    key = (name, int8)
    if key not in _CACHE:
        jl, tl = _lm_configs(name)
        jm = JCausalLM(jl, dtype=jnp.float32)
        ids = jnp.zeros((1, 4), jnp.int32)
        params = jm.init(jax.random.PRNGKey(3), ids)["params"]
        if int8:
            params = j_quantize_params_int8(params, min_size=1, dtype=jnp.float32)
        leaves = jax.tree_util.tree_flatten_with_path(params)[0]
        flat = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
                np.asarray(v) for path, v in leaves}
        tm = build_model(tl, device="cpu", weights=flat, dtype=torch.float32)
        _CACHE[key] = (jm, params, tm)
    return _CACHE[key]


def _ids(cfg, b=3, t=20, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(b, t)).astype(np.int32)
    seq_len = np.asarray([t, t - 5, t - 11][:b], np.int32)
    for r, n in enumerate(seq_len):
        ids[r, n:] = 0
    return ids, seq_len


def _j_greedy(jm, params, ids, seq_len, n_new):
    """Greedy decode of the JAX module by hand (its Generator passes media
    keywords a CausalLM does not take): prefill with ``return_kv``, then
    one ``decode_state`` call a token through its gen caches."""
    b, t = ids.shape
    lids, start = j_left_align(jnp.asarray(ids), jnp.asarray(seq_len), 0)
    positions = jnp.maximum(jnp.arange(t, dtype=jnp.int32)[None, :] - start[:, None], 0)
    logits, kv = jm.apply({"params": params}, lids, kv_start=start, positions=positions,
                          return_kv=True)
    gen = [j_init_gen_cache(b, n_new, jm.cfg, jnp.float32) for _ in range(jm.cfg.num_layers)]
    last = logits[:, -1]
    toks, steps = [], []
    for step in range(n_new):
        nxt = jnp.argmax(jax.nn.log_softmax(last, axis=-1), axis=-1).astype(jnp.int32)
        toks.append(np.asarray(nxt))
        ds = {"self": kv["self"], "gen": gen, "step": jnp.int32(step), "kv_start": start}
        logits, gen = jm.apply({"params": params}, nxt[:, None],
                               positions=(t + step - start)[:, None], decode_state=ds)
        last = logits[:, 0]
        steps.append(np.asarray(last))
    return np.stack(toks, 1), np.stack(steps, 1)


def _t_greedy(tm, ids, seq_len, n_new):
    gen = Generator(tm, GenerationConfig(max_new_tokens=n_new, eos_id=-1, pad_id=0),
                    media_id=-1)
    toks, _ = gen.generate(torch.from_numpy(ids).long(), torch.from_numpy(seq_len).long())
    return toks[:, 0].numpy()


@pytest.mark.parametrize("name", list(FAMILIES))
@torch.no_grad()
def test_prefill_logits_match_jax(name):
    jm, params, tm = _pair(name)
    ids, _ = _ids(jm.cfg)
    want, _ = jm.apply({"params": params}, jnp.asarray(ids))
    got, cache = tm(torch.from_numpy(ids).long())
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL, rtol=0)
    # prefill with caches: the same logits, one prompt cache a layer, as JAX's
    want_kv, jkv = jm.apply({"params": params}, jnp.asarray(ids), return_kv=True)
    got_kv, tkv = tm(torch.from_numpy(ids).long(), return_kv=True)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv), atol=LOGITS_ATOL, rtol=0)
    assert len(tkv["self"]) == len(jkv["self"]) == jm.cfg.num_layers
    for tc, jc in zip(tkv["self"], jkv["self"]):
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=LOGITS_ATOL,
                                       rtol=0)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_greedy_decode_matches_jax(name):
    jm, params, tm = _pair(name)
    ids, seq_len = _ids(jm.cfg, seed=1)
    want, _ = _j_greedy(jm, params, ids, seq_len, NEW_TOKENS)
    got = _t_greedy(tm, ids, seq_len, NEW_TOKENS)
    np.testing.assert_array_equal(got, want)


def test_decode_logits_through_the_gen_cache_match_jax():
    """Each decode step's logits, the port driven by hand with the JAX
    tokens, within 1e-5 of JAX's at every step."""
    jm, params, tm = _pair("neox")
    ids, seq_len = _ids(jm.cfg, seed=2)
    toks, want = _j_greedy(jm, params, ids, seq_len, 8)
    b, t = ids.shape
    lids, start = j_left_align(jnp.asarray(ids), jnp.asarray(seq_len), 0)
    lids, start = torch.tensor(np.asarray(lids)).long(), torch.tensor(np.asarray(start))
    positions = torch.clamp(torch.arange(t)[None, :] - start[:, None], min=0)
    with torch.no_grad():
        _, kv = tm(lids, kv_start=start, positions=positions, return_kv=True)
        gen = tm.init_gen_caches(b, 8)
        for step in range(8):
            ds = {"self": kv["self"], "gen": gen, "step": step, "kv_start": start}
            logits, gen = tm(torch.from_numpy(toks[:, step:step + 1]).long(),
                             positions=(t + step - start)[:, None], decode_state=ds)
            np.testing.assert_allclose(logits[:, 0].numpy(), want[:, step], atol=LOGITS_ATOL,
                                       rtol=0)


@pytest.mark.parametrize("name", ["llama_untied", "neox", "mpt_untied"])
@torch.no_grad()
def test_int8_weights_match_jax_int8(name):
    """A tree the JAX quantizer made int8 (every kernel, the head too) loads
    into int8 kernels of the port and gives JAX's int8 logits and greedy
    tokens."""
    jm, params, tm = _pair(name, int8=True)
    assert isinstance(tm.lm_head.kernel, QuantizedKernel)
    mlp_kernels = 3 if jm.cfg.act == "silu" else 2
    assert count_quantized(tm) == 1 + (4 + mlp_kernels) * jm.cfg.num_layers
    ids, seq_len = _ids(jm.cfg, seed=3)
    want, _ = jm.apply({"params": params}, jnp.asarray(ids))
    got, _ = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_ATOL, rtol=0)
    jt, _ = _j_greedy(jm, params, ids, seq_len, NEW_TOKENS)
    np.testing.assert_array_equal(_t_greedy(tm, ids, seq_len, NEW_TOKENS), jt)


def test_causal_lm_refuses_media_and_a_mesh():
    _, tl = _lm_configs("llama_tied")
    model = CausalLM(tl, torch.float32)
    with pytest.raises(ValueError, match="no media"):
        model(torch.zeros(1, 3, dtype=torch.long), latents=torch.zeros(1, 1, 1, 1))
    with pytest.raises(ValueError, match="inference on one device"):
        build_model(tl, device="cpu", train=True)
    # the multimodal model's compute dtype is its config's, not an argument
    with pytest.raises(ValueError, match="cfg.dtype"):
        build_model(get_config("debug"), device="cpu", dtype=torch.float32)
