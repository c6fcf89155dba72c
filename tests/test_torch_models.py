"""The port's model against the JAX package, on the CPU, in float32.

Weights come from a seeded JAX ``model.init``, go through numpy into the
port (``load_flax_params``), and the same numpy inputs go to both. Gates
are opened so that cross-attention (and so the media masks) count.
Variants: ``debug`` and ``small`` (LLaMA-style LM), plus debug-sized
NeoX (the 4b family: parallel block, partial RoPE, head dim 80, biases,
untied head) and MPT (ALiBi, tied) LMs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.models.layers import apply_rope as j_apply_rope
from unimp_tpu.utils.quant import quantize_params_int8 as j_quantize_params_int8
from unimp_tpu_torch.models import UniMPModel, compute_q_media, get_config
from unimp_tpu_torch.models.layers import apply_rope
from unimp_tpu_torch.tools.from_flax import build_model, flatten_tree, init_params, load_flax_params
from unimp_tpu_torch.utils.quant import QuantizedKernel, count_quantized

torch.set_num_threads(2)  # six test workers share the cores
MEDIA_ID = 7

LM_FAMILIES = {
    "neox": dict(hidden_size=160, num_heads=2, norm="layernorm", positions="rope",
                 rotary_pct=0.25, act="gelu", parallel_block=True, use_bias=True,
                 tie_embeddings=False),
    "mpt": dict(hidden_size=128, num_heads=2, norm="layernorm", positions="alibi",
                act="gelu", use_bias=False, tie_embeddings=True),
}
# logits tolerances: f32 sums in another order through a few layers
ATOL = {"debug": 1e-4, "neox": 1e-4, "mpt": 1e-4, "small": 5e-4}


def _configs(name):
    base = "small" if name == "small" else "debug"
    jcfg = j_get_config(base, dtype="float32")
    tcfg = get_config(base, dtype="float32")
    if name in LM_FAMILIES:
        jcfg = jcfg.replace(lm=dataclasses.replace(jcfg.lm, **LM_FAMILIES[name]))
        tcfg = tcfg.replace(lm=dataclasses.replace(tcfg.lm, **LM_FAMILIES[name]))
    return jcfg, tcfg


def _inputs(cfg, batch=2, n_media=3, seq=24, seed=0):
    rng = np.random.default_rng(seed)
    img = cfg.vision.image_size
    vision = rng.normal(size=(batch, n_media, img, img, 3)).astype(np.float32)
    ids = rng.integers(10, cfg.lm.vocab_size, size=(batch, seq)).astype(np.int32)
    for pos in (1, seq // 3, seq // 2):
        ids[:, pos] = MEDIA_ID
    return vision, ids


_CACHE = {}


def _pair(name):
    """(jax model, jax params with gates open, port model with the same
    weights); cached per module run."""
    if name not in _CACHE:
        jcfg, tcfg = _configs(name)
        jmodel = JModel(jcfg)
        vision, ids = _inputs(jcfg, batch=1, n_media=1, seq=8)
        params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                             vision_x=jnp.asarray(vision),
                             q_media=j_compute_q_media(jnp.asarray(ids), MEDIA_ID))["params"]
        params = jax.tree_util.tree_map(lambda x: x, params)
        for key in params:
            if key.startswith("xattn_"):
                params[key]["attn_gate"] = jnp.asarray(1.0)
                params[key]["ff_gate"] = jnp.asarray(1.0)
        tmodel = UniMPModel(tcfg)
        flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
        load_flax_params(tmodel, flat)
        _CACHE[name] = (jmodel, params, tmodel.eval(), flat)
    return _CACHE[name]


@pytest.mark.parametrize("name", ["debug", "small", "neox", "mpt"])
def test_load_flax_params_covers_every_leaf(name):
    """Every Flax leaf lands on a port parameter; the counts are equal."""
    _, params, tmodel, flat = _pair(name)
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    n_port = sum(p.numel() for p in tmodel.parameters())
    assert n_jax == n_port
    assert len(flat) == len(list(tmodel.parameters()))
    for pname, p in tmodel.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), flat[pname.replace(".", "/")])


@pytest.mark.parametrize("name", ["debug", "small"])
def test_encode_vision_matches_jax(name):
    jmodel, params, tmodel, _ = _pair(name)
    vision, _ = _inputs(jmodel.cfg, batch=2, n_media=2)
    want = jmodel.apply({"params": params}, jnp.asarray(vision),
                        method=JModel.encode_vision)
    with torch.no_grad():
        got = tmodel.encode_vision(torch.from_numpy(vision))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["debug", "small", "neox", "mpt"])
def test_full_forward_logits_match_jax(name):
    jmodel, params, tmodel, _ = _pair(name)
    vision, ids = _inputs(jmodel.cfg)
    want, _ = jmodel.apply({"params": params}, jnp.asarray(ids), vision_x=jnp.asarray(vision),
                           q_media=j_compute_q_media(jnp.asarray(ids), MEDIA_ID))
    t_ids = torch.from_numpy(ids).long()
    with torch.no_grad():
        got, _ = tmodel(t_ids, vision_x=torch.from_numpy(vision),
                        q_media=compute_q_media(t_ids, MEDIA_ID))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL[name], rtol=ATOL[name])


@pytest.mark.parametrize("name", ["debug", "neox", "mpt"])
def test_prefill_decode_matches_full_forward(name):
    """Prefill the first s-4 tokens, decode the rest one at a time through
    the split prompt/gen cache; logits must match the full forward (as
    tests/test_models.py does for the JAX model)."""
    jmodel, _, tmodel, _ = _pair(name)
    vision, ids = _inputs(jmodel.cfg, batch=1, seq=24)
    t_ids = torch.from_numpy(ids).long()
    q_media = compute_q_media(t_ids, MEDIA_ID)
    b, s = ids.shape
    split = s - 4
    with torch.no_grad():
        latents = tmodel.encode_vision(torch.from_numpy(vision))
        full, _ = tmodel(t_ids, latents=latents, q_media=q_media)
        pos = torch.arange(split)[None].expand(b, split)
        pre, kv = tmodel(t_ids[:, :split], latents=latents, q_media=q_media[:, :split],
                         positions=pos, return_kv=True)
        np.testing.assert_allclose(pre.numpy(), full[:, :split].numpy(), atol=2e-4, rtol=2e-4)
        state = {"self": kv["self"], "xattn": kv["xattn"],
                 "kv_start": torch.zeros(b, dtype=torch.int32),
                 "n_media": q_media[:, -1], "kv_media": UniMPModel.kv_media_for(latents)}
        gen = tmodel.init_gen_caches(b, 8)
        steps = []
        for j, tpos in enumerate(range(split, s)):
            lg, gen = tmodel(t_ids[:, tpos:tpos + 1], positions=torch.full((b, 1), tpos),
                             decode_state=dict(state, gen=gen, step=j))
            steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, split:].numpy(),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", ["debug", "neox"])
def test_int8_logits_match_jax(name):
    """Weights quantized by the JAX package (every kernel, min_size 1,
    float32 compute) and loaded into the port from the int8 tree: every
    leaf lands, and the generation prefill (images through the ViT, whose
    patch embedding dequantizes; the last position only, K6 on the head)
    gives the JAX logits at 1e-4. neox covers the untied head, o_proj's
    [out] scale and the biases."""
    jmodel, params, _, _ = _pair(name)
    qparams = j_quantize_params_int8(params, min_size=1, dtype=jnp.float32)
    leaves = jax.tree_util.tree_flatten_with_path(qparams)[0]
    flat = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            np.asarray(v) for path, v in leaves}
    tmodel = UniMPModel(_configs(name)[1])
    load_flax_params(tmodel, flat)
    tmodel.eval()
    state = tmodel.state_dict()
    assert {k.replace(".", "/") for k in state} == set(flat)
    for key, val in state.items():
        np.testing.assert_array_equal(val.numpy(), flat[key.replace(".", "/")])
    assert isinstance(tmodel.block_0.attn.qkv_int8, QuantizedKernel)

    vision, ids = _inputs(jmodel.cfg)
    jids, t_ids = jnp.asarray(ids), torch.from_numpy(ids).long()
    want, _ = jmodel.apply({"params": qparams}, jids, vision_x=jnp.asarray(vision),
                           return_kv=True, last_logit_only=True,
                           q_media=j_compute_q_media(jids, MEDIA_ID))
    with torch.no_grad():
        got, _ = tmodel(t_ids, vision_x=torch.from_numpy(vision), return_kv=True,
                        last_logit_only=True, q_media=compute_q_media(t_ids, MEDIA_ID))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_build_model_int8():
    """build_model(eval_param_dtype="int8"): cast to bf16, then every kernel
    of at least 65,536 elements int8; norms, embeddings and biases stay."""
    cfg = get_config("debug")
    model = build_model(cfg, device="cpu", eval_param_dtype="int8")
    kernel = model.block_0.mlp.down.kernel  # [512, 128]
    assert isinstance(kernel, QuantizedKernel) and kernel.dtype == torch.bfloat16
    assert not isinstance(model.block_0.attn.q_proj.kernel, QuantizedKernel)  # 128 x 2 x 64
    assert model.embed.embedding.dtype == torch.bfloat16
    assert model.block_0.ln1.scale.dtype == torch.float32
    assert count_quantized(model) == cfg.lm.num_layers * 3 + 2 * 2  # LM + x-attn MLPs
    with pytest.raises(ValueError):
        build_model(cfg, device="cpu", eval_param_dtype="int4")


@pytest.mark.parametrize("d,pct", [(64, 1.0), (80, 0.25), (128, 0.5)])
def test_apply_rope_matches_jax(d, pct):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 9)).astype(np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), pct, 10000.0)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), pct, 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_init_params_distributions():
    """The seeded init draws Flax's distributions: zero gates and biases,
    unit scales, lecun-normal kernels (std sqrt(1/fan_in))."""
    model = build_model(get_config("debug", dtype="float32"), device="cpu", seed=3)
    p = {name: t.detach() for name, t in model.named_parameters()}
    assert float(p["xattn_0.attn_gate"].detach()) == 0.0
    assert torch.all(p["vision.pre_ln.scale"] == 1) and torch.all(p["vision.pre_ln.bias"] == 0)
    k = p["block_0.mlp.down.kernel"]  # [512, 128]: fan_in 512
    assert abs(float(k.std()) - (1 / 512) ** 0.5) < 0.1 * (1 / 512) ** 0.5
    q = p["block_0.attn.q_proj.kernel"]  # [128, 2, 64]: flax fan_in 128*2
    assert abs(float(q.std()) - (1 / 256) ** 0.5) < 0.1 * (1 / 256) ** 0.5
    other = build_model(get_config("debug", dtype="float32"), device="cpu", seed=3)
    assert torch.equal(other.block_0.attn.q_proj.kernel, q)
    init_params(other, torch.Generator().manual_seed(4))
    assert not torch.equal(other.block_0.attn.q_proj.kernel, q)


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        build_model(get_config("debug"), device="cuda")
