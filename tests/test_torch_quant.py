"""The port's weight-only int8 and int8 KV caches against the JAX package,
on the CPU.

The same seeded numpy inputs go to both: the quantizer must give the same
int8 payloads and scales, ``quant_matmul_ref`` (the plain K6) must match
the Pallas kernel in interpret mode, ``quant_dot`` must take the same
arithmetic on both sides of its 512-row threshold, and the int8 branches
of the plain K4 / K5 must match the Pallas kernels (interpret mode, the
arithmetic they follow) at the JAX suite's float32 tolerance and the XLA
path (which dequantizes up front) at the suite's 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from unimp_tpu.decode.sampler import quantize_kv_cache as j_quantize_kv_cache
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.models.layers import OProj as JOProj
from unimp_tpu.ops.decode_attention import decode_attention as j_decode_attention
from unimp_tpu.ops.decode_attention import single_query_attention as j_single_query
from unimp_tpu.ops.quant_matmul import quant_dot as j_quant_dot
from unimp_tpu.ops.quant_matmul import quant_matmul as j_quant_matmul
from unimp_tpu.utils import quant as jq
from unimp_tpu_torch.decode.sampler import quantize_kv_cache
from unimp_tpu_torch.models import UniMPModel, get_config
from unimp_tpu_torch.models.layers import DenseWeights, OProj, Proj
from unimp_tpu_torch.ops.decode_attention import decode_attention, single_query_attention
from unimp_tpu_torch.ops.quant_matmul import quant_dot, quant_matmul, quant_matmul_ref
from unimp_tpu_torch.tools.from_flax import flatten_tree, load_flax_params
from unimp_tpu_torch.utils.quant import (
    QuantizedKernel,
    concat_kernels_int8,
    count_quantized,
    dequantize_params,
    quantize_params_int8,
    quantized_bytes,
)

torch.set_num_threads(2)  # six test workers share the cores
# float32: the JAX suite's kernel tolerance; bf16: one bf16 rounding apart
TOL = {np.float32: dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=1e-2, rtol=1e-2)}
XLA_TOL = dict(atol=2e-2, rtol=2e-2)  # tests/test_decode.py:567-569


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat_jax(tree) -> dict:
    """A (possibly quantized) JAX tree -> {"a/b/kernel/q": numpy array}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            np.asarray(v) for path, v in leaves}


# shapes of a Dense [in, N], a Proj [in, H, d] and an o_proj [H, d, out]
KERNELS = {"dense": (96, 80), "proj": (64, 4, 16), "o_proj": (4, 16, 72)}


def _port_layer(name, w):
    """A one-layer port module under ``name`` holding float kernel ``w``."""
    if name == "dense":
        layer = DenseWeights(*w.shape, use_bias=False)
    elif name == "proj":
        layer = Proj(*w.shape, use_bias=False)
    else:
        layer = OProj(*w.shape, use_bias=False, dtype=torch.float32)
    with torch.no_grad():
        layer.kernel.copy_(_t(w))
    return nn.ModuleDict({name: layer})


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_quantize_leaf_matches_jax(name):
    """The same int8 payload and scale (o_proj: scale [out], both leading
    axes contracted; Proj: scale [H, d])."""
    w = np.random.default_rng(len(name)).normal(size=KERNELS[name]).astype(np.float32)
    want = jq.quantize_params_int8({name: {"kernel": jnp.asarray(w)}}, min_size=1,
                                   dtype=jnp.float32)[name]["kernel"]
    port = quantize_params_int8(_port_layer(name, w), min_size=1, dtype=torch.float32)
    got = port[name].kernel
    assert isinstance(got, QuantizedKernel) and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale.shape == ((KERNELS[name][-1],) if name == "o_proj" else KERNELS[name][1:])


@pytest.mark.parametrize("min_size", [1, 1 << 13])
def test_quantize_model_matches_jax(min_size):
    """On a debug model: the same kernels quantized (the min_size filter),
    the same payloads, norms / biases / gates / embeddings untouched, the
    same byte count; dequantize_params gives back the JAX dequant."""
    cfg = j_get_config("debug", dtype="float32")
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(7)
    img = cfg.vision.image_size
    params = JModel(cfg).init(jax.random.PRNGKey(1), ids,
                              vision_x=jnp.zeros((1, 1, img, img, 3)),
                              q_media=j_compute_q_media(ids, 7))["params"]
    jparams = jq.quantize_params_int8(params, min_size=min_size, dtype=jnp.float32)
    model = UniMPModel(get_config("debug", dtype="float32"))
    load_flax_params(model, {k: np.asarray(v) for k, v in flatten_tree(params).items()})
    quantize_params_int8(model, min_size=min_size, dtype=torch.float32)
    want = _flat_jax(jparams)
    got = {k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert count_quantized(model) == jq.count_quantized(jparams) > 0
    assert quantized_bytes(model) == jq.quantized_bytes(jparams)
    if min_size > 1:  # the filter left the small kernels (4096 elements) float
        assert not isinstance(model.vision.block_0.attn.q_proj.kernel, QuantizedKernel)
        assert isinstance(model.vision.block_0.mlp.up.kernel, QuantizedKernel)
    deq = _flat_jax(jq.dequantize_params(jparams))
    dequantize_params(model)
    for key, val in model.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), deq[key.replace(".", "/")], err_msg=key)


def test_concat_kernels_int8_matches_jax():
    """The fused payload keeps each column's scale: equal to the JAX concat,
    and a matmul through it equals the per-kernel matmuls."""
    rng = np.random.default_rng(3)
    ws = [rng.normal(size=(96, n)).astype(np.float32) for n in (32, 48)]
    jks = [jq.quantize_params_int8({"kernel": jnp.asarray(w)}, min_size=1,
                                   dtype=jnp.float32)["kernel"] for w in ws]
    tks = [QuantizedKernel(_t(k.q), _t(k.scale), torch.float32) for k in jks]
    fused, jfused = concat_kernels_int8(tks), jq.concat_kernels_int8(jks)
    np.testing.assert_array_equal(fused.q.numpy(), np.asarray(jfused.q))
    np.testing.assert_array_equal(fused.scale.numpy(), np.asarray(jfused.scale))
    x = _t(rng.normal(size=(4, 96)).astype(np.float32))
    np.testing.assert_allclose(quant_dot(x, fused).numpy(),
                               torch.cat([quant_dot(x, k) for k in tks], -1).numpy(), atol=1e-6)


QMM_SHAPES = {  # tests/test_quant_matmul.py:33-41: (m, k, n, block_n, block_k)
    "single_block": (12, 128, 256, None, None),
    "multi_block": (20, 384, 512, 128, 128),
    "padded": (4, 100, 70, 32, 48),
    "one_row": (1, 256, 512, 128, 64),
}


def _qk(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32)
    return jq.quantize_params_int8({"kernel": jnp.asarray(w)}, min_size=1)["kernel"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(QMM_SHAPES))
def test_quant_matmul_plain_matches_pallas(shape, dtype):
    """Plain K6 == the Pallas kernel (interpret mode): f32 1e-5, bf16 1e-2,
    each with atol taken relative to max |out|: the f32 sum runs over
    x * q with |q| up to 127, so its order noise follows the row's size,
    not the element's."""
    m, k, n, bn, bk = QMM_SHAPES[shape]
    rng = np.random.default_rng(m + k)
    qk = _qk(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = j_quant_matmul(jnp.asarray(x, jdt), qk.q, qk.scale.reshape(-1), block_n=bn,
                          block_k=bk, interpret=True)
    got = quant_matmul(_t(_np(jnp.asarray(x, jdt))).to(tdt), _t(qk.q), _t(qk.scale))
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    _close_rel(got, want, dtype)


def _close_rel(got, want, dtype):
    tol = TOL[np.float32 if dtype == "f32" else "bf16"]["rtol"]
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_matmul_leading_batch_dims(dtype):
    rng = np.random.default_rng(1)
    qk = _qk(rng, 64, 96)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = j_quant_matmul(jnp.asarray(x, jdt), qk.q, qk.scale.reshape(-1), interpret=True)
    got = quant_matmul_ref(_t(_np(jnp.asarray(x, jdt))).to(tdt), _t(qk.q), _t(qk.scale))
    assert tuple(got.shape) == (2, 3, 96)
    _close_rel(got, want, dtype)


@pytest.mark.parametrize("rows", [8, 600])
@pytest.mark.parametrize("layer", ["dense", "o_proj"])
def test_quant_dot_matches_jax(layer, rows):
    """Both sides of the 512-row threshold (K6 below, the dequantized
    matmul above) give the JAX package's numbers, for a Dense kernel and
    for OProj with a quantized [H, d, out] kernel; f32 at 1e-5."""
    rng = np.random.default_rng(rows)
    w = rng.normal(size=KERNELS[layer]).astype(np.float32)
    jk = jq.quantize_params_int8({layer: {"kernel": jnp.asarray(w)}}, min_size=1,
                                 dtype=jnp.float32)[layer]
    port = quantize_params_int8(_port_layer(layer, w), min_size=1, dtype=torch.float32)[layer]
    if layer == "dense":
        x = rng.normal(size=(rows, w.shape[0])).astype(np.float32)
        want = j_quant_dot(jnp.asarray(x), jk["kernel"])
        got = port(_t(x))
    else:
        x = rng.normal(size=(rows, *w.shape[:2])).astype(np.float32)
        want = JOProj(w.shape[2], use_bias=False, dtype=jnp.float32).apply(
            {"params": jk}, jnp.asarray(x))
        got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL[np.float32])


@pytest.mark.parametrize("setting", [None, "1024"])
def test_quant_dot_reads_the_row_threshold_like_jax(monkeypatch, setting):
    """600 rows, between 512 and a larger ``UNIMP_QMM_MAX_ROWS``: unset, both
    packages take the dequantized matmul; at 1024 both stream through the
    int8 kernel (K6's plain version here, the Pallas kernel on the JAX
    side), with the JAX numbers at 1e-5."""
    import unimp_tpu.ops.quant_matmul as j_qmm
    import unimp_tpu_torch.ops.quant_matmul as t_qmm

    if setting is None:
        monkeypatch.delenv("UNIMP_QMM_MAX_ROWS", raising=False)
    else:
        monkeypatch.setenv("UNIMP_QMM_MAX_ROWS", setting)
    calls = {"jax": 0, "port": 0}
    j_orig, t_orig = j_qmm.quant_matmul, t_qmm.QuantMatmulFn.apply

    def j_spy(*args, **kw):
        calls["jax"] += 1
        return j_orig(*args, **kw)

    def t_spy(*args, **kw):
        calls["port"] += 1
        return t_orig(*args, **kw)

    monkeypatch.setattr(j_qmm, "quant_matmul", j_spy)
    monkeypatch.setattr(t_qmm.QuantMatmulFn, "apply", t_spy)
    rng = np.random.default_rng(600)
    w = rng.normal(size=KERNELS["dense"]).astype(np.float32)
    jk = jq.quantize_params_int8({"dense": {"kernel": jnp.asarray(w)}}, min_size=1,
                                 dtype=jnp.float32)["dense"]
    port = quantize_params_int8(_port_layer("dense", w), min_size=1,
                                dtype=torch.float32)["dense"]
    x = rng.normal(size=(600, w.shape[0])).astype(np.float32)
    want = j_qmm.quant_dot(jnp.asarray(x), jk["kernel"])
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL[np.float32])
    assert calls == ({"jax": 0, "port": 0} if setting is None else {"jax": 1, "port": 1})
    assert t_qmm.default_max_rows() == (512 if setting is None else 1024)


def _int8_decode_case(seed, b, kb, t, g, h, hkv, d):
    """int8 caches quantized by the JAX package, as numpy."""
    rng = np.random.default_rng(seed)
    bk = b * kb
    prompt = j_quantize_kv_cache({n: jnp.asarray(rng.normal(size=(b, hkv, t, d)), jnp.float32)
                                  for n in ("k", "v")})
    gen = j_quantize_kv_cache({n: jnp.asarray(rng.normal(size=(bk, hkv, g, d)), jnp.float32)
                               for n in ("k", "v")})
    return dict(
        q=rng.normal(size=(bk, h, d)).astype(np.float32),
        prompt={n: np.asarray(v) for n, v in prompt.items()},
        gen={n: np.asarray(v) for n, v in gen.items()},
        kv_start=rng.integers(0, t // 2, size=b).astype(np.int32),
        sel=rng.integers(0, kb, size=(bk, g)).astype(np.int32),
    )


def _bf16_q(q):
    """numpy f32 q -> (torch bf16, jax bf16) holding the same values."""
    t = torch.from_numpy(q).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("step", [1, 29])
@pytest.mark.parametrize("mode", ["beam", "gqa_d80", "bf16_shared_d80"])
def test_decode_int8_plain_matches_jax(step, mode):
    """Plain int8 K4, random beam_sel and kv_start (tests/test_decode.py:
    535-580): the Pallas kernel at 1e-5, the XLA path at 2e-2. bf16 q (the
    card's tensor-core kernel; beams sharing their first 16 ancestors):
    the Pallas kernel at 2e-2 (p rounds to bf16 under other maxima, the
    output to bf16 after sums in another order: tests/test_torch_ops.py
    BF16_TOL); the XLA path has no bf16 batched dot on the CPU backend."""
    b, kb, t, g, h, hkv, d = (2, 3, 16, 32, 4, 4, 16) if mode == "beam" else \
        (2, 3, 16, 32, 4, 2, 80)
    c = _int8_decode_case(step + d, b, kb, t, g, h, hkv, d)
    p, gn = c["prompt"], c["gen"]
    sel = c["sel"]
    tq, jq = _t(c["q"]), jnp.asarray(c["q"])
    if mode.startswith("bf16"):
        tq, jq = _bf16_q(c["q"])
        sel = sel.copy()
        sel[:, :16] = np.repeat(sel[::kb, :1], kb, axis=0)
    got = decode_attention(
        tq, _t(p["k"]), _t(p["v"]), _t(gn["k"]), _t(gn["v"]), step=step,
        kv_start=_t(c["kv_start"]), beam_sel=_t(sel),
        prompt_k_scale=_t(p["k_scale"]), prompt_v_scale=_t(p["v_scale"]),
        gen_k_scale=_t(gn["k_scale"]), gen_v_scale=_t(gn["v_scale"])).float().numpy()
    jkw = dict(step=jnp.int32(step), kv_start=jnp.asarray(c["kv_start"]),
               beam_sel=jnp.asarray(sel),
               prompt_k_scale=jnp.asarray(p["k_scale"]), prompt_v_scale=jnp.asarray(p["v_scale"]),
               gen_k_scale=jnp.asarray(gn["k_scale"]), gen_v_scale=jnp.asarray(gn["v_scale"]))
    jargs = [jq] + [jnp.asarray(x) for x in (p["k"], p["v"], gn["k"], gn["v"])]
    want = np.asarray(j_decode_attention(*jargs, **jkw, impl="pallas"), np.float32)
    if mode.startswith("bf16"):
        np.testing.assert_allclose(got, want, **XLA_TOL)
        return
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    np.testing.assert_allclose(
        got, np.asarray(j_decode_attention(*jargs, **jkw, impl="xla", gen_chunk=0)), **XLA_TOL)


def test_decode_int8_needs_all_scales():
    """int8 caches take all four scales or none (as the JAX package's
    decode_attention does), the latents both or none."""
    c = _int8_decode_case(7, 2, 3, 8, 16, 2, 2, 16)
    p, gn = c["prompt"], c["gen"]
    args = [_t(c["q"])] + [_t(x) for x in (p["k"], p["v"], gn["k"], gn["v"])]
    with pytest.raises(ValueError, match="scales"):
        decode_attention(*args, step=1, prompt_k_scale=_t(p["k_scale"]))
    with pytest.raises(ValueError, match="scales"):
        single_query_attention(args[0], args[1], args[2], torch.ones(2, 8, dtype=torch.bool),
                               k_scale=_t(p["k_scale"]))


@pytest.mark.parametrize("gqa,dtype", [pytest.param(False, "f32", id="False"),
                                       pytest.param(True, "f32", id="True"),
                                       pytest.param(True, "bf16", id="True-bf16-d80")])
def test_single_query_int8_plain_matches_jax(gqa, dtype):
    """Plain int8 K5 with a fully masked row (gives 0): Pallas at 1e-5, XLA
    at 2e-2; bf16 q at d80 (the card's tensor-core kernel): Pallas at 2e-2
    (as test_decode_int8_plain_matches_jax)."""
    b, kb, s, h, d = 2, 3, 24, 4, (80 if dtype == "bf16" else 16)
    hkv = 2 if gqa else h
    rng = np.random.default_rng(11 + gqa)
    q = rng.normal(size=(b * kb, h, d)).astype(np.float32)
    kv = {n: np.asarray(v) for n, v in j_quantize_kv_cache(
        {n: jnp.asarray(rng.normal(size=(b, hkv, s, d)), jnp.float32) for n in ("k", "v")}).items()}
    mask = rng.random((b, s)) < 0.7
    mask[1] = False
    tq, jq = _bf16_q(q) if dtype == "bf16" else (_t(q), jnp.asarray(q))
    got = single_query_attention(tq, _t(kv["k"]), _t(kv["v"]), _t(mask),
                                 k_scale=_t(kv["k_scale"]), v_scale=_t(kv["v_scale"]))
    assert torch.equal(got[kb:], torch.zeros_like(got[kb:]))
    got = got.float().numpy()
    jargs = (jq, jnp.asarray(kv["k"]), jnp.asarray(kv["v"]), jnp.asarray(mask))
    jkw = dict(k_scale=jnp.asarray(kv["k_scale"]), v_scale=jnp.asarray(kv["v_scale"]))
    want = np.asarray(j_single_query(*jargs, **jkw, impl="pallas"), np.float32)
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, **XLA_TOL)
        return
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    np.testing.assert_allclose(got, np.asarray(j_single_query(*jargs, **jkw, impl="xla")),
                               **XLA_TOL)


def test_quantize_kv_cache_matches_jax_generator():
    """The KV quantizer gives the int8 payload and the scales of the JAX
    package's jitted quantize_kv_cache (the one its Generator runs)."""
    rng = np.random.default_rng(5)
    cache = {n: rng.normal(size=(2, 4, 24, 80)).astype(np.float32) for n in ("k", "v")}
    want = jax.jit(j_quantize_kv_cache)({n: jnp.asarray(v) for n, v in cache.items()})
    got = quantize_kv_cache({n: _t(v) for n, v in cache.items()})
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)
