"""The port's generation against the JAX ``Generator``, on the CPU.

Same weights (a seeded JAX init, gates opened, loaded through numpy),
same prompts and item latents: the beam search must return the same
tokens for both length conventions, greedy the same tokens, and a short
prompt must decode the same alone as batched with a longer one.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from unimp_tpu.decode import GenerationConfig as JGenerationConfig
from unimp_tpu.decode import Generator as JGenerator
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.utils.quant import quantize_params_int8 as j_quantize_params_int8
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.decode.sampler import left_align, top_k
from unimp_tpu_torch.evals.metrics import rank_metrics_for_hits
from unimp_tpu_torch.models import UniMPModel, get_config
from unimp_tpu_torch.tools.from_flax import flatten_tree, load_flax_params
from unimp_tpu_torch.utils.quant import quantize_params_int8

torch.set_num_threads(2)  # six test workers share the cores
MEDIA_ID = 7


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("debug", dtype="float32")
    jmodel = JModel(jcfg)
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(MEDIA_ID)
    img = jcfg.vision.image_size
    params = jmodel.init(jax.random.PRNGKey(0), ids,
                         vision_x=jnp.zeros((1, 1, img, img, 3), jnp.float32),
                         q_media=j_compute_q_media(ids, MEDIA_ID))["params"]
    params = jax.tree_util.tree_map(lambda x: x, params)
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(1.0)
            params[key]["ff_gate"] = jnp.asarray(1.0)
    tmodel = UniMPModel(get_config("debug", dtype="float32"))
    load_flax_params(tmodel, {k: np.asarray(v) for k, v in flatten_tree(params).items()})
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module")
def bf16_models():
    """The debug model computing in bfloat16 on both sides (float32 weights,
    cast at use), from the same seeded JAX init, gates opened."""
    jcfg = j_get_config("debug", dtype="bfloat16")
    jmodel = JModel(jcfg)
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(MEDIA_ID)
    img = jcfg.vision.image_size
    params = jmodel.init(jax.random.PRNGKey(0), ids,
                         vision_x=jnp.zeros((1, 1, img, img, 3), jnp.float32),
                         q_media=j_compute_q_media(ids, MEDIA_ID))["params"]
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(1.0)
            params[key]["ff_gate"] = jnp.asarray(1.0)
    tmodel = UniMPModel(get_config("debug", dtype="bfloat16"))
    load_flax_params(tmodel, {k: np.asarray(v) for k, v in flatten_tree(params).items()})
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module")
def int8_models(models):
    """The same weights quantized by the JAX package (every kernel,
    min_size 1, float32 compute) and loaded into the port from the int8
    tree (``.../kernel/q``, ``.../kernel/scale``)."""
    jmodel, params, _ = models
    qparams = j_quantize_params_int8(params, min_size=1, dtype=jnp.float32)
    leaves = jax.tree_util.tree_flatten_with_path(qparams)[0]
    flat = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path):
            np.asarray(v) for path, v in leaves}
    tmodel = UniMPModel(get_config("debug", dtype="float32"))
    load_flax_params(tmodel, flat)
    return jmodel, qparams, tmodel.eval()


def _prompts(cfg, b=3, t=16, m=2, seed=0):
    """Right-padded prompts with m media tokens each, ragged lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, cfg.lm.vocab_size, size=(b, t)).astype(np.int32)
    seq_len = np.array([t, t - 5, t - 3][:b], np.int32)
    ids[:, 1] = MEDIA_ID
    ids[:, 5] = MEDIA_ID
    for r in range(b):
        ids[r, seq_len[r]:] = 0
    img = cfg.vision.image_size
    vision = rng.normal(size=(b, m, img, img, 3)).astype(np.float32)
    return ids, seq_len, vision


def _run_both(models, gen_kw, multimodal=True):
    jmodel, params, tmodel = models
    ids, seq_len, vision = _prompts(jmodel.cfg)
    jlat = tlat = None
    if multimodal:
        jlat = jmodel.apply({"params": params}, jnp.asarray(vision), method=JModel.encode_vision)
        with torch.no_grad():
            tlat = tmodel.encode_vision(torch.from_numpy(vision))
    jgen = JGenerator(jmodel, JGenerationConfig(**gen_kw), media_id=MEDIA_ID)
    jtok, jscores = jgen.generate(params, jnp.asarray(ids), jnp.asarray(seq_len), jlat)
    tgen = Generator(tmodel, GenerationConfig(**gen_kw), media_id=MEDIA_ID)
    ttok, tscores = tgen.generate(torch.from_numpy(ids).long(),
                                  torch.from_numpy(seq_len).long(), tlat)
    return (np.asarray(jtok), np.asarray(jscores)), (ttok.numpy(), tscores.numpy())


@pytest.mark.parametrize("length_norm,early", [("full", True), ("generated", True),
                                               ("full", False)])
def test_beam_tokens_match_jax(models, length_norm, early):
    gen_kw = dict(max_new_tokens=6, eos_id=3, pad_id=0, num_beams=4,
                  num_return_sequences=4, length_norm=length_norm, early_stopping=early)
    (jtok, jscores), (ttok, tscores) = _run_both(models, gen_kw)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=1e-4)


def test_beam_with_frequent_eos_matches_jax(models):
    """An eos the model picks often exercises the finished-set banking."""
    jmodel, params, tmodel = models
    ids, seq_len, _ = _prompts(jmodel.cfg)
    probe = JGenerator(jmodel, JGenerationConfig(max_new_tokens=3, eos_id=1, pad_id=0),
                       media_id=MEDIA_ID)
    eos = int(np.asarray(probe.generate(params, jnp.asarray(ids),
                                        jnp.asarray(seq_len))[0])[0, 0, 1])
    gen_kw = dict(max_new_tokens=5, eos_id=eos, pad_id=0, num_beams=3,
                  num_return_sequences=3)
    (jtok, jscores), (ttok, tscores) = _run_both(models, gen_kw, multimodal=False)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=1e-4)


def test_greedy_tokens_match_jax(models):
    gen_kw = dict(max_new_tokens=6, eos_id=3, pad_id=0)
    (jtok, jscores), (ttok, tscores) = _run_both(models, gen_kw)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=1e-4)


def _near_tied_logits(seed, steps, b, v):
    """[steps, B, V] bf16 logits whose best two in each row are adjacent
    bf16 values in [4, 8), the larger at the higher index, over a bulk
    0.5-2.5 below them (so that |log p| of the best is near 8 or above,
    where a bf16 step is as wide as the gap or wider); the last id (eos)
    is never picked."""
    rng = np.random.default_rng(seed)
    top = rng.uniform(4.0, 8.0, size=(steps, b)).astype(ml_dtypes.bfloat16)
    below = np.nextafter(top, np.zeros_like(top))
    bulk = (top.astype(np.float32)[..., None] - rng.uniform(0.5, 2.5, size=(steps, b, 1))
            - 0.3 * np.abs(rng.normal(size=(steps, b, v))))
    x = bulk.astype(ml_dtypes.bfloat16)
    for s in range(steps):
        for r in range(b):
            i, j = np.sort(rng.choice(v - 1, 2, replace=False))
            x[s, r, i], x[s, r, j] = below[s, r], top[s, r]
    x[..., v - 1] = -30.0
    return x


class _JStubModel:
    """Serves fixed logits to the JAX Generator: the prefill's, then one
    set per decode step (no KV caches)."""

    def __init__(self, logits):
        self.logits = jnp.asarray(logits)

    def init_gen_caches(self, b, max_new, quantized=False):
        return jnp.zeros((b,), jnp.int32)

    def apply(self, variables, ids, positions=None, decode_state=None, **kw):
        if decode_state is None:
            return self.logits[0][:, None], {"self": [], "xattn": []}
        step = decode_state["step"] + 1
        return jax.lax.dynamic_index_in_dim(self.logits, step, keepdims=False)[:, None], \
            decode_state["gen"]


class _StubModel:
    """The same logits for the port's Generator."""

    def __init__(self, logits):
        self.logits = torch.from_numpy(logits.astype(np.float32)).to(torch.bfloat16)

    def init_gen_caches(self, b, max_new, device, quantized=False):
        return None

    def __call__(self, ids, positions=None, decode_state=None, **kw):
        if decode_state is None:
            return self.logits[0][:, None], {"self": [], "xattn": []}
        return self.logits[decode_state["step"] + 1][:, None], decode_state["gen"]


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_bf16_near_ties_match_jax(seed):
    """bf16 logits (the 4b family's untied head) through both greedy loops:
    JAX takes log_softmax in bf16, where the best two of a near-tied row
    can round to one value and argmax then takes the lower index; the port
    must pick the same tokens and sum the same bf16 scores."""
    steps, b, v = 3, 64, 8192
    x = _near_tied_logits(seed, steps + 1, b, v)
    gen_kw = dict(max_new_tokens=steps, eos_id=v - 1, pad_id=0)
    ids, seq_len = np.ones((b, 4), np.int32), np.full(b, 4, np.int32)
    jtok, jscores = JGenerator(_JStubModel(x), JGenerationConfig(**gen_kw),
                               media_id=MEDIA_ID).generate({}, jnp.asarray(ids),
                                                           jnp.asarray(seq_len))
    ttok, tscores = Generator(_StubModel(x), GenerationConfig(**gen_kw),
                              media_id=MEDIA_ID).generate(torch.from_numpy(ids).long(),
                                                          torch.from_numpy(seq_len).long())
    jtok, jscores = np.asarray(jtok)[:, 0], np.asarray(jscores)
    xf = x[:steps].astype(np.float32)
    higher = np.array([[np.flatnonzero(row == row.max())[-1] for row in step] for step in xf]).T
    lower_picks = int((jtok != higher).sum())
    assert 0 < lower_picks < b * steps  # the rounding decides some rows, not all
    np.testing.assert_array_equal(ttok.numpy()[:, 0], jtok)
    np.testing.assert_array_equal(tscores.numpy(), jscores)


@pytest.mark.parametrize("beams", [1, 4])
def test_greedy_tokens_match_jax_bf16(bf16_models, beams):
    """The debug model in bfloat16: greedy (log_softmax in bf16 on both
    sides) and 4-beam search give JAX's tokens. Scores within 8e-3
    relative: each step's log p is a bf16 value (greedy) or comes from bf16
    logits that the two frameworks' matmuls may round one bf16 step apart
    (2^-8 to 2^-7 relative)."""
    gen_kw = dict(max_new_tokens=6, eos_id=3, pad_id=0, num_beams=beams,
                  num_return_sequences=beams)
    (jtok, jscores), (ttok, tscores) = _run_both(bf16_models, gen_kw)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tscores, jscores, rtol=8e-3)


def test_rec_eval_path_matches_jax(models):
    """The rec-eval path end to end: item latents through both ItemLatentCaches
    (uint8 images, CLIP normalize, chunked encode, gather), then a 3-beam
    search over them (the metrics: ``test_rank_metrics_match_jax``)."""
    from unimp_tpu.evals.latent_cache import ItemLatentCache as JItemLatentCache
    from unimp_tpu_torch.evals.latent_cache import ItemLatentCache

    jmodel, params, tmodel = models
    rng = np.random.default_rng(5)
    img = jmodel.cfg.vision.image_size
    images = rng.integers(0, 256, size=(7, img, img, 3), dtype=np.uint8)
    image_ids = np.array([[0, 5], [3, 3], [6, 1]])
    jcache = JItemLatentCache(jmodel, params, lambda i: images[i], 7, chunk=4)
    tcache = ItemLatentCache(tmodel, lambda i: images[i], 7, chunk=4, device="cpu")
    jlat, tlat = jcache.gather(image_ids), tcache.gather(image_ids)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-4, rtol=1e-4)

    ids, seq_len, _ = _prompts(jmodel.cfg, seed=4)
    gen_kw = dict(max_new_tokens=4, eos_id=3, pad_id=0, num_beams=3, num_return_sequences=3)
    jtok, _ = JGenerator(jmodel, JGenerationConfig(**gen_kw), media_id=MEDIA_ID).generate(
        params, jnp.asarray(ids), jnp.asarray(seq_len), jlat)
    ttok, _ = Generator(tmodel, GenerationConfig(**gen_kw), media_id=MEDIA_ID).generate(
        torch.from_numpy(ids).long(), torch.from_numpy(seq_len).long(), tlat)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("beams", [4, 1])
def test_int8_generate_matches_jax(int8_models, beams, kv_int8):
    """int8 weights (K6 at every decode and prefill projection but the
    patch embedding), with and without int8 KV caches: the same tokens as
    the JAX Generator. Scores: 1e-4; with int8 KV 1e-3, because a K/V
    value whose float32 noise between the two frameworks straddles an
    int8 rounding midpoint lands one int8 step apart (a logit moves by up
    to one scale), which moves a greedy score by up to 7e-4 on these
    prompts."""
    gen_kw = dict(max_new_tokens=6, eos_id=3, pad_id=0, num_beams=beams,
                  num_return_sequences=beams, kv_int8=kv_int8)
    (jtok, jscores), (ttok, tscores) = _run_both(int8_models, gen_kw)
    np.testing.assert_array_equal(ttok, jtok)
    tol = 1e-3 if kv_int8 else 1e-4
    np.testing.assert_allclose(tscores, jscores, atol=tol, rtol=tol)


def test_int8_rec_eval_path_matches_jax(int8_models):
    """The rec-eval path with int8 weights and int8 KV: item latents through
    both ItemLatentCaches, then a 3-beam search over them."""
    from unimp_tpu.evals.latent_cache import ItemLatentCache as JItemLatentCache
    from unimp_tpu_torch.evals.latent_cache import ItemLatentCache

    jmodel, qparams, tmodel = int8_models
    rng = np.random.default_rng(6)
    img = jmodel.cfg.vision.image_size
    images = rng.integers(0, 256, size=(7, img, img, 3), dtype=np.uint8)
    image_ids = np.array([[2, 5], [3, 0], [6, 6]])
    jlat = JItemLatentCache(jmodel, qparams, lambda i: images[i], 7, chunk=4).gather(image_ids)
    tlat = ItemLatentCache(tmodel, lambda i: images[i], 7, chunk=4, device="cpu").gather(image_ids)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-4, rtol=1e-4)
    ids, seq_len, _ = _prompts(jmodel.cfg, seed=7)
    gen_kw = dict(max_new_tokens=4, eos_id=3, pad_id=0, num_beams=3, num_return_sequences=3,
                  kv_int8=True)
    jtok, _ = JGenerator(jmodel, JGenerationConfig(**gen_kw), media_id=MEDIA_ID).generate(
        qparams, jnp.asarray(ids), jnp.asarray(seq_len), jlat)
    ttok, _ = Generator(tmodel, GenerationConfig(**gen_kw), media_id=MEDIA_ID).generate(
        torch.from_numpy(ids).long(), torch.from_numpy(seq_len).long(), tlat)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_port_quantizer_gives_jax_tokens(models, int8_models):
    """The port quantizing the float tree itself decodes as the JAX package
    does with the tree it quantized."""
    _, params, _ = models
    jmodel, qparams, _ = int8_models
    tmodel = UniMPModel(get_config("debug", dtype="float32"))
    load_flax_params(tmodel, {k: np.asarray(v) for k, v in flatten_tree(params).items()})
    quantize_params_int8(tmodel.eval(), min_size=1, dtype=torch.float32)
    gen_kw = dict(max_new_tokens=6, eos_id=3, pad_id=0, num_beams=4, num_return_sequences=4)
    (jtok, jscores), (ttok, tscores) = _run_both((jmodel, qparams, tmodel), gen_kw)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=1e-4)


def test_padding_invariance(models):
    """A short prompt decoded alone == the same prompt batched with a
    longer one (as tests/test_decode.py checks for the JAX package)."""
    _, _, tmodel = models
    rng = np.random.default_rng(2)
    short = rng.integers(10, 512, size=8)
    long_ = rng.integers(10, 512, size=16)
    gen = Generator(tmodel, GenerationConfig(max_new_tokens=4, eos_id=3, pad_id=0,
                                             num_beams=3, num_return_sequences=3),
                    media_id=999)
    ids = np.zeros((2, 16), np.int64)
    ids[0, :8] = short
    ids[1] = long_
    tok_b, sc_b = gen.generate(torch.from_numpy(ids), torch.tensor([8, 16]))
    tok_s, sc_s = gen.generate(torch.from_numpy(short[None]), torch.tensor([8]))
    assert torch.equal(tok_b[0], tok_s[0])
    torch.testing.assert_close(sc_b[0], sc_s[0], atol=2e-4, rtol=2e-4)


def test_left_align_matches_jax():
    from unimp_tpu.decode.sampler import left_align as j_left_align

    ids = np.arange(1, 25, dtype=np.int32).reshape(3, 8)
    seq_len = np.array([8, 3, 5], np.int32)
    want_ids, want_start = j_left_align(jnp.asarray(ids), jnp.asarray(seq_len), 0)
    got_ids, got_start = left_align(torch.from_numpy(ids), torch.from_numpy(seq_len), 0)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_start.numpy(), np.asarray(want_start))


def test_top_k_breaks_ties_like_jax():
    x = np.array([[1.0, 3.0, 3.0, -1e9, 3.0, 2.0, -1e9, -1e9],
                  [-1e9] * 8], np.float32)
    for k in (1, 2, 3, 5):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_rank_metrics_match_jax():
    from unimp_tpu.evals import metrics as jm
    from unimp_tpu_torch.evals import metrics as tm

    for hits in ([0] * 10, [0, 0, 1] + [0] * 7, [1] + [0] * 9, [0] * 6 + [1, 1, 0, 0]):
        assert rank_metrics_for_hits(np.array(hits)) == jm.rank_metrics_for_hits(np.array(hits))
        for k in (3, 10):
            p, r = tm.precision_at_k(hits, k), tm.recall_at_k(hits, k, 2)
            assert (p, r) == (jm.precision_at_k(hits, k), jm.recall_at_k(hits, k, 2))
            assert tm.f1_score(p, r) == jm.f1_score(p, r)


@pytest.mark.parametrize("beams", [1, 4])
def test_cpu_generate_decodes_eagerly(models, beams):
    """A CPU model takes the eager path: every decode step counts as
    ``eager``, none as a capture or a replay."""
    from unimp_tpu_torch.decode import sampler

    _, _, tmodel = models
    ids, seq_len, _ = _prompts(tmodel.cfg, seed=8)
    gen = Generator(tmodel, GenerationConfig(max_new_tokens=5, eos_id=3, pad_id=0,
                                             num_beams=beams, num_return_sequences=beams),
                    media_id=MEDIA_ID)
    steps, real = [0], gen._decode_step

    def counted(*args, **kwargs):
        steps[0] += 1
        return real(*args, **kwargs)

    gen._decode_step = counted
    sampler.reset_decode_steps()
    gen.generate(torch.from_numpy(ids).long(), torch.from_numpy(seq_len).long())
    assert steps[0] > 0
    assert sampler.DECODE_STEPS == {"captures": 0, "replays": 0, "eager": steps[0]}
    assert gen._graph is None


@pytest.mark.parametrize("device,tp_group,graph", [
    ("cuda", None, True),
    ("cuda", "tp", False),  # a model sliced over tp: its forwards hold collectives
    ("cpu", None, False),
])
def test_decode_graph_is_chosen_from_device_and_lockstep_group(device, tp_group, graph):
    """The decode step runs as a CUDA graph only on the card and only where
    no other rank steps with this one; nothing else chooses it."""
    from types import SimpleNamespace

    model = SimpleNamespace(tp_group=tp_group, zero=None)
    gen = Generator(model, GenerationConfig(max_new_tokens=2, eos_id=3, pad_id=0), MEDIA_ID)
    assert gen._takes_graph(torch.device(device)) is graph
