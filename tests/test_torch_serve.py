"""The port's serving path against the JAX package, on the CPU.

Sampling (the filter element for element, the draw against its
softmax), the streaming decoder, the wave-batched engine (alone, full,
mixed with an image, int8 KV, a sampled request in any slot, failures),
the worker's image path and the HTTP stack (controller, worker,
clients, moderation, registration), dispatch and the conversation
templates. Weights: one seeded JAX init of the ``debug`` model in
float32, cross-attention gates opened, loaded into the port through
numpy.
"""

import base64
import dataclasses
import json
import tempfile
import threading
import time
import types
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from unimp_tpu.decode import GenerationConfig as JGenerationConfig
from unimp_tpu.decode import Generator as JGenerator
from unimp_tpu.decode.streaming import StreamingGenerator as JStreamingGenerator
from unimp_tpu.models import UniMPModel as JModel
from unimp_tpu.models import compute_q_media as j_compute_q_media
from unimp_tpu.models import get_config as j_get_config
from unimp_tpu.serve import batching as jbatching
from unimp_tpu.serve import cli_chat as jcli_chat
from unimp_tpu.serve import controller as jcontroller
from unimp_tpu.serve import conversation as jconversation
from unimp_tpu.serve import worker as jworker
from unimp_tpu.tools import synth_data as j_synth_data
from unimp_tpu_torch.data import jpeg
from unimp_tpu_torch.decode import GenerationConfig, Generator
from unimp_tpu_torch.decode.sampler import NEG_INF, sample_draw, sample_filter
from unimp_tpu_torch.decode.streaming import StreamingGenerator
from unimp_tpu_torch.models import UniMPModel, get_config
from unimp_tpu_torch.serve import conversation
from unimp_tpu_torch.serve.batching import BatchedStreamingEngine, EngineError
from unimp_tpu_torch.serve.cli_chat import post_json, stream_bytes, stream_request
from unimp_tpu_torch.serve.constants import MODERATION_MSG
from unimp_tpu_torch.serve.controller import Controller
from unimp_tpu_torch.serve.controller import make_handler as controller_handler
from unimp_tpu_torch.serve.register_worker import register
from unimp_tpu_torch.serve.web_server import make_handler as web_handler
from unimp_tpu_torch.serve.web_server import violates_moderation
from unimp_tpu_torch.serve.worker import ModelWorker
from unimp_tpu_torch.serve.worker import make_handler as worker_handler
from unimp_tpu_torch.tools import synth_data
from unimp_tpu_torch.tools.from_flax import flatten_tree, load_flax_params

torch.set_num_threads(2)  # six test workers share the cores
MAX_NEW = 6
PROMPTS = ["hello world", "what item next", "rate this cream", "hello world again and again"]


@pytest.fixture(scope="module")
def stack():
    """JAX and port models with the same weights, and both tokenizers of
    one synthetic dataset (the same ids)."""
    with tempfile.TemporaryDirectory() as d:
        j_synth_data.generate(d, n_items=32, n_users=4, image_size=28, write_images=False)
        jtok = j_synth_data.build_tokenizer(d, n_items=32)
        tok = synth_data.build_tokenizer(d, n_items=32)
    assert len(tok) == len(jtok)
    jcfg = j_get_config("debug", dtype="float32")
    jcfg = jcfg.replace(lm=dataclasses.replace(jcfg.lm, vocab_size=len(jtok) + 8))
    jmodel = JModel(jcfg)
    ids = jnp.ones((1, 8), jnp.int32).at[0, 1].set(jtok.media_token_id)
    img = jcfg.vision.image_size
    params = jmodel.init(jax.random.PRNGKey(0), ids,
                         vision_x=jnp.zeros((1, 1, img, img, 3), jnp.float32),
                         q_media=j_compute_q_media(ids, jtok.media_token_id))["params"]
    for key in params:
        if key.startswith("xattn_"):
            params[key]["attn_gate"] = jnp.asarray(1.0)
            params[key]["ff_gate"] = jnp.asarray(1.0)
    cfg = get_config("debug", dtype="float32")
    cfg = cfg.replace(lm=dataclasses.replace(cfg.lm, vocab_size=len(tok) + 8))
    model = UniMPModel(cfg)
    load_flax_params(model, {k: np.asarray(v) for k, v in flatten_tree(params).items()})
    image = np.random.default_rng(3).normal(size=(1, 1, img, img, 3)).astype(np.float32)
    return types.SimpleNamespace(jmodel=jmodel, params=params, jtok=jtok, model=model.eval(),
                                 tok=tok, img=img, image=image)


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _run_concurrently(engine, requests, params=None, stagger_s=0.0, max_new=MAX_NEW):
    """Stream each (prompt, kwargs) on its own thread; returns the final
    texts and the number of texts each stream yielded."""
    texts, counts = [None] * len(requests), [0] * len(requests)

    def run(i):
        prompt, kw = requests[i]
        text = ""
        for text in engine.stream(params, prompt, max_new_tokens=max_new, **kw):
            counts[i] += 1
        texts[i] = text

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
        time.sleep(stagger_s)
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    engine.stop()
    return texts, counts


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("top_k", [0, 20])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_sample_filter_matches_jax(monkeypatch, temperature, top_k, top_p, dtype):
    """``sample_filter`` gives exactly the logits that JAX's
    ``Generator._sample_from`` hands to ``jax.random.categorical`` (its
    greedy loop passes float32: bf16 rows widen first)."""
    rows = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 96)).astype(np.float32) * 3)
    rows = rows.to(getattr(torch, dtype))
    kw = dict(max_new_tokens=4, eos_id=1, pad_id=0, temperature=temperature, top_k=top_k,
              top_p=top_p)
    seen = {}

    def categorical(key, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.zeros(logits.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    JGenerator(None, JGenerationConfig(**kw), media_id=0)._sample_from(
        jnp.asarray(rows.float().numpy()), jax.random.PRNGKey(0))
    got = sample_filter(rows, GenerationConfig(**kw)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, seen["logits"])
    if top_k or top_p < 1:
        assert (got == NEG_INF).any()


def test_sampled_generate_follows_its_generator(stack):
    """JAX's ``test_sampling_modes`` properties: one generator seed gives
    the same tokens, seeds 0 and 1 differ; sampling without a generator
    raises."""
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(10, stack.model.cfg.lm.vocab_size, size=(2, 10)))
    seq_len = torch.tensor([10, 10])
    gen = Generator(stack.model, GenerationConfig(max_new_tokens=6, eos_id=1, pad_id=0,
                                                  temperature=1.0, top_k=20, top_p=0.9),
                    media_id=999)
    t1, s1 = gen.generate(prompt, seq_len, generator=torch.Generator().manual_seed(0))
    t2, _ = gen.generate(prompt, seq_len, generator=torch.Generator().manual_seed(1))
    t3, s3 = gen.generate(prompt, seq_len, generator=torch.Generator().manual_seed(0))
    assert t1.shape == (2, 1, 6)
    assert not torch.equal(t1, t2)
    assert torch.equal(t1, t3) and torch.equal(s1, s3)
    assert bool((s1 < 0).all())  # summed log-probabilities of the drawn tokens
    with pytest.raises(ValueError, match="torch.Generator"):
        gen.generate(prompt, seq_len)


def test_sample_draw_follows_the_filtered_softmax():
    """20,000 draws from one filtered row (temperature 0.8, top-k 20,
    nucleus 0.95) against its softmax: chi-square p > 1e-3, and no draw
    of a cut logit."""
    logits = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 40)).astype(np.float32))
    cfg = GenerationConfig(4, 1, 0, temperature=0.8, top_k=20, top_p=0.95)
    row = sample_filter(logits, cfg)
    draws = sample_draw(row.expand(20000, -1), torch.Generator().manual_seed(0))
    counts = np.bincount(draws.numpy(), minlength=40)
    probs = torch.softmax(row[0], dim=-1).double().numpy()
    kept = probs > 0
    assert 5 <= kept.sum() <= 20 and counts[~kept].sum() == 0
    p = scipy.stats.chisquare(counts[kept], probs[kept] / probs[kept].sum() * 20000).pvalue
    assert p > 1e-3, p


# ---------------------------------------------------------------- streaming

@pytest.mark.parametrize("with_image", [False, True])
def test_streaming_matches_jax(stack, with_image):
    """Greedy streaming, with and without one image: every yielded text
    equals the JAX ``StreamingGenerator``'s."""
    prompt = "<image> what item next" if with_image else "hello world"
    vision = stack.image if with_image else None
    want = list(JStreamingGenerator(stack.jmodel, stack.jtok, max_new_tokens=8).stream(
        stack.params, prompt, vision_x=vision))
    got = list(StreamingGenerator(stack.model, stack.tok, max_new_tokens=8).stream(
        None, prompt, vision_x=vision))
    assert got == want and len(got) >= 2


def test_streaming_sampled_follows_its_seed(stack):
    gen = StreamingGenerator(stack.model, stack.tok, max_new_tokens=8)
    runs = [list(gen.stream(None, "hello world", temperature=1.5, seed=s)) for s in (7, 7, 8)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


# ---------------------------------------------------------------- the engine

def test_engine_four_prompts_match_jax_and_streamer(stack):
    """Four concurrent streams in one wave give the JAX engine's final
    texts and the port streamer's, streamed token by token."""
    streamer = StreamingGenerator(stack.model, stack.tok, max_new_tokens=MAX_NEW)
    expected = [list(streamer.stream(None, p))[-1] for p in PROMPTS]
    reqs = [(p, {}) for p in PROMPTS]
    got, counts = _run_concurrently(BatchedStreamingEngine(
        stack.model, stack.tok, max_slots=4, max_new_tokens=MAX_NEW, wave_window_ms=200), reqs)
    jgot, _ = _run_concurrently(jbatching.BatchedStreamingEngine(
        stack.jmodel, stack.jtok, max_slots=4, max_new_tokens=MAX_NEW, wave_window_ms=200),
        reqs, stack.params)
    assert got == jgot == expected
    assert all(c >= 2 for c in counts)


def test_engine_partial_and_mixed_image_waves_match_jax(stack):
    """One request alone (three inactive slots), then a wave of an image
    request and two text-only ones: the JAX engine's texts."""
    alone = [("rate this cream", {})]
    mixed = [("<image> what item next", {"vision_x": stack.image}), ("hello world", {}),
             ("rate this cream", {})]
    for reqs in (alone, mixed):
        got, _ = _run_concurrently(BatchedStreamingEngine(
            stack.model, stack.tok, max_slots=4, max_new_tokens=MAX_NEW, wave_window_ms=300),
            reqs)
        jgot, _ = _run_concurrently(jbatching.BatchedStreamingEngine(
            stack.jmodel, stack.jtok, max_slots=4, max_new_tokens=MAX_NEW, wave_window_ms=300),
            reqs, stack.params)
        assert got == jgot and all(got)


def test_engine_kv_int8_matches_float_caches_and_jax(stack):
    """JAX's ``test_batched_engine_kv_int8_streams`` (its prompts, 5 new
    tokens): int8 prompt, latent and gen caches give the float-cache
    engine's texts, and the JAX int8 engine's."""
    reqs = [(p, {}) for p in PROMPTS[:2]]
    kw = dict(max_slots=2, max_new_tokens=5, wave_window_ms=200)
    base, _ = _run_concurrently(BatchedStreamingEngine(stack.model, stack.tok, **kw), reqs,
                                max_new=5)
    quant, _ = _run_concurrently(BatchedStreamingEngine(stack.model, stack.tok, kv_int8=True,
                                                        **kw), reqs, max_new=5)
    jquant, _ = _run_concurrently(jbatching.BatchedStreamingEngine(
        stack.jmodel, stack.jtok, kv_int8=True, **kw), reqs, stack.params, max_new=5)
    assert quant == base == jquant and all(base)


def test_sampled_request_is_independent_of_its_wave_and_slot(stack):
    """A sampled request (seed 7, temperature 0.9) gives the same text
    alone and in slot 3 of a full wave."""
    sampled = ("what item next", {"temperature": 0.9, "seed": 7})
    alone, _ = _run_concurrently(BatchedStreamingEngine(
        stack.model, stack.tok, max_slots=4, max_new_tokens=MAX_NEW, wave_window_ms=1),
        [sampled])
    engine = BatchedStreamingEngine(stack.model, stack.tok, max_slots=4,
                                    max_new_tokens=MAX_NEW, wave_window_ms=2000)
    slots = []
    run_wave = engine._run_wave
    engine._run_wave = lambda reqs: (slots.append([r.seed for r in reqs]), run_wave(reqs))
    full, _ = _run_concurrently(engine, [("hello world", {"seed": 1}),
                                         ("rate this cream", {"temperature": 1.2, "seed": 2}),
                                         ("hello world again", {"seed": 3}), sampled],
                                stagger_s=0.1)
    assert slots == [[1, 2, 3, 7]]
    assert full[3] == alone[0] and alone[0]


def test_engine_failure_surfaces_as_error_not_text(stack):
    """JAX's ``test_engine_failure_surfaces_as_error_not_text``: a failed
    wave raises ``EngineError`` from ``stream()``, and the worker turns
    it into one error chunk (error_code 1) without the message."""
    def fail(reqs):
        raise RuntimeError("CUDA out of memory " + "x" * 4096)

    engine = BatchedStreamingEngine(stack.model, stack.tok, max_slots=2, max_new_tokens=4,
                                    wave_window_ms=1)
    engine._run_wave = fail
    with pytest.raises(EngineError):
        list(engine.stream(None, "hello", max_new_tokens=4))
    engine.stop()
    worker = ModelWorker(stack.model, stack.tok, ["tiny"], image_size=stack.img,
                         max_new_tokens=4)
    worker.engine._run_wave = fail
    chunks = list(worker.generate_stream({"prompt": "hello", "max_new_tokens": 4}))
    worker.engine.stop()
    assert chunks == [{"text": "engine error: EngineError", "error_code": 1, "finish": True}]


# ---------------------------------------------------------------- the worker

def test_worker_decodes_images_like_jax(stack):
    """A base64 JPEG (written by ``data/jpeg.py``) becomes the JAX worker's
    frames bit for bit, resized or not; anything else gets one error
    chunk."""
    yy, xx = np.mgrid[0:50, 0:70]
    rgb = np.stack([xx * 3, yy * 5, (xx + yy) * 2], -1).astype(np.uint8)
    square = np.random.default_rng(4).integers(0, 256, (stack.img, stack.img, 3), np.uint8)
    worker = ModelWorker(stack.model, stack.tok, ["tiny"], image_size=stack.img)
    jfake = types.SimpleNamespace(image_size=stack.img)
    b64 = [base64.b64encode(jpeg.encode_jpeg(a, quality=q)).decode()
           for a, q in ((rgb, 90), (square, 75))]
    got = worker.decode_images(b64)
    want = jworker.ModelWorker._decode_images(jfake, b64)
    assert got.shape == (1, 2, stack.img, stack.img, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    png = base64.b64encode(b"\x89PNG\r\n\x1a\n" + bytes(64)).decode()
    chunks = list(worker.generate_stream({"prompt": "<image> hi", "images": [png]}))
    assert len(chunks) == 1 and chunks[0]["error_code"] == 1 and chunks[0]["finish"]


def test_live_http_matches_jax_stack(stack):
    """Port controller -> port worker -> port ``stream_request``: the chunk
    list of the JAX stack for the same greedy request."""
    def run(worker_mod, controller_mod, client, model, tok, params):
        if params is None:
            worker = worker_mod.ModelWorker(model, tok, ["tiny"], image_size=stack.img,
                                            max_new_tokens=8)
        else:
            worker = worker_mod.ModelWorker(model, params, tok, ["tiny"],
                                            image_size=stack.img, max_new_tokens=8)
        wsrv, waddr = _serve(worker_mod.make_handler(worker))
        ctrl = controller_mod.Controller()
        ctrl.register_worker(waddr, False, worker.status())
        csrv, caddr = _serve(controller_mod.make_handler(ctrl))
        try:
            models = post_json(caddr + "/list_models", {})["models"]
            chunks = list(client(caddr, {"model": "tiny", "prompt": "hello world",
                                         "max_new_tokens": 5}))
        finally:
            wsrv.shutdown()
            csrv.shutdown()
            worker.engine.stop()
        return models, chunks

    from unimp_tpu_torch.serve import controller, worker

    got = run(worker, controller, stream_request, stack.model, stack.tok, None)
    want = run(jworker, jcontroller, jcli_chat.stream_request, stack.jmodel, stack.jtok,
               stack.params)
    assert got == want
    models, chunks = got
    assert models == ["tiny"] and len(chunks) >= 2
    assert chunks[-1]["finish"] is True and all(c["error_code"] == 0 for c in chunks)


def test_manual_register_worker_fetches_status(stack):
    worker = ModelWorker(stack.model, stack.tok, ["tiny"], image_size=stack.img)
    wsrv, waddr = _serve(worker_handler(worker))
    ctrl = Controller()
    csrv, caddr = _serve(controller_handler(ctrl))
    try:
        assert register(caddr, waddr) == 200  # no worker_status
        assert ctrl.list_models() == ["tiny"]
    finally:
        wsrv.shutdown()
        csrv.shutdown()


def test_web_server_moderation_hook(stack):
    """A flagged prompt gets one ``MODERATION_MSG`` chunk and no worker
    call; a clean one streams through the controller."""
    worker = ModelWorker(stack.model, stack.tok, ["tiny"], image_size=stack.img,
                         max_new_tokens=4)
    calls = []
    generate_stream = worker.generate_stream
    worker.generate_stream = lambda req: (calls.append(req["prompt"]), generate_stream(req))[1]
    wsrv, waddr = _serve(worker_handler(worker))
    ctrl = Controller()
    ctrl.register_worker(waddr, False, worker.status())
    csrv, caddr = _serve(controller_handler(ctrl))
    seen = []
    websrv, webaddr = _serve(web_handler(caddr, moderation_fn=lambda t: (
        seen.append(t), "forbidden" in t)[1]))

    def gen(prompt):
        raw = b"".join(stream_bytes(webaddr + "/api/generate",
                                    {"model": "tiny", "prompt": prompt, "max_new_tokens": 4}))
        return [json.loads(p) for p in raw.split(b"\0") if p]

    try:
        flagged = gen("forbidden words")
        assert flagged == [{"text": MODERATION_MSG, "error_code": 1}] and calls == []
        ok = gen("hello world")
        assert ok[-1]["finish"] is True and all(c["error_code"] == 0 for c in ok)
        assert seen == ["forbidden words", "hello world"] and calls == ["hello world"]
        req = urllib.request.Request(webaddr + "/api/list_models", data=b"{}")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["models"] == ["tiny"]
    finally:
        websrv.shutdown()
        wsrv.shutdown()
        csrv.shutdown()
        worker.engine.stop()


def test_violates_moderation_fails_open(monkeypatch):
    monkeypatch.setenv("UNIMP_MODERATION_URL", "http://127.0.0.1:1/nope")
    assert violates_moderation("anything", timeout=0.2) is False


# ---------------------------------------------------------------- dispatch

def test_controller_dispatch_matches_jax():
    """Queue bumps, unknown heartbeats and stale expiry as JAX's
    ``test_registry_and_dispatch``; lottery picks for one rng equal the
    JAX ``Controller``'s."""
    for cls in (Controller, jcontroller.Controller):
        c = cls("shortest_queue")
        c.register_worker("http://w1", True, {"model_names": ["m"], "speed": 1,
                                              "queue_length": 5})
        c.register_worker("http://w2", True, {"model_names": ["m"], "speed": 1,
                                              "queue_length": 0})
        assert c.list_models() == ["m"]
        assert c.get_worker_address("m") == "http://w2"
        assert c.workers["http://w2"].queue_length == 1
        assert c.get_worker_address("other") == ""
        assert c.receive_heart_beat("http://w3", 0) is False
        assert c.receive_heart_beat("http://w1", 2) is True
        c.workers["http://w1"].last_heart_beat = time.time() - 10_000
        assert c.remove_stale_workers() == ["http://w1"]
    picks = []
    for cls in (Controller, jcontroller.Controller):
        c = cls("lottery")
        for name, speed in (("http://a", 9), ("http://b", 1), ("http://c", 3)):
            c.register_worker(name, True, {"model_names": ["m"], "speed": speed})
        rng = np.random.default_rng(0)
        picks.append([c.get_worker_address("m", rng) for _ in range(200)])
    assert picks[0] == picks[1] and picks[0].count("http://a") > 100
    with pytest.raises(ValueError):
        Controller("round_robin")


def test_conversation_templates_match_jax():
    turns = [("ask", "reply"), (("tuple text", "img-placeholder"), None)]
    assert conversation.CONV_TEMPLATES.keys() == jconversation.CONV_TEMPLATES.keys()
    assert conversation.default_conversation is conversation.CONV_TEMPLATES["otter"]
    for name in conversation.CONV_TEMPLATES:
        convs = [mod.get_conv_template(name) for mod in (conversation, jconversation)]
        for conv in convs:
            for u, a in turns:
                conv.append_message(conv.roles[0], u)
                conv.append_message(conv.roles[1], a)
        got, want = convs
        assert got.get_prompt() == want.get_prompt(), name
        assert got.to_gradio_chatbot() == want.to_gradio_chatbot(), name
        assert got.dict() == want.dict(), name
    assert len(conversation.CONV_TEMPLATES["v1"].messages) == 2
