"""Traffic family ``rec_beam``: the rec evaluation's closed loop.

Back-to-back batches of ``batch`` users through the program's
``Generator.generate`` (beam search), each fed by
``ItemLatentCache.gather`` from a catalogue of ``n_items`` seeded item
images that set-up encodes into the cache (tower and perceiver once an
item). Prompts come from ``traffic.prompts``. One batch in set-up warms
every shape. After the window the benchmark frees the program and holds a
sample of the served beams to the plain reference (``gpubench/checks.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import checks, common, traffic
from gpubench import weights as W


def trace_spans(r: common.Run, gen, model, steps: list):
    """Host spans around the program's layers for the traced run (each
    batch's decode steps counted into ``steps[-1]``); returns the function
    that takes the module-level wrapper away again."""
    from unimp_tpu_torch.decode import sampler

    real_decode = gen._decode_step

    def counted(*args, **kwargs):
        steps[-1] += 1
        with r.spans.span("decode_step"):
            return real_decode(*args, **kwargs)

    gen._decode_step = counted
    real_forward = model.forward

    def forward(*args, **kwargs):
        name = "decode_forward" if kwargs.get("decode_state") is not None else "prefill"
        with r.spans.span(name):
            return real_forward(*args, **kwargs)

    model.forward = forward
    real_top_k = sampler.top_k
    sampler.top_k = r.spans.wrap("beam_top_k", real_top_k)

    def restore():
        sampler.top_k = real_top_k

    return restore


def skew_selection(beams: int):
    """A planted fault: each step's expansion keeps the candidates ranked
    K + 2 .. 3K + 1 in place of the best 2K, their scores true to their
    tokens. Returns the function that takes it away again."""
    from unimp_tpu_torch.decode import sampler

    real_top_k = sampler.top_k

    def skewed(x, k):
        if k == 2 * beams and x.shape[-1] > 4 * beams:  # the candidates' top-2K
            vals, idx = real_top_k(x, 3 * beams + 1)
            return vals[..., beams + 1:], idx[..., beams + 1:]
        return real_top_k(x, k)

    sampler.top_k = skewed

    def restore():
        sampler.top_k = real_top_k

    return restore


def run(r: common.Run) -> dict:
    from unimp_tpu_torch.decode.sampler import GenerationConfig, Generator
    from unimp_tpu_torch.evals.latent_cache import ItemLatentCache
    from unimp_tpu_torch.ops import kernel_lib
    from unimp_tpu_torch.tools.from_flax import build_model

    t, p, tok = r.spec["traffic"], dict(r.spec["program"]), r.sizes.tokens
    p.update(r.overrides.get("program", {}))
    dev = r.device
    if dev.type == "cuda":
        kernel_lib.build_all()
    cfg = common.port_config(r.spec["config_file"], p)
    model = build_model(cfg, device=dev, eval_param_dtype=p["eval_param_dtype"],
                        weights=common.seeded_weights(r.sizes, r.seed, dev))
    n_items, size = t["n_items"], r.sizes.vision.image_size
    catalogue = W.images(r.seed, "catalogue", n_items, size, dev).cpu().numpy()
    cache = ItemLatentCache(model, lambda i: catalogue[i], n_items, chunk=t["encode_chunk"],
                            device=dev)
    cache.gather(np.arange(n_items)[None])  # the whole catalogue, once
    gen = Generator(model, GenerationConfig(
        max_new_tokens=t["new_tokens"], eos_id=tok["eos"], pad_id=tok["pad"],
        num_beams=t["beams"], num_return_sequences=t["beams"], kv_int8=p["kv_int8"]),
        media_id=tok["media"])
    rng = np.random.default_rng([r.seed % 2**63, 0])
    pool = [traffic.prompts(rng, t["batch"], t["prompt_len"], t["media"], n_items,
                            t["min_len"], tok) for _ in range(t["pool"])]
    pool = [(torch.from_numpy(ids).to(dev), torch.from_numpy(sl).to(dev), img, sl)
            for ids, sl, img in pool]

    fault = r.overrides.get("fault")

    def batch(i):
        ids, seq_len, image_ids, _ = pool[i % len(pool)]
        with r.spans.span("gather"):
            lat = cache.gather(image_ids)
        if fault == "half_batch":  # the second half of the users left out
            half = ids.shape[0] // 2
            tokens, scores = gen.generate(ids[:half], seq_len[:half], lat[:half])
            tokens, scores = torch.cat([tokens, tokens]), torch.cat([scores, scores])
        else:
            tokens, scores = gen.generate(ids, seq_len, lat)
        if fault == "token_altered":  # one token of every beam changed where produced
            tokens = tokens.clone()
            tokens[:, :, 1] = (tokens[:, :, 1] + 1) % r.sizes.lm.vocab_size
        with r.spans.span("read_out"):
            return tokens.cpu(), scores.cpu()

    batch(len(pool) - 1)  # warm-up: every shape of the window
    if fault == "stale_state":  # each decode step answers as the first did
        first = {}
        real_step = gen._decode_step

        def stale(tokens, state, gen_caches, step, positions, gen_index=None):
            out = real_step(tokens, state, gen_caches, step, positions, gen_index)
            first.setdefault(out[0].shape, out[0])
            return first[out[0].shape], out[1]

        gen._decode_step = stale
    restores = []
    if fault == "wrong_selection":
        restores.append(skew_selection(t["beams"]))
    steps = []
    if r.trace:
        restores.append(trace_spans(r, gen, model, steps))
    outputs = []

    def step(i):
        steps.append(0)
        outputs.append((i % len(pool),) + batch(i))

    ends = r.record["step_ends_s"] = []
    r.record["setup_s"] = common.process_start_s()
    if r.trace:
        from gpubench.trace import DeviceTrace

        with DeviceTrace() as dt:
            n, secs = traffic.run_window(step, r.seconds, ends=ends)
        r.record.update(device_trace=dt, decode_steps=steps)
    else:
        n, secs = traffic.run_window(step, r.seconds, ends=ends)
    for restore in reversed(restores):
        restore()
    r.record.update(seq_lens=[pool[i][3] for i, _, _ in outputs],
                    peak_bytes=common.peak_bytes(dev))
    items = n * t["batch"]
    del gen, cache, model, pool
    common.free_device()

    check = checks.rec_beam(r, catalogue, outputs)
    return {"attempted": items, "failed": 0,
            "e2e": {"items_per_s": items / secs,
                    "peak_mem_gib": r.record["peak_bytes"] / 2**30,
                    "setup_s": r.record["setup_s"]},
            "check": check}
