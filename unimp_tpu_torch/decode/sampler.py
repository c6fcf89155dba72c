"""KV-cached generation: greedy and beam search.

Counterpart of ``unimp_tpu/decode/sampler.py`` (the eval hot loop: HF
``generate(num_beams=10, num_return_sequences=10, early_stopping,
max_new_tokens)``):

  * prompts are left-aligned into a fixed window so many users decode in
    one batch;
  * the KV cache is split: the prompt KV [B, T] is shared by all beams of
    a row and never reordered; the generated KV [B*K, max_new] is never
    reordered either: an ancestry table ``anc`` names, for each beam and
    generated position, the cache row holding that token's K/V, and the
    decode kernel reads the ancestor's row directly;
  * ``kv_int8`` stores the prompt, latent and generated KV caches in int8
    with one f32 scale per (row, head, position); the decode kernels read
    the int8 bytes and fold the scales in;
  * beam-search semantics follow HF beam_search: top-2K candidate
    expansion, EOS candidates with rank < K retire to the finished set
    normalized by length^length_penalty, early_stopping=True stops a row
    once K hypotheses are banked, False compares the worst banked score
    with the best attainable running score.

The loop runs on the host, one model call per step, and stops when every
row is done. On a CUDA model that decodes alone (no lockstep group: not
sliced over tp, not under ZeRO-3, whose forwards hold collectives) the
model call of a step is a CUDA graph (``_DecodeGraph``): captured at the
first decode step of a ``generate()`` call over static copies of the
step's inputs (tokens, positions, ancestry table, and ``step`` as a
device scalar: the caches are written at a column indexed on the device,
``models/layers.py:decode_step_tensors``), replayed for that step and
every later one after the inputs are copied in; its static tensors go
when the call returns. A model's first graph step in a process runs
eagerly on the capture stream instead, to warm it up (cuBLAS' workspace,
the kernels' modules and shared-memory settings). Beam selection stays
eager, so the first read of a step waits for the replay. The graphs of
one ``Generator`` are captured into one memory pool: a spent graph, never
replayed again, is kept until the next capture has taken its pool over,
so the pool's memory (one step's transient tensors, free between calls)
is reused and not reserved anew each call; Python's garbage collector is
off during a capture, which a graph destroyed inside it would void. A
``Generator`` runs one ``generate()`` at a time. ``DECODE_STEPS`` counts the steps by path; a
replay adds the launches its capture counted to ``kernel_lib.LAUNCHES``.

A greedy step reads the device once (``bool(done.all())``); a beam step
four times: that check and one ``nonzero()`` in each of the
three ``top_k`` calls (candidates, the finished set, the alive set). The
JAX loop is one ``lax.while_loop`` and reads nothing back. Ties in every
top-k resolve to the lower index, as ``jax.lax.top_k`` does. The greedy
pick takes ``log_softmax`` in the logits' dtype, step by step as
``jax.nn.log_softmax`` does, so bf16 logits round (and near-ties break)
as in JAX.

Spans (``utils/profiling.py``): ``generate.prefill`` (the prefill and
the KV quantisation), then a ``generate.step`` a loop iteration holding
the ``read.done`` check, ``generate.select`` (the pick or the beam
bookkeeping, with its ``read.top_k`` reads) and ``generate.decode`` (the
model call, and in it ``generate.capture`` on a graph's first step, the
capture and its first replay, or ``generate.replay`` on a later one); a
loop that stops before ``max_new_tokens`` ends in a ``generate.step`` that
holds only the check.

Sampling (``temperature`` > 0, greedy loop only): ``sample_filter`` gives
the temperature-scaled, top-k and nucleus-cut logits that JAX's
``Generator._sample_from`` hands to ``jax.random.categorical``, element
for element; ``sample_draw`` draws from them with an explicit
``torch.Generator``. The draw is the port's own (the Gumbel-max race,
argmax of logits - log E with E ~ Exp(1)): JAX's threefry stream is not
reproduced, so one seed gives other tokens than in JAX, with the same
distribution.

Returns generated tokens only (no prompt), padded with pad_id.

Under tensor parallelism every decode step holds collectives, so the ranks
of a tp group decode the same number of steps: the loop's "every row
done" exit is one decision over the model's tp group (``parallel/mesh.py:
all_ranks_true``, an all-reduce MIN; over the world under ZeRO-3, whose
every forward gathers over fsdp: ``lockstep_group``); data-parallel ranks
of an unsharded model decode on their own.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import torch

from unimp_tpu_torch.models.flamingo import compute_q_media
from unimp_tpu_torch.ops import kernel_lib
from unimp_tpu_torch.parallel.mesh import all_ranks_true, lockstep_group
from unimp_tpu_torch.utils import profiling
from unimp_tpu_torch.utils.quant import quantize_kv

NEG_INF = -1.0e9

# decode steps by path: "captures" (the step captured the model call into a
# CUDA graph and replayed it once), "replays" (it replayed that graph),
# "eager" (it called the model)
DECODE_STEPS = {"captures": 0, "replays": 0, "eager": 0}

_CAPTURE_STREAMS: dict = {}  # device -> the side stream graphs are captured on
_WARMED = weakref.WeakSet()  # models whose decode step ran once on that stream


def reset_decode_steps() -> None:
    for name in DECODE_STEPS:
        DECODE_STEPS[name] = 0


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int
    eos_id: int
    pad_id: int
    num_beams: int = 1
    num_return_sequences: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = True
    # "full": score / (prompt_len + generated_before_eos)**lp (classic HF
    # BeamSearchScorer, the reference's semantics); "generated": score /
    # (generated incl. eos)**lp (transformers >= 4.50)
    length_norm: str = "full"
    # int8 KV caches (prompt + latent + generated)
    kv_int8: bool = False
    # sampling (num_beams 1): temperature 0 = greedy
    temperature: float = 0.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled


def quantize_kv_cache(cache: dict) -> dict:
    """{"k","v"} [B, H, S, D] -> int8 + per-(head, position) f32 scales
    {"k","v","k_scale","v_scale"} (written once at prefill, read every
    decode step)."""
    out = {}
    for name in ("k", "v"):
        out[name], out[name + "_scale"] = quantize_kv(cache[name])
    return out


def left_align(input_ids: torch.Tensor, seq_len: torch.Tensor, pad_id: int):
    """Right-padded rows -> left-padded rows; returns (ids, start) where
    start[b] = T - seq_len[b]."""
    t = input_ids.shape[1]
    start = (t - seq_len).to(torch.int32)
    pos = torch.arange(t, device=input_ids.device)[None, :]
    src = (pos - start[:, None].long()) % t  # row roll by start
    shifted = torch.gather(input_ids, 1, src)
    ids = torch.where(pos < start[:, None], torch.full_like(shifted, pad_id), shifted)
    return ids, start


def log_softmax_like_jax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last dim as the jitted JAX loop
    rounds it: float32 as ``torch.log_softmax``; a narrower dtype (the 4b
    family's bf16 logits) step by step in that dtype (the max, the shifted
    logits, the log of the sum, the difference), except that XLA fuses the
    exps into the sum and keeps them in f32 (the sum rounds once), so that
    two near-tied logits tie or not as they do in JAX."""
    if x.dtype == torch.float32:
        return torch.log_softmax(x, dim=-1)
    shifted = x - x.amax(dim=-1, keepdim=True)
    total = torch.exp(shifted.float()).sum(dim=-1, keepdim=True).to(x.dtype)
    return shifted - torch.log(total)


def top_k(x: torch.Tensor, k: int):
    """Top-k along the last dim with ties broken by the lower index (the
    order ``jax.lax.top_k`` gives). Returns (values, indices) sorted by
    value, descending."""
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    tied = x == kth
    need = k - above.sum(dim=-1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied.to(torch.int32), dim=-1) <= need))
    with profiling.read("top_k"):
        idx = take.nonzero()[:, -1].reshape(*x.shape[:-1], k)  # ascending index
    vals = torch.gather(x, -1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def sample_filter(logits: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """[B, V] logits -> the float32 logits JAX's ``_sample_from`` passes to
    ``jax.random.categorical`` (the greedy loop hands it float32 logits):
    divided by the temperature, then every logit below the k-th largest
    (``top_k``) and below the nucleus' smallest (``top_p``: the smallest
    set whose cumulative probability reaches top_p, kept where the
    probability before it is below top_p) set to ``NEG_INF``."""
    scaled = logits.float() / max(cfg.temperature, 1e-6)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=scaled.device)
    if cfg.top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -cfg.top_k][:, None]
        scaled = torch.where(scaled < kth, neg, scaled)
    if cfg.top_p < 1.0:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        keep = csum - probs < cfg.top_p
        cutoff = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < cutoff, neg, scaled)
    return scaled


def sample_draw(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw a row of [B, V] logits, from ``generator`` (on
    the logits' device): the Gumbel-max race, argmax of logits - log E with
    E ~ Exp(1) (E clamped above 0, so -log E <= 88 and a ``NEG_INF``
    logit never wins). Reads nothing back to the host
    (``torch.multinomial`` checks its input there)."""
    x = logits.float()
    race = torch.empty_like(x).exponential_(generator=generator)
    return torch.argmax(x - torch.log(race.clamp_min(torch.finfo(torch.float32).tiny)), dim=-1)


class _DecodeGraph:
    """One ``generate()`` call's decode step as a CUDA graph: the model call
    captured over static copies of the step's inputs; ``replay`` copies a
    step's inputs in and returns a copy of the logits (a later replay
    overwrites the static ones) and the gen caches, which the graph writes
    in place."""

    def __init__(self, model, tokens, state, gen, step, positions, gen_index, pool):
        dev = tokens.device
        self.state = state
        self.tokens, self.positions = tokens.clone(), positions.clone()
        self.gen_index = None if gen_index is None else gen_index.clone()
        self.step = torch.full((1,), step, dtype=torch.int64, device=dev)
        ds = dict(state, gen=gen, step=self.step, gen_index=self.gen_index)
        before = dict(kernel_lib.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # no garbage collection during the capture: a collected Generator's
        # spent graph, destroyed inside it, would void it
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                # thread_local: another thread's CUDA calls (a loader pinning
                # memory) do not void the capture
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.logits, self.new_gen = model(self.tokens, positions=self.positions,
                                                      decode_state=ds)
                finally:
                    self.graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(stream)
        # the launches the capture counted, counted again at each replay
        self.launches = {k: n - before[k] for k, n in kernel_lib.LAUNCHES.items()
                         if n != before[k]}

    def fits(self, tokens, state, gen, positions, gen_index) -> bool:
        """Whether this step's inputs are the captured call's: the same
        batch state and caches, the same shapes."""
        return (state is self.state and len(gen) == len(self.new_gen)
                and all(a is b for a, b in zip(gen, self.new_gen))
                and tokens.shape == self.tokens.shape
                and positions.shape == self.positions.shape
                and (gen_index is None) == (self.gen_index is None)
                and (gen_index is None or gen_index.shape == self.gen_index.shape))

    def replay(self, tokens, step, positions, gen_index, count_launches: bool = True):
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        if gen_index is not None:
            self.gen_index.copy_(gen_index)
        self.step.fill_(step)
        self.graph.replay()
        if count_launches:
            kernel_lib.add_launches(self.launches)
        return self.logits.clone(), self.new_gen


def _capture_stream(dev) -> torch.cuda.Stream:
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return stream


class Generator:
    """generate() over a UniMPModel (or an API-compatible model)."""

    def __init__(self, model, gen_cfg: GenerationConfig, media_id: int):
        self.model = model
        self.cfg = gen_cfg
        self.media_id = media_id
        # the ranks that decode together (a model sliced over tp, or ZeRO-3
        # over fsdp), or None
        self.lockstep_group = lockstep_group(model)
        # this call's decode graph; the memory pool of this Generator's
        # graphs (made at the first capture) and the last call's spent
        # graph, which holds the pool until the next capture
        self._graph = None
        self._pool = None
        self._spent = None

    @torch.no_grad()
    def generate(self, input_ids, seq_len, latents=None, generator=None):
        """input_ids [B, T] right-padded; seq_len [B]; latents [B, M, L, D];
        ``generator`` (a ``torch.Generator`` on the model's device) is
        required when sampling (temperature > 0).

        Returns (tokens [B, R, max_new], scores [B, R]).
        """
        cfg = self.cfg
        if cfg.temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a torch.Generator")
        profiling.request("generate")
        b, t = input_ids.shape
        dev = input_ids.device
        ids, start = left_align(input_ids, seq_len, cfg.pad_id)
        positions = torch.clamp(torch.arange(t, device=dev)[None, :] - start[:, None], min=0)
        q_media = n_media = kv_media = None
        if latents is not None:
            q_media = compute_q_media(ids, self.media_id)
            n_media = q_media[:, -1]
            kv_media = self.model.kv_media_for(latents)
        with profiling.span("generate.prefill"):
            logits, kv = self.model(
                ids, latents=latents, q_media=q_media, kv_start=start,
                positions=positions, return_kv=True, last_logit_only=True,
            )
            self_kv, xattn_kv = kv["self"], kv.get("xattn", [])  # none from a CausalLM
            if cfg.kv_int8:
                self_kv = [quantize_kv_cache(c) for c in self_kv]
                xattn_kv = [quantize_kv_cache(c) for c in xattn_kv]
        state = {
            "self": self_kv,
            "xattn": xattn_kv,
            "kv_start": start,
            "n_media": n_media,
            "kv_media": kv_media,
        }
        last_logits = logits[:, -1]
        try:
            if cfg.num_beams == 1:
                return self._greedy_loop(last_logits, state, start, t, generator)
            return self._beam_loop(last_logits, state, start, t, seq_len)
        finally:
            if self._graph is not None:
                # the last replay done before the static tensors go
                torch.cuda.current_stream(dev).synchronize()
                self._spent, self._graph = self._graph.graph, None

    def _decode_step(self, tokens, state, gen, step, positions, gen_index=None):
        """One decode step's model call (``step``, an int: the tokens
        generated before this one): (logits [B*, 1, V], gen caches). A
        CUDA model that decodes alone takes the CUDA graph (module doc)."""
        with profiling.span("generate.decode"):
            if not self._takes_graph(tokens.device):
                DECODE_STEPS["eager"] += 1
                ds = dict(state, gen=gen, step=step, gen_index=gen_index)
                return self.model(tokens, positions=positions, decode_state=ds)
            graph = self._graph
            if graph is not None and graph.fits(tokens, state, gen, positions, gen_index):
                with profiling.span("generate.replay"):
                    DECODE_STEPS["replays"] += 1
                    return graph.replay(tokens, step, positions, gen_index)
            if graph is not None:  # spent: it holds the pool until the next capture
                self._spent, self._graph = graph.graph, None
            if self.model not in _WARMED:
                return self._warm_up(tokens, state, gen, step, positions, gen_index)
            with profiling.span("generate.capture"):
                DECODE_STEPS["captures"] += 1
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                self._graph = _DecodeGraph(self.model, tokens, state, gen, step, positions,
                                           gen_index, self._pool)
                self._spent = None
                return self._graph.replay(tokens, step, positions, gen_index,
                                          count_launches=False)

    def _takes_graph(self, device: torch.device) -> bool:
        """Whether a decode step on ``device`` runs as a CUDA graph: on the
        card, where no other rank steps with this one (a lockstep group's
        forwards hold collectives and ZeRO-3's gathers)."""
        return device.type == "cuda" and self.lockstep_group is None

    def _warm_up(self, tokens, state, gen, step, positions, gen_index):
        """The model's first graph step in this process: the model call run
        eagerly on the capture stream."""
        DECODE_STEPS["eager"] += 1
        dev = tokens.device
        main, stream = torch.cuda.current_stream(dev), _capture_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            ds = dict(state, gen=gen, step=step, gen_index=gen_index)
            logits, new_gen = self.model(tokens, positions=positions, decode_state=ds)
        main.wait_stream(stream)
        logits.record_stream(main)  # made on the side stream, read on this one
        _WARMED.add(self.model)
        return logits, new_gen

    def _greedy_loop(self, last_logits, state, start, t, generator=None):
        cfg = self.cfg
        b = last_logits.shape[0]
        dev = last_logits.device
        gen = self.model.init_gen_caches(b, cfg.max_new_tokens, dev, quantized=cfg.kv_int8)
        tokens = torch.full((b, cfg.max_new_tokens), cfg.pad_id, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        scores = torch.zeros(b, dtype=torch.float32, device=dev)
        logits = last_logits
        step = 0
        while step < cfg.max_new_tokens:
            with profiling.span("generate.step"):
                with profiling.read("done"):
                    finished = all_ranks_true(done.all(), self.lockstep_group)
                if finished:
                    break
                with profiling.span("generate.select"):
                    logp = log_softmax_like_jax(logits)
                    if cfg.temperature > 0.0:
                        nxt = sample_draw(sample_filter(logits, cfg), generator)
                    else:
                        nxt = torch.argmax(logp, dim=-1)  # first maximum, as jnp.argmax
                    nxt = torch.where(done, cfg.pad_id, nxt)
                    picked = torch.gather(logp, 1, nxt[:, None])[:, 0]
                    scores = scores + torch.where(done, 0.0, picked)
                    tokens[:, step] = nxt
                    done = done | (nxt == cfg.eos_id)
                    pos = (t + step - start)[:, None]
                new_logits, gen = self._decode_step(nxt[:, None], state, gen, step, pos)
                logits = new_logits[:, 0]
                step += 1
        return tokens[:, None, :], scores[:, None]

    def _beam_loop(self, last_logits, state, start, t, seq_len):
        cfg = self.cfg
        b, v = last_logits.shape
        k = cfg.num_beams
        max_new = cfg.max_new_tokens
        lp = cfg.length_penalty
        dev = last_logits.device
        if cfg.length_norm not in ("full", "generated"):
            raise ValueError(f"unknown length_norm: {cfg.length_norm!r}")
        norm_gen = cfg.length_norm == "generated"
        seq_len_f = seq_len.to(device=dev, dtype=torch.float32)

        start_k = start.repeat_interleave(k)
        gen = self.model.init_gen_caches(b * k, max_new, dev, quantized=cfg.kv_int8)
        # anc[bk, g] = global cache row holding beam bk's KV for generated
        # position g (the caches are never reordered)
        anc = torch.zeros(b * k, max_new, dtype=torch.int64, device=dev)
        own_rows = torch.arange(b * k, device=dev)
        row_base = (torch.arange(b, device=dev) * k)[:, None]

        alive_tok = torch.full((b, k, max_new), cfg.pad_id, dtype=torch.int64, device=dev)
        alive_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        alive_scores[:, 0] = 0.0
        fin_tok = torch.full((b, k, max_new), cfg.pad_id, dtype=torch.int64, device=dev)
        fin_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        fin_count = torch.zeros(b, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        logits = last_logits.repeat_interleave(k, dim=0).reshape(b, k, v)
        rank = torch.arange(2 * k, device=dev)[None, :]

        step = 0
        while step < max_new:
            with profiling.span("generate.step"):
                with profiling.read("done"):
                    finished = all_ranks_true(done.all(), self.lockstep_group)
                if finished:
                    break
                with profiling.span("generate.select"):
                    logp = torch.log_softmax(logits.float(), dim=-1)
                    cand = alive_scores[:, :, None] + logp  # [B, K, V]
                    top_vals, top_idx = top_k(cand.reshape(b, k * v), 2 * k)
                    src_beam = top_idx // v
                    tok = top_idx % v
                    is_eos = tok == cfg.eos_id

                    # retire EOS candidates with rank < K to the finished set
                    if norm_gen:
                        hyp_len = torch.full((b, 1), step + 1.0, device=dev)
                    else:
                        hyp_len = (seq_len_f + step)[:, None]
                    cand_fin_score = torch.where(
                        is_eos & (rank < k) & ~done[:, None], top_vals / hyp_len**lp,
                        torch.full_like(top_vals, NEG_INF))
                    cand_seq = torch.gather(
                        alive_tok, 1, src_beam[:, :, None].expand(b, 2 * k, max_new))
                    all_scores = torch.cat([fin_scores, cand_fin_score], dim=1)
                    all_seq = torch.cat([fin_tok, cand_seq], dim=1)
                    new_fin_scores, keep_idx = top_k(all_scores, k)
                    new_fin_tok = torch.gather(
                        all_seq, 1, keep_idx[:, :, None].expand(b, k, max_new))
                    new_fin_count = torch.clamp(
                        fin_count + (cand_fin_score > NEG_INF / 2).sum(dim=1), max=k)

                    # new alive: top K non-EOS candidates
                    alive_vals = torch.where(is_eos, torch.full_like(top_vals, NEG_INF), top_vals)
                    a_vals, a_idx = top_k(alive_vals, k)
                    a_src = torch.gather(src_beam, 1, a_idx)
                    a_tok = torch.gather(tok, 1, a_idx)
                    new_alive_tok = torch.gather(
                        alive_tok, 1, a_src[:, :, None].expand(b, k, max_new)).clone()
                    new_alive_tok[:, :, step] = a_tok
                    # freeze rows that were already done
                    new_alive_tok = torch.where(done[:, None, None], alive_tok, new_alive_tok)
                    new_alive_scores = torch.where(done[:, None], alive_scores, a_vals)
                    new_fin_scores = torch.where(done[:, None], fin_scores, new_fin_scores)
                    new_fin_tok = torch.where(done[:, None, None], fin_tok, new_fin_tok)
                    new_fin_count = torch.where(done, fin_count, new_fin_count)

                    if cfg.early_stopping:
                        row_done = new_fin_count >= k
                    else:
                        heur_len = (torch.full((b,), step + 1.0, device=dev) if norm_gen
                                    else seq_len_f + step + 1)
                        best_running = new_alive_scores.amax(dim=1) / heur_len**lp
                        worst_fin = new_fin_scores.amin(dim=1)
                        row_done = (new_fin_count >= k) & (worst_fin >= best_running)
                    done = done | row_done
                    alive_tok, alive_scores = new_alive_tok, new_alive_scores
                    fin_tok, fin_scores, fin_count = new_fin_tok, new_fin_scores, new_fin_count

                    # ancestry update instead of a cache reorder: beam j inherits
                    # parent a_src[j]'s rows and writes its own KV at column step
                    anc = anc[(row_base + a_src).reshape(b * k)]
                    anc[:, step] = own_rows
                    pos = (t + step - start_k)[:, None]
                new_logits, gen = self._decode_step(
                    a_tok.reshape(b * k, 1), state, gen, step, pos, gen_index=anc)
                logits = new_logits.reshape(b, k, v)
                step += 1

        # finalize: running beams of rows not done compete with the banked
        # set by normalized score; done rows keep their banked set
        if norm_gen:
            fin_len = torch.full((b, 1), float(max_new), device=dev)
        else:
            fin_len = seq_len_f[:, None] + max_new
        run_norm = torch.where(done[:, None], torch.full_like(alive_scores, NEG_INF),
                               alive_scores / fin_len**lp)
        all_scores = torch.cat([fin_scores, run_norm], dim=1)
        all_tok = torch.cat([fin_tok, alive_tok], dim=1)
        r = cfg.num_return_sequences
        out_scores, sel = top_k(all_scores, r)
        out_tok = torch.gather(all_tok, 1, sel[:, :, None].expand(b, r, max_new))
        return out_tok, out_scores
