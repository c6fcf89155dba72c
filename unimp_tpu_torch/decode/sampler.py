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
row is done. A greedy step reads the device once (``bool(done.all())``);
a beam step four times: that check and one ``nonzero()`` in each of the
three ``top_k`` calls (candidates, the finished set, the alive set). The
JAX loop is one ``lax.while_loop`` and reads nothing back. Ties in every
top-k resolve to the lower index, as ``jax.lax.top_k`` does. The greedy
pick takes ``log_softmax`` in the logits' dtype, step by step as
``jax.nn.log_softmax`` does, so bf16 logits round (and near-ties break)
as in JAX.

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
all_ranks_true``, an all-reduce MIN); data-parallel ranks decode on their
own.
"""

from __future__ import annotations

import dataclasses

import torch

from unimp_tpu_torch.models.flamingo import compute_q_media
from unimp_tpu_torch.parallel.mesh import all_ranks_true
from unimp_tpu_torch.utils.quant import quantize_kv

NEG_INF = -1.0e9


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


class Generator:
    """generate() over a UniMPModel (or an API-compatible model)."""

    def __init__(self, model, gen_cfg: GenerationConfig, media_id: int):
        self.model = model
        self.cfg = gen_cfg
        self.media_id = media_id
        # the ranks that decode together (a model sliced over tp), or None
        self.tp_group = getattr(model, "tp_group", None)

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
        b, t = input_ids.shape
        dev = input_ids.device
        ids, start = left_align(input_ids, seq_len, cfg.pad_id)
        positions = torch.clamp(torch.arange(t, device=dev)[None, :] - start[:, None], min=0)
        q_media = n_media = kv_media = None
        if latents is not None:
            q_media = compute_q_media(ids, self.media_id)
            n_media = q_media[:, -1]
            kv_media = self.model.kv_media_for(latents)
        logits, kv = self.model(
            ids, latents=latents, q_media=q_media, kv_start=start,
            positions=positions, return_kv=True, last_logit_only=True,
        )
        self_kv, xattn_kv = kv["self"], kv["xattn"]
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
        if cfg.num_beams == 1:
            return self._greedy_loop(last_logits, state, start, t, generator)
        return self._beam_loop(last_logits, state, start, t, seq_len)

    def _decode_step(self, tokens, state, gen, step, positions, gen_index=None):
        ds = dict(state, gen=gen, step=step, gen_index=gen_index)
        return self.model(tokens, positions=positions, decode_state=ds)

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
        while step < cfg.max_new_tokens and not all_ranks_true(done.all(), self.tp_group):
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
        while step < max_new and not all_ranks_true(done.all(), self.tp_group):
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
            new_fin_tok = torch.gather(all_seq, 1, keep_idx[:, :, None].expand(b, k, max_new))
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
