"""Streaming generation: prefill, then a per-token loop that yields the
decoded text as it grows.

Counterpart of ``unimp_tpu/decode/streaming.py`` (the serving
equivalent of the reference's TextIteratorStreamer thread): one request,
no padding, a host read a token so that a chat client sees words as
they generate. The greedy pick is ``argmax`` of the raw logits, as in
JAX (not of ``log_softmax``, which in bf16 can tie two logits that
differ). Sampling divides the logits by the temperature and draws with a
``torch.Generator`` seeded from ``seed`` (``sampler.sample_draw``;
JAX's threefry stream is not reproduced).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from unimp_tpu_torch.decode.sampler import GenerationConfig, sample_draw, sample_filter
from unimp_tpu_torch.models.flamingo import compute_q_media


class StreamingGenerator:
    def __init__(self, model, tokenizer, max_new_tokens: int = 256):
        self.model = model
        self.tok = tokenizer
        self.max_new = max_new_tokens

    @torch.inference_mode()
    def _prefill(self, prompt: str, vision_x, max_new: int):
        """(last logits [1, V], decode state, gen caches, prompt length)."""
        model, tok = self.model, self.tok
        dev = model.embed.embedding.device
        ids = torch.tensor([tok.encode(prompt, add_bos=True)], dtype=torch.int64, device=dev)
        t = ids.shape[1]
        latents = q_media = None
        state = {"kv_start": torch.zeros(1, dtype=torch.int32, device=dev),
                 "n_media": None, "kv_media": None}
        if vision_x is not None:
            latents = model.encode_vision(torch.as_tensor(vision_x, dtype=torch.float32,
                                                          device=dev))
            q_media = compute_q_media(ids, tok.media_token_id)
            state["n_media"] = q_media[:, -1]
            state["kv_media"] = model.kv_media_for(latents)
        logits, kv = model(ids, latents=latents, q_media=q_media,
                           positions=torch.arange(t, device=dev)[None], return_kv=True)
        state.update(self=kv["self"], xattn=kv["xattn"])
        return logits[:, -1], state, model.init_gen_caches(1, max_new, dev), t

    @torch.inference_mode()
    def _step(self, token: torch.Tensor, state, gen, i: int, t: int):
        """Decode ``token`` [1] at generated position ``i``: (logits [1, V],
        gen caches)."""
        logits, gen = self.model(token[:, None], positions=torch.full((1, 1), t + i,
                                                                      device=token.device),
                                 decode_state=dict(state, gen=gen, step=i))
        return logits[:, 0], gen

    def stream(
        self,
        params,
        prompt: str,
        vision_x: Optional[np.ndarray] = None,
        temperature: float = 0.0,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
    ) -> Iterator[str]:
        """Greedy (temperature 0) or sampled streaming decode; yields the
        accumulated generation text after each token. ``params`` is
        ignored (the model holds its weights); ``vision_x`` [1, M, H, W, 3]
        CLIP-normalized frames. Grad mode is per thread and would span the
        yields, so each model call sets inference mode itself."""
        del params
        tok = self.tok
        max_new = max_new_tokens or self.max_new
        logits, state, gen, t = self._prefill(prompt, vision_x, max_new)
        sample_cfg = GenerationConfig(max_new, tok.eos_token_id, tok.pad_token_id,
                                      temperature=temperature)
        generator = (torch.Generator(logits.device).manual_seed(seed) if temperature > 0
                     else None)
        out_ids = []
        for i in range(max_new):
            with torch.inference_mode():
                if temperature > 0:
                    nxt = sample_draw(sample_filter(logits, sample_cfg), generator)
                else:
                    nxt = torch.argmax(logits, dim=-1)
            token_id = int(nxt[0])
            if token_id == tok.eos_token_id:
                break
            out_ids.append(token_id)
            yield tok.decode(out_ids)
            logits, gen = self._step(nxt, state, gen, i, t)
