"""Server-side batched streaming decode (continuous-batching lite).

Counterpart of ``unimp_tpu/serve/batching.py``. Concurrent streams share
one model call a token instead of one a token per request:

  * requests are collected into a WAVE (up to ``max_slots``, waiting at
    most ``wave_window_ms`` after the first arrival);
  * the wave's prompts are left-aligned into one window bucketed to
    ``prompt_bucket`` (the layout of the batched sampler,
    ``decode/sampler.py``) and prefilled in one call; slots the wave
    does not fill hold all-pad rows with ``kv_start = T`` and are retired
    as done; when any request carries images, every slot's ``m`` frames
    (zeros where it has none) go through the vision tower;
  * the decode runs in CHUNKS of ``chunk`` steps, one model call a step
    (``decode_state`` with ``gen_index`` None; ``step`` is the host's own
    counter). The next token never visits the host: the pick (``argmax``
    of the raw logits where a row's temperature is 0, else a draw from
    that row's own ``torch.Generator``, seeded from its request) and the
    done flags stay on the device, and each chunk's (token, done) pairs
    land in one packed [S, CHUNK, 2] int32 tensor that reaches the host
    in ONE copy a chunk (pinned memory, ``non_blocking``, with an event);
  * the host streams a chunk's tokens to the consumers as soon as its
    copy's event has completed, polled between the steps of the next
    chunk (the JAX engine's runahead of one chunk, without holding the
    first tokens back for a whole chunk of host time); rows retire on
    EOS or their own ``max_new``.

A sampled row's draws depend on its seed and step only, not on the wave
it shares or its slot. JAX's threefry stream
(``fold_in(fold_in(0, seed), step)``) is not reproduced. Every wave
failure reaches the caller as ``EngineError``, never as text.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from unimp_tpu_torch.decode.sampler import quantize_kv_cache, sample_draw
from unimp_tpu_torch.models.flamingo import compute_q_media

_END = object()
log = logging.getLogger("unimp.serve.batching")


class EngineError(RuntimeError):
    """A wave failed wholesale (out of memory, a kernel's launch). Raised
    out of ``stream()`` so callers surface it with an error code instead
    of streaming the exception text as if it were generated tokens."""


class _Request:
    def __init__(self, prompt_ids, vision, max_new, temperature, seed):
        self.prompt_ids = prompt_ids
        self.vision = vision  # [M, H, W, 3] float32 or None
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.out_ids: list = []  # the tokens streamed so far
        self.out: "queue.Queue" = queue.Queue()


class _HostCopy:
    """One device->host copy of a chunk's packed [S, CHUNK, 2] tokens: on
    the card into pinned memory, ``non_blocking``, with an event behind
    it; on the CPU the tensor itself."""

    def __init__(self, packed: torch.Tensor):
        self.event = None
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class BatchedStreamingEngine:
    def __init__(self, model, tokenizer, *, max_slots: int = 4,
                 max_new_tokens: int = 256, wave_window_ms: float = 30.0,
                 prompt_bucket: int = 64, chunk: int = 8,
                 kv_int8: bool = False):
        self.model = model
        self.tok = tokenizer
        self.max_slots = max_slots
        self.max_new = max_new_tokens
        self.window = wave_window_ms / 1000.0
        self.prompt_bucket = prompt_bucket
        self.chunk = max(1, chunk)
        # int8 prompt, latent and gen KV caches: the decode kernels read
        # the int8 bytes and fold the scales in
        self.kv_int8 = kv_int8
        # the last wave's shape and counts: rows, slots, t, media, gen,
        # chunk, steps, copies (device->host copies of decoded tokens)
        self.last_wave: dict = {}
        self._inbox: "queue.Queue" = queue.Queue()
        self._thread = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # ---------------- public ----------------

    def start(self):
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()

    def stop(self):
        self._stop.set()
        self._inbox.put(None)

    def queue_depth(self) -> int:
        return self._inbox.qsize()

    def stream(self, params, prompt: str, vision_x=None, temperature: float = 0.0,
               max_new_tokens: Optional[int] = None, seed: int = 0):
        """Iterator of accumulated generation text (the surface of
        ``StreamingGenerator.stream``), served from the shared wave.
        ``params`` is ignored: the model holds its weights."""
        del params
        self.start()
        ids = self.tok.encode(prompt, add_bos=True)
        vision = None
        if vision_x is not None:
            vision = np.asarray(vision_x, np.float32)
            if vision.ndim == 5:  # [1, M, H, W, 3] -> [M, H, W, 3]
                vision = vision[0]
        req = _Request(ids, vision, int(max_new_tokens or self.max_new),
                       float(temperature), int(seed))
        self._inbox.put(req)
        while True:
            item = req.out.get()
            if item is _END:
                return
            if isinstance(item, EngineError):
                raise item
            yield item

    # ---------------- wave formation ----------------

    def _loop(self):
        while not self._stop.is_set():
            first = self._inbox.get()
            if first is None:
                continue
            reqs = [first]
            deadline = time.monotonic() + self.window
            while len(reqs) < self.max_slots:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._inbox.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is not None:
                    reqs.append(nxt)
            try:
                self._run_wave(reqs)
            except Exception as e:  # the engine thread must keep serving
                log.exception("wave of %d requests failed", len(reqs))
                for r in reqs:
                    r.out.put(EngineError(str(e)))
                    r.out.put(_END)

    # ---------------- the wave ----------------

    def _pick(self, logits, temps, sampled, rows):
        """[S] next tokens: argmax of the raw logits, and for each sampled
        row a draw from its own generator over logits / temperature."""
        nxt = torch.argmax(logits, dim=-1)
        if sampled:
            scaled = logits[rows].float() / temps[rows, None].clamp_min(1e-6)
            draws = torch.cat([sample_draw(scaled[i:i + 1], gen)
                               for i, gen in enumerate(sampled)])
            nxt = nxt.index_put((rows,), draws)
        return nxt

    @torch.inference_mode()  # grad mode is per thread: the caller's does not reach here
    def _run_wave(self, reqs):
        model, tok = self.model, self.tok
        dev = model.embed.embedding.device
        s, n = self.max_slots, len(reqs)
        pad_id, eos_id = tok.pad_token_id, tok.eos_token_id

        t = -(-max(len(r.prompt_ids) for r in reqs) // self.prompt_bucket) * self.prompt_bucket
        m = max((0 if r.vision is None else r.vision.shape[0] for r in reqs), default=0)
        max_new = max(r.max_new for r in reqs)
        chunk = min(self.chunk, max_new)
        # gen window of a chunk multiple: no chunk writes past the cache
        g = -(-max_new // chunk) * chunk

        # left-aligned prompt window; unused slots are all pad, kv_start = t
        ids = np.full((s, t), pad_id, np.int64)
        kv_start = np.full((s,), t, np.int32)
        for i, r in enumerate(reqs):
            ln = len(r.prompt_ids)
            ids[i, t - ln:] = r.prompt_ids
            kv_start[i] = t - ln
        ids_d = torch.from_numpy(ids).to(dev)
        kv_start_d = torch.from_numpy(kv_start).to(dev)
        positions = torch.clamp(torch.arange(t, device=dev)[None] - kv_start_d[:, None], min=0)

        latents = q_media = None
        state = {"kv_start": kv_start_d, "n_media": None, "kv_media": None}
        if m > 0:
            img = next(r.vision.shape[1:] for r in reqs if r.vision is not None)
            vision = np.zeros((s, m) + img, np.float32)
            for i, r in enumerate(reqs):
                if r.vision is not None:
                    vision[i, : r.vision.shape[0]] = r.vision
            latents = model.encode_vision(torch.from_numpy(vision).to(dev))
            q_media = compute_q_media(ids_d, tok.media_token_id)
            state["n_media"] = q_media[:, -1]
            state["kv_media"] = model.kv_media_for(latents)

        logits, kv = model(ids_d, latents=latents, q_media=q_media, kv_start=kv_start_d,
                           positions=positions, return_kv=True, last_logit_only=True)
        self_kv, xattn_kv = kv["self"], kv["xattn"]
        if self.kv_int8:
            self_kv = [quantize_kv_cache(c) for c in self_kv]
            xattn_kv = [quantize_kv_cache(c) for c in xattn_kv]
        state.update(self=self_kv, xattn=xattn_kv)
        gen = model.init_gen_caches(s, g, dev, quantized=self.kv_int8)
        logits = logits[:, -1]
        temps = torch.tensor([r.temperature for r in reqs] + [0.0] * (s - n), device=dev)
        rows = [j for j, r in enumerate(reqs) if r.temperature > 0]
        sampled = [torch.Generator(dev).manual_seed(reqs[j].seed) for j in rows]
        rows = torch.tensor(rows, dtype=torch.int64, device=dev)
        done = torch.arange(s, device=dev) >= n  # unused slots retired

        host_done = [i >= n for i in range(s)]
        prev_done = np.array(host_done)

        def drain(copy: _HostCopy):
            nonlocal prev_done
            pk = copy.wait()
            for c in range(pk.shape[1]):
                for j, r in enumerate(reqs):
                    if host_done[j]:
                        continue
                    dn = bool(pk[j, c, 1])
                    if not prev_done[j] and not dn and len(r.out_ids) < r.max_new:
                        r.out_ids.append(int(pk[j, c, 0]))
                        r.out.put(tok.decode(r.out_ids))
                    if dn or len(r.out_ids) >= r.max_new:
                        host_done[j] = True
                        r.out.put(_END)
                prev_done = pk[:, c, 1].astype(bool)

        step = copies = 0
        pending = None  # the previous chunk's copy, not yet streamed
        while step < g and not all(host_done):
            packed = torch.empty((s, chunk, 2), dtype=torch.int32, device=dev)
            for c in range(chunk):
                emit = torch.where(done, pad_id, self._pick(logits, temps, sampled, rows))
                done = done | (emit == eos_id)
                packed[:, c, 0] = emit
                packed[:, c, 1] = done
                ds = dict(state, gen=gen, step=step, gen_index=None)
                logits, gen = model(emit[:, None], positions=(t + step - kv_start_d)[:, None],
                                    decode_state=ds)
                logits = logits[:, 0]
                step += 1
                if pending is not None and pending.ready():
                    drain(pending)
                    pending = None
            if pending is not None:
                drain(pending)
            pending = _HostCopy(packed)
            copies += 1
        if pending is not None:
            drain(pending)
        for j, r in enumerate(reqs):
            if not host_done[j]:
                host_done[j] = True
                r.out.put(_END)
        self.last_wave = dict(rows=n, slots=s, t=t, media=m, gen=g, chunk=chunk,
                              steps=step, copies=copies)
