"""Model worker: builds a model from a run, streams generations over HTTP.

Counterpart of ``unimp_tpu/serve/worker.py`` (the reference worker's
capabilities: registration and a heartbeat loop to the controller, a
concurrency semaphore, base64 image decode and CLIP preprocessing, a
NUL-delimited JSON chunk stream):

    python -m unimp_tpu_torch.serve.worker --pretrained_model_name_or_path 4b-instruct \\
        --mmrec_path DATA --subset beauty --task rec --n_items N \\
        --controller-address http://localhost:21001 --port 21002 [--device cpu]

Images arrive as base64 JPEGs or PNGs, decoded by the port's own codecs
(``data/jpeg.py``, ``data/png.py``; the JAX worker uses PIL, which the
card's machine lacks) and resized as PIL does; any other format gets an
``error_code`` 1 chunk. Controller calls go through ``urllib``. A request's ``seed``
reaches the engine (the JAX worker streams every sampled request from
seed 0).
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from unimp_tpu_torch.data.transforms import decode_image, preprocess_image
from unimp_tpu_torch.decode.streaming import StreamingGenerator
from unimp_tpu_torch.serve.batching import BatchedStreamingEngine
from unimp_tpu_torch.serve.cli_chat import post_json
from unimp_tpu_torch.serve.constants import STREAM_DELIMITER, WORKER_HEART_BEAT_INTERVAL

log = logging.getLogger("unimp.serve.worker")


class ModelWorker:
    def __init__(
        self,
        model,
        tokenizer,
        model_names,
        *,
        worker_addr: str = "",
        controller_addr: Optional[str] = None,
        limit_concurrency: int = 2,
        image_size: int = 224,
        max_new_tokens: int = 256,
        batched: bool = True,
        kv_int8: bool = False,
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.model_names = list(model_names)
        self.worker_id = str(uuid.uuid4())[:6]
        self.worker_addr = worker_addr
        self.controller_addr = controller_addr
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.image_size = image_size
        # batched (default): concurrent streams share one model call a
        # token (serve/batching.py); unbatched: one stream at a time each
        self.streamer = None
        self.engine = None
        if batched:
            self.engine = BatchedStreamingEngine(
                model, tokenizer, max_slots=max(limit_concurrency, 1),
                max_new_tokens=max_new_tokens, kv_int8=kv_int8)
        else:
            self.streamer = StreamingGenerator(model, tokenizer, max_new_tokens)
        self._queue = 0
        self._lock = threading.Lock()

    # ---------------- controller plumbing ----------------

    def status(self) -> dict:
        return {"model_names": self.model_names, "speed": 1, "queue_length": self._queue}

    def register(self):
        if not self.controller_addr:
            return
        post_json(self.controller_addr + "/register_worker",
                  {"worker_name": self.worker_addr, "check_heart_beat": True,
                   "worker_status": self.status()})

    def heartbeat_loop(self, stop: threading.Event):
        while not stop.wait(WORKER_HEART_BEAT_INTERVAL):
            try:
                reply = post_json(self.controller_addr + "/receive_heart_beat",
                                  {"worker_name": self.worker_addr,
                                   "queue_length": self._queue})
                if not reply.get("exist", False):
                    self.register()  # the controller forgot this worker
            except (OSError, ValueError) as e:  # controller down: beat again later
                log.warning("heartbeat failed: %s", e)

    # ---------------- generation ----------------

    def decode_images(self, images_b64) -> np.ndarray:
        """base64 JPEGs or PNGs -> CLIP-normalized float32 [1, M, H, W, 3]
        (PIL's resize, as the JAX worker's); raises ValueError on anything
        these decoders do not read."""
        frames = []
        for s in images_b64:
            try:
                data = base64.b64decode(s, validate=True)
            except (binascii.Error, TypeError) as e:
                raise ValueError(f"image is not base64: {e}") from None
            try:
                rgb = decode_image(data)
            except Exception as e:  # a malformed image, or a format not read
                raise ValueError(f"image not decoded: {type(e).__name__}: {e}") from None
            frames.append(preprocess_image(rgb, self.image_size))
        return np.stack(frames)[None].astype(np.float32)

    def generate_stream(self, req: dict):
        """Yields dict chunks {text, error_code}; the last one has the whole
        generation and ``finish``."""
        with self._lock:
            self._queue += 1
        acquired = self.semaphore.acquire(timeout=120)
        try:
            if not acquired:
                yield {"text": "server overloaded", "error_code": 1}
                return
            vision = None
            if req.get("images"):
                try:
                    vision = self.decode_images(req["images"])
                except ValueError as e:
                    yield {"text": f"image error: {e}", "error_code": 1, "finish": True}
                    return
            text = ""
            src = self.engine if self.engine is not None else self.streamer
            try:
                for text in src.stream(
                    None, req["prompt"], vision_x=vision,
                    temperature=float(req.get("temperature", 0.0)),
                    max_new_tokens=req.get("max_new_tokens"),
                    seed=int(req.get("seed", 0)),
                ):
                    yield {"text": text, "error_code": 0}
            except Exception as e:
                # a failed wave (EngineError) or step: an error code, never
                # generated text; the whole message goes to the log only
                log.error("generation failed: %s", e)
                yield {"text": f"engine error: {type(e).__name__}", "error_code": 1,
                       "finish": True}
                return
            yield {"text": text, "error_code": 0, "finish": True}
        finally:
            if acquired:
                self.semaphore.release()
            with self._lock:
                self._queue -= 1


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _read(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path == "/worker_get_status":
                self._json(200, worker.status())
            elif self.path == "/worker_generate_stream":
                req = self._read()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream(req):
                    self.wfile.write(json.dumps(chunk).encode() + STREAM_DELIMITER)
                    self.wfile.flush()
            else:
                self._json(404, {"error": "unknown route"})

    return Handler


def make_server(worker: ModelWorker, host: str = "0.0.0.0", port: int = 21002):
    """The worker's HTTP server, bound (port 0: an ephemeral one); without
    a worker address the worker takes the bound one (localhost for
    0.0.0.0)."""
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    if not worker.worker_addr:
        name = "localhost" if host in ("", "0.0.0.0") else host
        worker.worker_addr = f"http://{name}:{server.server_address[1]}"
    return server


def serve(worker: ModelWorker, host: str = "0.0.0.0", port: int = 21002):
    server = make_server(worker, host, port)
    stop = threading.Event()
    if worker.controller_addr:
        worker.register()
        threading.Thread(target=worker.heartbeat_loop, args=(stop,), daemon=True).start()
    print(f"[worker {worker.worker_id}] listening on {worker.worker_addr}", flush=True)
    try:
        server.serve_forever()
    finally:
        stop.set()
        server.server_close()
        if worker.engine is not None:
            worker.engine.stop()


def build_parser():
    from unimp_tpu_torch.cli.arguments import build_parser as cli_parser

    p = cli_parser(eval_only=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21002)
    p.add_argument("--controller-address", default=None)
    p.add_argument("--worker-address", default=None)
    p.add_argument("--limit-model-concurrency", type=int, default=2)
    p.add_argument("--no-batched-streaming", action="store_true",
                   help="one stream at a time, each its own decode")
    return p


def build_worker(args) -> ModelWorker:
    """``main``'s worker, built from its parsed command line: the tokenizer from
    the run's data, the model through the port's ``cli/common.py`` (seeded
    weights, or ``--load_weights_name``; ``--eval_param_dtype int8`` is the
    reference worker's ``load_in_8bit``)."""
    from unimp_tpu_torch.cli import common
    from unimp_tpu_torch.train import checkpoint as ckpt

    common.check_ported(args)
    tokenizer = common.build_tokenizer(args)
    weights = None
    if args.load_weights_name:
        weights = ckpt.restore_params(common.weights_dir(args), args.load_weights_name)
    model = common.build_model(args, tokenizer, weights=weights)
    return ModelWorker(
        model, tokenizer, [args.run_name],
        worker_addr=args.worker_address or "",
        controller_addr=args.controller_address,
        limit_concurrency=args.limit_model_concurrency,
        image_size=args.patch_image_size,
        batched=not args.no_batched_streaming,
        kv_int8=args.kv_int8,
    )


def main(argv=None):
    """Build a worker from a run (or seeded weights) and serve it."""
    args = build_parser().parse_args(argv)
    serve(build_worker(args), args.host, args.port)


if __name__ == "__main__":
    main()
