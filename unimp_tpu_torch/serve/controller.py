"""Serving controller: worker registry, heartbeats, dispatch.

Counterpart of ``unimp_tpu/serve/controller.py`` (the reference
controller's capabilities, pipeline/serve/controller.py:55-291) on the
stdlib HTTP stack, the stream proxied through ``urllib``:

    python -m unimp_tpu_torch.serve.controller --port 21001

  * POST /register_worker      {worker_name, check_heart_beat, worker_status}
  * POST /receive_heart_beat   {worker_name, queue_length}
  * POST /refresh_all_workers
  * POST /list_models
  * POST /get_worker_address   {model}
  * POST /worker_generate_stream  — proxied fan-out to the chosen worker,
    streaming NUL-delimited JSON chunks through unchanged

Dispatch: "lottery" (speed-weighted random) or "shortest_queue"
(queue_length/speed argmin), matching controller.py:124-175.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from unimp_tpu_torch.serve.cli_chat import post_json, stream_bytes
from unimp_tpu_torch.serve.constants import CONTROLLER_HEART_BEAT_EXPIRATION


class WorkerInfo:
    def __init__(self, model_names, speed, queue_length, check_heart_beat):
        self.model_names = model_names
        self.speed = speed
        self.queue_length = queue_length
        self.check_heart_beat = check_heart_beat
        self.last_heart_beat = time.time()


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        if dispatch_method not in ("lottery", "shortest_queue"):
            raise ValueError(f"unknown dispatch method {dispatch_method!r}")
        self.dispatch_method = dispatch_method
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()

    # ------------- registry -------------

    def register_worker(self, name: str, check_heart_beat: bool,
                        status: Optional[dict]) -> bool:
        if status is None:
            # manual registration (register_worker.py) sends no status —
            # fetch it from the worker, matching the reference
            # controller's get_worker_status fallback (controller.py:93)
            status = self._fetch_status(name)
        status = status or {}
        with self.lock:
            self.workers[name] = WorkerInfo(
                status.get("model_names", []),
                status.get("speed", 1),
                status.get("queue_length", 0),
                check_heart_beat,
            )
        return True

    def _fetch_status(self, name: str) -> Optional[dict]:
        try:
            return post_json(name.rstrip("/") + "/worker_get_status", {}, timeout=5)
        except (OSError, ValueError):  # unreachable or not a worker
            return None

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            w = self.workers.get(name)
            if w is None:
                return False  # worker must re-register (controller.py:177-186)
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
            return True

    def remove_stale_workers(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self.lock:
            dead = [
                n for n, w in self.workers.items()
                if w.check_heart_beat and w.last_heart_beat < expire
            ]
            for n in dead:
                del self.workers[n]
        return dead

    def list_models(self):
        with self.lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
        return sorted(names)

    # ------------- dispatch (controller.py:124-175) -------------

    def get_worker_address(self, model: str, rng=None) -> str:
        rng = rng or np.random.default_rng()
        with self.lock:
            cands = [
                (n, w) for n, w in self.workers.items()
                if model in w.model_names
            ]
            if not cands:
                return ""
            if self.dispatch_method == "lottery":
                speeds = np.array([w.speed for _, w in cands], np.float64)
                total = speeds.sum()
                if total <= 0:
                    return ""
                return cands[rng.choice(len(cands), p=speeds / total)][0]
            costs = [w.queue_length / max(w.speed, 1e-6) for _, w in cands]
            name, w = cands[int(np.argmin(costs))]
            w.queue_length += 1
            return name


def _heartbeat_reaper(controller: Controller, stop: threading.Event):
    while not stop.is_set():
        controller.remove_stale_workers()
        stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION / 2)


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            req = self._read()
            route = self.path
            if route == "/register_worker":
                ok = controller.register_worker(
                    req["worker_name"], req.get("check_heart_beat", True),
                    req.get("worker_status"),
                )
                self._json(200, {"exist": ok})
            elif route == "/receive_heart_beat":
                exist = controller.receive_heart_beat(
                    req["worker_name"], req.get("queue_length", 0)
                )
                self._json(200, {"exist": exist})
            elif route == "/refresh_all_workers":
                controller.remove_stale_workers()
                self._json(200, {})
            elif route == "/list_models":
                self._json(200, {"models": controller.list_models()})
            elif route == "/get_worker_address":
                self._json(
                    200, {"address": controller.get_worker_address(req["model"])}
                )
            elif route == "/worker_generate_stream":
                self._proxy_stream(req)
            else:
                self._json(404, {"error": f"unknown route {route}"})

        def _proxy_stream(self, req: dict):
            addr = controller.get_worker_address(req.get("model", ""))
            if not addr:
                self._json(503, {"text": "no worker available", "error_code": 2})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            for chunk in stream_bytes(addr + "/worker_generate_stream", req):
                self.wfile.write(chunk)
                self.wfile.flush()

    return Handler


def serve(host: str = "0.0.0.0", port: int = 21001,
          dispatch_method: str = "shortest_queue"):
    controller = Controller(dispatch_method)
    stop = threading.Event()
    threading.Thread(
        target=_heartbeat_reaper, args=(controller, stop), daemon=True
    ).start()
    server = ThreadingHTTPServer((host, port), make_handler(controller))
    print(f"[controller] listening on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        stop.set()


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21001)
    p.add_argument("--dispatch-method", default="shortest_queue",
                   choices=["lottery", "shortest_queue"])
    a = p.parse_args()
    serve(a.host, a.port, a.dispatch_method)
