"""Web chat UI: counterpart of ``unimp_tpu/serve/web_server.py`` (the
reference's pipeline/serve/gradio_web_server.py, on the stdlib instead of
gradio): a single-page chat app that streams tokens from the
controller's /worker_generate_stream proxy, with a model picker, a
temperature control and image upload (base64 JPEG -> worker):

    python -m unimp_tpu_torch.serve.web_server --controller-address http://localhost:21001
"""

from __future__ import annotations

import argparse
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import urllib.request

from unimp_tpu_torch.serve.cli_chat import stream_bytes
from unimp_tpu_torch.serve.constants import MODERATION_MSG, STREAM_DELIMITER


def violates_moderation(text: str, *, url: Optional[str] = None,
                        timeout: float = 25.0) -> bool:
    """Reference moderation check (serving_utils.py:108-129): POST the
    text to an OpenAI-moderations-shaped endpoint, flag on
    results[0].flagged, FAIL OPEN on any transport/shape error. The
    endpoint is injectable (url arg / UNIMP_MODERATION_URL) since this
    framework carries no OpenAI dependency."""
    url = url or os.environ.get("UNIMP_MODERATION_URL",
                                "https://api.openai.com/v1/moderations")
    headers = {
        "Content-Type": "application/json",
        "Authorization": "Bearer " + os.environ.get("OPENAI_API_KEY", ""),
    }
    data = json.dumps({"input": text.replace("\n", "")}).encode("utf-8")
    try:
        req = urllib.request.Request(url, data=data, headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return bool(json.loads(r.read())["results"][0]["flagged"])
    except (OSError, ValueError, KeyError, IndexError, TypeError):
        return False  # fail open: transport error or a reply of another shape

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>UniMP</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 760px; margin: 2rem auto; }
 #log { border: 1px solid #ccc; border-radius: 8px; padding: 1rem;
        min-height: 300px; white-space: pre-wrap; }
 .u { color: #14532d; } .a { color: #1e3a8a; }
 #row { display: flex; gap: .5rem; margin-top: 1rem; }
 #msg { flex: 1; padding: .5rem; }
 select, input[type=number] { margin-left: .5rem; }
</style></head><body>
<h2>UniMP chat</h2>
<div>model <select id="model"></select>
 temperature <input id="temp" type="number" value="0" step="0.1" min="0" max="2" style="width:4rem">
 <input id="img" type="file" accept="image/*"></div>
<div id="log"></div>
<div id="row"><input id="msg" placeholder="message…">
<button onclick="send()">send</button></div>
<script>
async function loadModels() {
  const r = await fetch('/api/list_models', {method:'POST'});
  const models = (await r.json()).models;
  const sel = document.getElementById('model');
  models.forEach(m => { const o = document.createElement('option');
                        o.textContent = m; sel.appendChild(o); });
}
loadModels();
function append(cls, text) {
  const d = document.createElement('div'); d.className = cls;
  d.textContent = text; document.getElementById('log').appendChild(d);
  return d;
}
async function send() {
  const msg = document.getElementById('msg').value;
  if (!msg) return;
  document.getElementById('msg').value = '';
  append('u', 'you: ' + msg);
  const out = append('a', '');
  const images = [];
  const f = document.getElementById('img').files[0];
  if (f) {
    const buf = await f.arrayBuffer();
    images.push(btoa(String.fromCharCode(...new Uint8Array(buf))));
  }
  const body = {model: document.getElementById('model').value,
                prompt: msg, images,
                temperature: parseFloat(document.getElementById('temp').value)};
  const resp = await fetch('/api/generate', {method:'POST',
    body: JSON.stringify(body)});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    const parts = buf.split('\\u0000');
    buf = parts.pop();
    for (const p of parts) {
      if (!p) continue;
      const chunk = JSON.parse(p);
      out.textContent = 'model: ' + chunk.text;
    }
  }
}
document.getElementById('msg').addEventListener('keydown',
  e => { if (e.key === 'Enter') send(); });
</script></body></html>"""


def make_handler(controller_addr: str,
                 moderation_fn: Optional[Callable[[str], bool]] = None):
    """moderation_fn: called with the user prompt before dispatch; a
    truthy return short-circuits generation with MODERATION_MSG (the
    reference gates add_text the same way under --moderate,
    gradio_web_server.py:216-230)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/api/list_models":
                lm = urllib.request.Request(controller_addr + "/list_models", data=b"{}",
                                            headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(lm, timeout=10) as r:
                    body = r.read()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/api/generate":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                if moderation_fn is not None and moderation_fn(
                        req.get("prompt", "")):
                    chunk = json.dumps(
                        {"text": MODERATION_MSG, "error_code": 1}
                    ).encode() + STREAM_DELIMITER
                    self.wfile.write(chunk)
                    self.wfile.flush()
                    return
                for chunk in stream_bytes(controller_addr + "/worker_generate_stream", req):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--controller-address", default="http://localhost:21001")
    p.add_argument("--moderate", action="store_true",
                   help="gate user input through the moderation endpoint "
                        "(reference gradio_web_server.py --moderate; "
                        "endpoint via UNIMP_MODERATION_URL)")
    args = p.parse_args(argv)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(args.controller_address,
                     moderation_fn=violates_moderation if args.moderate
                     else None),
    )
    print(f"[web] http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
