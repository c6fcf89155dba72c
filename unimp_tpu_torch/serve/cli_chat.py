"""Terminal streaming chat client, and the HTTP helpers of the serving
stack (``urllib`` / ``http.client``: the card's machine has no
``requests``).

Counterpart of ``unimp_tpu/serve/cli_chat.py`` (the reference's
pipeline/serve/cli.py): talks to a worker, directly or through the
controller, and renders the NUL-delimited JSON chunk stream as it comes:

    python -m unimp_tpu_torch.serve.cli_chat --worker-address http://localhost:21001
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from unimp_tpu_torch.serve.constants import STREAM_DELIMITER
from unimp_tpu_torch.serve.conversation import get_conv_template

# a stream's read timeout: a worker sends nothing until its first wave's
# prefill is done
STREAM_TIMEOUT_S = 900


def post_json(url: str, payload: dict, timeout: float = 10.0) -> dict:
    """POST ``payload`` as JSON and return the JSON reply."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read() or b"{}")


def stream_bytes(url: str, payload: dict):
    """POST ``payload`` as JSON and yield the reply's bytes as they arrive."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=STREAM_TIMEOUT_S) as r:
        while True:
            chunk = r.read1(65536)
            if not chunk:
                return
            yield chunk


def stream_request(addr: str, payload: dict):
    """The chunks (dicts) of ``addr``'s /worker_generate_stream for
    ``payload``, each as soon as its delimiter arrives."""
    buf = b""
    for chunk in stream_bytes(addr + "/worker_generate_stream", payload):
        buf += chunk
        while STREAM_DELIMITER in buf:
            part, buf = buf.split(STREAM_DELIMITER, 1)
            if part:
                yield json.loads(part)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--worker-address", default="http://localhost:21002")
    p.add_argument("--model", default="unimp")
    p.add_argument("--template", default="unimp")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=128)
    args = p.parse_args(argv)

    conv = get_conv_template(args.template)
    print("UniMP chat — ctrl-d to exit")
    while True:
        try:
            user = input(f"{conv.roles[0]}: ")
        except EOFError:
            break
        conv.append_message(conv.roles[0], user)
        conv.append_message(conv.roles[1], None)
        payload = {
            "model": args.model,
            "prompt": conv.get_prompt(),
            "temperature": args.temperature,
            "max_new_tokens": args.max_new_tokens,
        }
        shown = 0
        text = ""
        for chunk in stream_request(args.worker_address, payload):
            if chunk.get("error_code"):
                print(f"[error] {chunk['text']}")
                break
            text = chunk["text"]
            sys.stdout.write(text[shown:])
            sys.stdout.flush()
            shown = len(text)
        print()
        conv.messages[-1][1] = text


if __name__ == "__main__":
    main()
