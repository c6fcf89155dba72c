"""Manual smoke client (the reference's pipeline/serve/test_message.py):
registers nothing; lists the models through the controller and streams
one generation end to end. Counterpart of ``unimp_tpu/serve/test_message.py``:

    python -m unimp_tpu_torch.serve.test_message --controller-address http://localhost:21001
"""

from __future__ import annotations

import argparse
import json

from unimp_tpu_torch.serve.cli_chat import post_json, stream_request


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", default="http://localhost:21001")
    p.add_argument("--model", default=None)
    p.add_argument("--prompt", default="What is the next item recommended to the user? <answer>")
    args = p.parse_args(argv)

    models = post_json(args.controller_address + "/list_models", {})["models"]
    print(f"models: {models}")
    model = args.model or (models[0] if models else None)
    if model is None:
        print("no workers registered")
        return
    for chunk in stream_request(
        args.controller_address,
        {"model": model, "prompt": args.prompt, "max_new_tokens": 16},
    ):
        print(json.dumps(chunk))


if __name__ == "__main__":
    main()
