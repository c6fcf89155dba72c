"""Manually register a worker with a controller: a copy of
``unimp_tpu/serve/register_worker.py`` (the reference's
pipeline/serve/register_worker.py). Workers register themselves on
start (worker.py); after a controller restart this re-announces a live
worker without restarting it:

    python -m unimp_tpu_torch.serve.register_worker --controller-address URL --worker-name URL
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def register(controller_address: str, worker_name: str,
             check_heart_beat: bool = False, worker_status=None) -> int:
    req = urllib.request.Request(
        controller_address.rstrip("/") + "/register_worker",
        data=json.dumps({
            "worker_name": worker_name,
            "check_heart_beat": check_heart_beat,
            "worker_status": worker_status,
        }).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", type=str, required=True)
    p.add_argument("--worker-name", type=str, required=True)
    p.add_argument("--check-heart-beat", action="store_true")
    args = p.parse_args(argv)
    status = register(args.controller_address, args.worker_name,
                      args.check_heart_beat)
    print(f"register_worker: HTTP {status}")


if __name__ == "__main__":
    main()
