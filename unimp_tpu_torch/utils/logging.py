"""Metric logging: console + JSONL (counterpart of ``unimp_tpu/utils/logging.py``).

Keeps the reference's metric names and writes a local JSONL so runs are
inspectable offline. wandb is not ported: asking for it raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, run_dir: str, run_name: str, use_wandb: bool = False,
                 wandb_project: Optional[str] = None,
                 wandb_entity: Optional[str] = None, config: Optional[dict] = None,
                 rank: int = 0):
        if use_wandb:
            raise NotImplementedError("wandb reporting is not ported (the port logs JSONL only)")
        self.rank = rank
        self.path = None
        if rank != 0:
            return
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, f"{run_name}_metrics.jsonl")

    def log(self, metrics: dict, step: Optional[int] = None):
        if self.rank != 0:
            return
        rec = {"ts": time.time(), **({"step": step} if step is not None else {}),
               **{k: float(v) if hasattr(v, "__float__") else v
                  for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def print(self, msg: str):
        if self.rank == 0:
            print(msg, flush=True)
