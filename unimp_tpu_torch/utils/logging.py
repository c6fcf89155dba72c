"""Metric logging: console + JSONL (counterpart of ``unimp_tpu/utils/logging.py``).

Keeps the reference's metric names and writes a local JSONL so runs are
inspectable offline. wandb is not ported: asking for it, or for an
artifact upload, raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class AverageMeter:
    """Running average (reference train_utils.py:268-284 semantics)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


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

    def log_artifact(self, path: str, name: str, type: str = "checkpoint"):
        raise NotImplementedError("wandb artifacts are not ported (the port logs JSONL only)")
