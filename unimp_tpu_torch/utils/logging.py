"""Metric logging: console + JSONL (counterpart of ``unimp_tpu/utils/logging.py``).

Keeps the reference's metric names and writes a local JSONL so runs are
inspectable offline; with ``use_wandb`` rank 0 also reports to wandb, and
where wandb is missing or fails it prints one line and keeps the JSONL, as
the JAX package's logger does (wandb is imported only when asked for).
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
        self.rank = rank
        self.path = None
        self._wandb = None
        if rank != 0:
            return
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, f"{run_name}_metrics.jsonl")
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, entity=wandb_entity,
                           name=run_name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # offline / not installed: JSONL still works
                print(f"[logging] wandb unavailable ({e}); JSONL only")

    def log(self, metrics: dict, step: Optional[int] = None):
        if self.rank != 0:
            return
        rec = {"ts": time.time(), **({"step": step} if step is not None else {}),
               **{k: float(v) if hasattr(v, "__float__") else v
                  for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def print(self, msg: str):
        if self.rank == 0:
            print(msg, flush=True)

    def log_artifact(self, path: str, name: str, type: str = "checkpoint"):
        """Upload a checkpoint directory or file as a wandb artifact (the
        reference uploads the final weights under
        ``--save_checkpoints_to_wandb``, mmrec.py:893-894); nothing without
        wandb."""
        if self.rank != 0 or self._wandb is None:
            return
        try:
            art = self._wandb.Artifact(name, type=type)
            if os.path.isdir(path):
                art.add_dir(path)
            else:
                art.add_file(path)
            self._wandb.log_artifact(art)
        except Exception as e:
            print(f"[logging] wandb artifact upload failed ({e})")
