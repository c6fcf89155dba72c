"""Checkpoints: the port's counterpart of ``unimp_tpu/train/checkpoint.py``.

The JAX package's names and cadence (the reference's rank-0 save,
UniMP's mmrec.py:873-894): ``weights_epoch_{e}`` after every epoch,
``checkpoint_{e}`` (the weights plus the optimizer state, the step and the
epoch) for ``--resume_from_checkpoint``, and ``final_weights`` at the end.
Each is a directory, as Orbax's are, holding ``params.pt``: every tensor
of the model, trainable and frozen, in its stored dtype, keyed by its flat
Flax path (``tools/from_flax.py:flatten_tree``'s "a/b/c"), so one naming
serves the port's checkpoints and trees carried over from JAX;
``checkpoint_{e}`` adds ``train_state.pt``.

``torch.save`` copies each device tensor to the host as it writes it, one
storage at a time, so a save never stages a whole host copy of the model;
a restore maps the file (``torch.load(mmap=True)``) and hands back host
tensors that ``tools/from_flax.py:load_flax_params`` copies onto the
model. An Orbax directory of the JAX package raises: its converter is not
ported yet (ROADMAP.md §1, item 8), and neither is ``merge_with_growth``
(the transfer entry, item 5).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def model_tree(model) -> dict:
    """{flat Flax path: tensor} of every tensor in the model's state (no
    copies)."""
    return {name.replace(".", "/"): t.detach() for name, t in model.state_dict().items()}


def _write(path: str, obj) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _checkpoint_dir(save_dir: str, name: str) -> str:
    path = os.path.join(os.path.abspath(save_dir), name)
    if not os.path.exists(os.path.join(path, PARAMS_FILE)) and any(
            os.path.exists(os.path.join(path, m)) for m in ORBAX_MARKERS):
        raise NotImplementedError(f"{path} is an Orbax checkpoint of the JAX package: its "
                                  "converter is not ported yet (ROADMAP.md §1, item 8)")
    return path


def save_params(save_dir: str, model, name: str = "final_weights") -> str:
    """Write the model's tensors under ``save_dir/name``; returns the path."""
    path = os.path.join(os.path.abspath(save_dir), name)
    os.makedirs(path, exist_ok=True)
    _write(os.path.join(path, PARAMS_FILE), model_tree(model))
    return path


def restore_params(save_dir: str, name: str) -> dict:
    """{flat Flax path: host tensor} of ``save_dir/name`` (any of the three
    kinds), mapped from the file."""
    return _read(os.path.join(_checkpoint_dir(save_dir, name), PARAMS_FILE))


def save_epoch(save_dir: str, model, epoch: int) -> str:
    """Reference cadence: weights_epoch_{e} per epoch (mmrec.py:873-881)."""
    return save_params(save_dir, model, name=f"weights_epoch_{epoch}")


def save_train_state(save_dir: str, trainer, epoch: int) -> str:
    """Full resume checkpoint ``checkpoint_{epoch}``: the weights, the
    optimizer's state (``state_dict()``: moments by parameter name, AdamW's
    step, the schedule's count, and MultiSteps' mean and counts), the
    trainer's step and the epoch."""
    path = save_params(save_dir, trainer.model, name=f"checkpoint_{epoch}")
    _write(os.path.join(path, STATE_FILE), {"opt_state": trainer.optimizer.state_dict(),
                                            "step": trainer.step, "epoch": epoch})
    return path


def restore_train_state(save_dir: str, name: str) -> dict:
    """{"opt_state", "step", "epoch"} of ``save_dir/name`` (a
    ``checkpoint_{e}``); its weights come from ``restore_params``."""
    return _read(os.path.join(_checkpoint_dir(save_dir, name), STATE_FILE))


def latest_checkpoint(save_dir: str) -> Optional[str]:
    if not os.path.isdir(save_dir):
        return None
    cands = [d for d in os.listdir(save_dir)
             if d.startswith("checkpoint_") and d.split("_")[-1].isdigit()]
    if not cands:
        return None
    return max(cands, key=lambda d: int(d.split("_")[-1]))
