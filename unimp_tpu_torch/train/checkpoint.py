"""Checkpoints: the port's counterpart of ``unimp_tpu/train/checkpoint.py``.

The JAX package's names and cadence (the reference's rank-0 save,
UniMP's mmrec.py:873-894): ``weights_epoch_{e}`` after every epoch,
``checkpoint_{e}`` (the weights plus the optimizer state, the step and the
epoch) for ``--resume_from_checkpoint``, and ``final_weights`` at the end.
Each is a directory, as Orbax's are, holding ``params.pt``: every tensor
of the model, trainable and frozen, in its stored dtype (an int8 frozen
kernel as its float32 dequantization, see ``model_tree``), keyed by its flat
Flax path (``tools/from_flax.py:flatten_tree``'s "a/b/c"), so one naming
serves the port's checkpoints and trees carried over from JAX;
``checkpoint_{e}`` adds ``train_state.pt``.

``torch.save`` copies each device tensor to the host as it writes it, one
storage at a time, so a save never stages a whole host copy of the model;
a restore maps the file (``torch.load(mmap=True)``) and hands back host
tensors that ``tools/from_flax.py:load_flax_params`` copies onto the
model. An Orbax directory of the JAX package raises: its converter is not
ported yet (ROADMAP.md §1, item 8). ``merge_with_growth`` grafts a restored
tree onto a model whose vocabulary grew since (the transfer entry).

Over several ranks (``parallel/mesh.py``) a checkpoint holds whole
tensors, whatever the mesh: the tp blocks of a tensor are all-gathered
(``full_model_tree``), the fsdp shards of the optimizer state too
(``Trainer.optimizer_state``), and rank 0 alone writes, with a barrier
after; a restore reads the whole tree on every rank and each takes its
block (``load_flax_params``, ``Trainer.load_optimizer_state``), so a
checkpoint resumes on any world size and mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from unimp_tpu_torch.parallel.mesh import barrier, is_distributed
from unimp_tpu_torch.parallel.sharding import gather_tp, tensor_tp_dim
from unimp_tpu_torch.utils.quant import count_quantized, dequantize_params_host

PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def model_tree(model) -> dict:
    """{flat Flax path: tensor} of every tensor in the model's state (no
    copies), each int8 kernel (``--frozen_int8``) dequantized to a float32
    host tensor at its ``.../kernel`` path: checkpoints are float trees,
    as the JAX package writes them (``unimp_tpu/train/checkpoint.py:
    24-32``), and a resume quantizes them again."""
    if count_quantized(model):
        return dequantize_params_host(model)
    return {name.replace(".", "/"): t.detach() for name, t in model.state_dict().items()}


def full_model_tree(model) -> dict:
    """``model_tree`` with each tp-sharded tensor whole (all-gathered over
    the model's tp group; host tensors). Collective under tp."""
    tree = model_tree(model)
    layout = model.tp_layout
    if not layout:
        return tree
    dev = "cuda" if dist.get_backend(model.tp_group) == "nccl" else "cpu"
    for path, t in tree.items():
        dim = tensor_tp_dim(layout, path)
        if dim is not None:
            tree[path] = gather_tp(t, dim, model.tp_group, dev)
    return tree


def is_writer() -> bool:
    """Rank 0 writes the run's files (the reference's main process)."""
    return not is_distributed() or dist.get_rank() == 0


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
    """Write the model's tensors under ``save_dir/name`` (rank 0; every
    rank calls it); returns the path."""
    path = os.path.join(os.path.abspath(save_dir), name)
    tree = full_model_tree(model)
    if is_writer():
        os.makedirs(path, exist_ok=True)
        _write(os.path.join(path, PARAMS_FILE), tree)
    del tree
    barrier()
    return path


def restore_params(save_dir: str, name: str) -> dict:
    """{flat Flax path: host tensor} of ``save_dir/name`` (any of the three
    kinds), mapped from the file."""
    return _read(os.path.join(_checkpoint_dir(save_dir, name), PARAMS_FILE))


def merge_with_growth(restored: dict, target: dict) -> dict:
    """Graft a restored flat tree onto ``target`` ({flat path: tensor}, e.g.
    ``model_tree`` of a fresh init), tolerating grown tables.

    The transfer entry (``cli/mmrec_prefix.py``) extends the vocabulary
    after pretraining, so the new embedding / lm-head rows have no stored
    counterpart: the overlapping region is copied and the rest keeps the
    fresh init (the reference reaches the same state via
    ``resize_token_embeddings`` after the load). Each value is cast to the
    target's dtype; a path missing from ``restored``, or a shape that does
    not fit inside the target's, keeps the target's tensor."""
    out = {}
    for path, t in target.items():
        r = restored.get(path)
        if r is None:
            out[path] = t
        elif tuple(r.shape) == tuple(t.shape):
            out[path] = r.to(t.dtype)
        elif r.dim() == t.dim() and all(rd <= td for rd, td in zip(r.shape, t.shape)):
            grown = t.clone()
            grown[tuple(slice(0, d) for d in r.shape)] = r.to(t.device, t.dtype)
            out[path] = grown
        else:
            print(f"[checkpoint] keeping init for {path}: {tuple(r.shape)} vs {tuple(t.shape)}")
            out[path] = t
    return out


def save_epoch(save_dir: str, model, epoch: int) -> str:
    """Reference cadence: weights_epoch_{e} per epoch (mmrec.py:873-881)."""
    return save_params(save_dir, model, name=f"weights_epoch_{epoch}")


def save_train_state(save_dir: str, trainer, epoch: int) -> str:
    """Full resume checkpoint ``checkpoint_{epoch}``: the weights, the
    optimizer's state (``state_dict()``: moments by parameter name, AdamW's
    step, the schedule's count, and MultiSteps' mean and counts), the
    trainer's step and the epoch."""
    path = save_params(save_dir, trainer.model, name=f"checkpoint_{epoch}")
    state = trainer.optimizer_state()
    if is_writer():
        _write(os.path.join(path, STATE_FILE), {"opt_state": state, "step": trainer.step,
                                                "epoch": epoch})
    del state
    barrier()
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
