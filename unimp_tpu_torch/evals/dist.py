"""Cross-process metric aggregation (counterpart of ``unimp_tpu/evals/dist.py``).

The reference's ``accelerator.gather`` / ``wait_for_everyone``: each rank's
per-user metric list is all-gathered over the run's data axis
(``parallel/mesh.py``: dp x fsdp; the ranks of one tp group evaluate the
same users, so the gather over the data group of each tp index gives every
rank the union once). One process passes through.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from unimp_tpu_torch.parallel import mesh as pmesh
from unimp_tpu_torch.parallel.mesh import get_mesh, is_distributed


def _group(axis: str = "data"):
    mesh = get_mesh()
    if not is_distributed():
        return None, 1
    group = mesh.group(axis)
    if group is None:  # a process group but no mesh built on it
        return dist.group.WORLD, dist.get_world_size()
    return group, mesh.size(axis)


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *t.shape] on the host; through the card under NCCL, which takes
    no host tensors."""
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
    dist.all_gather_into_tensor(out, t.to(dev), group=group)
    return out.reshape((n,) + tuple(t.shape)).cpu()


def gather_metric_lists(values: List[float]) -> np.ndarray:
    """Concatenate per-rank metric lists over the data axis: padded with
    NaN to the longest, all-gathered, the padding dropped (the JAX
    package's rule)."""
    group, n = _group()
    if n == 1:
        return np.asarray(values, np.float64)
    arr = torch.tensor(values, dtype=torch.float64)
    lens = _all_gather(torch.tensor([len(values)], dtype=torch.int64), group, n)
    padded = torch.full((int(lens.max()),), float("nan"), dtype=torch.float64)
    padded[: len(values)] = arr
    flat = _all_gather(padded, group, n).reshape(-1).numpy()
    return flat[~np.isnan(flat)]


def mean_over_hosts(metrics: Dict[str, float]) -> Dict[str, float]:
    """Each key's mean over the data axis' ranks."""
    group, n = _group()
    if n == 1:
        return metrics
    keys = sorted(metrics)
    vals = torch.tensor([metrics[k] for k in keys], dtype=torch.float64)
    gathered = _all_gather(vals, group, n)
    return dict(zip(keys, gathered.mean(0).tolist()))


def barrier(name: str = "sync") -> None:
    """``wait_for_everyone``: every rank of the world reaches ``name``."""
    del name  # torch.distributed barriers are not named
    pmesh.barrier()
