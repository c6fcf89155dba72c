"""Process groups and the ("dp", "fsdp", "tp") mesh.

Counterpart of ``unimp_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` and lets XLA place the collectives; here each GPU is
one process (``torchrun``'s environment: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR / MASTER_PORT), the mesh is a ``DeviceMesh`` over the world,
and every collective is a named ``torch.distributed`` call on one of its
groups:

  dp    pure data parallelism: each rank its own rows, gradients summed
  fsdp  data parallelism whose gradients and optimizer state are sharded
        (``parallel/sharding.py:ZeroShards``): reduce-scatter, then an
        all-gather of the updated parameters
  tp    tensor parallelism over attention heads, MLP columns and the
        vocabulary (``parallel/sharding.py:shard_model_tp``)

Ranks lie row-major over (dp, fsdp, tp), as ``make_mesh``'s reshape of the
JAX device list does. The data axis is dp x fsdp: the ranks of one tp
group read the same rows, and ``Mesh.data_rank`` / ``data_size`` give the
loader its shard. One process with no process group is a mesh of one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from unimp_tpu_torch.device import resolve_device

AXES = ("dp", "fsdp", "tp")


def world_info_from_env():
    """(rank, world) from the launcher's variables, as the JAX package (and
    the reference, distributed.py:44-65) reads them: torchrun / SLURM /
    OpenMPI."""
    for rank_var in ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK"):
        if rank_var in os.environ:
            rank = int(os.environ[rank_var])
            break
    else:
        rank = 0
    for ws_var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        if ws_var in os.environ:
            world = int(os.environ[ws_var])
            break
    else:
        world = 1
    return rank, world


def local_rank_from_env() -> int:
    for var in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if var in os.environ:
            return int(os.environ[var])
    return 0


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def barrier() -> None:
    """Every rank of the world reaches this point (none: a no-op)."""
    if is_distributed() and dist.get_world_size() > 1:
        dist.barrier()


def process_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK}`` (modulo the cards
    present, so that ranks may share one card) for a CUDA request, else
    ``device`` as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank_from_env() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: Optional[str] = None, device="cuda"):
    """Join the launcher's process group; returns (rank, world).

    Idempotent: a group initialised already (by a test, or a caller that
    picked its own backend) is kept. Otherwise a launch with
    ``MASTER_ADDR`` in the environment (``torchrun``) or a world above one
    initialises ``backend`` (default NCCL for a CUDA device, gloo for the
    CPU) over the ``env://`` rendezvous; one process launched without a
    launcher runs without a group."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    rank, world = world_info_from_env()
    dev = process_device(device)
    if world > 1 or "MASTER_ADDR" in os.environ:
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, rank=rank, world_size=world)
    return rank, world


@dataclasses.dataclass
class Mesh:
    """The run's mesh: its sizes, this rank's coordinates and the process
    groups of each axis (None without a process group)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    rank: int = 0
    device_mesh: object = None
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def world(self) -> int:
        return self.dp * self.fsdp * self.tp

    @property
    def coords(self):
        """(dp, fsdp, tp) index of this rank."""
        return (self.rank // (self.fsdp * self.tp), (self.rank // self.tp) % self.fsdp,
                self.rank % self.tp)

    @property
    def data_size(self) -> int:
        return self.dp * self.fsdp

    @property
    def data_rank(self) -> int:
        d, f, _ = self.coords
        return d * self.fsdp + f

    def group(self, axis: str):
        """The process group of ``axis`` ("dp", "fsdp", "tp" or "data",
        the flattened dp x fsdp) holding this rank."""
        return self.groups.get(axis)

    def size(self, axis: str) -> int:
        return self.data_size if axis == "data" else getattr(self, axis)


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
              device="cuda") -> Mesh:
    """A ("dp", "fsdp", "tp") mesh over the world; ``dp=None`` takes what
    remains. Raises as the JAX ``make_mesh`` asserts when the sizes do not
    multiply to the world. Collective: every rank calls it."""
    world = dist.get_world_size() if is_distributed() else 1
    if dp is None:
        if world % (fsdp * tp):
            raise ValueError(f"mesh fsdp={fsdp} x tp={tp} does not divide world {world}")
        dp = world // (fsdp * tp)
    if dp * fsdp * tp != world:
        raise ValueError(f"mesh {dp}*{fsdp}*{tp} != world {world}")
    mesh = Mesh(dp, fsdp, tp)
    if not is_distributed():
        return mesh
    from torch.distributed.device_mesh import init_device_mesh

    mesh.rank = dist.get_rank()
    dev = torch.device(device)
    mesh.device_mesh = init_device_mesh(dev.type, (dp, fsdp, tp), mesh_dim_names=AXES)
    mesh.groups = {axis: mesh.device_mesh.get_group(axis) for axis in AXES}
    # the data axis (dp x fsdp at one tp index): one group per tp index,
    # created by every rank in the same order
    for t in range(tp):
        ranks = [r for r in range(world) if r % tp == t]
        group = dist.new_group(ranks) if world > 1 else dist.group.WORLD
        if mesh.rank % tp == t:
            mesh.groups["data"] = group
    return mesh


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the run's (``evals/dist.py`` and the CLIs' loaders
    read it; one a process, as its process group is); None restores one
    process."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Mesh:
    return _MESH if _MESH is not None else Mesh()


def all_ranks_true(flag: torch.Tensor, group=None) -> bool:
    """One decision over ``group``: True only if every rank's ``flag`` is
    (an all-reduce MIN); this rank's alone without a group."""
    if group is None:
        return bool(flag)
    t = flag.to(torch.int32).reshape(1).clone()
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())
