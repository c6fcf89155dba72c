"""Process groups, the ("dp", "fsdp", "tp") mesh, sharding and ring attention."""

from unimp_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from unimp_tpu_torch.parallel.seq_shard import (
    get_sequence_sharding,
    sequence_sharding,
    set_sequence_sharding,
)
from unimp_tpu_torch.parallel.sharding import param_specs, partition_rules, spec_for_path

__all__ = [
    "Mesh",
    "make_mesh",
    "init_distributed",
    "partition_rules",
    "spec_for_path",
    "param_specs",
    "sequence_sharding",
    "set_sequence_sharding",
    "get_sequence_sharding",
]
