"""Sequence-parallel (ring) attention context.

Counterpart of ``unimp_tpu/parallel/seq_shard.py``: while a mesh is set,
``ops/attention.py:multi_head_attention`` routes causal self-attention
(q and k/v of one sequence, no media masks, no ALiBi, no window start, no
GQA) through ``ops/ring_attention.py`` over the mesh's fsdp group; ViT,
perceiver and gated cross-attention keep their own paths. ``--seq_shard``
sets it in the CLIs (``cli/common.py:build_mesh``), or::

    with sequence_sharding(mesh):
        ... the training step ...
"""

from __future__ import annotations

import contextlib
from typing import Optional

_ACTIVE = None


def set_sequence_sharding(mesh) -> None:
    """Route causal self-attention through ring attention (None: stop)."""
    global _ACTIVE
    _ACTIVE = mesh


def get_sequence_sharding() -> Optional[object]:
    """The mesh whose fsdp group runs the ring, or None."""
    return _ACTIVE


@contextlib.contextmanager
def sequence_sharding(mesh):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield
    finally:
        _ACTIVE = prev
