"""Cross-process metric aggregation (counterpart of ``unimp_tpu/evals/dist.py``).

One process only: a rank's metric list is the whole list. The
multi-process gather over ``torch.distributed`` comes with multi-GPU
(ROADMAP.md §1, item 7); until then a run inside an initialised process
group of more than one rank raises rather than report one rank's share.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch.distributed as dist


def gather_metric_lists(values: List[float]) -> np.ndarray:
    """Concatenate per-process metric lists (one process: the list)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("multi-process metric gathering is not ported yet "
                                  "(ROADMAP.md §1, item 7)")
    return np.asarray(values, np.float64)
