"""Profiling: step timing and a ``torch.profiler`` trace of a step range.

Counterpart of ``unimp_tpu/utils/profiling.py``: ``StepTimer`` keeps the
reference's step_time / data_time accounting (mmrec.py:99-105,259-264)
and ``maybe_trace`` records the enclosed steps with ``torch.profiler``
and writes a Chrome trace (Perfetto reads it) into ``trace_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

from unimp_tpu_torch.utils.logging import AverageMeter


class StepTimer:
    """step_time / data_time accounting (mmrec.py:99-105,259-264)."""

    def __init__(self):
        self.step_time = AverageMeter()
        self.data_time = AverageMeter()
        self._end = time.time()

    def data_loaded(self):
        self.data_time.update(time.time() - self._end)

    def step_done(self):
        self.step_time.update(time.time() - self._end)
        self._end = time.time()

    def throughput(self, samples_per_step: int, world_size: int = 1):
        if self.step_time.val == 0:
            return {}
        return {
            "step_time": self.step_time.avg,
            "data_time": self.data_time.avg,
            "samples_per_second": samples_per_step * world_size / self.step_time.val,
            "samples_per_second_per_chip": samples_per_step / self.step_time.val,
        }


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """Record the enclosed steps (host and, where there is one, the card)
    and write ``trace_dir/trace.json``; no-op without ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
