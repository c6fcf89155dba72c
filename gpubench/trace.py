"""Host spans and the reduction of a device trace.

``Spans`` records what the host is doing, on the wall clock that the
profiler's events use (``time.time_ns``): the benchmark's wrappers open a
span around each call into a layer of the program. ``DeviceTrace`` runs
``torch.profiler`` over the card's activity only (no CPU operators) and
reduces its events to what the per-layer metrics read: the busy time
(the union of the device operations' intervals), each operation's time by
name, and the idle gaps labelled by the innermost host span open when the
device ran dry.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Spans:
    """Host spans: (name, start ns, end ns), in the order they closed."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return wrapped


def union_length(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, t0: int, t1: int) -> list:
    """The [start, end) stretches of [t0, t1) that no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


OUTSIDE = "outside the benchmark's spans"


def labels_at(spans, times) -> list:
    """For each of the sorted ``times``, the innermost host span open at it
    (the open one that started last), in one sweep over the spans."""
    spans = sorted(spans, key=lambda x: x[1])
    out, open_, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            open_.append(spans[i])
            i += 1
        open_ = [x for x in open_ if x[2] > t]
        out.append(open_[-1][0] if open_ else OUTSIDE)
    return out


class DeviceTrace:
    """``torch.profiler`` over the card around the measured window."""

    def __init__(self):
        self.prof = None
        self.events = []  # (start ns, end ns, name) of device operations
        self.t0 = self.t1 = 0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if torch.cuda.is_available():  # without a card the trace stays empty
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        if self.prof is None:
            self.t1 = time.time_ns()
            return False
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA or ev.is_user_annotation():
                continue
            start = ev.start_ns()
            self.events.append((start, start + ev.duration_ns(), ev.name()))
        self.prof = None
        return False

    def busy_ns(self, t0: int = None, t1: int = None) -> int:
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        return union_length((max(s, t0), min(e, t1)) for s, e, _ in self.events
                            if e > t0 and s < t1)

    def time_by_name(self) -> dict:
        """{operation name: device ns summed}."""
        out = {}
        for s, e, name in self.events:
            out[name] = out.get(name, 0) + (e - s)
        return out

    def ns_matching(self, parts) -> int:
        """Device ns of the operations whose name contains any of ``parts``."""
        return sum(e - s for s, e, name in self.events if any(p in name for p in parts))

    def idle_by_label(self, spans, t0: int, t1: int) -> dict:
        """{host span label: idle ns} over the gaps in [t0, t1)."""
        out = {}
        idle = gaps([(a, b) for a, b, _ in self.events], t0, t1)
        for (s, e), label in zip(idle, labels_at(spans, [s for s, _ in idle])):
            out[label] = out.get(label, 0) + (e - s)
        return out
