"""Profiling: step timing, a ``torch.profiler`` trace of a step range, and
spans of the program's own layers.

Counterpart of ``unimp_tpu/utils/profiling.py``: ``StepTimer`` keeps the
reference's step_time / data_time accounting (mmrec.py:99-105,259-264)
and ``maybe_trace`` records the enclosed steps with ``torch.profiler``
and writes a Chrome trace (Perfetto reads it) into ``trace_dir``, the
program's spans among its events.

Spans: the hot paths mark each layer boundary with ``span(name)`` and
each device-to-host read with ``read(site)``. Nothing is recorded unless
a caller holds ``recording()`` open; then every span appends [name, start
ns, end ns, parent, request] to the ``Record`` it yields, on the clock
the profiler's events use (``time.time_ns``). ``parent`` is the index of
the span enclosing it on the same thread (-1 at the top of a thread: the
autograd thread's recomputation under remat starts its own tree),
``request`` the index in ``Record.requests`` of the ``generate`` call or
the update under way (``request(kind)``; -1 before the first). Off,
``span`` and ``read`` return one shared object whose enter and exit do
nothing: no allocation, no clock read. Spans never synchronise the
device: they time what the host does. A read's span holds the host's wait
for the device to reach the read.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import threading
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


class Record:
    """What ``recording()`` yields: ``spans`` ([name, start_ns, end_ns,
    parent, request], in the order they opened; end_ns None while open)
    and ``requests`` (the kind of each request, by index)."""

    def __init__(self):
        self.spans: list = []
        self.requests: list = []
        self._lock = threading.Lock()
        self._local = threading.local()  # each thread's stack of open spans

    @property
    def reads(self) -> collections.Counter:
        """Device-to-host reads by site, counted from the ``read.<site>``
        spans."""
        return collections.Counter(s[0][5:] for s in self.spans if s[0].startswith("read."))

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str) -> int:
        stack = self._stack()
        with self._lock:
            index = len(self.spans)
            self.spans.append([name, time.time_ns(), None, stack[-1] if stack else -1,
                               len(self.requests) - 1])
        stack.append(index)
        return index

    def close(self, index: int) -> None:
        self.spans[index][2] = time.time_ns()
        self._stack().pop()


class _Span:
    __slots__ = ("record", "name", "index")

    def __init__(self, record: Record, name: str):
        self.record, self.name = record, name

    def __enter__(self):
        self.index = self.record.open(self.name)
        return self

    def __exit__(self, *exc):
        self.record.close(self.index)
        return False


class _Off:
    """The span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_record: Optional[Record] = None  # the record being filled, or None


def span(name: str):
    """A context manager timing the enclosed host work as ``name``."""
    rec = _record
    return _OFF if rec is None else _Span(rec, name)


def read(site: str):
    """``span("read.<site>")`` around one device-to-host read (counted by
    ``Record.reads``)."""
    rec = _record
    return _OFF if rec is None else _Span(rec, "read." + site)


def request(kind: str) -> None:
    """Tag the spans that follow, on every thread, with a new request of
    ``kind`` ("generate", "update")."""
    rec = _record
    if rec is not None:
        with rec._lock:
            rec.requests.append(kind)


@contextlib.contextmanager
def recording():
    """Record the program's spans while open; yields the ``Record`` (kept
    in memory: nothing is written)."""
    global _record
    rec = Record()
    outer, _record = _record, rec
    try:
        yield rec
    finally:
        _record = outer


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """Record the enclosed steps (host and, where there is one, the card)
    and the program's spans, and write ``trace_dir/trace.json``; no-op
    without ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    with recording() as rec:
        with profile(activities=activities) as prof:
            yield
    prof.export_chrome_trace(path)
    _add_spans_to_trace(path, rec)


def _add_spans_to_trace(path: str, rec: Record) -> None:
    """Insert ``rec``'s closed spans at the end of the ``traceEvents`` of
    the Chrome trace at ``path``, as complete events of one track
    ("program spans") on the trace's time base (``baseTimeNanoseconds`` +
    ``ts`` microseconds). The events already there are not parsed: only
    the file's head and tail are read, where the profiler writes its
    scalar keys, and the file is rewritten from the array's end."""
    with open(path, "rb+") as f:
        size = f.seek(0, os.SEEK_END)
        f.seek(0)
        head = f.read(_EDGE)
        start = max(0, size - _EDGE)
        f.seek(start)
        tail = f.read()
        close = _events_end(tail)
        if close is None:  # not the layout the profiler writes: parse it all
            f.seek(0)
            trace = json.load(f)
            base = trace.get("baseTimeNanoseconds", 0)
            trace.setdefault("traceEvents", []).extend(_span_events(rec, base))
            f.seek(0)
            f.truncate()
            f.write(json.dumps(trace).encode())
            return
        found = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head) or \
            re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', tail[close:])
        base = int(found.group(1)) if found else 0
        body = ",\n".join(json.dumps(e) for e in _span_events(rec, base)).encode()
        empty = tail[:close].rstrip().endswith(b"[")
        f.seek(start + close)
        f.truncate()
        f.write((b"" if empty else b",\n") + body + tail[close:])


_EDGE = 1 << 16  # bytes read at each end of a trace for its keys


def _events_end(tail: bytes) -> Optional[int]:
    """The offset in ``tail`` of the ``]`` that closes a Chrome trace's
    ``traceEvents`` as ``torch.profiler`` writes it: the array is followed
    by scalar keys, ``traceName`` among them, and the closing brace. None
    where no ``]`` is followed so."""
    close = tail.rfind(b"]")
    while close >= 0:
        rest = tail[close + 1:].strip()
        if rest.startswith(b","):
            try:
                keys = json.loads(b"{" + rest[1:])
            except ValueError:
                keys = None
            if keys is not None:
                scalar = all(not isinstance(v, (list, dict)) for v in keys.values())
                return close if scalar and "traceName" in keys else None
        close = tail.rfind(b"]", 0, close)
    return None


def _span_events(rec: Record, base: int) -> list:
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": "program spans",
               "args": {"name": "program spans"}}]
    for i, (name, start, end, parent, req) in enumerate(rec.spans):
        if end is not None:
            events.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid,
                           "tid": "program spans", "ts": (start - base) / 1e3,
                           "dur": (end - start) / 1e3,
                           "args": {"index": i, "parent": parent, "request": req}})
    return events
