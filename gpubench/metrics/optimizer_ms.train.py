"""optimizer_ms.train: the synchronised host wall of the optimizer's
``step`` calls (``MultiSteps``: the accumulation and, each ``accum``-th
call, clip and AdamW) in the window, per update, in ms, from the
benchmark's ``optimizer_step`` spans."""

from gpubench.readers import device_trace


def read(r):
    spans = [e - s for name, s, e in r.spans.items if name == "optimizer_step"]
    if device_trace(r) is None or not spans:
        return None
    return sum(spans) / r.record["updates"] / 1e6
