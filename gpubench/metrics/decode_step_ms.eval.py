"""decode_step_ms.eval: the host wall of ``Generator._decode_step`` (one
decode step's model call: launches, no synchronisation) over the window,
per step, in ms, from the benchmark's ``decode_step`` spans."""

from gpubench.readers import device_trace


def read(r):
    spans = [e - s for name, s, e in r.spans.items if name == "decode_step"]
    if device_trace(r) is None or not spans:
        return None
    return sum(spans) / len(spans) / 1e6
