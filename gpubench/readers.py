"""Arithmetic the per-layer metric readers (``metrics/<name>.py``) share:
each takes a finished traced run (``common.Run``) and returns a number, or
None when its run holds nothing for it to read."""

from __future__ import annotations

from gpubench import yardstick as Y


def device_trace(r):
    """The run's device trace, or None (an untraced run, or a trace with no
    device operation in it, as on a machine without a card)."""
    dt = r.record.get("device_trace")
    return dt if dt is not None and dt.events else None


def idle_share(r):
    dt = device_trace(r)
    if dt is None:
        return None
    return 100.0 * (1.0 - dt.busy_ns() / (dt.t1 - dt.t0))


def share(least_s: float, device_ns: int):
    """A roofline share in %: the least time over the device time, or None
    where the kernels did not run."""
    if device_ns <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / (device_ns / 1e9)


def window_seconds(r) -> float:
    dt = r.record["device_trace"]
    return (dt.t1 - dt.t0) / 1e9


def eval_flops(r) -> float:
    """Model FLOPs of the traced window's rec-eval batches (each at its own
    number of decode steps)."""
    t = r.spec["traffic"]
    return sum(Y.eval_batch_flops(r.sizes, t["batch"], t["prompt_len"], t["media"], t["beams"],
                                  steps) for steps in r.record["decode_steps"])


def train_flops(r) -> float:
    """Model FLOPs of the traced window's updates (no recomputation
    credited; the tower's forward only where the step runs it)."""
    t = r.spec["traffic"]
    rows = t["micro_batch"] * t["accum"]
    per = Y.train_step_flops(r.sizes, rows, t["seq_len"], t["media"], frozen_backbone=True)
    if r.spec["program"].get("cache_vision_latents"):
        per -= Y.vision_forward_flops(r.sizes, rows * t["media"])
    return per * r.record["updates"]
