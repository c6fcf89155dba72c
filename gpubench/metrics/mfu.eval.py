"""mfu.eval: model FLOPs of the window's rec-eval batches (prefill and
decode steps, ``yardstick.eval_batch_flops``) over the traced window and
the card's dense bf16 peak, in %."""

from gpubench import yardstick as Y
from gpubench.readers import device_trace, eval_flops, window_seconds


def read(r):
    if device_trace(r) is None:
        return None
    return 100.0 * eval_flops(r) / window_seconds(r) / Y.PEAK_BF16_FLOPS
