"""mfu.train: model FLOPs of the window's updates
(``yardstick.train_step_flops``, recomputation not credited) over the
traced window and the card's dense bf16 peak, in %."""

from gpubench import yardstick as Y
from gpubench.readers import device_trace, train_flops, window_seconds


def read(r):
    if device_trace(r) is None:
        return None
    return 100.0 * train_flops(r) / window_seconds(r) / Y.PEAK_BF16_FLOPS
