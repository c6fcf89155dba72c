"""idle_share.train: % of the traced window with no operation on the
device (the union of the device operations' intervals from
``torch.profiler``), training cells."""

from gpubench.readers import idle_share


def read(r):
    return idle_share(r)
