"""idle_share.eval: % of the traced window with no operation on the
device (the union of the device operations' intervals from
``torch.profiler``), rec evaluation cells."""

from gpubench.readers import idle_share


def read(r):
    return idle_share(r)
