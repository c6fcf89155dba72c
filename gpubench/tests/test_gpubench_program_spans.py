"""The idle labelling over the program's own spans
(``unimp_tpu_torch/utils/profiling.py``'s records) beside the
benchmark's: a device gap takes the innermost span open when the card ran
dry, so a program span nested in a benchmark span names it."""

import pytest
import torch

from gpubench import run, trace
from gpubench.tests import tiny

SEED = 2**31 + 12345


def test_a_gap_takes_the_program_span_nested_inside_a_benchmark_span():
    bench = [("decode_forward", 0, 100)]
    program = [["generate.decode", 10, 90, -1, 0], ["model.block", 20, 40, 0, 0]]
    dt = trace.DeviceTrace()
    dt.events = [(0, 5, "a"), (10, 25, "b"), (30, 60, "c")]
    dt.t0, dt.t1 = 0, 100
    idle = dt.idle_by_label(bench + program, dt.t0, dt.t1)
    assert idle == {"decode_forward": 5, "model.block": 5, "generate.decode": 40}


@pytest.mark.parametrize("cell", ["rec.tiny-neox", "train.tiny-mpt"])
def test_each_program_leaf_labels_its_own_midpoint(tmp_path, cell):
    """A tiny cell run with the recorder on: at the middle of every span
    that holds no other, the labelling names that span."""
    from unimp_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    bench = tiny.write_tree(tmp_path)
    with profiling.recording() as rec:
        run.run_cell(bench, cell, SEED, 0.2, False, torch.device("cpu"), root=tmp_path)
    parents = {s[3] for s in rec.spans}
    leaves = [s for i, s in enumerate(rec.spans) if i not in parents and s[2] > s[1]]
    wanted = {"read.top_k", "read.done", "model.block"} if cell.startswith("rec") else \
        {"read.finite", "model.block", "optimizer.accumulate"}
    assert wanted <= {s[0] for s in leaves}
    spans = sorted(leaves, key=lambda s: s[1])
    times = [(s[1] + s[2]) // 2 for s in spans]
    order = sorted(range(len(times)), key=times.__getitem__)
    labels = trace.labels_at(rec.spans, [times[i] for i in order])
    wrong = [(spans[i][0], label) for i, label in zip(order, labels) if label != spans[i][0]]
    assert not wrong, wrong[:5]
