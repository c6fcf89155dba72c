"""The benchmark's cells driven end to end on the CPU at tiny sizes (the
kernels' plain versions), each loaded from files written here: the
program against the plain reference, and the faults and controls that
must make ``correct`` false."""

import pytest
import torch

from gpubench import run
from gpubench.tests import tiny

SEED = 2**31 + 12345  # above 32 signed bits, as the driver's are


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench")
    return root, tiny.write_tree(root)


def run_tiny(tree, cell, overrides=None, trace=False):
    root, bench = tree
    return run.run_cell(bench, cell, SEED, 0.2, trace, torch.device("cpu"), overrides,
                        root=root)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_agrees_with_the_reference(tree, cell):
    line = run_tiny(tree, cell)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    wanted = "items_per_s" if cell.startswith("rec") else "samples_per_s"
    assert set(line["metrics"]) == {wanted, "peak_mem_gib", "setup_s"}
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("rec.tiny-neox", "train.tiny-neox")
    for f in ("stale_state", "half_batch", "token_altered")])
def test_a_fault_in_the_timed_path_is_not_correct(tree, cell, fault):
    line = run_tiny(tree, cell, {"fault": fault})
    assert not line["correct"], (fault, line["compared"])


@pytest.mark.parametrize("cell", ["rec.tiny-neox", "rec-int8.tiny-mpt"])
def test_a_selection_fault_reads_in_the_selection_deficit_alone(tree, cell):
    """Beams that keep worse candidates, their scores true to their
    tokens: the score gaps read as a sound run's, the selection deficit
    (printed under ``checked``) does not."""
    sound = run_tiny(tree, cell)
    line = run_tiny(tree, cell, {"fault": "wrong_selection"})
    assert all(x["value"] <= x["limit"] for x in line["compared"].values()), line["compared"]
    assert sound["checked"]["selection_deficit_nats"] == 0.0
    assert line["checked"]["selection_deficit_nats"] > 0.01


def test_a_limit_for_a_number_no_check_computes_is_refused():
    from gpubench import checks

    with pytest.raises(KeyError):
        checks.judge({"loss_gap": 0.1}, {"loss_gap": 1.0, "los_gap": 1.0})


@pytest.mark.parametrize("cell,control", [
    ("rec.tiny-neox", {"program": {"eval_param_dtype": "int8"}}),
    ("rec-int8.tiny-mpt", {"reference_in_place": "int4"}),
    ("train.tiny-neox", {"program": {"frozen": "int8"}}),
    ("train.tiny-mpt", {"reference_in_place": "int4"}),
])
def test_the_control_is_not_correct(tree, cell, control):
    line = run_tiny(tree, cell, control)
    assert not line["correct"], line["compared"]


def test_a_traced_run_on_the_cpu_reports_no_device_metric(tree):
    root, bench = tree
    bench = dict(bench, per_layer=[
        {"name": "idle_share.eval", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "items_per_s", "workloads": ["rec.tiny-neox"]}])
    line = run.run_cell(bench, "rec.tiny-neox", SEED, 0.2, True, torch.device("cpu"),
                        root=root)
    assert line["correct"] and line["metrics"] == {}
