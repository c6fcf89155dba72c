"""What a run imports: never a module whose whole top-level name is jax,
jaxlib, flax or unimp_tpu (the port's name begins with the JAX package's,
so names are compared whole), and the reference nothing of the program."""

import subprocess
import sys

from gpubench import run
from gpubench.tests.conftest import ROOT

RUN_A_CELL = f"""
import sys, json, tempfile, pathlib
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from gpubench import run
from gpubench.tests import tiny
root = pathlib.Path(tempfile.mkdtemp())
bench = tiny.write_tree(root)
line = run.run_cell(bench, "rec.tiny-neox", 7, 0.1, False, torch.device("cpu"), root=root)
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import gpubench.reference.flamingo, gpubench.reference.train_step, gpubench.checks
import gpubench.weights, gpubench.yardstick, gpubench.traffic
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0].startswith("unimp"))))
"""


def _last_line(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    assert _last_line(RUN_A_CELL) == "[]"


def test_the_reference_imports_nothing_of_the_program():
    assert _last_line(REFERENCE) == "[]"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "unimp_tpu_torch_like", object())
    assert "unimp_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "unimp_tpu", object())
    assert "unimp_tpu" in run.forbidden_modules()


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "rec-beam10.4b-instruct", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
