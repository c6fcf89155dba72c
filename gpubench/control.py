"""Readings for the limits of ``correct``: a cell's compared numbers over
many seeds in one process, for the program as committed, for the cell's
control, or with a fault planted in the timed path.

    python3 gpubench/control.py --workload <name> --seeds 11,12,13 \\
        --mode program|control|fault:<name> [--seconds 5]

``control`` is the workload file's ``check.control``: the program with a
lower-precision path of its own switched on (``program`` settings), or
the reference at the precision below the configuration's put in the
program's place (``reference_in_place``). The faults
(``families/<family>.py``): ``stale_state`` (a decode step answers as the
first one did; an update leaves the parameters unchanged),
``half_batch`` (half of the rows left out), ``token_altered`` (a token or
an answer changed where it is produced), ``wrong_selection`` (rec: the
beam expansion keeps worse candidates, scores true to their tokens). The benchmark's own runs never
take these paths. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def overrides_for(spec: dict, mode: str) -> dict:
    if mode == "program":
        return {}
    if mode == "control":
        return dict(spec["check"]["control"])
    if mode.startswith("fault:"):
        return {"fault": mode.split(":", 1)[1]}
    raise ValueError(f"unknown mode {mode!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import common, manifest, run

    bench = manifest.load_manifest()
    spec = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("gpubench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run.run_cell(bench, args.workload, seed, args.seconds, False,
                            torch.device("cuda", 0), overrides=overrides_for(spec, args.mode))
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": line["correct"], "compared": line["compared"],
                          "checked": line["checked"], "metrics": line["metrics"]}), flush=True)
        torch.cuda.reset_peak_memory_stats()
        common.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
