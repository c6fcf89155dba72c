"""Run one cell of the benchmark once.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``
entry and ``gpubench/workloads/<name>.json``) names its configuration and
its traffic family (``gpubench/families/<family>.py``), which builds the
program with weights drawn from the seed, sets up, measures whole batches
or updates for ``--seconds`` and checks what the window produced against
the plain reference. ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` runs ``torch.profiler`` over the window and reports its
per-layer metrics, each read by ``gpubench/metrics/<name>.py``. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (``breakdown`` with ``--trace 1``) and
last ``compared``, each number compared beside its limit; the same numbers
end standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "unimp_tpu")  # top-level module names


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def read_metric(name: str, r):
    """``gpubench/metrics/<name>.py``'s ``read(run)``: a number, or None when
    it finds nothing to read."""
    path = ROOT / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(r)


def breakdown(r) -> dict:
    dt = r.record["device_trace"]
    ops = sorted(dt.time_by_name().items(), key=lambda kv: -kv[1])[:10]
    idle = dt.idle_by_label(r.spans.items, dt.t0, dt.t1)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:200], ns / 1e9] for name, ns in ops],
            "idle_gaps": [[name, ns / 1e9] for name, ns in gaps]}


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict = None, root: Path = ROOT) -> dict:
    """One run of ``workload`` on ``device``; returns the result line (the
    chip check and the printing are ``main``'s)."""
    import torch

    from gpubench import common, manifest

    spec = manifest.cell(bench, workload, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = common.Run(spec=spec, sizes=manifest.model_sizes(spec["config_file"]), seed=seed,
                   seconds=seconds, trace=trace, device=device, overrides=overrides or {})
    family = importlib.import_module(f"gpubench.families.{spec['family']}")
    result = family.run(r)
    metrics = {}
    for m in manifest.metrics_for(bench, workload, trace):
        value = read_metric(m["name"], r) if trace else result["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(spec["chips"]), "memory_peak_bytes": r.record["peak_bytes"]}
    line = {"correct": result["check"]["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if trace and r.record.get("device_trace") is not None:
        dt = r.record["device_trace"]
        dev.update(busy_s=dt.busy_ns() / 1e9, window_s=(dt.t1 - dt.t0) / 1e9)
        line["breakdown"] = breakdown(r)
        if dt.events:  # the device's clock against the host's, in ms
            line["trace_clock_ms"] = [(min(e[0] for e in dt.events) - dt.t0) / 1e6,
                                      (dt.t1 - max(e[1] for e in dt.events)) / 1e6]
    if device.type == "cuda":
        line["card"] = card_line()
    line["step_ends_s"] = r.record["step_ends_s"]
    line["checked"] = result["check"].get("checked", {})
    line["compared"] = result["check"]["numbers"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import manifest

    bench = manifest.load_manifest()
    chips = int(manifest.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"gpubench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, x in line["compared"].items():
        print(f"{name} {x['value']!r} limit {x['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
