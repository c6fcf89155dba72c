"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, one
file a cell under ``workloads/`` and one a configuration under
``configs/``, all found by the names the manifest gives. Imports nothing
of the program."""

from __future__ import annotations

import json
import re
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_manifest(path: Path = MANIFEST) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no benchmark manifest at {path}")
    return json.loads(path.read_text())


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """``gpubench/<kind>/<name>.json`` under the checkout ``root``."""
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    path = root / "gpubench" / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def cell(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The manifest's entry of workload ``name`` with its file's content
    (``family``, ``traffic``, ``program``, ``check``) and its
    configuration's file under ``config_file``."""
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r} is not in the manifest once")
    entry = dict(entries[0])
    spec = load_json("workloads", name, root)
    for key in ("config", "chips", "why"):
        if spec.get(key) != entry[key]:
            raise ValueError(f"{name}: its file gives {key} {spec.get(key)!r}, the manifest "
                             f"{entry[key]!r}")
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_path = root / configs[entry["config"]]["file"]
    entry.update(spec)
    entry["config_file"] = json.loads(cfg_path.read_text())
    return entry


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` false) or per-layer
    metrics (``trace`` true): entries without ``workloads`` belong to every
    cell."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def model_sizes(config: dict) -> SimpleNamespace:
    """A configuration file's sizes with the derived ones the yardstick and
    the reference use (head_dim, kv_heads, mlp_dim, num_patches)."""
    lm = SimpleNamespace(**config["lm"])
    lm.head_dim = lm.hidden_size // lm.num_heads
    lm.kv_heads = lm.num_kv_heads or lm.num_heads
    lm.mlp_dim = lm.mlp_hidden or 4 * lm.hidden_size
    vision = SimpleNamespace(**config["vision"])
    vision.num_patches = (vision.image_size // vision.patch_size) ** 2
    vision.head_dim = vision.hidden_size // vision.num_heads
    resampler = SimpleNamespace(**config["resampler"])
    return SimpleNamespace(lm=lm, vision=vision, resampler=resampler,
                           cross_attn_every_n=config["cross_attn_every_n"],
                           media_mode=config.get("media_mode", "immediate"),
                           tokens=config["tokens"])

