"""BENCHMARK.json and the files it names keep to the benchmark's
contract: names, units, keys, each per-layer metric's cells report the
metric it moves, every configuration has a cell, every cell, metric and
configuration has its file, and the run length fits the full check."""

import json
import math

import pytest

from gpubench import manifest

BENCH = manifest.load_manifest()
ROOT = manifest.ROOT
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def cells_reporting(metric):
    return set(metric.get("workloads", [w["name"] for w in BENCH["workloads"]]))


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [x["name"] for x in BENCH[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert manifest.NAME_RE.match(name), name


def test_metrics_have_their_keys_units_and_sources():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS, m["name"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and "\t" not in m["layer"] and len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert manifest.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_each_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert cells_reporting(m) <= cells_reporting(e2e[m["moves"]]), m["name"]
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_cell_reports_setup_another_e2e_metric_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in cells_reporting(m) for m in BENCH["per_layer"]), w["name"]


def test_configs_and_cells_have_their_files():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and "hidden" not in key
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        spec = manifest.cell(BENCH, w["name"])
        assert spec["family"] and (ROOT / "gpubench" / "families" / f"{spec['family']}.py").is_file()


def test_four_chip_cells_stay_within_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_new_cell_is_only_new_files(tmp_path):
    """A cell, configuration and traffic the benchmark did not know of,
    from files written here."""
    from gpubench.tests import tiny

    cells = {"new-cell.tiny-mpt": dict(tiny.CELLS["rec.tiny-neox"], config="tiny-mpt")}
    bench = tiny.write_tree(tmp_path, cells, {"tiny-mpt": tiny.CONFIGS["tiny-mpt"]})
    spec = manifest.cell(bench, "new-cell.tiny-mpt", tmp_path)
    sizes = manifest.model_sizes(spec["config_file"])
    assert spec["family"] == "rec_beam" and sizes.lm.positions == "alibi"
    assert math.prod((sizes.lm.vocab_size, sizes.lm.hidden_size)) > 0
