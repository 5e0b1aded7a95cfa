"""The benchmark's parts are found by name from BENCHMARK.json: every
cell's configuration, traffic mix and runner, and every per-layer metric's
reader; and BENCHMARK.json keeps to the contract's shape."""

import json
import os
import re

import pytest

from zkbench import manifest

BENCH = manifest.Bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH.spec) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert BENCH.spec["paths"] == ["zkbench"]
    assert 1 <= BENCH.spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH.spec["workloads"]])
def test_cell_parts_found_by_name(cell):
    spec = BENCH.workload(cell)
    cfg = BENCH.config(spec["config"])
    traffic = BENCH.traffic(spec["traffic"])
    run_mod = manifest.runner(traffic["runner"])
    assert hasattr(run_mod, "Cell") and hasattr(run_mod, "control")
    assert cfg["name"] == spec["config"]
    reported = {m["name"] for m in BENCH.end_to_end(cell)}
    assert "setup_s" in reported and len(reported) >= 2
    assert BENCH.per_layer(cell), "a cell reports a per-layer metric"
    assert spec["chips"] == 1 and len(spec["why"]) <= 200


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH.spec["per_layer"]])
def test_metric_reader_found_by_name(metric):
    entry = next(m for m in BENCH.spec["per_layer"] if m["name"] == metric)
    assert callable(manifest.reader(metric).read)
    assert entry["moves"] in {m["name"] for m in BENCH.spec["end_to_end"]}
    for cell in entry["workloads"]:
        assert entry["moves"] in {m["name"] for m in BENCH.end_to_end(cell)}


def test_names_units_and_entry_keys():
    names = []
    for key, keys in (("configs", {"name", "source", "file", "reduced",
                                   "why"}),
                      ("workloads", {"name", "config", "traffic", "chips",
                                     "why"})):
        for e in BENCH.spec[key]:
            assert set(e) == keys
            names.append(e["name"])
    for key in ("end_to_end", "per_layer"):
        for m in BENCH.spec[key]:
            assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for m in BENCH.spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH.spec["configs"]])
def test_config_files_state_their_cuts(cfg):
    entry = next(c for c in BENCH.spec["configs"] if c["name"] == cfg)
    with open(os.path.join(manifest.ROOT, entry["file"])) as f:
        data = json.load(f)
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    assert data["source"] == entry["source"]
    assert "assumed" in data and data["guarantees"]
