"""The benchmark is driven by its files: a configuration, a traffic mix and
a metric added as files alone make a cell the harness runs and reports; and
``BENCHMARK.json`` keeps to its contract's names, units and keys."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest
import torch

from liobench import check, harness
from liobench.tests.tiny import ROUTE, WORLD

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_names_units_and_keys():
    b = BENCH
    assert set(b) == KEYS["top"]
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[section]]
        assert len(names) == len(set(names)), section
        for e in b[section]:
            extra = set(e) - KEYS[section]
            assert extra <= ({"workloads"} if section in (
                "end_to_end", "per_layer") else set()), (section, extra)
            assert KEYS[section] <= set(e), (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and section != "end_to_end":
                    assert _line(e[k]), (e["name"], k)
    metrics = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    assert len(metrics) == len(b["end_to_end"]) + len(b["per_layer"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) and NAME.match(w["traffic"])
               for w in b["workloads"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_its_metrics(workload):
    """Each cell has its files, reports setup_s and another end-to-end
    metric, and at least one per-layer metric, each moving one of its
    end-to-end metrics."""
    cell = harness.Cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert {"start_pos_gap_m", "chain_pos_gap_m"} <= set(cell.limits) <= set(
        check.NUMBERS)


METRIC = '''"""A test's metric: the window's slowest enqueue, ms."""


def read(ctx):
    e = ctx["window"].get("enqueue_s", [])
    return 1e3 * max(e) if e else None
'''


def test_a_cell_from_files_alone(tmp_path):
    """A configuration, a mix, a metric and the cell's limits written to a
    temporary directory, and entries for them in a copy of BENCHMARK.json:
    the harness runs the new cell at a tiny size and reports the metric."""
    lio = tmp_path / "liobench"
    for sub in ("configs", "mixes", "metrics", "limits"):
        (lio / sub).mkdir(parents=True)
    conf = json.loads((ROOT / "liobench/configs/avia.json").read_text())
    conf["name"] = "avia_small"
    conf["config"].update(n_points_max=2048, n_ds_max=1024, map_h_log2=12)
    conf["assumed"]["sensor"].update(rate=12000)
    (lio / "configs/avia_small.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "liobench/mixes/replay.json").read_text())
    mix.update(warm_laps=0, profile_scans=3)
    mix["route"].update(ROUTE)
    mix["world"].update(WORLD)
    mix["check"].update(start_packets=6, chains=1)
    (lio / "mixes/short_replay.json").write_text(json.dumps(mix))
    (lio / "metrics/slowest_enqueue_ms.small.py").write_text(METRIC)
    (lio / "limits/avia_small.short_replay.json").write_text(json.dumps(
        {"start_pos_gap_m": 1.0, "chain_pos_gap_m": 1.0}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="avia_small",
                                 file="liobench/configs/avia_small.json"))
    bench["workloads"].append({"name": "avia_small.short_replay",
                               "config": "avia_small",
                               "traffic": "short_replay", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "scans_per_s":
            m["workloads"].append("avia_small.short_replay")
    bench["per_layer"].append({
        "name": "slowest_enqueue_ms.small", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "packet API and feed",
        "moves": "scans_per_s", "workloads": ["avia_small.short_replay"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    torch.set_num_threads(2)
    traced = harness.run_cell("avia_small.short_replay", 5, 1.0, True, "cpu",
                              bench_path=path)
    assert set(traced["metrics"]) == {"slowest_enqueue_ms.small"}
    assert traced["metrics"]["slowest_enqueue_ms.small"]["value"] > 0
    assert traced["correct"], traced["_stderr"]
    plain = harness.run_cell("avia_small.short_replay", 5, 1.0, False, "cpu",
                             bench_path=path)
    assert set(plain["metrics"]) == {"scans_per_s", "setup_s"}
    assert plain["attempted"] > 0 and plain["failed"] == 0
