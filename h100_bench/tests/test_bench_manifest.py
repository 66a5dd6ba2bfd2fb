"""The manifest keeps to its contract, and everything it names is found by
name; a cell, a configuration, a traffic mix and a metric are added as new
files and manifest entries alone."""
import hashlib
import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_shape():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["h100_bench"] and m["command"][1] == "h100_bench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("h100_bench/")
        names.add(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["moves"] in e2e
    for e in m["end_to_end"] + m["per_layer"] + m["configs"] + m["workloads"]:
        assert NAME.match(e["name"])
        assert "unit" not in e or UNIT.match(e["unit"])


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_every_name_is_found(workload):
    cell = core.Cell(manifest(), workload)
    core.load_driver(cell.traffic["kind"])
    reported = cell.metrics(False) + cell.metrics(True)
    assert any(m["name"] == "setup_s" for m in reported)
    assert len(cell.metrics(False)) >= 2 and cell.metrics(True)
    for m in reported:
        assert callable(core.load_metric(m["name"]).read)
        if m in cell.per_layer:
            moves = m["moves"]
            assert any(e["name"] == moves for e in cell.end_to_end)


def test_names_cannot_leave_their_directory():
    for bad in ("../x", "a/b", "", ".hidden", "a b"):
        with pytest.raises(ValueError):
            core.check_name(bad)


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_takes_new_files_only(tiny_bench):
    import run as bench_run

    before = digest(tiny_bench)
    (tiny_bench / "configs" / "dummy-b.json").write_text(
        (tiny_bench / "configs" / "vitpose-b-int8.json").read_text())
    t = json.loads((tiny_bench / "traffic" / "pose64-1080p-ahead.json").read_text())
    t.update(slots=4, masked=1, frames=2)
    (tiny_bench / "traffic" / "dummy-pose4.json").write_text(json.dumps(t))
    (tiny_bench / "metrics" / "dummy_steps.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    m = json.loads((tiny_bench.parent / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dummy-b", "source": "https://example.org", "reduced": [],
                         "file": "h100_bench/configs/dummy-b.json", "why": "test"})
    m["workloads"].append({"name": "dummy-cell", "config": "dummy-b", "traffic": "dummy-pose4",
                           "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "dummy_steps", "unit": "steps", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["dummy-cell"]})
    (tiny_bench.parent / "BENCHMARK.json").write_text(json.dumps(m))
    cell = core.Cell(core.load_manifest(tiny_bench.parent), "dummy-cell", bench=tiny_bench)
    line = bench_run.run_cell(cell, 2 ** 31 + 7, 0.3, False, "cpu")
    assert line["metrics"]["dummy_steps"]["value"] >= 1
    assert "setup_s" in line["metrics"] and line["attempted"] >= 1
    after = digest(tiny_bench)
    assert all(after[k] == v for k, v in before.items())
