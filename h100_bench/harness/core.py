"""The benchmark's data: the manifest, and everything found in it by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration,
traffic mix and metrics.  Each lives in a file of its own under
``h100_bench/``:

* ``configs/<config>.json``: the model's sizes, its serving or training
  settings;
* ``limits/<workload>.json``: each number that decides the cell's
  ``correct``, with its limit;
* ``traffic/<traffic>.json``: the parameters of one traffic mix, read by
  the driver its ``kind`` names (``harness/drivers/<kind>.py``);
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of one
  metric from a finished run (host clocks, the trace, counters).

Adding a cell, a configuration, a traffic mix or a metric adds files and
manifest entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent.parent          # h100_bench/
ROOT = BENCH.parent                                      # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "easy_vitpose_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    """A manifest name, refused when it could leave its directory."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, bench: Path = BENCH) -> Dict[str, Any]:
    with open(bench / kind / f"{check_name(name)}.json") as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "harness" / "drivers" / f"{check_name(kind)}.py",
                       f"h100_bench_driver_{kind}")


def load_metric(name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "metrics" / f"{check_name(name)}.py",
                       "h100_bench_metric_" + name.replace(".", "_").replace("-", "_"))


class Cell:
    """One manifest cell with its configuration, traffic and metric specs."""

    def __init__(self, manifest: Dict[str, Any], workload: str, bench: Path = BENCH):
        self.spec = find(manifest["workloads"], workload, "workload")
        self.name = workload
        self.chips = int(self.spec["chips"])
        self.config_name = self.spec["config"]
        self.traffic_name = self.spec["traffic"]
        find(manifest["configs"], self.config_name, "config")
        self.config = load_json("configs", self.config_name, bench)
        self.traffic = load_json("traffic", self.traffic_name, bench)
        limits = bench / "limits" / f"{self.name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._reports(m)]
        self.bench = bench

    def _reports(self, metric: Dict[str, Any]) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        return self.per_layer if trace else self.end_to_end


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX, Flax and the JAX package, compared as whole names (the port's
    name starts with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
