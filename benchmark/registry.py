"""Finds a cell's parts by the names in `BENCHMARK.json`, so that a new
configuration, traffic mix or per-layer metric is new files and new
entries, and no edit:

  * a configuration: the file its entry names (`benchmark/configs/...`);
  * a traffic mix: `benchmark/traffic/<mix>.json`;
  * a per-layer metric: `benchmark/metrics/<metric>.py`, a reader with its
    LAYER, UNIT, SOURCE and MOVES and `read(ctx)`;
  * a cell's limits on the numbers its check compares:
    `benchmark/limits/<cell>.json`.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Cell:
    def __init__(self, bench: "Bench", entry: dict):
        self.name, self.chips = entry["name"], int(entry["chips"])
        conf = next(c for c in bench.spec["configs"] if c["name"] == entry["config"])
        self.cfg = json.loads((bench.root / conf["file"]).read_text())
        self.traffic = json.loads((bench.here / "traffic" / f"{entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench.spec["end_to_end"]
                           if self.name in m.get("workloads", [self.name])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench.spec["per_layer"]
                          if (self.name in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]
        path = bench.here / "limits" / f"{self.name}.json"
        self.limits = json.loads(path.read_text()) if path.exists() else {}
        self.readers = {m["name"]: bench.reader(m) for m in self.per_layer}


class Bench:
    def __init__(self, root=None):
        self.here = HERE if root is None else Path(root) / "benchmark"
        self.root = self.here.parent
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        for entry in self.spec["workloads"]:
            if entry["name"] == name:
                return Cell(self, entry)
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def reader(self, metric: dict):
        """The metric's reader module, checked against its entry."""
        path = self.here / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for key in ("layer", "unit", "source", "moves"):
            if getattr(mod, key.upper()) != metric[key]:
                raise ValueError(f"{path.name}: {key} {getattr(mod, key.upper())!r} is not "
                                 f"BENCHMARK.json's {metric[key]!r}")
        return mod
