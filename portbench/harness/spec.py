"""What ``BENCHMARK.json`` names, found by name in files of their own.

A cell names a configuration and a traffic mix; each is a JSON file,
``configs/<name>.json`` and ``traffic/<name>.json`` under the benchmark's
folder. A per-layer metric is a reader, ``metrics/<name>.py``, holding
``read(reading)``: the number, or None where the run gave it nothing to
read. A traffic file's ``kind`` names the driver that runs it
(``harness/<kind>.py``). Adding a cell or a metric adds files and entries;
no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.bench = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
