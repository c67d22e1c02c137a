"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration and traffic; the files under
``port_bench/`` hold the rest (see ``port_bench/run.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"port_bench_file_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    root: Path
    bench: dict
    entry: dict  # the workload's entry in BENCHMARK.json
    config: dict  # the configuration as run
    traffic: dict  # the traffic mix's parameters
    limits: dict  # compared number -> limit

    @property
    def name(self) -> str:
        return self.entry["name"]

    def driver(self):
        return load_module(self.root / "port_bench" / "drivers" / f"{self.traffic['driver']}.py")

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: the end-to-end ones without
        ``trace``, the per-layer ones with it; a metric with ``workloads``
        only in the cells it names."""
        entries = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in entries if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(self.root / "port_bench" / "metrics" / f"{metric}.py")

    def kernels(self) -> list:
        return [load_module(p) for p in sorted((self.root / "port_bench" / "kernels").glob("*.py"))]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``; KeyError if absent."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = load_json(root / "port_bench" / "workloads" / f"{name}.json")
    return Cell(root=root, bench=bench, entry=entry, config=load_json(root / conf["file"]),
                traffic=load_json(root / "port_bench" / "traffic" / f"{entry['traffic']}.json"),
                limits=workload["limits"])
