"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by its name:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes, whose
  ``architecture`` names ``benchmark/models/<architecture>.py`` (how the
  program is built from it, and its plain reference);
- ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters, read by
  the one generator in ``benchmark/traffic.py``;
- ``benchmark/metrics/<metric>.py``: one reader per metric;
- ``benchmark/limits/<workload>.json``: the limits of the cell's output check.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]  # the checkout: BENCHMARK.json and benchmark/
BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    limits: Dict[str, float]
    root: Path

    @property
    def model(self):
        """The configuration's module under ``benchmark/models``."""
        return importlib.import_module(f"benchmark.models.{self.config['architecture']}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises KeyError or
    FileNotFoundError when the benchmark does not define it."""
    bench = load_json(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / c["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "benchmark" / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}

    def metrics(kind: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"]) for m in bench[kind] if _applies(m, workload)]

    return Cell(workload, int(w["chips"]), config, traffic, metrics("end_to_end"), metrics("per_layer"), limits,
                root)


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``root/benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
