"""The benchmark's description, found by name: ``BENCHMARK.json`` at the
checkout's root, each cell's traffic file ``benchmark/workloads/<cell>.json``,
each configuration's ``benchmark/configs/<config>.json``, each traffic
driver ``benchmark/traffic/<driver>.py`` and each per-layer metric's reader
``benchmark/metrics/<metric>.py``. A new cell, configuration or metric is
new files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # workloads/<cell>.json
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def limits(self) -> dict:
        return self.traffic["limits"]


def read_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = read_spec() if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {[w['name'] for w in spec['workloads']]}")
    config = json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    if (traffic["config"], traffic["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"workloads/{name}.json names {traffic['config']}/{traffic['traffic']}, "
                         f"BENCHMARK.json {entry['config']}/{entry['traffic']}")
    everyone = {m["name"] for m in spec["end_to_end"] if "workloads" not in m}
    e2e = [m for m in spec["end_to_end"] if m["name"] in everyone or name in m.get("workloads", ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer)


def unlisted_cell(name: str) -> Cell:
    """A cell whose traffic file is kept for a later PR and that
    ``BENCHMARK.json`` does not list: its file and configuration, one chip,
    no metrics. For ``study.py`` and the tests; ``run.py`` runs listed cells only."""
    traffic = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{traffic['config']}.json").read_text())
    return Cell(name, 1, config, traffic, [], [])


def driver(cell: Cell):
    """The traffic driver module the cell's file names."""
    return importlib.import_module(f"benchmark.traffic.{cell.traffic['driver']}")


def metric_reader(name: str):
    """``read(stretch) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
