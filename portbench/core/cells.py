"""Cells as data: a workload ``<config>.<traffic>`` is found by name from
``configs/<config>.json`` and ``traffic/<traffic>.json`` under the harness
root; the traffic names its driver (``drivers/<driver>.py``); each per-layer
metric is ``metrics/<name>.py``; a cell's comparison limits are
``limits/<workload>.json``.  ``BENCHMARK.json`` says which metrics a cell
reports and with which units."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    settings: dict                  # the dotted program settings of both files
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, dict]
    chips: int
    root: Path = ROOT

    @property
    def ranks(self) -> int:
        return int(self.traffic.get("ranks", 1))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def split_name(workload: str, root: Path = ROOT):
    """(config, traffic) of ``workload``: the one split at a dot for which
    both files exist."""
    found = [(workload[:i], workload[i + 1:]) for i, ch in enumerate(workload) if ch == "."
             if (root / "configs" / f"{workload[:i]}.json").is_file()
             and (root / "traffic" / f"{workload[i + 1:]}.json").is_file()]
    if len(found) != 1:
        raise ValueError(f"workload {workload!r}: {len(found)} matches of "
                         f"configs/<config>.json and traffic/<traffic>.json under {root}")
    return found[0]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT, benchmark: Optional[Path] = None) -> Cell:
    config_name, traffic_name = split_name(workload, root)
    config = read_json(root / "configs" / f"{config_name}.json")
    traffic = read_json(root / "traffic" / f"{traffic_name}.json")
    bench = read_json(benchmark or REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    limits_path = root / "limits" / f"{workload}.json"
    limits = read_json(limits_path)["numbers"] if limits_path.is_file() else {}
    return Cell(name=workload, config=config, traffic=traffic,
                settings={**config["settings"], **traffic["settings"]},
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
                limits=limits,
                chips=int(entry["chips"]) if entry else int(traffic.get("ranks", 1)),
                root=root)


def _load(path: Path, module: str) -> ModuleType:
    if module in sys.modules:
        return sys.modules[module]
    spec = importlib.util.spec_from_file_location(module, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell) -> ModuleType:
    name = cell.traffic["driver"]
    return _load(cell.root / "drivers" / f"{name}.py", f"portbench.drivers.{name}")


def load_reader(cell: Cell, metric: str):
    """``read`` of ``metrics/<metric>.py``."""
    module = "portbench.metrics." + metric.replace(".", "_").replace("-", "_")
    return _load(cell.root / "metrics" / f"{metric}.py", module).read
