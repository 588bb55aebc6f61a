"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by its name:

- the configuration: the file that its ``BENCHMARK.json`` entry names (the
  program's conf, the reference model, the counts module, what is assumed);
- the traffic mix: ``<bench>/traffic/<traffic>.json`` (the scene's
  parameters);
- the cell's limits of the comparison that decides ``correct``:
  ``<bench>/limits/<workload>.json``;
- a per-layer metric's reader: ``<bench>/metrics/<name>.py``, whose
  ``read(readings)`` returns the number or None.

``bench`` is the benchmark's folder beside ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

REPO = Path(__file__).resolve().parent.parent
BENCH = "benchmark"


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _load_reader(path: Path) -> Callable:
    name = "benchmark_metric_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reported(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load(workload: str, root: Path = REPO) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the cells are {sorted(cells)}")
    w = cells[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    folder = root / BENCH
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((folder / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((folder / "limits" / f"{workload}.json").read_text())
    cell = Cell(workload, int(w["chips"]), config, traffic, limits)
    cell.end_to_end = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"]
                       if _reported(m, workload)]
    for m in bench["per_layer"]:
        if _reported(m, workload):
            cell.per_layer.append(Metric(m["name"], m["unit"],
                                         _load_reader(folder / "metrics" / f"{m['name']}.py")))
    return cell
