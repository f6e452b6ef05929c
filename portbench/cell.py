"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix.  The configuration's
file (``configs/``) names its family, whose module (``families/``) knows
the weights' layout and builds the program; the traffic file
(``traffic/<name>.json``) names the driver (``drivers/``) that runs it;
each per-layer metric is a reader in ``metrics/<metric name>.py``; the
limits of the comparison that decides ``correct`` are in
``limits/<workload>.json``.  A later cell, configuration or metric adds
files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    family: Any = None
    driver: Any = None
    readers: Dict[str, Callable] = field(default_factory=dict)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def reader(name: str) -> Callable:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read(run) -> float | None``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find(workload: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``bench`` (default: the repo's
    ``BENCHMARK.json``), its files loaded and its modules imported."""
    bench = bench if bench is not None else benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, e2e_names)]
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    cell = Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                limits=limits)
    cell.family = importlib.import_module(
        f"portbench.families.{config['family']}")
    cell.driver = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}")
    cell.readers = {m["name"]: reader(m["name"]) for m in per_layer}
    return cell
