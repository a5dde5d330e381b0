"""A cell, found by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file, its limits file and its metrics'
readers. Nothing here names a cell, a configuration or a metric: a new one
is new files and a new entry.

* ``configs/<config>.json``: {"source", "reduced", "assumed", "reference",
  "config"}: the config as it is run, in the shipped YAML's schema, and the
  name of its plain reference, a module ``reference/<name>.py`` that
  exports ``reference.CONTRACT`` (there is no default);
* ``traffic/<traffic>.json``: {"driver": one of ``drivers/``, and that
  driver's parameters};
* ``limits/<cell>.json``: {"<number>": limit} for every number the
  comparison holds;
* ``metrics/<metric>.py``: a function ``read(rec)`` that returns the
  metric's value from a run's records, or None where it finds nothing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

from ..reference import CONTRACT

HERE = Path(__file__).resolve().parent.parent  # benchmark/


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config_file: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    reference: ModuleType
    root: Path = HERE

    @property
    def cfg(self) -> Dict[str, Any]:
        return self.config_file["config"]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config: str, config_file: Dict[str, Any], root: Path = HERE) -> ModuleType:
    """The plain reference module that ``config``'s file names, from the
    tree ``root``. It is imported as ``benchmark.reference.<name>``, so that
    a reference of a tree of its own builds on the package's by relative
    import. Raises KeyError, with the configuration's name, when the file
    names none, or a module that is not there or lacks part of the contract."""
    name = config_file.get("reference")
    path = root / "reference" / f"{name}.py"
    if not isinstance(name, str) or not name.isidentifier() or not path.is_file():
        raise KeyError(f"configuration {config!r}: its file names no reference module under "
                       f"{root / 'reference'} (\"reference\": {name!r})")
    qualified = f"benchmark.reference.{name}"
    mod = importlib.import_module(qualified) if root == HERE else load_module(path, qualified)
    missing = [k for k in CONTRACT if not hasattr(mod, k)]
    if missing:
        raise KeyError(f"configuration {config!r}: reference {name!r} lacks {missing}")
    return mod


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(bench: Dict[str, Any], name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of the parsed ``BENCHMARK.json``; raises KeyError
    when there is no such cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}: one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfile = json.loads((root.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per = [m for m in bench["per_layer"] if _applies(m, name)]
    ref = reference(w["config"], cfile, root)
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), cfile, traffic, limits, e2e, per, ref, root)


def driver(cell: Cell) -> ModuleType:
    return load_module(cell.root / "drivers" / f"{cell.traffic['driver']}.py", f"bench_driver_{cell.traffic['driver']}")


def reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(cell.root / "metrics" / f"{metric}.py", f"bench_metric_{metric.replace('.', '_')}")


@dataclass
class Records:
    """What a run hands the metrics' readers."""

    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    requests: int = 0  # completed in the window
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Any = None
    counts: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)
    reference: Optional[ModuleType] = None  # the configuration's reference module


def read_metrics(cell: Cell, rec: Records) -> Dict[str, Optional[float]]:
    out = {}
    for m in cell.per_layer:
        out[m["name"]] = reader(cell, m["name"]).read(rec)
    return out
