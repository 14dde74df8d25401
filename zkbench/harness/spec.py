"""Find a cell's pieces by name.

``BENCHMARK.json`` at the repository root names each cell's
configuration and traffic.  Everything else is a file of its own under
``zkbench/``, found by name:

* ``configs/<config>.json``: the configuration (its ``file`` in
  ``BENCHMARK.json``);
* ``traffic/<traffic>.json``: the traffic mix's parameters, whose
  ``job`` names the job builder ``traffic/<job>.py``;
* ``machines/<machine>.py``: the entry a configuration's ``machine``
  names;
* ``metrics/<metric>.py``: the reader of a per-layer metric.

A new cell, configuration, mix or metric is a new file and an entry in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent      # zkbench/
REPO = ROOT.parent

__all__ = ["Cell", "ROOT", "REPO", "load_benchmark", "load_cell",
           "load_module", "per_layer_for", "end_to_end_for"]


@dataclass
class Cell:
    name: str
    workload: dict        # the cell's entry of BENCHMARK.json
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads(Path(path or REPO / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_for(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer_for(bench: dict, cell: str) -> list:
    """Per-layer metrics read in ``cell``: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def load_cell(name: str, bench: dict | None = None,
              root: Path | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    root = Path(root or ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root.parent / cfg["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                end_to_end=end_to_end_for(bench, name),
                per_layer=per_layer_for(bench, name))


def load_module(kind: str, name: str, root: Path | None = None):
    """``zkbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = Path(root or ROOT) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    mod_name = f"zkbench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
