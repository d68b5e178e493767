"""Everything of a cell is found by name, in files of its own.

* a cell:          ``workloads/<cell>.json``  (config, traffic, entry, chips, why)
* a configuration: ``configs/<config>.json``
* a traffic mix:   ``traffic/<mix>.json``     (read by ``harness.traffic``)
* an entry:        ``entries/<entry>.py``     (defines ``run(ctx)``)
* a metric:        ``metrics/<metric>.py``    (UNIT, LAYER, MOVES, SOURCE, ``read(run)``)

``BENCHMARK.json`` at the checkout's root says which metrics each cell
reports. A later change adds a cell, a mix or a metric as new files and
entries there, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """The files under ``root`` (default: this benchmark's folder) and the
    benchmark definition ``bench`` (default: the checkout's
    ``BENCHMARK.json``)."""

    def __init__(self, root: Path | None = None, bench: dict | None = None):
        self.root = Path(root) if root is not None else BENCH_DIR
        self.bench = (bench if bench is not None
                      else _json(CHECKOUT / "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        return _json(self.root / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return _json(self.root / "configs" / f"{name}.json")

    def mix(self, name: str) -> dict:
        return _json(self.root / "traffic" / f"{name}.json")

    def entry(self, name: str) -> ModuleType:
        return _module(self.root / "entries" / f"{name}.py",
                       f"cobsbench_entry_{name}")

    def metric(self, name: str) -> ModuleType:
        return _module(self.root / "metrics" / f"{name}.py",
                       "cobsbench_metric_" + name.replace(".", "_"))

    def workload(self, name: str) -> dict:
        """The cell's entry in BENCHMARK.json."""
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics_of(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports. A
        per-layer metric without ``workloads`` goes with every cell that
        reports the end-to-end metric it moves."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
