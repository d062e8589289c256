"""Finds what ``BENCHMARK.json`` names: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``), its
own settings of the check (``workloads/<cell>.json``), and each per-layer
metric's reader (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name, self.chips = name, int(self.entry["chips"])
        self.config = _json(HERE, "configs", f"{self.entry['config']}.json")
        self.traffic = _json(HERE, "traffic", f"{self.entry['traffic']}.json")
        self.settings = _json(HERE, "workloads", f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name]) and m["moves"] in reported]

    @property
    def config_dir(self) -> str:
        return os.path.join(HERE, "configs")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (the name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(kind: str) -> dict | None:
    """The published peaks of the card ``kind`` (``peaks.json``), or None."""
    table = _json(HERE, "peaks.json")
    for name, row in table["cards"].items():
        if name == kind or row.get("match", "\0") in kind:
            return row
    return None
