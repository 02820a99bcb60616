"""Everything of one cell, found by the names in ``BENCHMARK.json``.

A configuration is ``configs/<config>.json``; a traffic mix is
``traffic/<mix>.json``, which names its driver, ``drivers/<driver>.py``; a
per-layer metric is read by ``metrics/<metric>.py``; a roofline divides by
``work/<name>.py``; an index kind is judged by ``reference/<kind>.py``; a
cell's limits are ``limits/<cell>.json``. Python files load by path, so a
name may hold dots and dashes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


_MODULES: Dict[str, ModuleType] = {}


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark's folder, loaded once."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"portbench_{kind}_{name}"
    mod = _MODULES.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<mix>.json
    limits: dict          # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]  # the per-layer metrics this cell reports

    @property
    def kind(self) -> str:
        return self.config["db"]["index"]["kind"]

    def driver(self) -> ModuleType:
        return load_module("drivers", self.traffic["driver"])

    def reference(self) -> ModuleType:
        return load_module("reference", self.kind)


def load_cell(name: str, bench_path: str = None) -> Cell:
    bench = read_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = read_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    limits = read_json(os.path.join(BENCH_DIR, "limits", name + ".json"))

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])
