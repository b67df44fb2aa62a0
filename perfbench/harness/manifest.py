"""The benchmark's data, found by name: `BENCHMARK.json` at the root of a
checkout, and under `perfbench/` one file for each configuration
(`configs/<config>.json`, named by the manifest), traffic mix
(`traffic/<traffic>.json`), cell's comparison limits
(`limits/<workload>.json`) and metric (`metrics/<metric>.py`, a reader).
A new cell, mix or metric is new files and a manifest entry: no file the
harness already has changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str = ROOT) -> str:
    return os.path.join(root, "perfbench")


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            cfg = _json(os.path.join(root, c["file"]))
            cfg.setdefault("name", name)
            return cfg
    raise SystemExit(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(bench_dir(root), "traffic", f"{name}.json"))


def limits(name: str, root: str = ROOT) -> dict:
    """The cell's comparison limits: {number: limit}."""
    return _json(os.path.join(bench_dir(root), "limits", f"{name}.json"))


def reader(name: str, root: str = ROOT):
    """The module of metric `name`: perfbench/metrics/<name>.py, whose
    read(rec) returns the metric's value or None."""
    path = os.path.join(bench_dir(root), "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reported(man: dict, wl: dict, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics cell `wl` reports:
    those that list it under `workloads`; an end-to-end metric that lists
    no cells, in every cell."""
    return [m for m in man[kind]
            if wl["name"] in m.get("workloads", [wl["name"]])]
