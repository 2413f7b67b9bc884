"""Find a cell's files by name: its workload, its configuration, its driver
and the readers of its per-layer metrics.  Adding a cell, a configuration
or a metric adds files and ``BENCHMARK.json`` entries; nothing here names
one."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    return _json(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return _module(os.path.join(HERE, "drivers", f"{kind}.py"), f"portbench.drivers.{kind}")


def reader(metric: str):
    """The ``read(summary)`` of a per-layer metric."""
    return _module(os.path.join(HERE, "metrics", f"{metric}.py"),
                   f"portbench.metrics.{metric.replace('.', '_')}").read


def end_to_end(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list:
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]
