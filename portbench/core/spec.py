"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the entry's ``file``): the model's sizes, tier,
  caps, peaks and limits;
- ``traffic/<traffic>.json``: a mix's parameters, with the generator
  ``kind`` that reads them, ``traffic/kinds/<kind>.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    """One workload of the benchmark with everything it names."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(bench_path: str, name: str, root: Optional[str] = None) -> Cell:
    """The cell ``name`` of the benchmark file at ``bench_path``; file paths
    in it are relative to ``root`` (the file's directory by default)."""
    bench = load_json(bench_path)
    root = root or os.path.dirname(os.path.abspath(bench_path))
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(traffic_dir(root), work["traffic"] + ".json"))
    return Cell(name, work, config, traffic,
                [m for m in bench["end_to_end"] if _in_cell(m, name)],
                [m for m in bench["per_layer"] if _in_cell(m, name)])


def traffic_dir(root: str) -> str:
    return os.path.join(root, "portbench", "traffic")


def _load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(root: str, kind: str):
    """The generator module of a traffic kind: ``run(ctx)``."""
    return _load_module(os.path.join(traffic_dir(root), "kinds", f"{kind}.py"), f"kind_{kind}")


def metric_reader(root: str, name: str) -> Callable:
    """The reader of per-layer metric ``name``: ``read(run) -> float | None``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    return _load_module(path, "metric_" + name.replace(".", "_").replace("-", "_")).read
