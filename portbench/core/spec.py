"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json`` (the entry's ``file``): the model's sizes, tier,
  caps, peaks and limits, and its ``family``;
- ``families/<family>.py``: the model family's build, recorder wraps, loop
  counters, work count and reference check;
- ``traffic/<traffic>.json``: a mix's parameters, with the generator
  ``kind`` that reads them, ``traffic/kinds/<kind>.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``.

It also names the packages no run may load (``FORBIDDEN``), which the
harness looks for once the window has closed and again after the check.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Callable, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "realtime_whisper_asr_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot),
    compared whole, is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


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


def model_family(root: str, config: dict):
    """The module of the model family that configuration ``config`` names
    (its ``"family"``): ``build(cfg, seed, device)``, ``attach(rec, asr)``,
    ``loop_stats(asr)``, ``work(cfg, rec, dispatch)`` and ``check(rec, cfg,
    seed, device, control)``."""
    if "family" not in config:
        raise KeyError(f"configuration {config.get('name')!r} names no \"family\"")
    name = config["family"]
    path = os.path.join(root, "portbench", "families", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"configuration {config.get('name')!r} names the model "
                                f"family {name!r}, but there is no {path}")
    return _load_module(path, f"family_{name}")


def metric_reader(root: str, name: str) -> Callable:
    """The reader of per-layer metric ``name``: ``read(run) -> float | None``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    return _load_module(path, "metric_" + name.replace(".", "_").replace("-", "_")).read
