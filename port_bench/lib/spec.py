"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the
model's fields and their source), ``traffic/<traffic>.json`` (which names
its driver, ``drivers/<driver>.py``, and its parameters) and
``limits/<cell>.json`` (the limit of each number its check compares).  A
per-layer metric ``<family>.<part>`` is read by ``metrics/<family>.py``.
A cell, a configuration, a traffic mix or a metric is added with files
and entries alone.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"port_bench: no file {path}")
    return json.loads(path.read_text())


def resolve(name: str, bench: Dict, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell called ``name``, with its files read and its metrics
    chosen: every end-to-end metric without ``workloads`` or listing the
    cell; every per-layer metric listing the cell, or without
    ``workloads`` and moving an end-to-end metric the cell reports."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"port_bench: no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(bench_dir.parent / conf["file"])
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, config, traffic, limits, e2e, per_layer,
                int(w["chips"]))


def driver(cell: Cell):
    """The module that runs the cell's traffic."""
    return importlib.import_module(
        f"port_bench.drivers.{cell.traffic['driver']}")


def reader(metric_name: str):
    """The ``read(record)`` function of a per-layer metric's family."""
    family = metric_name.split(".", 1)[0]
    return importlib.import_module(f"port_bench.metrics.{family}").read
