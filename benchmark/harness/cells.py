"""Finds a cell's parts by the names in BENCHMARK.json.

Everything that belongs to one configuration, one traffic mix, one
operation or one metric is a file of its own under the benchmark's
folder, found by name, so a later change adds a cell, a configuration, a
mix or a metric by adding files and entries and edits none:

- ``configs/<config>.json``: the deployment's sizes and its source;
- ``traffic/<traffic>.json``: the mix's parameters, and the name of the
  operation that serves it;
- ``operations/<operation>.py``: the closed-loop client's set-up, one
  operation, its logical bytes and the comparison that decides
  ``correct``;
- ``metrics/<metric>.py``: one metric's reader (end-to-end or per-layer);
  where there is none, ``metrics/<kind>.py``, the reader of every metric
  whose name starts with ``<kind>.`` (``idle_pct.extract`` and
  ``idle_pct.dotprod`` share ``metrics/idle_pct.py``).
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class UnknownCell(LookupError):
    """A workload name that BENCHMARK.json does not hold."""


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything its run needs."""
    name: str
    chips: int
    config: dict
    traffic: dict
    operation: object               # the operation module
    end_to_end: list[dict]          # the metrics this cell reports
    per_layer: list[dict]
    readers: dict                   # metric name -> reader module


def load_module(path: str, tag: str):
    """Import the file at `path` as a module of its own."""
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(bench_dir: str, metric: str) -> str:
    """The reader of `metric`: its own file, or its kind's."""
    own = os.path.join(bench_dir, "metrics", metric + ".py")
    if os.path.exists(own):
        return own
    return os.path.join(bench_dir, "metrics", metric.split(".")[0] + ".py")


def load(name: str, bench_json: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of the BENCHMARK.json at `bench_json`, with its
    configuration, mix, operation and metric readers loaded from
    `bench_dir`.  Raises UnknownCell for a name it does not hold."""
    spec = _json(bench_json)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise UnknownCell(f"unknown workload {name!r}; BENCHMARK.json "
                          f"holds {sorted(cells)}")
    w = cells[name]
    config = _json(os.path.join(bench_dir, "configs", w["config"] + ".json"))
    traffic = _json(os.path.join(bench_dir, "traffic",
                                 w["traffic"] + ".json"))
    op = load_module(os.path.join(bench_dir, "operations",
                                  traffic["operation"] + ".py"),
                     "bench_op_" + traffic["operation"])
    e2e = [m for m in spec["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in moved and reports(m, name)]
    readers = {m["name"]: load_module(reader_path(bench_dir, m["name"]),
                                      "bench_metric_"
                                      + re.sub(r"\W", "_", m["name"]))
               for m in e2e + layer}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, operation=op, end_to_end=e2e,
                per_layer=layer, readers=readers)
