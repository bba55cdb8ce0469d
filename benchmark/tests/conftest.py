"""Fixtures of the benchmark's CPU tests: the repository root on the path,
and a copy of the benchmark's data files with its configurations cut to a
size a test holds, run on the port's CPU device.

The copy's BENCHMARK.json also holds the extract cell, which the real one
leaves out while its host path spreads wider than any bound allowed
(PERF.md): its operation, readers, reference reader and control stay
held by these tests, so that the cell comes back as entries alone."""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"samples": 24, "records": 1100, "block_length": 256}

#: The extract cell's entries, added to the copy's BENCHMARK.json.
EXTRACT = {
    "workloads": [
        {"name": "kgp3-chr20.extract", "config": "kgp3-chr20",
         "traffic": "extract", "chips": 1,
         "why": "whole 4-block container to BCF back to back, one client: "
                "the host gt fold and BCF emit, the device decode a small "
                "part"}],
    "end_to_end": [
        {"name": "extract_gbps", "unit": "GB/s", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["kgp3-chr20.extract"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "extract_gbps",
         "workloads": ["kgp3-chr20.extract"]}
        for name, unit, source, layer in (
            ("fold_ms.extract", "ms", "program_span", "host block decode"),
            ("decode_device_ms.extract", "ms", "device_trace",
             "device decode"),
            ("idle_pct.extract", "%", "device_trace", "device"))],
}


def make_tree(dst: str) -> tuple[str, str]:
    """Copy BENCHMARK.json, with the extract cell added, and the
    benchmark's configs, traffic, operations and metrics under `dst`, the
    configurations cut to TINY.
    Returns (BENCHMARK.json path, benchmark dir)."""
    src = os.path.join(ROOT, "benchmark")
    bench = os.path.join(dst, "benchmark")
    for sub in ("configs", "traffic", "operations", "metrics"):
        shutil.copytree(os.path.join(src, sub), os.path.join(bench, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name in os.listdir(os.path.join(bench, "configs")):
        p = os.path.join(bench, "configs", name)
        with open(p) as f:
            cfg = json.load(f)
        cfg.update(TINY)
        with open(p, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for key, entries in EXTRACT.items():
        spec[key] += entries
    bj = os.path.join(dst, "BENCHMARK.json")
    with open(bj, "w") as f:
        json.dump(spec, f, indent=1)
    return bj, bench


def run_tiny(bj: str, bench: str, name: str, workdir: str,
             seconds: float = 0.4, trace: bool = False,
             seed: int = 2**31 + 5):
    """run_cell of `name` on the CPU device: (result, stderr lines, rc)."""
    from benchmark.harness import cells, runner
    cell = cells.load(name, bj, bench)
    run = runner.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                     device="cpu", workdir=workdir,
                     t_start=time.perf_counter())
    return runner.run_cell(run)


@pytest.fixture
def tiny(tmp_path):
    bj, bench = make_tree(str(tmp_path / "tree"))
    work = tmp_path / "work"
    work.mkdir()

    def run(name, **kw):
        return run_tiny(bj, bench, name, str(work), **kw)
    run.bj, run.bench = bj, bench
    return run
