"""Whole runs of each cell at a tiny size on the port's CPU device, the
refusals of run.py, and a cell, a configuration, a traffic mix and a
per-layer metric added as new files only."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["kgp3-chr20.extract", "kgp3-chr20.dotprod", "hrc.dotprod"]


def spec(tiny):
    with open(tiny.bj) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(tiny, name):
    result, lines, rc = tiny(name)
    assert rc == 0, lines
    assert result["correct"], (result, lines)
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"] for m in spec(tiny)["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert lines[-len(result["checks"]):] == [
        l for l in lines if l.startswith("check ")]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(tiny, name):
    result, lines, rc = tiny(name, trace=True)
    assert rc == 0 and result["correct"], lines
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result
    layer = {m["name"] for m in spec(tiny)["per_layer"]
             if name in m.get("workloads", [name])}
    # on the CPU device no kernel runs: only host spans and the trace
    assert set(result["metrics"]) <= layer
    assert any(k.startswith(("fold_ms", "host_parse_ms"))
               for k in result["metrics"])


def test_unknown_cell_is_refused(tiny):
    from benchmark.harness import cells
    with pytest.raises(cells.UnknownCell):
        cells.load("no-such.cell", tiny.bj, tiny.bench)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                       "run.py"),
                          "--workload", "no-such.cell", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_run_without_a_card_fails_with_one_line():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark",
                                                       "run.py"),
                          "--workload", "kgp3-chr20.dotprod",
                          "--seed", str(2**31 + 9),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
    assert len(out.stderr.strip().splitlines()) == 1


def test_a_metric_kind_reads_through_its_kinds_file(tiny):
    from benchmark.harness import cells
    bench = tiny.bench
    assert cells.reader_path(bench, "idle_pct.extract").endswith(
        os.path.join("metrics", "idle_pct.py"))
    assert cells.reader_path(bench, "fold_ms.extract").endswith(
        os.path.join("metrics", "fold_ms.extract.py"))
    cell = cells.load("hrc.dotprod", tiny.bj, bench)
    assert cell.readers["idle_pct.dotprod"].__file__.endswith("idle_pct.py")


def test_a_cell_is_added_by_files_only(tiny):
    """A configuration, a mix and a per-layer metric, each a new file, and
    new entries in BENCHMARK.json: the harness finds them by name."""
    bench = tiny.bench
    with open(os.path.join(bench, "configs", "kgp3-chr20.json")) as f:
        cfg = json.load(f)
    cfg.update(name="kgp3-chr20-wide", samples=40)
    with open(os.path.join(bench, "configs", "kgp3-chr20-wide.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "extract.json")) as f:
        mix = json.load(f)
    mix["output_type"] = "u"
    with open(os.path.join(bench, "traffic", "extract-plain.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "ops_done.extract.py"),
              "w") as f:
        f.write("def install(probe):\n    pass\n\n\n"
                "def read(run):\n    return float(len(run.completed()))\n")
    with open(tiny.bj) as f:
        s = json.load(f)
    s["configs"].append({"name": "kgp3-chr20-wide", "source": "x",
                         "file": "benchmark/configs/kgp3-chr20-wide.json",
                         "reduced": ["records"], "why": "x"})
    s["workloads"].append({"name": "kgp3-chr20-wide.extract-plain",
                           "config": "kgp3-chr20-wide",
                           "traffic": "extract-plain", "chips": 1,
                           "why": "x"})
    for m in s["end_to_end"]:
        if m["name"] == "extract_gbps":
            m["workloads"].append("kgp3-chr20-wide.extract-plain")
    s["per_layer"].append({"name": "ops_done.extract", "unit": "ops",
                           "better": "higher", "source": "host_clock",
                           "layer": "client", "moves": "extract_gbps",
                           "workloads": ["kgp3-chr20-wide.extract-plain"]})
    with open(tiny.bj, "w") as f:
        json.dump(s, f)
    result, lines, rc = tiny("kgp3-chr20-wide.extract-plain")
    assert rc == 0 and result["correct"], lines
    assert "extract_gbps" in result["metrics"]
    result, lines, rc = tiny("kgp3-chr20-wide.extract-plain", trace=True)
    assert rc == 0 and result["correct"], lines
    assert result["metrics"]["ops_done.extract"]["value"] >= 1
