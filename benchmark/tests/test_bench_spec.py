"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files each name leads to, and the chip-time budget."""
from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT

SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    assert os.path.getsize(SPEC_PATH) <= 64 * 1024
    with open(SPEC_PATH) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["command"]) <= 32
    assert all(TEXT.match(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    for word in spec["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51


def test_check_budget_fits_24_cells(spec):
    runs = 2 + 14 * 24
    need = runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def test_names_units_and_entry_keys(spec):
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for group in (spec["configs"], spec["workloads"]):
        assert len({x["name"] for x in group}) == len(group)
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(spec["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in moved.get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in e2e.values() if w in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in spec["per_layer"])


def test_chips_and_configs(spec):
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    for c in spec["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])


def test_every_name_has_its_file(spec):
    bench = os.path.join(ROOT, "benchmark")
    for w in spec["workloads"]:
        assert os.path.isfile(os.path.join(bench, "configs",
                                           w["config"] + ".json"))
        with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.isfile(os.path.join(bench, "operations",
                                           traffic["operation"] + ".py"))
    from benchmark.harness.cells import reader_path
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.isfile(reader_path(bench, m["name"]))
