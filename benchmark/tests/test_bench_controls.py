"""Each cell's control must come out as not correct: its readings exceed
one of the cell's limits.  On the CPU at a tiny size, and on the card
(marked `cuda`) at each configuration's own width with fewer records;
`python3 -m benchmark.harness.control` runs them at the cells' own
sizes."""
from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import ROOT, TINY, make_tree
from benchmark.harness import cells, control

CELLS = ["kgp3-chr20.extract", "kgp3-chr20.dotprod", "hrc.dotprod"]


def _fails(name, size, device, workdir, seed):
    bj, bench = make_tree(os.path.join(workdir, "tree"))
    cell = cells.load(name, bj, bench)
    cfg = {**cell.config, **size}
    got = control.CONTROLS[cell.traffic["operation"]](
        cfg, cell.traffic, seed, device, workdir)
    limits = cell.traffic["limits"]
    return got, any(v > limits[k] for k, v in got.items() if k in limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_cpu(tmp_path, name):
    got, fails = _fails(name, TINY, "cpu", str(tmp_path), 2**31 + 3)
    assert fails, got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(tmp_path, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = name.split(".")[0]
    with open(os.path.join(ROOT, "benchmark", "configs",
                           config + ".json")) as f:
        samples = json.load(f)["samples"]
    size = {"samples": samples, "records": 2048, "block_length": 1024}
    got, fails = _fails(name, size, "cuda", str(tmp_path), 2**31 + 4)
    assert fails, got
