"""The topmed-r2 cell on the port's CPU device: at the tiny cut of every
cell (conftest.TINY), and on the port's wide route, its configuration cut
to 32,800 samples (65,600 haplotypes, the narrowest
width above the 16-bit slot field: 32-bit sparse and track streams, the
decode chain's state (slot << 15) | beta in 15-line chunks), 300 records
and blocks of 256 (two blocks).  The run goes through the cell's own path,
the program's `-c` and `bench.tools.dot_prod`, traced, so the program's
spans say which route each block took."""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from conftest import make_tree

CUT = {"samples": 32800, "records": 300, "block_length": 256}
SEED = 2**33 + 7
CELL = "topmed-r2.dotprod"


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    from benchmark.harness import cells, program_spans, runner
    from xsqueezeit_tpu_torch.utils import trace

    trace.disable()
    trace.collect()
    bj, bench = make_tree(str(tmp_path_factory.mktemp("tree")))
    path = os.path.join(bench, "configs", "topmed-r2.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(CUT)
    with open(path, "w") as f:
        json.dump(cfg, f)
    cell = cells.load(CELL, bj, bench)
    run = runner.Run(cell=cell, seed=SEED, seconds=0.4, trace=True,
                     device="cpu", workdir=str(tmp_path_factory.mktemp("w")),
                     t_start=time.perf_counter())
    try:
        result, lines, rc = runner.run_cell(run)
        ops = program_spans.operations(run, "dot_prod")
    finally:
        trace.disable()
        trace.collect()
    return run, result, lines, rc, ops


def test_the_cut_stays_on_the_wide_route():
    from benchmark.harness import gen
    from xsqueezeit_tpu_torch.ops import pbwt_kernels
    H = gen.n_haps(CUT)
    assert H == 65600 and H > pbwt_kernels.SLOT16_H
    assert pbwt_kernels.decode_chunk(H) == 15
    assert -(-CUT["records"] // CUT["block_length"]) == 2


def test_wide_cell_runs_correct(wide):
    _, result, lines, rc, _ = wide
    assert rc == 0 and result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["checks"]["dot_rel_err"]["value"] <= 1e-5


def test_wide_cell_dots_match_the_reference(wide):
    from benchmark.reference import dots
    run, *_ = wide
    want = dots.dots(run.cell.config, SEED, SEED, "cpu")
    assert want.shape == (CUT["records"],)
    done = run.completed()
    assert done
    for r in done:
        got = np.asarray(r.done.output)
        assert dots.rel_err(got, want) <= 1e-5


def test_wide_cell_blocks_take_the_device_route(wide):
    *_, ops = wide
    assert ops
    for _, spans in ops:
        blocks = [s for s in spans if s.name == "dot_prod.block"]
        assert [s.attrs for s in blocks] == [
            {"block": k, "route": "device"} for k in range(2)]


def test_wide_cell_spans_read_32_bit_streams_and_15_line_chunks(wide):
    *_, ops = wide
    for _, spans in ops:
        parse = [s.attrs for s in spans
                 if s.name == "decode.parse" and s.attrs]
        assert parse == [{"aet_bits": 32}] * 2
        chains = [s for s in spans if s.name == "decode.chain"]
        assert [s.attrs for s in chains] == [
            {"width": 65600, "chunk_lines": 15, "route": "plain"}] * 2
        flushes = [s for s in spans if s.name == "decode.flush"]
        assert len(flushes) == 2
        assert all(s.attrs["chunk_lines"] == 15 for s in flushes)


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_correct(tiny, traced):
    """The cell at the tiny cut, as the other cells run in
    test_bench_runs.py: correct, its end-to-end metrics untraced, its
    per-layer metrics (those the CPU device can read) traced."""
    with open(tiny.bj) as f:
        spec = json.load(f)
    result, lines, rc = tiny(CELL, trace=traced)
    assert rc == 0 and result["correct"], (result, lines)
    assert result["attempted"] >= 1 and result["failed"] == 0
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in spec[kind]
            if CELL in m.get("workloads", [CELL])}
    if traced:
        assert set(result["metrics"]) <= want
        assert "host_parse_ms.dotprod" in result["metrics"]
        assert result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
