"""The device decode's chain and run flush metrics: their readers on a
synthetic trace (the program's decode.chain and decode.flush spans and
the device time under their marks), nothing read where the marks are
absent, as in a program without them, and their byte bounds against
chip_smoke.py's at the TOPMed block's shapes."""
from __future__ import annotations

import importlib.util
import os
from types import SimpleNamespace as S

import pytest
import torch

from benchmark.harness import bounds, cells, decode_bounds
from conftest import ROOT

READERS = ("chain_device_ms.dotprod", "flush_device_ms.dotprod",
           "chain_roofline.dotprod", "flush_roofline.dotprod")
#: The TOPMed block of chip_smoke.py's kernel table: 5129 WAH lines in 367
#: chunks of 14 at 194,512 haplotypes.
TOPMED = dict(n_ch=367, C=14, W=194512, n=5129)


def reader(name):
    return cells.load_module(cells.reader_path(os.path.join(ROOT, "benchmark"),
                                               name), "t_" + name)


def _spans(blocks, ops=2, chain=True, flush=True):
    """ops `dot_prod` operations of `blocks` diploid blocks each, as the
    program records them: [(n_ch, C, W, n)] a block."""
    out, ids = [], iter(range(1, 10_000))
    t = 10.0
    for _ in range(ops):
        root = S(name="dot_prod", id=next(ids), parent=None, start=t,
                 attrs={}, counts={})
        root.op = root.id
        out.append(root)
        for n_ch, C, W, n in blocks:
            dev = S(name="decode.device", id=next(ids), parent=root.id,
                    op=root.id, start=t, end=t + 0.01, attrs={}, counts={})
            out.append(dev)
            if chain:
                out.append(S(name="decode.chain", id=next(ids),
                             parent=dev.id, op=root.id, start=t,
                             end=t + 0.001,
                             attrs={"width": W, "chunk_lines": C,
                                    "route": "rows"},
                             counts={"decode.chunks": n_ch}))
            if flush:
                out.append(S(name="decode.flush", id=next(ids),
                             parent=dev.id, op=root.id, start=t + 0.001,
                             end=t + 0.002,
                             attrs={"route": "cluster", "width": W,
                                    "chunk_lines": C, "chunks": n_ch,
                                    "lines": n, "haps": W, "history": False},
                             counts={}))
            t += 0.01
        root.end = t
    for s in out:
        s.seconds = s.end - s.start
    return out


def _run(spans, under):
    ends = [s.end for s in spans if s.parent is None]
    run = S(ops=[S(end=e) for e in ends], window_start=0.0,
            traced={"device_s_under": under})
    run._program_spans = {"spans": spans, "counters": {}}
    return run


def test_readers_read_a_synthetic_trace():
    blocks = [(367, 14, 194512, 5129), (300, 14, 194512, 4190)]
    run = _run(_spans(blocks), {"decode.chain": 0.020, "decode.flush": 0.028})
    # two operations of two blocks: 20 ms and 28 ms over four blocks
    assert reader("chain_device_ms.dotprod").read(run) == pytest.approx(5.0)
    assert reader("flush_device_ms.dotprod").read(run) == pytest.approx(7.0)
    chain = 2 * sum(decode_bounds.chain_decode_bytes(n_ch, C, W)
                    for n_ch, C, W, _ in blocks)
    flush = 2 * sum(decode_bounds.flush_bytes(n_ch, C, W, W, n, False)
                    for n_ch, C, W, n in blocks)
    assert reader("chain_roofline.dotprod").read(run) == pytest.approx(
        100 * bounds.bound_ms(chain) / 20.0)
    assert reader("flush_roofline.dotprod").read(run) == pytest.approx(
        100 * bounds.bound_ms(flush) / 28.0)
    assert 0 < reader("chain_roofline.dotprod").read(run) < 100


@pytest.mark.parametrize("case", ["no marks", "no device time",
                                  "no operations", "no shape"])
def test_readers_read_nothing_where_the_marks_are_absent(case):
    """The parent's program has decode.device but neither decode.chain nor
    decode.flush: every reader gives None, and none raises."""
    blocks = [(367, 14, 194512, 5129)]
    spans = _spans(blocks, chain=case != "no marks",
                   flush=case != "no marks")
    under = {} if case != "no operations" else {"decode.chain": 0.01,
                                                "decode.flush": 0.01}
    if case == "no marks":
        under = {"device decode": 0.05}
    if case == "no shape":
        under = {"decode.chain": 0.01, "decode.flush": 0.01}
        for s in spans:
            s.attrs.pop("width", None)
            s.counts.pop("decode.chunks", None)
    run = _run(spans, under)
    if case == "no operations":
        run.ops = []
    for name in READERS:
        got = reader(name).read(run)
        if case == "no shape" and "device_ms" in name:
            assert got is not None and got > 0
        else:
            assert got is None, (name, case)


def test_readers_read_nothing_without_a_trace():
    run = _run(_spans([(367, 14, 194512, 5129)]), {})
    run.traced = None
    assert all(reader(name).read(run) is None for name in READERS)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bounds_equal_chip_smokes_at_the_topmed_block():
    smoke = _chip_smoke()
    chain, flush = decode_bounds.chain_decode_bytes, decode_bounds.flush_bytes
    n_ch, C, W, n = TOPMED["n_ch"], TOPMED["C"], TOPMED["W"], TOPMED["n"]
    meta = dict(device="meta")
    yc = torch.empty((n_ch, C, W), dtype=torch.uint8, **meta)
    ss = torch.empty((n_ch, C), dtype=torch.bool, **meta)
    assert chain(n_ch, C, W) == smoke.chain_bytes("chain_decode", (yc, ss))
    p_fin = torch.empty((n_ch, W), dtype=torch.int32, **meta)
    start = torch.empty(W, dtype=torch.int64, **meta)
    assert flush(n_ch, C, W, W, n, False) == smoke.flush_bytes(
        (p_fin, start, ss, W, n, False), {})
    # a haploid run's flush over the samples, its histories written
    Wh = W // 2
    p_h = torch.empty((n_ch, Wh), dtype=torch.int32, **meta)
    start_h = torch.empty(Wh, dtype=torch.int64, **meta)
    assert flush(n_ch, C, Wh, W, n, True) == smoke.flush_bytes(
        (p_h, start_h, ss, W, n, True), {"want_T": True})
    # the bounds chip_smoke.py printed for this block (PERF.md's table)
    assert round(bounds.bound_ms(chain(n_ch, C, W)), 5) == 0.38357
    assert round(bounds.bound_ms(flush(n_ch, C, W, W, n, False)),
                 5) == 0.38397


@pytest.fixture
def tracer():
    from xsqueezeit_tpu_torch.utils import trace
    trace.disable()
    trace.collect()
    yield trace
    trace.disable()
    trace.collect()


@pytest.mark.parametrize("name", ["kgp3-chr20.dotprod", "hrc.dotprod",
                                  "topmed-r2.dotprod"])
def test_traced_cpu_runs_read_no_device_time(tiny, tracer, name):
    """On the CPU device no kernel runs: the readers find the spans but no
    device time under their marks, and leave their metrics out."""
    result, lines, rc = tiny(name, trace=True)
    assert rc == 0 and result["correct"], lines
    assert not set(READERS) & set(result["metrics"])
    assert result["metrics"]["host_parse_ms.dotprod"]["value"] > 0
    assert not tracer.enabled()


def test_readers_find_nothing_in_a_program_without_the_tracer(
        tiny, tracer, monkeypatch):
    """An older checkout of the program has no tracer: the readers install
    and read without raising, and leave their metrics out.  Every module
    of the program is imported first: the run's own imports must not meet
    the missing module, in a worker process that has imported none yet."""
    import pkgutil
    import sys

    import xsqueezeit_tpu_torch
    import xsqueezeit_tpu_torch.utils as utils
    for mod in pkgutil.walk_packages(xsqueezeit_tpu_torch.__path__,
                                     "xsqueezeit_tpu_torch."):
        importlib.import_module(mod.name)
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "xsqueezeit_tpu_torch.utils.trace",
                        None)
    result, lines, rc = tiny("topmed-r2.dotprod", trace=True)
    assert rc == 0 and result["correct"], lines
    assert not set(READERS) & set(result["metrics"])
