"""The mixed-ploidy cell, topmed-r2-chrx-males.dotprod-ploidy, on the CPU:
whole runs cut small, traced and untraced; its generator chunk by chunk
and its BCF read back by the reference's reader; a broken operation caught
by its check; its control; the three readers it adds (mixed_device_ms,
mixed_roofline, product_roofline) on a synthetic trace, and nothing read
where their marks or shapes are absent, as in a program without them;
their byte bounds against chip_smoke.py's."""
from __future__ import annotations

import importlib.util
import json
import os
from types import SimpleNamespace as S

import numpy as np
import pytest
import torch

from benchmark.harness import (bounds, cells, control_ploidy, gen,
                               gen_ploidy, ploidy_bounds)
from benchmark.reference import dots as ref_dots
from benchmark.reference import ploidy_dots
from benchmark.reference.bcf import BcfFile
from conftest import ROOT, make_tree, run_tiny

CELL = "topmed-r2-chrx-males.dotprod-ploidy"
READERS = ("mixed_device_ms.dotprod", "mixed_roofline.dotprod",
           "product_roofline.dotprod")
#: GRCh38 PAR1's last base.
PAR1_END = 2781479
#: The cell cut small: 45 males (90 and 45 slots, neither a multiple of
#: 16), 600 records in blocks of 256, PAR1's end after record 127: block 0
#: mixed, blocks 1 and 2 haploid.
SMALL = {"samples": 45, "records": 600, "block_length": 256,
         "first_pos": PAR1_END - 37 * 127}


def config(**over) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "topmed-r2-chrx-males.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL)
    cfg.update(over)
    return cfg


@pytest.fixture
def small(tmp_path):
    """Run the cell cut to SMALL on the CPU device."""
    bj, bench = make_tree(str(tmp_path / "tree"))
    path = os.path.join(bench, "configs", "topmed-r2-chrx-males.json")
    with open(path, "w") as f:
        json.dump(config(), f)
    work = tmp_path / "work"
    work.mkdir()

    def run(**kw):
        return run_tiny(bj, bench, CELL, str(work), **kw)
    run.bj = bj
    return run


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_cell_runs_correct(small, trace):
    result, lines, rc = small(trace=trace)
    assert rc == 0 and result["correct"], (result, lines)
    assert result["attempted"] >= 1 and result["failed"] == 0
    with open(small.bj) as f:
        spec = json.load(f)
    if not trace:
        assert set(result["metrics"]) == {"dotprod_gbps", "setup_s"}
        assert all(v["value"] > 0 for v in result["metrics"].values())
        return
    layer = {m["name"] for m in spec["per_layer"]
             if CELL in m.get("workloads", [CELL])}
    assert set(READERS) <= layer
    assert "decode_device_ms.dotprod" not in layer
    # on the CPU device no kernel runs: host spans only, no device reader
    assert set(result["metrics"]) <= layer
    assert not set(READERS) & set(result["metrics"])
    assert result["metrics"]["host_parse_ms.dotprod"]["value"] > 0
    labels = {k for k, _ in result["breakdown"]["idle_gaps"]}
    assert "decode.mixed" in labels


def test_logical_bytes_are_the_gt_arrays():
    cfg = config(samples=48628, records=16384, block_length=8192,
                 first_pos=2629928)
    assert gen_ploidy.ploidy(cfg).tolist() == [2] * 4096 + [1] * 12288
    assert gen_ploidy.logical_bytes(cfg) == 3_983_605_760
    pos = gen.positions(cfg)
    assert (pos[4095], pos[4096]) == (2781443, 2781480)


def test_draw_chunk_by_chunk_equals_the_draw_made_whole():
    """Any chunk drawn alone by a fresh draw equals the same chunk of a
    draw made in order; every record's ALT count lies in [1, n - 1] of its
    own haplotypes."""
    cfg = config(samples=20, records=2600, first_pos=PAR1_END - 37 * 1499)
    seed = 2**31 + 41
    whole = gen_ploidy.PloidyDraw(cfg, seed, "cpu")
    chunks = [whole.alleles(c) for c in range(gen.n_chunks(cfg))]
    assert [c[0].all() for c in chunks] == [True, False, False]
    assert [c[0].any() for c in chunks] == [True, True, False]
    for c in (2, 1, 0):
        dip, a2, a1 = gen_ploidy.PloidyDraw(cfg, seed, "cpu").alleles(c)
        want = chunks[c]
        assert np.array_equal(dip, want[0])
        for got, ref in ((a2, want[1]), (a1, want[2])):
            assert (got is None) == (ref is None)
            if got is not None:
                assert torch.equal(got, ref)
    n = cfg["samples"]
    for dip, a2, a1 in chunks:
        for a, width in ((a2, 2 * n), (a1, n)):
            if a is not None:
                assert a.shape[1] == width
                count = a.sum(1)
                assert int(count.min()) >= 1 and int(count.max()) <= width - 1
    counts = gen_ploidy.HaploidDraw(cfg, seed, "cpu").counts
    assert counts.min() >= 1 and counts.max() <= n - 1


def test_bcf_reads_back_as_drawn(tmp_path):
    """The reference's BCF reader gives every record's site and GT: 2N
    phased values inside PAR1, N haploid ones outside."""
    cfg = config(records=300)
    seed = 2**31 + 43
    path = str(tmp_path / "p.bcf")
    gen_ploidy.write_bcf(path, cfg, seed, "cpu", threads=2)
    bcf = BcfFile(path)
    n = cfg["samples"]
    assert bcf.samples == [f"S{i}" for i in range(n)]
    draw = gen_ploidy.PloidyDraw(cfg, seed, "cpu")
    want = [r for c in range(gen.n_chunks(cfg)) for r in draw.rows(c)]
    pos = gen.positions(cfg)
    recs = list(bcf)
    assert len(recs) == len(want) == 300
    for i, (rec, row) in enumerate(zip(recs, want)):
        assert (rec.pos, rec.id, rec.alleles) == (pos[i] - 1, f"rs{i}",
                                                  ["G", "A"])
        assert np.array_equal(rec.gt, row)
        if i < 128:
            assert rec.gt.shape == (2 * n,) and (rec.gt[1::2] & 1).all()
        else:
            assert rec.gt.shape == (n,) and set(rec.gt.tolist()) <= {2, 4}


def test_reference_dots_weigh_ploidy():
    """Diploid records sum both slots' sample weight, haploid ones one
    weight a sample."""
    cfg = config(records=300)
    seed = 2**31 + 47
    got = ploidy_dots.dots(cfg, seed, 5, "cpu")
    y = ref_dots.phenotype(cfg["samples"], 5)
    draw = gen_ploidy.PloidyDraw(cfg, seed, "cpu")
    rows = [r for c in range(gen.n_chunks(cfg)) for r in draw.rows(c)]
    for i, row in enumerate(rows):
        alt = (row >> 1) - 1 == 1
        w = np.repeat(y, 2) if row.shape[0] == 2 * len(y) else y
        assert got[i] == pytest.approx(float(w[alt].sum()), rel=1e-12)


def test_control_fails_the_cells_limit(tmp_path):
    """The TF32 dots against the float64 ones exceed the cell's limit."""
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "dotprod-ploidy.json")) as f:
        limit = json.load(f)["limits"]["dot_rel_err"]
    cfg = config(samples=4000, records=300)
    got = control_ploidy.control_dotprod_ploidy(cfg, {}, 2**31 + 53, "cpu",
                                                str(tmp_path))
    assert got["dot_rel_err"] > limit, got


def test_a_broken_operation_is_incorrect(small, monkeypatch):
    """Every other dot perturbed by 1e-4 relative: not correct."""
    from xsqueezeit_tpu_torch.bench import tools
    orig = tools._dot_prod_device

    def broken(path, seed, device):
        out = orig(path, seed, device)
        out["dots"] = out["dots"].copy()
        out["dots"][::2] *= 1 + 1e-4
        return out
    monkeypatch.setattr(tools, "_dot_prod_device", broken)
    result, lines, rc = small(seconds=0.3)
    assert rc == 0
    assert result["correct"] is False, (result, lines)
    assert result["checks"]["dot_rel_err"]["value"] > 1e-5


# --- the readers on a synthetic trace -----------------------------------

def reader(name):
    return cells.load_module(cells.reader_path(os.path.join(ROOT, "benchmark"),
                                               name), "t_" + name)


#: The cell's two blocks, as the program's spans name them.
MIXED = dict(haps=97256, w_max=6484, lines=8192, wah_lines=5000,
             haploid_lines=4096, stream_words=3_000_000,
             sparse_values=400_000)
PRODUCTS = (dict(rows=8192, width=97256, mode="mixed", samples=48628,
                 loads=1),
            dict(rows=8192, width=48628, mode="haploid", samples=48628,
                 loads=1))


def _spans(ops=2, mixed=True, samples=True):
    out, ids = [], iter(range(1, 10_000))
    t = 10.0
    for _ in range(ops):
        root = S(name="dot_prod", id=next(ids), parent=None, start=t,
                 attrs={}, counts={})
        root.op = root.id
        out.append(root)
        for k, product in enumerate(PRODUCTS):
            dev = S(name="decode.device", id=next(ids), parent=root.id,
                    op=root.id, start=t, end=t + 0.01, attrs={}, counts={})
            out.append(dev)
            if k == 0 and mixed:
                out.append(S(name="decode.mixed", id=next(ids),
                             parent=dev.id, op=root.id, start=t,
                             end=t + 0.009, attrs=dict(MIXED), counts={}))
            attrs = dict(product)
            if not samples:
                attrs.pop("samples")
                attrs.pop("loads")
            out.append(S(name="dot_prod.product", id=next(ids),
                         parent=root.id, op=root.id, start=t + 0.01,
                         end=t + 0.011, attrs=attrs, counts={}))
            t += 0.011
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
    run = _run(_spans(), {"decode.mixed": 0.012, "dot_prod.product": 0.004})
    # two operations, one mixed block each: 12 ms over two blocks
    assert reader("mixed_device_ms.dotprod").read(run) == pytest.approx(6.0)
    mixed = 2 * ploidy_bounds.mixed_block_bytes(
        MIXED["stream_words"], MIXED["sparse_values"], MIXED["lines"],
        MIXED["haps"])
    assert reader("mixed_roofline.dotprod").read(run) == pytest.approx(
        100 * bounds.bound_ms(mixed) / 12.0)
    prod = 2 * sum(ploidy_bounds.product_bytes(p["rows"], p["width"],
                                               p["samples"], p["mode"])
                   for p in PRODUCTS)
    got = reader("product_roofline.dotprod").read(run)
    assert got == pytest.approx(100 * bounds.bound_ms(prod) / 4.0)
    assert 0 < got < 100


@pytest.mark.parametrize("case", ["no marks", "no device time",
                                  "no operations", "no trace"])
def test_readers_read_nothing_where_the_marks_are_absent(case):
    """The parent's program has no decode.mixed span and no samples on
    dot_prod.product: every reader gives None, and none raises."""
    absent = case == "no marks"
    run = _run(_spans(mixed=not absent, samples=not absent),
               {} if case == "no device time" else
               {"decode.mixed": 0.012, "dot_prod.product": 0.004})
    if case == "no operations":
        run.ops = []
    if case == "no trace":
        run.traced = None
    for name in READERS:
        assert reader(name).read(run) is None, (name, case)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ploidy_bounds", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bounds_equal_chip_smokes_at_the_cells_shapes():
    """product_bytes is chip_smoke.py's product bound, a flag byte a row
    more in mode "mixed"; mixed_block_bytes is the whole block's decode
    bound (bounds.decode_block_bytes, frozen from chip_smoke.py) at a mixed
    block's shapes."""
    smoke = _chip_smoke()
    for K, H, N, mode in ((8192, 97256, 48628, "mixed"),
                          (8192, 48628, 48628, "haploid"),
                          (8192, 194512, 97256, "diploid")):
        extra = K if mode == "mixed" else 0
        assert ploidy_bounds.product_bytes(K, H, N, mode) == \
            smoke.product_bytes(K, H, N) + extra
    meta = dict(device="meta")
    L, n_wah, words, carriers, H = 8192, 5000, 3_000_000, 395_000, 97256

    def t(n, dtype):
        return torch.empty(n, dtype=dtype, **meta)
    want = bounds.decode_block_bytes(
        t(words, torch.uint16), t(n_wah, torch.bool), t(L, torch.int64),
        t(L, torch.bool), t(L, torch.uint8), t(carriers, torch.int64),
        t(carriers, torch.int64), H, -(-H // 15))
    assert ploidy_bounds.mixed_block_bytes(
        words, carriers + L - n_wah, L, H) == want
