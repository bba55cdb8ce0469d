"""The port's spans and counters (xsqueezeit_tpu_torch/utils/trace.py) on
the CPU: nothing recorded and no torch call while tracing is off; the
spans of dot_prod and of the decompressor's batches nested as named, on
the worker threads too, each with its operation's id; the record counter;
the spans' cover of an operation; the decode's chain and run flush
spans with their shapes and routes, at 16-bit and 32-bit widths, and
the sparse lines the decode writes; a mixed-ploidy block's decode.mixed
span with its shapes and the haploid lines counter; their
marks in a torch.profiler trace
and in the CLI's --profile trace; the kernel launch counters."""
import json
import os
import threading

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from xsqueezeit_tpu_torch.bench import tools
from xsqueezeit_tpu_torch.codec.decoder_torch import TorchBlockDecoder
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu_torch.cli import main as torch_cli
from xsqueezeit_tpu_torch.codec.decompressor import (
    Decompressor,
    DecompressorOptions,
)
from xsqueezeit_tpu_torch.io.bcf import BcfReader
from xsqueezeit_tpu_torch.ops import (
    pbwt_kernels,
    pbwt_torch,
    product_kernels,
    sparse_kernels,
    wah_kernels,
)
from xsqueezeit_tpu_torch.utils import trace
from tests import fixtures

#: Records, and records a block: three blocks.
N_RECORDS, BLOCK = 120, 40


@pytest.fixture(scope="module")
def container(tmp_path_factory):
    """A 3-block container of 30 samples, 15 % multi-allelic records."""
    td = tmp_path_factory.mktemp("trace")
    vcf = fixtures.random_vcf(str(td / "in.vcf"), n_samples=30,
                              n_records=N_RECORDS, seed=9, p_multi=0.15)
    xsi = str(td / "o.xsi")
    assert torch_cli(["-c", "-f", vcf, "-o", xsi, "--device", "numpy",
                      "--variant-block-length", str(BLOCK)]) == 0
    return xsi


@pytest.fixture
def tracing():
    """Tracing on for the test, off and emptied after it."""
    trace.collect()
    trace.enable()
    yield
    trace.disable()
    trace.collect()


def _no_record_function(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function called")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_records_nothing_and_calls_no_torch(container, monkeypatch):
    trace.disable()
    trace.collect()
    _no_record_function(monkeypatch)
    assert trace.span("a") is trace.span("b", parent=None, block=1)
    assert trace.current() is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        got = tools.dot_prod(container, device="cpu")
    assert got["device_blocks"] == 3
    trace.count("c", 2)
    assert trace.collect() == {"spans": [], "counters": {}}


def test_spans_nest_as_named(container, tracing):
    got = tools.dot_prod(container, device="cpu")
    spans = trace.collect()["spans"]
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["dot_prod"]
    root = roots[0]
    assert all(s.op == root.id for s in spans)
    assert all(s.thread == threading.get_ident() for s in spans)
    kids = _children(spans, root)
    assert [s.name for s in kids] == ["dot_prod.open", "dot_prod.walk"] + \
        ["dot_prod.block"] * 3
    blocks = kids[2:]
    assert [b.attrs for b in blocks] == [
        {"block": k, "route": "device"} for k in range(3)]
    for b in blocks:
        names = [s.name for s in _children(spans, b)]
        assert names == ["decode.parse", "decode.parse", "decode.upload",
                         "decode.device", "dot_prod.product",
                         "dot_prod.readback"]
        upload = [s for s in _children(spans, b)
                  if s.name == "decode.upload"][0]
        assert upload.attrs["bytes"] > 0
        product = [s for s in _children(spans, b)
                   if s.name == "dot_prod.product"][0]
        assert product.attrs["mode"] == "diploid"
        assert product.attrs["rows"] > 0 and product.attrs["width"] > 0
    for s in spans:
        up = next((p for p in spans if p.id == s.parent), None)
        if up is not None:
            assert up.start <= s.start <= s.end <= up.end
    assert got["device_blocks"] == 3


def test_host_blocks_take_their_own_span(container, tracing, monkeypatch):
    from xsqueezeit_tpu_torch.codec import decoder_torch
    for name in ("eligible", "mixed_device_ok"):
        monkeypatch.setattr(decoder_torch.TorchBlockDecoder, name,
                            property(lambda self: False))
    got = tools.dot_prod(container, device="cpu")
    spans = trace.collect()["spans"]
    blocks = [s for s in spans if s.name == "dot_prod.block"]
    assert [b.attrs["route"] for b in blocks] == ["host"] * 3
    for b in blocks:
        assert [s.name for s in _children(spans, b)] == [
            "decode.parse", "dot_prod.host_block"]
    assert got["host_blocks"] == 3


def test_records_counter_counts_the_variant_file(container, tracing):
    tools.dot_prod(container, device="cpu")
    got = trace.collect()
    reader = BcfReader(container + "_var.bcf")
    n = sum(1 for _ in reader)
    reader.close()
    assert n == N_RECORDS
    assert got["counters"]["dot_prod.records"] == n
    assert set(got["counters"]) == {"dot_prod.records", "decode.chunks",
                                    "decode.carriers", "decode.sparse_lines"}
    walk = [s for s in got["spans"] if s.name == "dot_prod.walk"]
    assert [s.counts for s in walk] == [{"dot_prod.records": n}]


@pytest.mark.parametrize("walk", ["native", "python"])
def test_walk_span_names_its_route(container, tracing, monkeypatch, walk):
    """The walk's span says which walk read the variant file, the native
    scan or (XSI_NATIVE=0) the Python reader, and its record counter
    counts the file's records either way."""
    if walk == "python":
        monkeypatch.setenv("XSI_NATIVE", "0")
    else:
        monkeypatch.delenv("XSI_NATIVE", raising=False)
    got = tools.dot_prod(container, device="cpu")
    assert got["walk"] == walk
    collected = trace.collect()
    walks = [s for s in collected["spans"] if s.name == "dot_prod.walk"]
    assert [s.attrs for s in walks] == [{"route": walk}]
    assert [s.counts for s in walks] == [{"dot_prod.records": N_RECORDS}]
    assert collected["counters"]["dot_prod.records"] == N_RECORDS
    assert set(collected["counters"]) == {"dot_prod.records",
                                          "decode.chunks", "decode.carriers",
                                          "decode.sparse_lines"}


def test_child_spans_cover_the_operation(container, tracing):
    for _ in range(3):
        tools.dot_prod(container, device="cpu")
    spans = trace.collect()["spans"]
    roots = [s for s in spans if s.name == "dot_prod"]
    assert len(roots) == 3
    for root in roots:
        kids = sorted((s.start, s.end) for s in _children(spans, root))
        covered = sum(b - a for a, b in kids)     # children do not overlap
        assert all(b1 <= a2 for (_, b1), (a2, _) in zip(kids, kids[1:]))
        assert covered >= 0.95 * root.seconds, (covered, root.seconds)


def test_spans_are_profiler_marks(container, tracing, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tools.dot_prod(container, device="cpu")
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = {e["name"] for e in events
             if e.get("cat") == "user_annotation"}
    names = {s.name for s in trace.collect()["spans"]}
    assert names == {"dot_prod", "dot_prod.open", "dot_prod.walk",
                     "dot_prod.block", "decode.parse", "decode.upload",
                     "decode.device", "decode.chain", "decode.flush",
                     "dot_prod.product", "dot_prod.readback"}
    assert names <= marks


@pytest.mark.parametrize("on", [False, True])
def test_launch_counts_are_unchanged(container, on):
    """The CPU runs the kernels' plain versions: no launch is counted,
    tracing on or off, and the trace's counters hold no launch."""
    before = {**pbwt_kernels.launches, **wah_kernels.launches,
              **sparse_kernels.launches, **product_kernels.launches}
    trace.collect()
    if on:
        trace.enable()
    try:
        tools.dot_prod(container, device="cpu")
    finally:
        trace.disable()
    assert {**pbwt_kernels.launches, **wah_kernels.launches,
            **sparse_kernels.launches, **product_kernels.launches} == before
    assert set(trace.collect()["counters"]) <= {
        "dot_prod.records", "decode.chunks", "decode.carriers",
        "decode.sparse_lines"}
    counts = {"r": 0}
    trace.count("r", 3, into=counts)
    assert counts == {"r": 3}


def _diploid_block(n_samples: int, n_records: int = 40, seed: int = 3,
                   ps=(0.0004, 0.3, 0.02, 0.9996, 0.6, 0.002)):
    """A phased diploid block of biallelic records, by default rare, common
    and near fixed (record i's ALT frequency ps[i % len(ps)]), at the
    codec's default threshold (MAF 0.001): (payload, aet dtype, stored
    sparse carriers).  16-bit streams up to 65,535 haplotypes, else
    32-bit."""
    rng = np.random.default_rng(seed)
    H = 2 * n_samples
    aet = np.uint16 if H <= 0xFFFF else np.uint32
    enc = GtBlockEncoder(n_samples=n_samples, block_bcf_lines=10_000,
                         mac_threshold=max(1, int(H * 0.001)),
                         default_phasing=1, aet_dtype=aet)
    stored = 0
    mac = max(1, int(H * 0.001))
    for i in range(n_records):
        alt = rng.random(H) < ps[i % len(ps)]
        gt = ((alt.astype(np.int32) + 1) << 1)
        gt[1::2] |= 1
        n_alt = int(alt.sum())
        if min(n_alt, H - n_alt) < mac:   # a sparse line: its minority
            stored += min(n_alt, H - n_alt)
        enc.encode_record(gt, 2)
    return enc.serialize(), aet, stored


@pytest.mark.parametrize("n_samples", [2504, 32800], ids=["narrow", "wide"])
def test_decode_spans_name_the_chain_and_the_flush(tracing, n_samples):
    """decode.chain and decode.flush nest under decode.device with their
    width, chunk and route; decode.chunks counts the chunks, decode.carriers
    the stored sparse carriers, and decode.parse names the streams' bits;
    decode.device names the sparse lines it writes, which
    decode.sparse_lines counts."""
    payload, aet, stored = _diploid_block(n_samples)
    H = 2 * n_samples
    dec = TorchBlockDecoder(payload, n_samples, H, aet, device="cpu")
    assert dec.eligible
    dec.decode_bits()
    got = trace.collect()
    spans = got["spans"]

    def one(name):
        found = [s for s in spans if s.name == name]
        assert len(found) == 1, (name, found)
        return found[0]
    device, chain, flush = (one("decode.device"), one("decode.chain"),
                            one("decode.flush"))
    assert chain.parent == device.id and flush.parent == device.id
    assert chain.end <= flush.start
    C = pbwt_kernels.decode_chunk(H)
    assert C == (16 if H <= 0xFFFF else 15)
    Lw = int(dec.meta.line_is_wah.sum())
    n_ch = -(-Lw // C)
    assert chain.attrs == {"width": H, "chunk_lines": C, "route": "plain"}
    assert chain.counts == {"decode.chunks": n_ch}
    assert flush.attrs == {"route": "plain", "width": H, "chunk_lines": C,
                           "chunks": n_ch, "lines": Lw, "haps": H,
                           "history": False}
    parse = [s for s in spans if s.name == "decode.parse"]
    assert [s.attrs for s in parse] == [{"aet_bits": 16 if H <= 0xFFFF
                                         else 32}]
    assert stored > 0
    assert parse[0].counts == {"decode.carriers": stored}
    n_sparse = dec.meta.binary_lines - Lw
    assert n_sparse > 0
    assert device.attrs == {"sparse_lines": n_sparse}
    assert device.counts == {"decode.sparse_lines": n_sparse}
    assert got["counters"] == {"decode.chunks": n_ch,
                               "decode.carriers": stored,
                               "decode.sparse_lines": n_sparse}


@pytest.mark.parametrize("n_samples", [2504, 32800], ids=["narrow", "wide"])
def test_decode_spans_off_record_nothing(n_samples, monkeypatch):
    trace.disable()
    trace.collect()
    _no_record_function(monkeypatch)
    payload, aet, _ = _diploid_block(n_samples)
    dec = TorchBlockDecoder(payload, n_samples, 2 * n_samples, aet,
                            device="cpu")
    dec.decode_bits()
    assert trace.collect() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("ps,kind", [((0.3, 0.6), "wah"),
                                     ((0.0004, 0.9996), "sparse")])
def test_decode_device_counts_its_sparse_lines(tracing, ps, kind):
    """A block of WAH lines only writes no sparse line: decode.device says
    0 and decode.sparse_lines counts nothing (no launch); a block of sparse
    lines only (negated ones too) runs no chain or flush, and every line
    is the sparse kernel's."""
    payload, aet, stored = _diploid_block(2504, ps=ps)
    dec = TorchBlockDecoder(payload, 2504, 5008, aet, device="cpu")
    m = dec.meta
    vals, _ = dec.decode_bits()
    want = GtBlockDecoder(payload, 2504, 5008, aet)
    for line in range(m.binary_lines):
        want.seek(line)
        gt = want.fill_genotype_array_advance(2)
        assert np.array_equal(vals[line].numpy(), (gt >> 1) - 1)
    got = trace.collect()
    names = [s.name for s in got["spans"]]
    device = [s for s in got["spans"] if s.name == "decode.device"]
    n_sparse = int((~m.line_is_wah.astype(bool)).sum())
    if kind == "wah":
        assert n_sparse == 0 and stored == 0
        assert "decode.sparse_lines" not in got["counters"]
        assert "decode.flush" in names
    else:
        assert n_sparse == m.binary_lines > 0
        assert got["counters"]["decode.sparse_lines"] == n_sparse
        assert "decode.chain" not in names and "decode.flush" not in names
    assert [s.attrs for s in device] == [{"sparse_lines": n_sparse}]


def _ploidy_block(n_samples: int, kind: str, n_records: int = 40,
                  seed: int = 5, ps=(0.0004, 0.3, 0.02, 0.9996, 0.6)):
    """A block of male chrX records at the codec's default threshold (MAF
    0.001): kind "mixed", its first half diploid (a PAR) and the rest
    haploid; kind "haploid", every record haploid.  Returns (payload, aet
    dtype, the shapes counted as the records are drawn: lines,
    haploid_lines, wah_lines and sparse_values, a sparse line's head and
    its stored minority)."""
    rng = np.random.default_rng(seed)
    H = 2 * n_samples
    aet = np.uint16 if H <= 0xFFFF else np.uint32
    mac = max(1, int(H * 0.001))
    enc = GtBlockEncoder(n_samples=n_samples, block_bcf_lines=10_000,
                         mac_threshold=mac, default_phasing=1, aet_dtype=aet)
    shapes = dict(lines=n_records, haploid_lines=0, wah_lines=0,
                  sparse_values=0)
    for i in range(n_records):
        haploid = kind == "haploid" or i >= n_records // 2
        n_gt = n_samples if haploid else H
        alt = rng.random(n_gt) < ps[i % len(ps)]
        gt = (alt.astype(np.int32) + 1) << 1
        if not haploid:
            gt[1::2] |= 1
        n_alt = int(alt.sum())
        minority = min(n_alt, n_gt - n_alt)
        shapes["haploid_lines"] += haploid
        if minority > mac:
            shapes["wah_lines"] += 1
        else:
            shapes["sparse_values"] += 1 + minority
        enc.encode_record(gt, 2)
    return enc.serialize(), aet, shapes


@pytest.mark.parametrize("kind", ["mixed", "haploid"])
@pytest.mark.parametrize("n_samples", [300, 32801], ids=["narrow", "wide"])
def test_decode_mixed_span_and_haploid_lines(tracing, monkeypatch, n_samples,
                                            kind):
    """A mixed block's decode.mixed nests under decode.device with the
    shapes its byte bound reads, each equal to the block's own; a uniformly
    haploid block has none.  decode.haploid_lines counts the haploid lines
    decoded on the device, on decode.device, on both routes; with tracing
    off the same decode records nothing and calls no torch mark."""
    payload, aet, shapes = _ploidy_block(n_samples, kind)
    H = 2 * n_samples
    dec = TorchBlockDecoder(payload, n_samples, H, aet, device="cpu")
    assert (dec.mixed_device_ok, dec.uniform_haploid) == (
        kind == "mixed", kind == "haploid")
    vals, route = dec.decode_bits()
    assert route == {"mixed": "mixed", "haploid": "device"}[kind]
    got = trace.collect()
    spans = got["spans"]
    (device,) = [s for s in spans if s.name == "decode.device"]
    mixed = [s for s in spans if s.name == "decode.mixed"]
    n_hap = shapes["haploid_lines"]
    assert 0 < n_hap <= shapes["lines"]
    assert device.counts["decode.haploid_lines"] == n_hap
    assert got["counters"]["decode.haploid_lines"] == n_hap
    host = GtBlockDecoder(payload, n_samples, H, aet)
    if kind == "haploid":
        assert mixed == [] and n_hap == shapes["lines"]
        assert vals.shape == (shapes["lines"], n_samples)
    else:
        (m,) = mixed
        assert m.parent == device.id
        assert device.start <= m.start <= m.end <= device.end
        assert [s.parent for s in spans if s.name in ("decode.chain",
                                                      "decode.flush")] \
            == [m.id] * sum(s.name in ("decode.chain", "decode.flush")
                            for s in spans)
        w_max = max(-(-H // 15), -(-n_samples // 15))
        assert m.attrs == dict(haps=H, w_max=w_max,
                               stream_words=host.wah_stream.shape[0],
                               **shapes)
        assert vals.shape == (shapes["lines"], H)
    for line in range(shapes["lines"]):
        host.seek(line)
        gt = host.fill_genotype_array_advance(2)
        row = vals[line].numpy()
        if host.haploid_line[line] and kind == "mixed":
            row = row[::2]
        assert np.array_equal(row, (gt >> 1) - 1)
    trace.disable()
    _no_record_function(monkeypatch)
    TorchBlockDecoder(payload, n_samples, H, aet, device="cpu").decode_bits()
    assert trace.collect() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("W,routes", [
    (5008, ("cta", "cta")), (28928, ("cta", "cta")),
    (28929, ("rows", "cta")), (64976, ("rows", "cta")),
    (65535, ("rows", "cta")), (65536, ("rows", "cluster")),
    (194512, ("rows", "cluster"))])
def test_decode_routes_by_width(W, routes):
    """The routes the spans name on the card follow the kernels' own
    choice: the chain on 16 CTAs above one CTA's 28,928 slots, the flush on
    a cluster above 65,535; on the CPU both are the plain versions."""
    assert pbwt_torch.decode_routes(W, torch.device("cuda")) == routes
    assert pbwt_torch.decode_routes(W, torch.device("cpu")) == ("plain",
                                                                "plain")


def _extract_spans(xsi, devices, stop_after=None):
    dec = Decompressor(xsi, DecompressorOptions(device="cpu",
                                                devices=devices))
    n = 0
    it = dec.iter_decoded_records()
    for n, _ in enumerate(it, 1):
        if n == stop_after:
            break
    it.close()
    dec.close()
    return n, trace.collect()["spans"]


@pytest.mark.parametrize("devices", [None, ("cpu", "cpu")])
def test_extract_batches_take_their_caller_as_parent(container, tracing,
                                                     devices):
    n, spans = _extract_spans(container, devices)
    assert n == N_RECORDS
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["extract"]
    root = roots[0]
    assert all(s.op == root.id for s in spans)
    batches = [s for s in spans if s.name == "extract.batch"]
    assert [b.attrs["blocks"] for b in batches] == (
        [[0], [1], [2]] if devices is None else [[0, 1], [2]])
    main = threading.get_ident()
    assert all(b.thread != main for b in batches)
    for b in batches:
        up = next(s for s in spans if s.id == b.parent)
        assert up.thread == main
        kids = [s.name for s in _children(spans, b)]
        assert set(kids) == {"decode.parse", "decode.block", "decode.fold"}
    blocks = [s for s in spans if s.name == "decode.block"]
    assert len(blocks) == 3
    for s in blocks:
        assert next(p for p in spans if p.id == s.parent).name == \
            "extract.batch"
        assert {k.name for k in _children(spans, s)} == {
            "decode.parse", "decode.upload", "decode.device"}
    assert {s.name for s in spans if s.thread == main} == {
        "extract", "extract.wait", "extract.emit"}


def test_extract_spans_close_when_the_consumer_stops(container, tracing):
    n, spans = _extract_spans(container, None, stop_after=5)
    assert n == 5
    names = [s.name for s in spans]
    assert "extract" in names and "extract.emit" in names
    assert all(s.end is not None for s in spans)
    assert trace.current() is None


def test_cli_profile_traces_the_extract_worker(container, tmp_path):
    prof = tmp_path / "prof"
    out = str(tmp_path / "o.bcf")
    assert torch_cli(["--profile", str(prof), "-x", "-f", container,
                      "-o", out, "--device", "cpu"]) == 0
    assert not trace.enabled()
    assert trace.collect() == {"spans": [], "counters": {}}
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    main = {e["tid"] for e in marks if e["name"] == "extract"}
    assert len(main) == 1
    batches = [e for e in marks if e["name"] == "extract.batch"]
    assert len(batches) == 3
    assert all(e["tid"] not in main for e in batches)
    parses = [e for e in marks if e["name"] == "decode.parse"]
    for b in batches:
        t0, t1 = float(b["ts"]), float(b["ts"]) + float(b["dur"])
        assert any(p["tid"] == b["tid"] and t0 <= float(p["ts"]) <= t1
                   for p in parses)
    assert os.path.getsize(out) > 0


def test_spans_from_many_threads_are_all_kept(tracing):
    """Threads open spans side by side, each under a parent handed over
    from the main thread: no span is lost and each nests under its own
    thread's span (more threads than cores, a short switch interval)."""
    import sys
    n_threads, per = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.span("root") as root:
            def work(k):
                with trace.span("worker", parent=root, k=k):
                    for _ in range(per):
                        with trace.span("leaf"):
                            trace.count("leaves")
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = trace.collect()
    spans = got["spans"]
    assert got["counters"] == {"leaves": n_threads * per}
    assert len(spans) == 1 + n_threads * (1 + per)
    assert len({s.id for s in spans}) == len(spans)
    workers = {s.id: s for s in spans if s.name == "worker"}
    assert all(w.parent == root.id and w.op == root.id
               for w in workers.values())
    leaves = [s for s in spans if s.name == "leaf"]
    assert all(workers[s.parent].thread == s.thread for s in leaves)
    assert all(s.op == root.id and s.counts == {"leaves": 1}
               for s in leaves)
