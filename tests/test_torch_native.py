"""The port's native host library (xsqueezeit_tpu_torch/native/, built by
xsqueezeit_tpu_torch/interop/native.py into xsqueezeit_tpu_torch/build/)
against the JAX package's native routes and against the port's Python
routes, on the same inputs: the accessor, the block encoder, the batch
BCF parse and frame walk, the track-offset walk, the VCF GT text, the
extract loop, the build made as on a machine without zstd or libdeflate,
and the C API with its two test programs.  Tolerance: exact equality.

The JAX package's tests pin XSI_DEVICE=numpy (tests/conftest.py), which
turns its native routes off; where a test compares with a JAX native
route it calls that route directly.  The emitter writes libdeflate's
bytes where libdeflate is found; XSI_EMIT_ZLIB=1 (the library's own
switch) gives zlib's, which are the Python writer's."""
import ctypes
import gzip
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

from xsqueezeit_tpu.cli import main as jax_cli
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder as JaxEncoder
from xsqueezeit_tpu.format.constants import WeirdnessStrategy
from xsqueezeit_tpu.interop import native as jax_native
from xsqueezeit_tpu.io.vcf import format_gt
from xsqueezeit_tpu_torch.accessor import Accessor
from xsqueezeit_tpu_torch.bench import tools
from xsqueezeit_tpu_torch.bench.synth import synth_bcf
from xsqueezeit_tpu_torch.cli import main as torch_cli
from xsqueezeit_tpu_torch.codec.decompressor import (
    Decompressor,
    DecompressorOptions,
)
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.format.constants import INT32_VECTOR_END
from xsqueezeit_tpu_torch.format.container import XsiReader
from xsqueezeit_tpu_torch.interop import native
from xsqueezeit_tpu_torch.io.bcf import BcfReader, BcfWriter
from xsqueezeit_tpu_torch.io.bcf import patch_shared_sample_counts
from xsqueezeit_tpu_torch.io.sites import encode_gt_indiv
from xsqueezeit_tpu_torch.io.unified import GtInput, count_entries_offsets
from xsqueezeit_tpu_torch.io.vcf import _format_gt_region_py
from xsqueezeit_tpu_torch.ops import sparse_np
from tests import fixtures
from tests.gt_synth import make_record
from tests.test_torch_parity import FIXTURES
from tests.jax_build import jax_native_built  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def vcf_to_bcf(vcf_path: str, bcf_path: str) -> str:
    inp = GtInput(vcf_path)
    w = BcfWriter(bcf_path, inp.header)
    n = len(inp.samples)
    for rec in inp:
        shared = patch_shared_sample_counts(rec.shared, 1, n)
        w.write_raw(shared, encode_gt_indiv(inp.header, rec.gt,
                                            rec.ploidy, n))
    w.close()
    inp.close()
    return bcf_path


def _variant_bms(xsi):
    """(bm, n_alleles) of every record of the variant file."""
    acc = Accessor(xsi)
    r = BcfReader(acc.variant_filename())
    out = [(acc.position_from_bm_entry(rec), rec.n_allele) for rec in r]
    r.close()
    return out


@pytest.fixture(scope="module", params=["plain", "zstd"])
def compressed(request, tmp_path_factory):
    """The JAX package's native test file: 22 samples, 90 records, 20 %
    multi-allelic, blocks of 40."""
    td = tmp_path_factory.mktemp("native")
    vcf = fixtures.random_vcf(str(td / "in.vcf"), n_samples=22, n_records=90,
                              seed=17, p_multi=0.2)
    xsi = str(td / "o.xsi")
    args = ["-c", "-f", vcf, "-o", xsi, "--variant-block-length", "40",
            "--maf", "0.03"]
    if request.param == "zstd":
        args.append("--zstd")
    assert jax_cli(args) == 0
    return vcf, xsi


@pytest.fixture(params=sorted(FIXTURES))
def micro(request, tmp_path):
    write, block = FIXTURES[request.param]
    vcf = write(str(tmp_path / "in.vcf"))
    xsi = str(tmp_path / "o.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi,
                    "--variant-block-length", str(block)]) == 0
    return request.param, vcf, xsi


# ------------------------------------------------------------ the accessor
def _accessor_lockstep(vcf, xsi, monkeypatch):
    """The port's NativeAccessor, the JAX package's and the port's
    GtBlockDecoder (Accessor with XSI_NATIVE=0), record by record:
    iteration, BM-keyed genotypes, allele counts and the batched walk."""
    port, jax = native.NativeAccessor(xsi), jax_native.NativeAccessor(xsi)
    assert port.n_samples == jax.n_samples
    assert port.sample_name(0) == jax.sample_name(0)
    got, want = list(port), list(jax)
    orig = [(r.n_alleles, r.gt) for r in GtInput(vcf)]
    assert len(got) == len(want) == len(orig) > 0
    for (na, gt), (jna, jgt), (ona, ogt) in zip(got, want, orig):
        assert na == jna == ona
        np.testing.assert_array_equal(gt, jgt)
        np.testing.assert_array_equal(gt, ogt)
    port.close()
    jax.close()
    port, jax = native.NativeAccessor(xsi), jax_native.NativeAccessor(xsi)
    bms, nas = port.scan_records()
    jbms, jnas = jax.scan_records()
    np.testing.assert_array_equal(bms, jbms)
    np.testing.assert_array_equal(nas, jnas)
    np.testing.assert_array_equal(port.count_alleles_range(bms, nas),
                                  jax.count_alleles_range(bms, nas))
    monkeypatch.setenv("XSI_NATIVE", "0")
    py = Accessor(xsi)
    for bm, na in reversed(_variant_bms(xsi)):     # backward seeks
        gt = port.fill_genotypes_bm(bm, na)
        np.testing.assert_array_equal(gt, jax.fill_genotypes_bm(bm, na))
        np.testing.assert_array_equal(gt, py.fill_genotype_array(bm, na))
        np.testing.assert_array_equal(port.fill_allele_counts_bm(bm, na),
                                      jax.fill_allele_counts_bm(bm, na))
    port.close()
    jax.close()


def test_native_accessor_lockstep(compressed, monkeypatch):
    _accessor_lockstep(*compressed, monkeypatch)


def test_native_accessor_on_every_fixture(micro, monkeypatch):
    _, vcf, xsi = micro
    _accessor_lockstep(vcf, xsi, monkeypatch)


def test_native_accessor_refuses_a_bad_file(tmp_path):
    bad = tmp_path / "bad.xsi"
    bad.write_bytes(b"\0" * 300)
    with pytest.raises(OSError, match="bad magic"):
        native.NativeAccessor(str(bad))


# --------------------------------------------------------- block encoder
def _kitchen_sink(rng, n):
    records = []
    for i in range(n):
        if i % 7 == 0:
            records.append(make_record(rng, 64, p_alt=0.5, haploid=True))
        elif i % 5 == 0:
            records.append(make_record(rng, 64, n_alts=3, p_alt=0.4,
                                       p_missing=0.03, p_phase_flip=0.05))
        elif i % 3 == 0:
            records.append(make_record(rng, 64, p_alt=0.002))
        else:
            records.append(make_record(rng, 64, p_alt=0.3, p_missing=0.02,
                                       p_eov=0.04, p_phase_flip=0.02))
    return records


def _encode_all(records, n_samples, **kw):
    """The port's NativeBlockEncoder (per record and batched), the port's
    GtBlockEncoder and the JAX package's write one payload."""
    payloads = []
    for cls in (native.NativeBlockEncoder, GtBlockEncoder, JaxEncoder):
        enc = cls(n_samples, **kw)
        for gt, na in records:
            enc.encode_record(gt, na)
        payloads.append(enc.serialize())
    enc = native.NativeBlockEncoder(n_samples, **kw)
    offs = np.zeros(len(records) + 1, np.int64)
    np.cumsum([g.shape[0] for g, _ in records], out=offs[1:])
    enc.encode_records(np.concatenate([g for g, _ in records]), offs,
                       np.array([na for _, na in records], np.int32),
                       0, len(records))
    payloads.append(enc.serialize())
    assert all(p == payloads[2] for p in payloads)
    return payloads[0]


@pytest.mark.parametrize("ws", [WeirdnessStrategy.WS_SPARSE,
                                WeirdnessStrategy.WS_WAH,
                                WeirdnessStrategy.WS_PBWT_WAH])
@pytest.mark.parametrize("aet", [np.uint16, np.uint32])
def test_native_encoder_matrix(ws, aet):
    """tests/test_native_encode.py's strategies and both index widths."""
    rng = np.random.default_rng(int(ws) * 7 + np.dtype(aet).itemsize)
    _encode_all(_kitchen_sink(rng, 48), 64, block_bcf_lines=10_000,
                mac_threshold=2, default_phasing=1, aet_dtype=aet,
                weirdness_strategy=ws)


RECORD_CLASSES = {
    "common": dict(p_alt=0.3),
    "rare": dict(p_alt=0.002),
    "multi_allelic": dict(n_alts=3, p_alt=0.4),
    "missing": dict(p_alt=0.3, p_missing=0.05),
    "eov": dict(p_alt=0.3, p_eov=0.1),
    "phase_flip": dict(p_alt=0.3, p_phase_flip=0.1),
    "unphased": dict(p_alt=0.3, phased=False),
    "haploid": dict(p_alt=0.4, haploid=True),
}


@pytest.mark.parametrize("aet", [np.uint16, np.uint32])
@pytest.mark.parametrize("cls", sorted(RECORD_CLASSES))
def test_native_encoder_every_record_class(cls, aet):
    rng = np.random.default_rng(len(cls))
    records = [make_record(rng, 50, **RECORD_CLASSES[cls])
               for _ in range(12)]
    _encode_all(records, 50, block_bcf_lines=100, mac_threshold=1,
                default_phasing=0 if cls == "unphased" else 1,
                aet_dtype=aet, weirdness_strategy=WeirdnessStrategy.WS_SPARSE)


def test_native_encoder_errors_match_python():
    kw = dict(block_bcf_lines=10, mac_threshold=1, default_phasing=1,
              aet_dtype=np.uint16,
              weirdness_strategy=WeirdnessStrategy.WS_SPARSE)
    clean = np.full(12, 2, np.int32)
    clean[1::2] |= 1
    bad = clean.copy()
    bad[0] = 0                 # missing on a zero-ALT record
    for cls in (native.NativeBlockEncoder, GtBlockEncoder):
        enc = cls(6, **kw)
        with pytest.raises(ValueError, match="no ALT allele"):
            enc.encode_record(bad, 1)
            enc.serialize()
    with pytest.raises(ValueError, match="Ploidy higher than 2"):
        native.NativeBlockEncoder(6, **kw).encode_record(
            np.zeros(18, np.int32), 2)


# ------------------------------------------------------ batch BCF parse
def _exception_bcf(tmp_path):
    """Missing cells, EOV, haploid records, unphased cells, multi-allelic
    records and 70 ALTs (int16-typed GT values)."""
    rng = np.random.default_rng(3)
    n = 7
    rows = [
        ("A", ["0|1", ".|.", "1|1", "0", "0|0", "1", ".|1"]),
        ("A", ["0"] * n),
        ("A,T,C", ["0|2", "3|1", "2/3", "0|0", "1|2", "3|3", "."]),
        ("A", ["0/1", "1/0", "0/0", "1/1", "0|1", "./1", "1|."]),
        (",".join("A" * (k + 1) for k in range(1, 71)),
         [f"{rng.integers(60, 71)}|{rng.integers(60, 71)}"
          for _ in range(n)]),
    ]
    vcf = fixtures.write_vcf(str(tmp_path / "m.vcf"), rows, n_samples=n)
    return vcf_to_bcf(vcf, str(tmp_path / "m.bcf"))


def _parse(path, monkeypatch, parse):
    monkeypatch.setenv("XSI_NATIVE_PARSE", parse)
    inp = GtInput(path)
    out = [(r.shared, None if r.gt is None else r.gt.copy(), r.n_alleles,
            r.ploidy) for r in inp]
    inp.close()
    return out


@pytest.mark.parametrize("kind", ["synth", "exceptions"])
def test_batch_parse_matches_python_reader(tmp_path, monkeypatch, kind):
    if kind == "synth":
        bcf = str(tmp_path / "s.bcf")
        synth_bcf(bcf, 700, 213, missing_frac=0.01)
    else:
        bcf = _exception_bcf(tmp_path)
    py = _parse(bcf, monkeypatch, "0")
    nat = _parse(bcf, monkeypatch, "1")
    assert len(py) == len(nat) > 0
    for a, b in zip(py, nat):
        assert a[0] == b[0] and a[2:] == b[2:]
        np.testing.assert_array_equal(a[1], b[1])
    # the batched form: the same GT rows back to back
    inp = GtInput(bcf)
    rows = []
    for gt_all, offs, na, pl, n in inp.iter_gt_batches():
        rows += [gt_all[offs[i]:offs[i + 1]] for i in range(n)]
    inp.close()
    assert len(rows) == len(py)
    for row, (_, gt, _, ploidy) in zip(rows, py):
        np.testing.assert_array_equal(row, gt if ploidy else row[:0])


def test_batch_parse_positions(tmp_path, monkeypatch):
    """skip_records (lazy, past the end too) and seek_fast position the
    native reader as they do the Python reader."""
    bcf = str(tmp_path / "s.bcf")
    synth_bcf(bcf, 300, 20)
    n, voffs = count_entries_offsets(bcf, 64)
    want = [r[0] for r in _parse(bcf, monkeypatch, "0")]
    for parse in ("1", "0"):
        monkeypatch.setenv("XSI_NATIVE_PARSE", parse)
        for skip in (0, 70, 299, 300, 450):
            inp = GtInput(bcf)
            inp.skip_records(skip)
            assert [r.shared for r in inp] == want[skip:]
            inp.close()
        inp = GtInput(bcf)
        inp.seek_fast(128, int(voffs[2]))
        assert [r.shared for r in inp] == want[128:]
        inp.close()


def test_batch_parse_of_a_truncated_file_raises(tmp_path):
    from xsqueezeit_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

    bcf = str(tmp_path / "t.bcf")
    synth_bcf(bcf, 60, 50)
    body = BgzfReader(bcf).read()
    cut = str(tmp_path / "cut.bcf")
    w = BgzfWriter(cut)
    w.write(body[: len(body) - 37])
    w.close()
    inp = GtInput(cut)
    with pytest.raises(ValueError, match="native BCF parse failed"):
        for _ in inp:
            pass
    inp.close()


@pytest.mark.parametrize("every", [0, 1, 7, 64, 1000])
def test_frame_walk_matches_python_walk(tmp_path, monkeypatch, every):
    from xsqueezeit_tpu.io.unified import (
        count_entries_offsets as jax_count_entries_offsets,
    )

    monkeypatch.delenv("XSI_SCAN_CACHE", raising=False)
    bcf = str(tmp_path / "in.bcf")
    synth_bcf(bcf, 600, 200, seed=3)
    n, voffs = count_entries_offsets(bcf, every)
    jn, jvoffs = jax_count_entries_offsets(bcf, every)    # its native walk
    monkeypatch.setenv("XSI_NATIVE_PARSE", "0")
    pn, pvoffs = count_entries_offsets(bcf, every)
    assert n == pn == jn == 600
    if every:
        np.testing.assert_array_equal(voffs, pvoffs)
        np.testing.assert_array_equal(voffs, jvoffs)
    else:
        assert voffs is None


# ------------------------------------------------------- offsets walk
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("n_lines", [1, 127, 128, 3000])
def test_sparse_offsets_match_the_lifting_walk(dtype, n_lines,
                                               monkeypatch):
    """sparse_offsets_native against the Python walks (scalar below 128
    lines or 4096 elements, binary lifting above) and the JAX package's
    native walk; a truncated stream raises on every route."""
    rng = np.random.default_rng(n_lines)
    flag = 1 << (np.dtype(dtype).itemsize * 8 - 1)
    parts = []
    for _ in range(n_lines + 5):
        cnt = int(rng.integers(0, 6))
        head = cnt | (flag if rng.random() < 0.2 else 0)
        parts.append(np.concatenate([[head], rng.integers(0, 100, cnt)]))
    stream = np.concatenate(parts).astype(dtype)
    got = native.sparse_offsets_native(stream, n_lines)
    np.testing.assert_array_equal(
        got, jax_native.sparse_offsets_native(stream, n_lines))
    assert np.array_equal(sparse_np.sparse_line_offsets(stream, n_lines),
                          got)
    monkeypatch.setenv("XSI_NATIVE", "0")
    np.testing.assert_array_equal(
        sparse_np.sparse_line_offsets(stream, n_lines), got)
    cut = stream[:int(got[n_lines]) - 1]
    with pytest.raises(ValueError, match="truncated"):
        native.sparse_offsets_native(cut, n_lines)
    if n_lines >= 128 and cut.shape[0] >= 4096:
        with pytest.raises(ValueError, match="truncated"):
            sparse_np.sparse_line_offsets(cut, n_lines)


# ------------------------------------------------------- VCF GT text
def _gt_cases():
    rng = np.random.default_rng(17)

    def enc(allele, phase):
        return ((allele + 1) << 1) | phase

    cases = []
    for _ in range(30):
        ns = int(rng.integers(1, 40))
        alleles = rng.integers(-1, 13, ns * 2)
        phases = rng.integers(0, 2, ns * 2)
        cases.append((np.array([enc(a, p) for a, p in zip(alleles, phases)],
                               np.int32), 2, ns))
    cases.append((np.array([enc(a, 0) for a in rng.integers(-1, 3, 23)],
                           np.int32), 1, 23))
    cases.append((np.array([enc(1, 0), INT32_VECTOR_END, INT32_VECTOR_END,
                            INT32_VECTOR_END, enc(0, 1), enc(2, 1)],
                           np.int32), 2, 3))
    cases.append((np.array([enc(123456, 0), enc(0, 1)], np.int32), 2, 1))
    cases.append((np.zeros(0, np.int32), 2, 0))
    uniform = rng.integers(0, 2, 2 * 300)
    cases.append((np.array([enc(a, i % 2) for i, a in enumerate(uniform)],
                           np.int32), 2, 300))
    return cases


def test_gt_formatter_matches_python_renderer():
    for gt, ploidy, ns in _gt_cases():
        got = native.format_gt_region_bytes_native(gt, ploidy, ns)
        assert got == _format_gt_region_py(gt, ploidy, ns)
        assert got.decode() == "\t".join(format_gt(gt, ploidy, ns))


# ------------------------------------------------------- extract loop
def _header_text(xsi):
    d = Decompressor(xsi, DecompressorOptions(device="numpy"))
    h = d.output_header()
    gt_key = h.ensure_string(
        "GT", '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    return h.to_text().encode() + b"\0", gt_key


def _records(path):
    r = BcfReader(path)
    out = [(bytes(rec.shared), bytes(rec.indiv)) for rec in r]
    r.close()
    return out


@pytest.mark.parametrize("zlib", [True, False], ids=["zlib", "libdeflate"])
def test_native_extract_matches_jax(micro, tmp_path, monkeypatch, zlib):
    """native_extract and native_extract_ranges write the JAX package's
    bytes; their records are the Python writer's (its bytes too in the
    emitter's zlib mode)."""
    if zlib:
        monkeypatch.setenv("XSI_EMIT_ZLIB", "1")
    _, vcf, xsi = micro
    text, gt_key = _header_text(xsi)
    got, want = str(tmp_path / "port.bcf"), str(tmp_path / "jax.bcf")
    n = native.native_extract(xsi, got, text, gt_key, 6)
    assert n == jax_native.native_extract(xsi, want, text, gt_key, 6) > 0
    assert _read(got) == _read(want)
    monkeypatch.setenv("XSI_NATIVE", "0")
    py = str(tmp_path / "py.bcf")
    Decompressor(xsi, DecompressorOptions(device="numpy")).decompress(py)
    assert _records(got) == _records(py)
    if zlib:
        assert _read(got) == _read(py)
    region = [(0, 1, 1 << 62)]
    got, want = str(tmp_path / "port_r.bcf"), str(tmp_path / "jax_r.bcf")
    n = native.native_extract_ranges(xsi, got, text, gt_key, 6,
                                     regions=region)
    assert n == jax_native.native_extract_ranges(
        xsi, want, text, gt_key, 6, regions=region)
    assert _read(got) == _read(want)


def test_emitter_matches_the_python_writer(tmp_path, monkeypatch):
    """NativeBcfEmitter (bcf_emit.cpp) in the emitter's zlib mode writes
    BcfWriter's bytes."""
    from xsqueezeit_tpu_torch.io.bcf import (
        BcfHeader,
        pack_type_descriptor,
        pack_typed_int,
    )
    from xsqueezeit_tpu_torch.io.sites import encode_shared_from_vcf_cols

    monkeypatch.setenv("XSI_EMIT_ZLIB", "1")
    h = BcfHeader.from_text(
        "##fileformat=VCFv4.2\n"
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "##contig=<ID=20>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB\tC")
    prefix = pack_typed_int(h.str2idx["GT"]) + pack_type_descriptor(1, 2)
    rows = np.random.default_rng(0).integers(2, 6, (40, 6)).astype(np.uint8)
    shared = [encode_shared_from_vcf_cols(
        h, ["20", str(1000 + i), ".", "A", "C", ".", "PASS", "."],
        n_fmt=1, n_sample=3) for i in range(40)]
    py = str(tmp_path / "py.bcf")
    w = BcfWriter(py, h)
    for sh, row in zip(shared, rows):
        w.write_raw(sh, prefix + row.tobytes(), want_offsets=False)
    w.close()
    nat = str(tmp_path / "nat.bcf")
    e = native.NativeBcfEmitter(nat, h.to_text().encode() + b"\0", level=6)
    off = np.zeros(41, np.uint64)
    off[1:] = np.cumsum([len(sh) for sh in shared])
    e.write_batch(b"".join(shared), off, prefix, rows)
    e.close()
    assert _read(nat) == _read(py)


def test_distributed_segments_match_the_python_ones(tmp_path, monkeypatch):
    """The multi-process paths' native segments: each rank's variant-pass
    window (xsi_var_pass_segment) and, on the host codec, its extract
    segment (xsi_extract_segment) equal the Python renderings of the
    same block range, bytes and offsets (the emitter's zlib mode)."""
    from xsqueezeit_tpu_torch.parallel import distributed as dist

    monkeypatch.setenv("XSI_EMIT_ZLIB", "1")
    bcf = str(tmp_path / "in.bcf")
    synth_bcf(bcf, 300, 40, seed=5, missing_frac=0.01)
    _, voffs = count_entries_offsets(bcf, 64)
    opts = dist.CompressorOptions(block_length=64, device="cpu")
    ranges = [(0, 2), (2, 4), (4, 5), (5, 5)]
    got = [dist._var_segment(bcf, str(tmp_path / "o.xsi"), opts, s, e,
                             voffs, s == 0) for s, e in ranges]
    monkeypatch.setenv("XSI_NATIVE", "0")
    want = [dist._var_segment(bcf, str(tmp_path / "o.xsi"), opts, s, e,
                              voffs, s == 0) for s, e in ranges]
    for (g, gt, _), (w, wt, _) in zip(got, want):
        assert g == w
        for a, b in zip(gt, wt):
            np.testing.assert_array_equal(a, b)
    monkeypatch.delenv("XSI_NATIVE")
    xsi = str(tmp_path / "o.xsi")
    assert jax_cli(["-c", "-f", bcf, "-o", xsi,
                    "--variant-block-length", "64"]) == 0
    for pidx, (s, e) in enumerate(ranges):
        d = Decompressor(xsi, DecompressorOptions(device="numpy",
                                                  block_range=(s, e)))
        data, n = dist._native_segment_bytes(d, s, e, pidx)
        body = io.BytesIO()
        assert d._decompress_to_bcf(body, write_header=(pidx == 0),
                                    write_eof=False)["records"] == n
        assert data == body.getvalue()
        d.close()


# ------------------------------------- the build without zstd/libdeflate
def test_build_without_zstd_and_libdeflate(compressed, tmp_path,
                                           monkeypatch):
    """The build of a machine without zstd or libdeflate, made here under
    its own name: it reads a plain container as the probed build does,
    writes the Python writer's bytes without XSI_EMIT_ZLIB, and refuses
    a zstd container with an error that names zstd."""
    vcf, xsi = compressed
    path = native.build_native(zstd=False, libdeflate=False)
    assert path == native.library_path("libxsqueezeit_tpu", False, False)
    assert path != native.build_native()
    with open(path + ".flags") as f:
        flags = f.read().split()
    assert "-lzstd" not in flags and "-ldeflate" not in flags
    assert "-DXSI_HAVE_ZSTD" not in flags
    monkeypatch.setattr(native, "_lib", lambda: native.load_library(
        zstd=False, libdeflate=False))
    monkeypatch.delenv("XSI_EMIT_ZLIB", raising=False)
    if XsiReader(xsi).header.zstd:
        with pytest.raises(OSError, match="without zstd"):
            native.NativeAccessor(xsi)
        return
    acc = native.NativeAccessor(xsi)
    orig = [(r.n_alleles, r.gt) for r in GtInput(vcf)]
    for (na, gt), (ona, ogt) in zip(acc, orig):
        assert na == ona
        np.testing.assert_array_equal(gt, ogt)
    acc.close()
    text, gt_key = _header_text(xsi)
    got = str(tmp_path / "nozstd.bcf")
    native.native_extract(xsi, got, text, gt_key, 6)
    monkeypatch.setenv("XSI_NATIVE", "0")
    py = str(tmp_path / "py.bcf")
    Decompressor(xsi, DecompressorOptions(device="numpy")).decompress(py)
    assert _read(got) == _read(py)


def test_build_is_serialised_and_follows_its_sources(tmp_path,
                                                     monkeypatch):
    """Three processes build one library at once into a fresh build
    directory: one compiles, the others wait on the lock and load it.  A
    source newer than the library rebuilds it."""
    src = tmp_path / "native"
    import shutil
    shutil.copytree(native.SRC_DIR, src)
    build = tmp_path / "build"
    script = textwrap.dedent(f"""
        from xsqueezeit_tpu_torch.interop import native
        native.SRC_DIR = {str(src)!r}
        native.BUILD_DIR = {str(build)!r}
        native.load_library(zstd=False, libdeflate=False)
        print(native.last_build_seconds is not None)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    built = [o[0].split()[0] == "True" for o in outs]
    assert built.count(True) == 1, outs
    lib = str(build / "libxsqueezeit_tpu-nozstd-nodeflate.so")
    assert os.path.exists(lib)
    assert not [f for f in os.listdir(build) if ".tmp" in f]
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    before = os.path.getmtime(lib)
    assert native.build_native(zstd=False, libdeflate=False) == lib
    assert os.path.getmtime(lib) == before           # fresh: not rebuilt
    os.utime(src / "gt_batch.cpp", (before + 10, before + 10))
    native.build_native(zstd=False, libdeflate=False)
    assert os.path.getmtime(lib) > before


def test_a_loaded_library_is_not_checked_again(tmp_path, monkeypatch):
    """Once a process has loaded a build, load_library hands it back
    without looking at the sources or the build again; another build
    directory is a build of its own."""
    lib = native.load_library()
    monkeypatch.setattr(native, "_deps", lambda: pytest.fail("checked"))
    monkeypatch.setattr(native, "build_native",
                        lambda *a, **kw: pytest.fail("built"))
    assert native.load_library() is lib
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(pytest.fail.Exception, match="built"):
        native.load_library()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    cxx = tmp_path / "g++"
    cxx.write_text("#!/bin/sh\necho 'cc1plus: fatal error: out of cheese' "
                   ">&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(native.NativeBuildError, match="out of cheese"):
        native.build_native()
    monkeypatch.setattr(native, "CXX", str(tmp_path / "missing-g++"))
    with pytest.raises(native.NativeBuildError, match="missing-g"):
        native.build_native()


# --------------------------------------------------------------- C API
@pytest.fixture(scope="module")
def c_programs(tmp_path_factory):
    return native.build_c_api_tests(str(tmp_path_factory.mktemp("capi")))


def test_c_programs_agree_with_the_accessor(compressed, c_programs):
    """c_api_test (libxsqueezeit_tpu.so) and c_xcf_test (the drop-in
    c_xcf_* API, libxsqueezeit.so), built with gcc against the port's
    libraries: their genotypes are the port Accessor's."""
    vcf, xsi = compressed
    acc = Accessor(xsi)
    r = BcfReader(acc.variant_filename())
    gts = [acc.get_genotypes(rec).astype(np.int64) for rec in r]
    r.close()
    out = subprocess.run([c_programs["c_api_test"], xsi], check=True,
                         capture_output=True, text=True).stdout
    assert f"records_read={len(gts)}" in out
    assert f"gt_checksum={sum(int(g.sum()) for g in gts)}" in out
    out = subprocess.run([c_programs["c_xcf_test"], xsi + "_var.bcf"],
                         check=True, capture_output=True, text=True).stdout
    assert f"nsamples {acc.n_samples}" in out
    got = [int(line.split()[-1]) for line in out.splitlines()
           if line.startswith("record ")]
    assert got == [int((g * np.arange(1, g.shape[0] + 1)).sum())
                   for g in gts]
    plain = xsi + ".plain.bcf"
    Decompressor(xsi, DecompressorOptions(device="numpy")).decompress(plain)
    out = subprocess.run([c_programs["c_xcf_test"], xsi + "_var.bcf", plain],
                         check=True, capture_output=True, text=True).stdout
    assert "lockstep-identical" in out


# --------------------------------------- a block of zero-ALT records only
@pytest.fixture
def zero_alt_zstd(tmp_path):
    """A zstd container with a block of zero-ALT records only: 3 samples,
    4 records with ALTs A, ., ., C (the middle two 0|0), blocks of one
    record.  Such a block has no binary line, so its line tracks sit at
    the payload's end, which under zstd is the block's exact size."""
    rows = [("A", ["0|1", "0|0", "1|1"]), (".", ["0|0"] * 3),
            (".", ["0|0"] * 3), ("C", ["1|0", "0|0", "0|1"])]
    vcf = fixtures.write_vcf(str(tmp_path / "in.vcf"), rows, n_samples=3)
    xsi = str(tmp_path / "o.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi, "--zstd",
                    "--variant-block-length", "1"]) == 0
    return vcf, xsi


def test_zero_alt_zstd_block_extracts_on_the_host_codec(zero_alt_zstd,
                                                       tmp_path):
    """-x --device numpy (the native accessor, record by record) writes
    the JAX package's VCF, byte for byte, and the input's genotypes."""
    vcf, xsi = zero_alt_zstd
    got, want = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
    assert torch_cli(["-x", "-f", xsi, "-o", got, "--device", "numpy"]) == 0
    assert jax_cli(["-x", "-f", xsi, "-o", want]) == 0
    assert _read(got) == _read(want)
    assert [r.gt.tolist() for r in GtInput(got)] == \
        [r.gt.tolist() for r in GtInput(vcf)]


def test_zero_alt_zstd_block_counts_natively(zero_alt_zstd):
    """The Accessor's allele counts through the native engine equal the
    genotypes' (6 REF on a zero-ALT record) and its genotypes the
    input's."""
    vcf, xsi = zero_alt_zstd
    acc = Accessor(xsi)
    assert acc._native() is not None
    r = BcfReader(acc.variant_filename())
    for rec, (gt, na) in zip(r, ((g.gt, g.n_alleles) for g in GtInput(vcf))):
        assert rec.n_allele == na
        np.testing.assert_array_equal(acc.get_genotypes(rec), gt)
        alleles = (gt >> 1) - 1
        np.testing.assert_array_equal(
            acc.get_allele_counts(rec),
            np.bincount(alleles[alleles >= 0], minlength=na))
    r.close()
    acc.close()


def test_zero_alt_zstd_block_in_the_c_api(zero_alt_zstd, c_programs):
    """c_api_test reads every record of the container (the port's C API
    decodes through the same block decoder)."""
    vcf, xsi = zero_alt_zstd
    gts = [g.gt.astype(np.int64) for g in GtInput(vcf)]
    out = subprocess.run([c_programs["c_api_test"], xsi], check=True,
                         capture_output=True, text=True).stdout
    assert f"records_read={len(gts)}" in out
    assert f"gt_checksum={sum(int(g.sum()) for g in gts)}" in out


def _next_line_returns(path):
    lib = ctypes.CDLL(native.build_c_api())
    lib.bcf_sr_init.restype = ctypes.c_void_p
    lib.bcf_sr_add_reader.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bcf_sr_next_line.argtypes = [ctypes.c_void_p]
    lib.bcf_sr_destroy.argtypes = [ctypes.c_void_p]
    sr = lib.bcf_sr_init()
    try:
        assert lib.bcf_sr_add_reader(sr, path.encode()) == 1
        rets = []
        while not rets or rets[-1] > 0:
            rets.append(lib.bcf_sr_next_line(sr))
        rets.append(lib.bcf_sr_next_line(sr))      # after the end
        return rets
    finally:
        lib.bcf_sr_destroy(sr)


def test_a_truncated_vcf_gz_is_an_error(tmp_path):
    """The port's c_xcf reader reports a plain-gzip stream cut short as a
    read error (bcf_sr_next_line < -1, htslib's bcf_read convention),
    once, where the JAX package's copy reads it as a clean end of file;
    a whole file ends with 0."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=10,
                              n_records=400, seed=1)
    data = gzip.compress(_read(vcf))
    full, cut = str(tmp_path / "full.vcf.gz"), str(tmp_path / "cut.vcf.gz")
    with open(full, "wb") as f:
        f.write(data)
    with open(cut, "wb") as f:
        f.write(data[: len(data) * 2 // 3])
    rets = _next_line_returns(full)
    assert rets[-2:] == [0, 0] and rets.count(1) == 400
    rets = _next_line_returns(cut)
    assert rets[-2:] == [-2, 0] and 0 < rets.count(1) < 400


# ------------------------------------------------------------ the tools
def test_loading_time_native_and_af_stats_walk(compressed, monkeypatch):
    """loading_time --native reads every record through the accessor
    library; af_stats' native walk equals its Python walk (XSI_NATIVE=0)
    on this fixture and closes its accessor."""
    vcf, xsi = compressed
    got, want = tools.loading_time(xsi, native=True), tools.loading_time(xsi)
    assert got["records"] == want["records"] == 90
    assert got["gt_entries"] == want["gt_entries"]
    nat = tools.af_stats(xsi)["stats"]
    monkeypatch.setenv("XSI_NATIVE", "0")
    assert nat == tools.af_stats(xsi)["stats"]
    with pytest.raises(OSError):
        tools.loading_time(vcf, native=True)
