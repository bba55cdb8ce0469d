"""The port's random-access API against the JAX package's, on the same
files: Accessor (genotypes in random order, allele counts, the raw
compressed forms), Decompressor.allele_counts_bm, Xcf over .xsi,
_var.bcf and plain VCF, count_entries and the CLI's --count-xcf and
--profile.  The JAX package runs on its host codec (the tests pin
XSI_DEVICE=numpy, tests/conftest.py); the files are the JAX CLI's.
Tolerance: exact equality."""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from xsqueezeit_tpu.accessor import Accessor as JaxAccessor
from xsqueezeit_tpu.cli import main as jax_cli
from xsqueezeit_tpu.codec.decompressor import Decompressor as JaxDecompressor
from xsqueezeit_tpu.interop.native import NativeAccessor as JaxNativeAccessor
from xsqueezeit_tpu.io.unified import GtInput as JaxInput
from xsqueezeit_tpu.io.unified import count_entries as jax_count_entries
from xsqueezeit_tpu.mixed import Xcf as JaxXcf
from xsqueezeit_tpu_torch.accessor import Accessor
from xsqueezeit_tpu_torch.cli import main as torch_cli
from xsqueezeit_tpu_torch.codec.decompressor import (
    Decompressor,
    DecompressorOptions,
)
from xsqueezeit_tpu_torch.io.bcf import BcfReader
from xsqueezeit_tpu_torch.io.unified import count_entries
from xsqueezeit_tpu_torch.mixed import Xcf
from xsqueezeit_tpu_torch.ops import pbwt_np
from tests import fixtures
from tests.test_torch_parity import FIXTURES
from tests.jax_build import jax_native_built  # noqa: F401 (autouse)

ORDER = [5, 60, 3, 119, 55, 0, 80, 49, 50]


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """The JAX package's accessor test file: 30 samples, 120 records,
    15 % multi-allelic, blocks of 50 records."""
    td = tmp_path_factory.mktemp("acc")
    vcf = fixtures.random_vcf(str(td / "in.vcf"), n_samples=30,
                              n_records=120, seed=9, p_multi=0.15)
    xsi = str(td / "o.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi,
                    "--variant-block-length", "50", "--maf", "0.02"]) == 0
    return vcf, xsi


@pytest.fixture(params=sorted(FIXTURES))
def micro(request, tmp_path):
    write, block = FIXTURES[request.param]
    vcf = write(str(tmp_path / "in.vcf"))
    xsi = str(tmp_path / "o.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi,
                    "--variant-block-length", str(block)]) == 0
    return request.param, vcf, xsi


def _variant_records(xsi):
    reader = BcfReader(xsi + "_var.bcf")
    recs = list(reader)
    reader.close()
    return recs


def _input_gts(vcf):
    inp = JaxInput(vcf)
    out = [r.gt for r in inp]
    inp.close()
    return out


def _same_internal_access(got, want):
    assert got.position == want.position
    assert got.n_alleles == want.n_alleles
    assert got.default_allele == want.default_allele
    assert got.a.dtype == want.a.dtype
    np.testing.assert_array_equal(got.a, want.a)
    assert got.sparse == want.sparse
    assert len(got.pointers) == len(want.pointers)
    for p, q in zip(got.pointers, want.pointers):
        assert p.dtype == q.dtype
        np.testing.assert_array_equal(p, q)


def test_accessor_random_access(compressed):
    """Records in the JAX test's random order, across block jumps: the
    input's genotypes, equal to the JAX Accessor's."""
    vcf, xsi = compressed
    acc, jacc = Accessor(xsi), JaxAccessor(xsi)
    assert acc.get_sample_list() == jacc.get_sample_list()
    assert len(acc.get_sample_list()) == 30
    assert acc.n_haps == jacc.n_haps == 60
    assert acc.variant_filename() == jacc.variant_filename()
    orig = _input_gts(vcf)
    recs = _variant_records(xsi)
    for i in ORDER:
        gt = acc.get_genotypes(recs[i])
        np.testing.assert_array_equal(gt, orig[i], err_msg=f"record {i}")
        np.testing.assert_array_equal(gt, jacc.get_genotypes(recs[i]))


def test_accessor_allele_counts(compressed):
    vcf, xsi = compressed
    acc, jacc = Accessor(xsi), JaxAccessor(xsi)
    recs = _variant_records(xsi)
    for rec, gt in zip(recs, _input_gts(vcf)):
        counts = acc.get_allele_counts(rec)
        alleles = (gt >> 1) - 1
        want = np.bincount(alleles[alleles >= 0], minlength=rec.n_allele)
        np.testing.assert_array_equal(counts, want)
        np.testing.assert_array_equal(counts, jacc.get_allele_counts(rec))
    bms = np.array([acc.position_from_bm_entry(r) for r in recs], np.int32)
    nas = np.array([r.n_allele for r in recs], np.int32)
    flat = acc.fill_allele_counts_range(bms, nas)
    assert flat.dtype == np.int64 and flat.shape == (int(nas.sum()),)
    np.testing.assert_array_equal(
        flat, JaxAccessor(xsi).fill_allele_counts_range(bms, nas))
    assert acc.fill_allele_counts_range([], []).shape == (0,)


def test_internal_access(compressed):
    """The raw compressed forms of every record, visited in random order:
    `a`, `sparse` and `pointers` equal to the JAX package's."""
    _, xsi = compressed
    acc, jacc = Accessor(xsi), JaxAccessor(xsi)
    recs = _variant_records(xsi)
    for i in ORDER + list(range(len(recs))):
        bm = acc.position_from_bm_entry(recs[i])
        got = acc.get_internal_access(bm, recs[i].n_allele)
        want = jacc.get_internal_access(bm, recs[i].n_allele)
        _same_internal_access(got, want)
        assert len(got.sparse) == recs[i].n_allele - 1
        assert got.a.shape[0] == acc.n_haps
        assert not got.haploid


def test_split_bm_and_names(compressed):
    _, xsi = compressed
    for bm in (0, 7, (3 << 15) | 11, (1 << 31) | 5):
        assert Accessor.split_bm(bm) == JaxAccessor.split_bm(bm)
    var = xsi + "_var.bcf"
    assert Accessor.xsi_filename_from_variant(var) == xsi
    with pytest.raises(ValueError):
        Accessor.xsi_filename_from_variant(xsi)


def test_micro_fixtures_match(micro, monkeypatch):
    """Every exception-track, haploid and mixed-ploidy fixture: genotypes,
    allele counts and internal access per record, in reverse order (every
    step a backward seek), equal to the JAX package's; `haploid` says
    which lines hold one slot per sample.  Allele counts come from the
    native count-only engine, equal to the JAX package's native engine;
    with XSI_NATIVE=0 from the Python decoder, equal to the genotypes'
    counts (the JAX package's Python route gives a zero-ALT record two
    counts, REF and a 0, where it has one allele)."""
    name, vcf, xsi = micro
    acc, jacc = Accessor(xsi), JaxAccessor(xsi)
    jnat = JaxNativeAccessor(xsi)
    recs = _variant_records(xsi)
    orig = _input_gts(vcf)
    assert len(recs) == len(orig) > 0
    for i in reversed(range(len(recs))):
        rec = recs[i]
        np.testing.assert_array_equal(acc.get_allele_counts(rec),
                                      jnat.fill_allele_counts_bm(
                                          acc.position_from_bm_entry(rec),
                                          rec.n_allele))
    jnat.close()
    monkeypatch.setenv("XSI_NATIVE", "0")
    acc = Accessor(xsi)
    for i in reversed(range(len(recs))):
        rec = recs[i]
        np.testing.assert_array_equal(acc.get_genotypes(rec), orig[i],
                                      err_msg=f"{name} record {i}")
        alleles = (orig[i] >> 1) - 1
        np.testing.assert_array_equal(
            acc.get_allele_counts(rec),
            np.bincount(alleles[alleles >= 0], minlength=rec.n_allele))
        bm = acc.position_from_bm_entry(rec)
        got = acc.get_internal_access(bm, rec.n_allele)
        _same_internal_access(got,
                              jacc.get_internal_access(bm, rec.n_allele))
        block, offset = acc.split_bm(bm)
        dec = acc._decoder(block)
        assert got.haploid == (rec.n_allele > 1
                               and bool(dec.haploid_line[offset]))
        assert got.haploid == (orig[i].shape[0] == acc.n_samples
                               and rec.n_allele > 1)


def test_internal_access_of_a_haploid_wah_line(tmp_path):
    """A haploid WAH line decodes n_samples bits wide in the haploid
    arrangement derived from `a`: its carriers are the input's."""
    rows = [("A", [f"{(i * 7 + r) % 3 % 2}" for i in range(40)])
            for r in range(6)]
    vcf = fixtures.write_vcf(str(tmp_path / "hap.vcf"), rows, n_samples=40)
    xsi = str(tmp_path / "hap.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi, "--maf", "0"]) == 0
    acc = Accessor(xsi)
    from xsqueezeit_tpu_torch.ops import wah_np
    n_wah = 0
    for rec, gt in zip(_variant_records(xsi), _input_gts(vcf)):
        ia = acc.get_internal_access(acc.position_from_bm_entry(rec), 2)
        assert ia.haploid
        if ia.sparse[0]:
            continue
        n_wah += 1
        bits, _ = wah_np.wah_decode(ia.pointers[0], acc.n_samples)
        a1 = pbwt_np.haploid_rearrangement_from_diploid(ia.a)
        carriers = np.sort(a1[np.flatnonzero(bits[:acc.n_samples])])
        np.testing.assert_array_equal(carriers,
                                      np.flatnonzero((gt >> 1) - 1 == 1))
    assert n_wah > 0


@pytest.mark.parametrize("device", ["numpy", "cpu"])
def test_decompressor_allele_counts_bm(compressed, device):
    _, xsi = compressed
    d = Decompressor(xsi, DecompressorOptions(device=device))
    jd = JaxDecompressor(xsi)
    acc = Accessor(xsi)
    recs = _variant_records(xsi)
    for i in ORDER + list(range(len(recs))):
        bm = acc.position_from_bm_entry(recs[i])
        got = d.allele_counts_bm(bm, recs[i].n_allele)
        np.testing.assert_array_equal(
            got, jd.allele_counts_bm(bm, recs[i].n_allele))
        np.testing.assert_array_equal(
            got, acc.fill_allele_counts(bm, recs[i].n_allele))


def test_decompressor_allele_counts_bm_micro(micro):
    """The counts equal the genotypes' (and the JAX package's wherever its
    Python route gives one count per allele: it gives a zero-ALT record
    two, REF and a 0)."""
    _, vcf, xsi = micro
    d = Decompressor(xsi, DecompressorOptions(device="cpu"))
    jd = JaxDecompressor(xsi)
    acc = Accessor(xsi)
    recs = _variant_records(xsi)
    orig = _input_gts(vcf)
    for i in reversed(range(len(recs))):
        rec = recs[i]
        bm = acc.position_from_bm_entry(rec)
        got = d.allele_counts_bm(bm, rec.n_allele)
        alleles = (orig[i] >> 1) - 1
        np.testing.assert_array_equal(
            got, np.bincount(alleles[alleles >= 0], minlength=rec.n_allele))
        if rec.n_allele > 1:
            np.testing.assert_array_equal(
                got, jd.allele_counts_bm(bm, rec.n_allele))


def _xcf_rows(x, i):
    return [(rec.n_allele if hasattr(rec, "n_allele") else rec.n_alleles,
             None if gt is None else gt.copy()) for rec, gt in x[i]]


def test_xcf_routes_and_matches(tmp_path):
    """Xcf over the variant file, the container and a plain VCF: the
    routes and every row equal to the JAX package's Xcf."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=11,
                              n_records=40, seed=31)
    xsi = str(tmp_path / "m.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi,
                    "--variant-block-length", "16"]) == 0
    bcf = str(tmp_path / "m.bcf")
    assert torch_cli(["-x", "-f", xsi, "-o", bcf, "--device", "cpu"]) == 0
    paths = (xsi + "_var.bcf", bcf, xsi, vcf)
    x, jx = Xcf(), JaxXcf()
    for p in paths:
        assert x.add_reader(p) == jx.add_reader(p)
    assert [e.is_xsi for e in x.entries] == [True, False, True, False]
    assert [e.is_xsi for e in x.entries] == [e.is_xsi for e in jx.entries]
    for i in range(len(paths)):
        assert x.sample_names(i) == jx.sample_names(i)
        assert x.n_samples(i) == jx.n_samples(i) == 11
        got, want = _xcf_rows(x, i), _xcf_rows(jx, i)
        assert len(got) == len(want) == 40
        for (na, g), (nb, w) in zip(got, want):
            assert na == nb
            np.testing.assert_array_equal(g, w)
    first = _xcf_rows(x, 0)
    for i in range(1, len(paths)):
        for (_, a), (_, b) in zip(first, _xcf_rows(x, i)):
            np.testing.assert_array_equal(a, b)
    x.close()
    jx.close()


def test_xcf_internal_access_and_header_route(tmp_path):
    """A variant file found through its ##XSI= header entry, and the raw
    forms through Xcf, equal to the JAX package's."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=9,
                              n_records=20, seed=32)
    xsi = str(tmp_path / "m.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi]) == 0
    x, jx = Xcf(), JaxXcf()
    i, j = x.add_reader(xsi), jx.add_reader(xsi)
    rec = x[i].reader.read_record()
    jrec = jx[j].reader.read_record()
    got = x[i].get_internal_access(rec)
    _same_internal_access(got, jx[j].get_internal_access(jrec))
    assert got.a.shape[0] == 18
    np.testing.assert_array_equal(x[i].get_genotypes(rec),
                                  jx[j].get_genotypes(jrec))
    from xsqueezeit_tpu.mixed import xsi_path_from_variant_header as jfind
    from xsqueezeit_tpu_torch.mixed import xsi_path_from_variant_header
    assert xsi_path_from_variant_header(xsi + "_var.bcf", rec._header) == \
        jfind(xsi + "_var.bcf", jrec._header) == xsi
    x.close()
    jx.close()
    with pytest.raises(FileNotFoundError):
        Xcf().add_reader(str(tmp_path / "absent.bcf"))


def test_count_entries(compressed, tmp_path):
    vcf, xsi = compressed
    var = xsi + "_var.bcf"
    bcf = str(tmp_path / "o.bcf")
    assert torch_cli(["-x", "-f", xsi, "-o", bcf, "--device", "cpu"]) == 0
    for path in (vcf, var, bcf):
        assert count_entries(path) == jax_count_entries(path) == 120


def _count_line(err: str) -> str:
    lines = [ln for ln in err.splitlines() if ln.startswith("INFO")]
    assert len(lines) == 1, err
    return lines[0]


@pytest.mark.parametrize("which", ["vcf", "var"])
def test_cli_count_xcf(compressed, capsys, which):
    vcf, xsi = compressed
    path = vcf if which == "vcf" else xsi + "_var.bcf"
    assert torch_cli(["--count-xcf", "-f", path]) == 0
    got = capsys.readouterr().err
    assert jax_cli(["--count-xcf", "-f", path]) == 0
    want = capsys.readouterr().err
    assert _count_line(got) == _count_line(want) == \
        "INFO : Number of entries is : 120"
    assert "Time taken : " in got


def test_cli_profile_writes_a_trace(compressed, tmp_path):
    vcf, _ = compressed
    prof = tmp_path / "prof"
    out = str(tmp_path / "p.xsi")
    assert torch_cli(["--profile", str(prof), "-c", "-f", vcf, "-o", out,
                      "--device", "cpu", "--variant-block-length", "50"]) == 0
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert os.path.getsize(out) > 0
