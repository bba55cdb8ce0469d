"""The port's tool suite (xsqueezeit_tpu_torch.bench and utils) against
the JAX package's, on the same files: loading_time, dot_prod (the host
walk and the block decode on CPU tensors, per variant), af_stats and its annotated
BCF, lockstep, the block stats, the mutators, the phasers, the bitmaps,
e2e / hrc / warmup at a tiny size, and `python -m xsqueezeit_tpu_torch.bench`
for each subcommand.  The JAX package runs on its host codec (the tests pin
XSI_DEVICE=numpy, tests/conftest.py).  Tolerance: exact equality, except
the float dot products: the port's host walk equals the plain VCF walk to
relative 1e-12 per variant and its checksum to 1e-6 (the JAX package's
XSI walk on diploid files exactly), and the float32 block products are
within relative 1e-6 of the host walk per variant."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xsqueezeit_tpu.bench import tools as jax_tools
from xsqueezeit_tpu.cli import main as jax_cli
from xsqueezeit_tpu.utils import bitmap as jax_bitmap
from xsqueezeit_tpu.utils import mutate as jax_mutate
from xsqueezeit_tpu.utils import phasing as jax_phasing
from xsqueezeit_tpu.utils.stats import xsi_block_stats as jax_block_stats
from xsqueezeit_tpu_torch.bench import e2e, tools
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.utils import bitmap, mutate, phasing
from xsqueezeit_tpu_torch.utils.stats import xsi_block_stats
from tests import fixtures
from tests.test_phasing_stats import _haplotype_panel_vcf
from tests.test_torch_parity import FIXTURES
from tests.jax_build import jax_native_built  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Fixtures whose every record is uniformly diploid: the JAX package's XSI
#: walk is right on them (it halves every carrier index).
DIPLOID = ("random", "missing", "eov", "zero_alt")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """The JAX package's accessor test file: 30 samples, 120 records,
    15 % multi-allelic, blocks of 50 records."""
    td = tmp_path_factory.mktemp("tools")
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


# ----------------------------------------------------------- loading_time
def test_loading_time(compressed):
    vcf, xsi = compressed
    for path in (vcf, xsi):
        got, want = tools.loading_time(path), jax_tools.loading_time(path)
        assert got["records"] == want["records"] == 120
        assert got["gt_entries"] == want["gt_entries"] == 120 * 60
        assert got["gt_per_second"] > 0


def test_iter_genotypes_and_is_xsi(micro):
    _, vcf, xsi = micro
    assert tools._is_xsi(xsi) and not tools._is_xsi(vcf)
    assert not tools._is_xsi(xsi + ".absent")
    for path in (vcf, xsi):
        got = list(tools.iter_genotypes(path))
        want = list(jax_tools.iter_genotypes(path))
        assert len(got) == len(want) > 0
        for (na, g), (nb, w) in zip(got, want):
            assert na == nb
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- dot_prod
def test_dot_prod_matches_the_jax_package(compressed):
    vcf, xsi = compressed
    got = tools.dot_prod(xsi, device="host")
    dots = got.pop("dots")
    assert got == {**jax_tools.dot_prod(xsi), "seconds": got["seconds"]}
    assert dots.shape == (got["variants"],)
    assert abs(dots.sum() - got["checksum"]) < 1e-6
    plain = tools.dot_prod(vcf, device="host")
    assert plain["checksum"] == jax_tools.dot_prod(vcf)["checksum"]
    assert plain["variants"] == got["variants"]
    assert abs(plain["checksum"] - got["checksum"]) < 1e-6
    np.testing.assert_allclose(dots, plain["dots"], rtol=1e-12, atol=0)


def test_dot_prod_on_every_fixture(micro):
    """The host walk equals the plain VCF walk on every fixture, haploid
    lines included (the JAX package's XSI walk is off on haploid lines:
    it halves their sample indices), and the JAX XSI walk exactly on the
    diploid ones."""
    name, vcf, xsi = micro
    got = tools.dot_prod(xsi, device="host")
    plain = jax_tools.dot_prod(vcf)
    assert got["variants"] == plain["variants"] > 0
    assert abs(got["checksum"] - plain["checksum"]) <= 1e-6
    if name in DIPLOID:
        assert got["checksum"] == jax_tools.dot_prod(xsi)["checksum"]
    port_plain = tools.dot_prod(vcf, device="host")
    assert port_plain["checksum"] == plain["checksum"]
    np.testing.assert_allclose(got["dots"], port_plain["dots"], rtol=1e-12,
                               atol=0)


#: The JAX package's dot_prod faults, repro at --variant-block-length 3:
#: fixture -> the plain VCF walk's checksum (its XSI walk gives 12.662652,
#: 6.038564 and 3.602539; its device tool raises TypeError on the first
#: two and gives 4.282318 on the third).
FAULT_REPRO = {"micro_haploid": 7.639632, "micro_mixed_ploidy": 4.859799,
               "micro_missing_non_uniform_phasing_ploidy": 3.94724}


@pytest.mark.parametrize("name", sorted(FAULT_REPRO))
def test_dot_prod_does_not_repeat_the_reference_faults(tmp_path, name):
    vcf = getattr(fixtures, name)(str(tmp_path / "in.vcf"))
    xsi = str(tmp_path / "o.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi,
                    "--variant-block-length", "3"]) == 0
    assert jax_tools.dot_prod(vcf)["checksum"] == FAULT_REPRO[name]
    host = tools.dot_prod(xsi, device="host")
    assert host["checksum"] == FAULT_REPRO[name]
    got = tools.dot_prod(xsi, device="cpu")
    assert abs(got["checksum"] - FAULT_REPRO[name]) <= \
        1e-5 * FAULT_REPRO[name]
    np.testing.assert_allclose(got["dots"], host["dots"], rtol=1e-6, atol=0)


#: Blocks per route of dot_prod(device="cpu") on each fixture.
ROUTES = {"haploid": (1, 0), "mixed_ploidy": (0, 2),
          "missing_non_uniform_phasing_ploidy": (1, 1)}


def test_dot_prod_device_cpu(micro):
    """Whole blocks decode on CPU tensors and one float32 product each
    runs there: every variant's dot within relative 1e-6 of the host
    walk's on every fixture, uniformly haploid and mixed-ploidy blocks
    included."""
    name, vcf, xsi = micro
    host = tools.dot_prod(xsi, device="host")
    got = tools.dot_prod(xsi, device="cpu")
    assert got["variants"] == host["variants"]
    np.testing.assert_allclose(got["dots"], host["dots"], rtol=1e-6, atol=0)
    assert abs(got["checksum"] - host["checksum"]) <= \
        1e-6 * abs(host["checksum"])
    assert got["device"] == "cpu" and got["host_blocks"] == 0
    dev, mixed = ROUTES.get(name, (got["device_blocks"], 0))
    assert (got["device_blocks"], got["mixed_blocks"]) == (dev, mixed)
    assert got["haploid_blocks"] == (1 if name == "haploid" else 0)
    assert got["device_blocks"] + got["mixed_blocks"] > 0


def test_dot_prod_device_cpu_random(compressed):
    vcf, xsi = compressed
    host = tools.dot_prod(xsi, device="host")
    got = tools.dot_prod(xsi, device="cpu")
    assert got["variants"] == host["variants"]
    np.testing.assert_allclose(got["dots"], host["dots"], rtol=1e-6, atol=0)
    assert abs(got["checksum"] - host["checksum"]) <= \
        1e-6 * abs(host["checksum"])
    assert (got["device_blocks"], got["mixed_blocks"],
            got["host_blocks"]) == (3, 0, 0)


def test_dot_prod_device_host_walk(micro, monkeypatch):
    """Blocks the device decoder does not take (neither eligible nor
    mixed_device_ok, e.g. sort != select) walk their records on the host:
    the host walk's checksum."""
    _, _, xsi = micro
    monkeypatch.setattr(decoder_torch.TorchBlockDecoder, "eligible",
                        property(lambda self: False))
    monkeypatch.setattr(decoder_torch.TorchBlockDecoder, "mixed_device_ok",
                        property(lambda self: False))
    got = tools.dot_prod(xsi, device="cpu")
    host = tools.dot_prod(xsi, device="host")
    assert got["variants"] == host["variants"]
    assert abs(got["checksum"] - host["checksum"]) <= 1e-6
    np.testing.assert_allclose(got["dots"], host["dots"], rtol=1e-12,
                               atol=0)
    assert got["device_blocks"] == got["mixed_blocks"] == 0
    assert got["host_blocks"] > 0


#: dot_prod's walks of the variant file: the native scan, and the Python
#: record reader XSI_NATIVE=0 leaves.
WALKS = ("native", "python")
ROUTE_COUNTS = ("device_blocks", "haploid_blocks", "mixed_blocks",
                "host_blocks")


def _dot_prod_walk(xsi, walk, monkeypatch):
    if walk == "python":
        monkeypatch.setenv("XSI_NATIVE", "0")
    else:
        monkeypatch.delenv("XSI_NATIVE", raising=False)
    got = tools.dot_prod(xsi, device="cpu")
    assert got["walk"] == walk
    return got


def _walks_agree(xsi, walk, monkeypatch):
    """dot_prod(device="cpu") by `walk` against the other walk: the same
    dots element for element, the same variants, checksum and routes; and
    the dots within relative 1e-6 of the host walk's."""
    other = WALKS[1 - WALKS.index(walk)]
    want = _dot_prod_walk(xsi, other, monkeypatch)
    got = _dot_prod_walk(xsi, walk, monkeypatch)
    np.testing.assert_array_equal(got["dots"], want["dots"])
    for key in ("variants", "checksum") + ROUTE_COUNTS:
        assert got[key] == want[key], key
    host = tools.dot_prod(xsi, device="host")
    np.testing.assert_allclose(got["dots"], host["dots"], rtol=1e-6, atol=0)
    return got


@pytest.mark.parametrize("walk", WALKS)
def test_dot_prod_device_walks_agree(micro, walk, monkeypatch):
    """The native scan and the Python walk group the records alike on
    every fixture: multi-allelic records and records with no ALT
    (zero_alt) hold one line each but the first of none, so each block's
    lines of its bi-allelic records are the same."""
    name, _, xsi = micro
    got = _walks_agree(xsi, walk, monkeypatch)
    dev, mixed = ROUTES.get(name, (got["device_blocks"], 0))
    assert (got["device_blocks"], got["mixed_blocks"]) == (dev, mixed)


@pytest.mark.parametrize("walk", WALKS)
def test_dot_prod_device_walks_agree_random(compressed, walk, monkeypatch):
    _, xsi = compressed
    got = _walks_agree(xsi, walk, monkeypatch)
    assert (got["device_blocks"], got["mixed_blocks"],
            got["host_blocks"]) == (3, 0, 0)


@pytest.mark.parametrize("walk", WALKS)
def test_dot_prod_device_walks_agree_on_host_blocks(compressed, walk,
                                                   monkeypatch):
    """The host route takes each block's variants and lines from either
    walk alike."""
    _, xsi = compressed
    monkeypatch.setattr(decoder_torch.TorchBlockDecoder, "eligible",
                        property(lambda self: False))
    monkeypatch.setattr(decoder_torch.TorchBlockDecoder, "mixed_device_ok",
                        property(lambda self: False))
    got = _walks_agree(xsi, walk, monkeypatch)
    assert got["host_blocks"] == 3 and got["device_blocks"] == 0


@pytest.mark.parametrize("name", sorted(FAULT_REPRO))
def test_dot_prod_device_walks_agree_on_small_blocks(tmp_path, name,
                                                     monkeypatch):
    """Blocks of three records, so many blocks: the native scan's grouping
    against the Python walk's, blocks in file order."""
    vcf = getattr(fixtures, name)(str(tmp_path / "in.vcf"))
    xsi = str(tmp_path / "o.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi,
                    "--variant-block-length", "3"]) == 0
    _walks_agree(xsi, "native", monkeypatch)


def test_group_by_block_keeps_first_appearance_and_file_order():
    """Records of a block in file order, blocks in order of first
    appearance, each variant's index counted over the whole file; a BM
    with its sign bit set is read as unsigned, as Accessor.split_bm
    reads it."""
    from xsqueezeit_tpu_torch.format.constants import BM_BLOCK_BITS
    blocks = np.array([2, 2, 0, 2, 0, 1, 0x1FFFF], np.int64)
    bms = ((blocks << BM_BLOCK_BITS) + np.arange(7)).astype(np.uint32) \
        .view(np.int32)
    nas = np.array([2, 3, 2, 1, 2, 2, 2], np.int32)
    groups, n = tools._group_by_block(bms, nas)
    assert n == 5
    assert [(b, na.tolist(), v.tolist()) for b, na, v in groups] == [
        (2, [2, 3, 1], [0]), (0, [2, 2], [1, 2]), (1, [2], [3]),
        (0x1FFFF, [2], [4])]
    none = np.zeros(0, np.int32)
    assert tools._group_by_block(none, none) == ([], 0)


def test_dot_prod_device_refuses_numpy_and_a_missing_card(compressed):
    """numpy is no dot_prod device; a plain file is read on the host only;
    the default is the card, and without one it raises."""
    from xsqueezeit_tpu_torch.bench.__main__ import main as bench_main
    vcf, xsi = compressed
    with pytest.raises(ValueError):
        tools.dot_prod(xsi, device="numpy")
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="--device host"):
            tools.dot_prod(vcf, device=device)
    with pytest.raises(SystemExit) as exc:
        bench_main(["dot_prod", vcf])
    assert exc.value.code == 2
    if not torch.cuda.is_available():
        from xsqueezeit_tpu_torch.utils.devprobe import DeviceUnavailable
        with pytest.raises(DeviceUnavailable):
            tools.dot_prod(xsi)


# --------------------------------------------------------------- af_stats
def test_af_stats(compressed):
    vcf, xsi = compressed
    for path in (vcf, xsi):
        got, want = tools.af_stats(path), jax_tools.af_stats(path)
        assert got["stats"] == want["stats"]
        assert got["records"] == want["records"] == 120
    assert tools.af_stats(xsi)["stats"] == tools.af_stats(vcf)["stats"]
    assert tools.af_stats(xsi)["logical_gb_s"] is not None


def test_af_stats_on_every_fixture(micro, monkeypatch):
    """The port's native walk equals the JAX package's native walk (its
    route without XSI_DEVICE), and with XSI_NATIVE=0 its Python walk
    equals the genotypes' counts (the VCF's walk).  The JAX package's
    Python walk is not the reference there: it miscounts a run of records
    after a zero-ALT one (its count path gives such a record two counts,
    and the flat walk reads every later record shifted by one)."""
    _, vcf, xsi = micro
    got = tools.af_stats(xsi)["stats"]
    monkeypatch.setenv("XSI_DEVICE", "auto")
    assert got == jax_tools.af_stats(xsi)["stats"]
    monkeypatch.setenv("XSI_DEVICE", "numpy")
    monkeypatch.setenv("XSI_NATIVE", "0")
    want = tools.af_stats(vcf)["stats"]
    assert tools.af_stats(xsi)["stats"] == want == got
    assert want == jax_tools.af_stats(vcf)["stats"]


def test_af_stats_annotate(compressed, tmp_path):
    """The annotated variant BCF is byte-equal to the JAX package's."""
    _, xsi = compressed
    got, want = str(tmp_path / "port.bcf"), str(tmp_path / "jax.bcf")
    stats = tools.af_stats(xsi, annotate_out=got)
    jax_tools.af_stats(xsi, annotate_out=want)
    assert _read(got) == _read(want)
    from xsqueezeit_tpu_torch.io.bcf import BcfReader
    from xsqueezeit_tpu_torch.io.sites import render_vcf_cols
    reader = BcfReader(got)
    n = 0
    for rec, (an, acs) in zip(reader, stats["stats"]):
        info = render_vcf_cols(reader.header, rec)[7]
        assert f"AN={an}" in info
        assert "AC=" + ",".join(str(c) for c in acs) in info
        n += 1
    reader.close()
    assert n == 120


# --------------------------------------------------------------- lockstep
def test_lockstep(compressed, tmp_path):
    vcf, xsi = compressed
    out = tools.lockstep_load(vcf, xsi)
    want = jax_tools.lockstep_load(vcf, xsi)
    assert out["identical"] and out["records"] == want["records"] == 120
    assert out["gt_entries"] == want["gt_entries"]
    bad = str(tmp_path / "bad.vcf")
    with open(vcf) as f:
        text = f.read()
    with open(bad, "w") as f:
        f.write(text.replace("0|1", "1|1", 1))
    with pytest.raises(AssertionError, match="genotypes differ"):
        tools.lockstep_load(bad, xsi)
    short = str(tmp_path / "short.vcf")
    with open(short, "w") as f:
        f.write(text[:text.rstrip("\n").rfind("\n") + 1])
    with pytest.raises(AssertionError, match="record count"):
        tools.lockstep_load(short, xsi)


# ------------------------------------------------------------------ stats
def test_block_stats(compressed):
    _, xsi = compressed
    assert xsi_block_stats(xsi) == jax_block_stats(xsi)


def test_block_stats_on_every_fixture(micro):
    _, _, xsi = micro
    assert xsi_block_stats(xsi) == jax_block_stats(xsi)


# ---------------------------------------------------------------- mutate
MUTATORS = {
    "unphase": lambda m, src, out: m.unphase(src, out),
    "unphase_random": lambda m, src, out: m.unphase_random(src, out, seed=1),
    "sprinkle_missing": lambda m, src, out: m.sprinkle_missing(
        src, out, rate=0.2, seed=7),
    "inject_phase_switches": lambda m, src, out: m.inject_phase_switches(
        src, out, prob=0.05, seed=7),
}


@pytest.mark.parametrize("ext", ["vcf", "bcf"])
@pytest.mark.parametrize("name", sorted(MUTATORS))
def test_mutators_write_the_jax_package_bytes(tmp_path, name, ext):
    src = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=13,
                              n_records=40, seed=3)
    got, want = (str(tmp_path / f"{w}.{ext}") for w in ("port", "jax"))
    n = MUTATORS[name](mutate, src, got)
    assert n == MUTATORS[name](jax_mutate, src, want)
    assert _read(got) == _read(want)


def test_phase_switch_errors_and_matrices(tmp_path):
    src = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=11,
                              n_records=60, seed=9)
    flipped = str(tmp_path / "flip.vcf")
    mutate.unphase_random(src, flipped, seed=2)
    for test, ref in ((src, src), (flipped, src)):
        assert mutate.compute_phase_switch_errors(test, ref) == \
            jax_mutate.compute_phase_switch_errors(test, ref)
    assert mutate.compute_phase_switch_errors(flipped, src)["total"] > 0
    assert mutate.count_entries(src) == jax_mutate.count_entries(src) == 60
    np.testing.assert_array_equal(mutate.extract_matrix(src),
                                  jax_mutate.extract_matrix(src))
    for a, b in zip(mutate.extract_phase_vectors(flipped),
                    jax_mutate.extract_phase_vectors(flipped)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- phasing
def test_phasers_write_the_jax_package_bytes(tmp_path):
    vcf = _haplotype_panel_vcf(str(tmp_path / "in.vcf"), n_samples=20,
                               n_records=150, seed=91)
    bad = str(tmp_path / "bad.bcf")
    mutate.inject_phase_switches(vcf, bad, prob=0.05, seed=7)
    for fn, kw in (("phase_file", {}),
                   ("phase_file_windows", {"word_bits": 64}),
                   ("phase_file_windows", {"word_bits": 13})):
        got, want = (str(tmp_path / f"{w}.bcf") for w in ("port", "jax"))
        assert getattr(phasing, fn)(bad, got, **kw) == \
            getattr(jax_phasing, fn)(bad, want, **kw)
        assert _read(got) == _read(want), (fn, kw)
        assert mutate.compute_phase_switch_errors(got, vcf) == \
            jax_mutate.compute_phase_switch_errors(want, vcf)


# ---------------------------------------------------------------- bitmap
BITMAPS = {
    "gt_bitmap": lambda m, p: m.gt_bitmap(p),
    "pbwt_sorted_bitmap": lambda m, p: m.pbwt_sorted_bitmap(p),
    "final_sorted_bitmap": lambda m, p: m.final_sorted_bitmap(p),
    "block_sorted_bitmap": lambda m, p: m.block_sorted_bitmap(p, 16),
    "block_sorted_bitmap_pbwt": lambda m, p: m.block_sorted_bitmap(
        p, 16, pbwt=True),
    "tree_sorted_bitmap": lambda m, p: m.tree_sorted_bitmap(p),
    "pbwt_color_bitmap": lambda m, p: m.pbwt_color_bitmap(p),
}


@pytest.mark.parametrize("name", sorted(BITMAPS))
def test_bitmaps(tmp_path, name):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=17,
                              n_records=70, seed=12)
    got, want = BITMAPS[name](bitmap, vcf), BITMAPS[name](jax_bitmap, vcf)
    assert got.dtype == want.dtype and got.size > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["plain", "pbwt", "sorted", "tree",
                                  "color", "unknown"])
def test_bitmap_dump_and_pbm(tmp_path, mode):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=9,
                              n_records=40, seed=13)
    got, want = str(tmp_path / "port.pbm"), str(tmp_path / "jax.pbm")
    if mode == "unknown":
        for m, path in ((bitmap, got), (jax_bitmap, want)):
            with pytest.raises(ValueError, match="unknown bitmap mode"):
                m.dump_common(vcf, path, mode=mode)
        return
    assert bitmap.dump_common(vcf, got, mode=mode) == \
        jax_bitmap.dump_common(vcf, want, mode=mode)
    assert _read(got) == _read(want)
    bits = bitmap.gt_bitmap(vcf)
    bitmap.save_pbm(got, bits)
    jax_bitmap.save_pbm(want, bits)
    assert _read(got) == _read(want)


# ---------------------------------------------------- e2e, hrc and warmup
@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_e2e_run(tmp_path, device):
    out = e2e.run(n_records=300, n_samples=20, workdir=str(tmp_path),
                  device=device, missing_frac=0.01)
    assert out["records"] == 300 and out["device"] == device
    assert out["xsi_mb"] > 0
    assert os.path.exists(tmp_path / "roundtrip.bcf")
    lock = tools.lockstep_load(str(tmp_path / "in.bcf"),
                               str(tmp_path / "roundtrip.bcf"))
    assert lock["records"] == 300


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_hrc_scale(tmp_path, device):
    out = tools.hrc_scale(n_records=300, n_samples=24, block_length=64,
                          workdir=str(tmp_path), device=device, keep=True)
    assert out["identical"] and out["n_records"] == out["entries"] == 300
    assert out["gt_entries"] == 300 * 48 and out["n_blocks"] == 5
    assert tools.lockstep_load(str(tmp_path / "hrc.bcf"),
                               str(tmp_path / "hrc.xsi"))["records"] == 300


def test_hrc_scale_devices_write_the_same_xsi(tmp_path):
    for device in ("cpu", "numpy"):
        os.makedirs(tmp_path / device)
        tools.hrc_scale(n_records=200, n_samples=16, block_length=64,
                        workdir=str(tmp_path / device), device=device)
    assert _read(tmp_path / "cpu" / "hrc.xsi") == \
        _read(tmp_path / "numpy" / "hrc.xsi")


def test_warmup_cpu():
    out = tools.warmup(24, block_length=64, fracs=(1.0, 0.45),
                       device="cpu")
    assert out["build_s"] is None and out["device"] == "cpu"
    assert [s["n_wah"] for s in out["shapes"]] == [64, 28]
    assert out["mac_threshold"] == 1


# ------------------------------------------------ python -m ...bench
def _bench(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "xsqueezeit_tpu_torch.bench",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def _json(proc):
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    td = tmp_path_factory.mktemp("cmd")
    vcf = fixtures.random_vcf(str(td / "in.vcf"), n_samples=12,
                              n_records=60, seed=21, p_multi=0.0)
    xsi = str(td / "o.xsi")
    assert jax_cli(["-c", "-f", vcf, "-o", xsi,
                    "--variant-block-length", "32"]) == 0
    return td, vcf, xsi


SUBCOMMANDS = ("loading_time", "dot_prod", "dot_prod_cpu", "af_stats",
               "lockstep", "unphase", "sprinkle-missing",
               "phase-switch-errors", "phase", "stats", "e2e", "hrc",
               "warmup")


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_bench_main_subcommand(panel, cmd):
    """Each subcommand in a process of its own: exit 0 and its JSON line,
    equal to the in-process tool's (times aside)."""
    td, vcf, xsi = panel
    out = str(td / f"{cmd}.bcf")
    if cmd == "loading_time":
        got = _json(_bench(cmd, xsi))
        assert (got["records"], got["gt_entries"]) == (60, 60 * 24)
    elif cmd in ("dot_prod", "dot_prod_cpu"):
        device = "cpu" if cmd == "dot_prod_cpu" else "host"
        got = _json(_bench("dot_prod", xsi, "--seed", "5", "--device",
                           device))
        want = tools.dot_prod(xsi, seed=5, device="host")
        assert got["variants"] == want["variants"]
        assert abs(got["checksum"] - want["checksum"]) <= \
            1e-6 * abs(want["checksum"])
        assert ("device_blocks" in got) == (device == "cpu")
        assert "dots" not in got
    elif cmd == "af_stats":
        got = _json(_bench(cmd, xsi, "--annotate", out))
        assert got["stats"] == [list(s) for s in
                                jax_tools.af_stats(xsi)["stats"]]
        assert _json(_bench(cmd, xsi, "--summary")).keys() == \
            {"records", "seconds"}
    elif cmd == "lockstep":
        assert _json(_bench(cmd, vcf, xsi))["identical"]
        bad = str(td / "bad.vcf")
        with open(vcf) as f, open(bad, "w") as g:
            g.write(f.read().replace("0|1", "1|0", 1))
        proc = _bench(cmd, bad, xsi)
        assert proc.returncode == 1 and "MISMATCH" in proc.stderr
    elif cmd == "unphase":
        assert _json(_bench(cmd, vcf, out, "--random", "--seed", "3")) == \
            {"records": 60}
        want = str(td / "unphase_jax.bcf")
        jax_mutate.unphase_random(vcf, want, seed=3)
        assert _read(out) == _read(want)
    elif cmd == "sprinkle-missing":
        assert _json(_bench(cmd, vcf, out, "--rate", "0.1",
                            "--seed", "4")) == {"records": 60}
        want = str(td / "sprinkle_jax.bcf")
        jax_mutate.sprinkle_missing(vcf, want, rate=0.1, seed=4)
        assert _read(out) == _read(want)
    elif cmd == "phase-switch-errors":
        got = _json(_bench(cmd, vcf, vcf))
        assert got["total"] == 0 and "per_sample" not in got
    elif cmd == "phase":
        got = _json(_bench(cmd, vcf, out))
        want = str(td / "phase_jax.bcf")
        assert got == jax_phasing.phase_file(vcf, want)
        assert _read(out) == _read(want)
        assert _json(_bench(cmd, vcf, out, "--windows"))["windows"] == 1
    elif cmd == "stats":
        assert _json(_bench(cmd, xsi)) == json.loads(
            json.dumps(jax_block_stats(xsi)))
    elif cmd == "e2e":
        got = _json(_bench(cmd, "--records", "200", "--samples", "16",
                           "--device", "numpy"))
        assert got["records"] == 200 and got["device"] == "numpy"
    elif cmd == "hrc":
        got = _json(_bench(cmd, "--records", "200", "--samples", "16",
                           "--block-length", "64", "--device", "cpu"))
        assert got["identical"] and got["n_blocks"] == 4
    elif cmd == "warmup":
        got = _json(_bench(cmd, "--samples", "16", "--block-length", "32",
                           "--fracs", "1.0,0.5", "--device", "cpu"))
        assert [s["n_wah"] for s in got["shapes"]] == [32, 16]


@pytest.mark.parametrize("cmd", ["dot_prod", "e2e", "hrc", "warmup"])
def test_bench_main_on_cuda_without_a_card(panel, cmd):
    """--device cuda (the default of dot_prod, e2e, hrc and warmup)
    without a card is a one-line error, never a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, xsi = panel
    args = {"dot_prod": [xsi],
            "e2e": ["--records", "10", "--samples", "4"],
            "hrc": ["--records", "10", "--samples", "4"],
            "warmup": ["--samples", "4"]}[cmd]
    proc = _bench(cmd, *args)
    assert proc.returncode == 1
    assert proc.stdout == ""
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and "no CUDA device" in lines[0], proc.stderr
