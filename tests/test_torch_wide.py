"""The torch port above the 16-bit slot field: H > 65,535 haplotypes.

The chunked encode and decode (pbwt_torch.pbwt_encode_chunked,
pbwt_decode_chunked) against the JAX package's forms at any width
(pbwt_jax.pbwt_encode_scan, pbwt_jax.pbwt_decode_blocked), from a few
haplotypes to 65,600; the decode's wide state and the route arithmetic
by width are held in tests/test_torch_wide_chains.py.  Wide blocks'
sparse and track streams are 32-bit.  The same
seeded numpy inputs go through the port (CPU tensors, the kernels' plain
versions) and the JAX package (XLA forms, the host codec, its CLI with
the NumPy codec).  The wide blocks are 32,800 samples (H = 65,600) and a
few dozen lines.  Tolerance: exact equality (bits, permutations, bytes).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.cli import main as jax_cli
from xsqueezeit_tpu.codec.encoder_jax import sparse_idx_by_search
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu.ops import pbwt_jax, wah_jax
from xsqueezeit_tpu_torch.accessor import Accessor
from xsqueezeit_tpu_torch.cli import main as torch_cli
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.codec.encoder_torch import (
    TorchBlockEncoder,
    carrier_indices,
)
from xsqueezeit_tpu_torch.interop import native
from xsqueezeit_tpu_torch.io.bcf import BcfReader
from xsqueezeit_tpu_torch.io.unified import GtInput
from xsqueezeit_tpu_torch.ops import pbwt_torch, wah_kernels, wah_torch
from tests import fixtures
from tests.gt_synth import make_record
from tests.test_e2e import read_all
from tests.jax_build import jax_native_built  # noqa: F401 (autouse)

N_SAMPLES = 32800
H = 2 * N_SAMPLES                  # 65,600: above the 16-bit slot field
MAC = int(H * 0.001)               # 65, the default MAF's threshold


def _lines(rng, L, width, ps=(0.0005, 0.02, 0.3, 0.7, 0.9995)):
    p = rng.choice(ps, size=L)
    return (rng.random((L, width)) < p[:, None]).astype(np.int8)


def _sorts(rng, L, kind):
    if kind == "all":
        return np.ones(L, bool)
    if kind == "none":
        return np.zeros(L, bool)
    return rng.random(L) < 0.8


# (L, width, sort flags): L a multiple of the chunk lines or not (the
# encode takes 16 lines a chunk at every width, the decode 16 up to 65,536
# haplotypes and 15 at 65,600), every line sorting, some, or none
SHAPES = [(42, 300, "all"), (37, 300, "some"), (5, 7, "some"),
          (64, 1001, "all"), (33, 1001, "none"), (1, 65600, "all"),
          (29, 65600, "some"), (48, 65600, "all")]


@pytest.mark.parametrize("L,width,kind", SHAPES)
def test_encode_scan_matches_jax(L, width, kind):
    """The chunked encode against the JAX package's packed-key scan."""
    rng = np.random.default_rng(L * 7 + width)
    x = _lines(rng, L, width)
    alts = np.ones(L, np.int32)
    sorts = _sorts(rng, L, kind)
    ys, a_fin = pbwt_torch.pbwt_encode_chunked(
        torch.from_numpy(x), torch.from_numpy(alts), torch.from_numpy(sorts))
    want_y, want_a = pbwt_jax.pbwt_encode_scan(
        jnp.asarray(x), jnp.asarray(alts), jnp.asarray(sorts),
        jnp.arange(width, dtype=jnp.int32))
    assert ys.dtype == torch.uint8 and ys.shape == (L, width)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(a_fin.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("L,width,kind", SHAPES)
def test_decode_blocked_matches_jax(L, width, kind):
    """The chunked decode against the JAX package's blocked decode."""
    rng = np.random.default_rng(L * 11 + width)
    ys = _lines(rng, L, width).astype(np.uint8)     # any bits decode
    sorts = _sorts(rng, L, kind)
    vals, a_fin = pbwt_torch.pbwt_decode_chunked(torch.from_numpy(ys),
                                                 torch.from_numpy(sorts))
    want_v, want_a = pbwt_jax.pbwt_decode_blocked(jnp.asarray(ys),
                                                  jnp.asarray(sorts))
    assert vals.dtype == torch.uint8 and vals.shape == (L, width)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(a_fin.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("L,width", [(37, 300), (29, 65600)])
def test_scan_then_blocked_decode_round_trips(L, width):
    """The chunked encode, then the chunked decode: the lines and the
    final arrangement back."""
    rng = np.random.default_rng(L + width)
    x = _lines(rng, L, width)
    sorts = torch.from_numpy(rng.random(L) < 0.9)
    ys, a_enc = pbwt_torch.pbwt_encode_chunked(
        torch.from_numpy(x), torch.ones(L, dtype=torch.int32), sorts)
    vals, a_dec = pbwt_torch.pbwt_decode_chunked(ys, sorts)
    np.testing.assert_array_equal(vals.numpy(), x.astype(np.uint8))
    np.testing.assert_array_equal(a_dec.numpy(), a_enc.numpy())


def test_decode_blocked_of_no_lines():
    """The chunked decode of no lines: no rows, and the block-start
    identity as the final arrangement."""
    vals, a = pbwt_torch.pbwt_decode_chunked(
        torch.zeros((0, 9), dtype=torch.uint8), torch.zeros(0, dtype=bool))
    assert vals.shape == (0, 9)
    assert a.tolist() == list(range(9))


@pytest.mark.parametrize("cap", [3, 40, 65])
def test_carrier_indices_match_search(cap):
    rng = np.random.default_rng(cap)
    counts = rng.integers(0, cap + 1, 12)
    mask = np.zeros((12, H), bool)
    for r, n in enumerate(counts):
        mask[r, rng.choice(H, n, replace=False)] = True
    mask[0, [0, H - 1]] = True            # both ends of the row
    got = carrier_indices(torch.from_numpy(mask), cap)
    want = sparse_idx_by_search(jnp.asarray(mask), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_expand_shared_memory_takes_every_width():
    """A CTA per line holds the format's widest line (32,767 groups,
    491,505 haplotypes) with 16-bit starts; a warp per line, four lines to
    a CTA with int starts, up to 7263 groups (csrc/wah.cu
    expand_line_smem)."""
    assert wah_kernels.expand_smem_bytes(32767, 256) == 32767 * 6 + 4
    assert wah_kernels.expand_smem_bytes(32767, 256) <= wah_kernels.SMEM_LIMIT
    assert (wah_kernels.expand_smem_bytes(7263, 32) <= wah_kernels.SMEM_LIMIT
            < wah_kernels.expand_smem_bytes(7264, 32))


@pytest.mark.parametrize("h", [194512, 491505])
def test_wah_routes_at_the_widest_lines_match_jax(h):
    """TOPMed width (w = 12,968) and the widest line the format allows
    (w = 32,767): the bits routes (plain versions on the CPU) against
    wah_jax.wah_encode_lines and wah_decode_lines."""
    rng = np.random.default_rng(h)
    p = np.array([0.0, 0.0005, 0.3, 1.0])[:, None]
    bits = (rng.random((4, h)) < p).astype(np.uint8)
    words, n = wah_kernels.wah_compress_bits(torch.from_numpy(bits))
    jw, jn = wah_jax.wah_encode_lines(jnp.asarray(bits))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    W = wah_torch.n_words_for(h)
    keep = np.arange(W)[None, :] < n.numpy()[:, None]
    stream = np.concatenate([words.numpy()[keep], np.zeros(W + 3, np.uint16)])
    got = wah_kernels.wah_expand_bits(torch.from_numpy(stream), 5, W, h)
    offs = wah_jax.wah_line_offsets(jnp.asarray(stream), h, W, n_lines=5)
    want = wah_jax.wah_decode_lines(jnp.asarray(stream), offs, h, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:4], bits)


def _block(kind, seed, n=40):
    """A short wide block: "uniform" (rare, common and near-fixed
    biallelic records plus one multi-allelic), "missing" (1 % missing
    entries, a missing track on every record) or "mixed" (runs of haploid
    and diploid records)."""
    rng = np.random.default_rng(seed)
    ps = [0.0004, 0.3, 0.9996, 0.05, 0.6, 0.002]
    recs = []
    for i in range(n):
        kw = dict(p_alt=ps[i % len(ps)])
        if kind == "missing":
            kw["p_missing"] = 0.01
        if kind == "mixed":
            kw["haploid"] = (i // 5) % 2 == 1
        recs.append(make_record(rng, N_SAMPLES, **kw))
    if kind == "uniform":
        recs.insert(n // 2, make_record(rng, N_SAMPLES, n_alts=2, p_alt=0.4))
    return recs


@pytest.mark.parametrize("kind", ["uniform", "missing", "mixed"])
def test_block_codec_matches_host_codec(kind):
    recs = _block(kind, {"uniform": 1, "missing": 2, "mixed": 3}[kind])
    kw = dict(n_samples=N_SAMPLES, block_bcf_lines=10_000,
              mac_threshold=MAC, default_phasing=1, aet_dtype=np.uint32)
    ref = GtBlockEncoder(**kw)
    enc = TorchBlockEncoder(device="cpu", **kw)
    for gt, na in recs:
        ref.encode_record(gt, na)
        enc.encode_record(gt, na)
    payload = enc.serialize()
    assert payload == ref.serialize()

    nas = [na for _, na in recs]
    got = decoder_torch.decode_block_records(payload, N_SAMPLES, H,
                                             np.uint32, nas, device="cpu")
    host = GtBlockDecoder(payload, N_SAMPLES, H, np.uint32)
    for i, na in enumerate(nas):
        want = host.fill_genotype_array_advance(na)
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i], recs[i][0])


def _wide_vcf(path, n_records=12, seed=32800):
    """The fault's repro: a 32,800-sample VCF, a rare/common mix with one
    multi-allelic record and 1 % missing entries."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_records):
        n_alts = 2 if i == 5 else 1
        p = [0.0005, 0.2, 0.5, 0.03][i % 4]
        a = rng.choice(n_alts + 1, (N_SAMPLES, 2),
                       p=[1 - p] + [p / n_alts] * n_alts).astype(str)
        a[rng.random(a.shape) < 0.01] = "."
        cells = np.char.add(np.char.add(a[:, 0], "|"), a[:, 1])
        rows.append(("A,C" if n_alts == 2 else "A", cells.tolist()))
    return fixtures.write_vcf(path, rows, n_samples=N_SAMPLES)


@pytest.fixture(scope="module")
def wide_vcf(tmp_path_factory):
    return _wide_vcf(str(tmp_path_factory.mktemp("wide") / "in.vcf"))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_cli_compress_matches_jax_package(wide_vcf, tmp_path):
    assert os.environ.get("XSI_DEVICE") == "numpy"   # tests/conftest.py
    got, want = str(tmp_path / "torch.xsi"), str(tmp_path / "jax.xsi")
    assert torch_cli(["-c", "-f", wide_vcf, "-o", got,
                      "--device", "cpu"]) == 0
    assert jax_cli(["-c", "-f", wide_vcf, "-o", want]) == 0
    assert _read(got) == _read(want)


def test_cli_extract_of_jax_package_file(wide_vcf, tmp_path):
    xsi = str(tmp_path / "jax.xsi")
    assert jax_cli(["-c", "-f", wide_vcf, "-o", xsi]) == 0
    got, want = str(tmp_path / "torch.vcf"), str(tmp_path / "jax.vcf")
    assert torch_cli(["-x", "-f", xsi, "-o", got, "--device", "cpu"]) == 0
    assert jax_cli(["-x", "-f", xsi, "-o", want]) == 0
    g, samples = read_all(got)
    assert g == read_all(want)[0]
    assert g == read_all(wide_vcf)[0] and len(samples) == N_SAMPLES


def test_cli_recompress_matches_numpy_device(wide_vcf, tmp_path):
    """-x -O x of a wide file re-encodes on the port's device (32-bit
    tracks) to the bytes --device numpy writes, which are the source's."""
    xsi = str(tmp_path / "in.xsi")
    assert torch_cli(["-c", "-f", wide_vcf, "-o", xsi,
                      "--device", "numpy"]) == 0
    outs = []
    for device in ("cpu", "numpy"):
        out = str(tmp_path / device / "re.xsi")   # the name is in the header
        os.makedirs(os.path.dirname(out))
        assert torch_cli(["-x", "-f", xsi, "-o", out, "-O", "x",
                          "--device", device]) == 0
        outs.append((_read(out), _read(out + "_var.bcf")))
    assert outs[0] == outs[1]
    assert outs[0][0] == _read(xsi)


def test_native_routes_read_32_bit_streams(wide_vcf, tmp_path, monkeypatch):
    """The native accessor reads 32-bit sparse streams wherever they sit
    in the block (the format does not align them to 4 bytes): -x
    --device numpy through the native extract loop (BCF) and the native
    accessor (VCF), and the Accessor's genotypes and allele counts
    natively, equal to the Python decoder's (XSI_NATIVE=0) and the
    input's."""
    monkeypatch.setenv("XSI_EMIT_ZLIB", "1")    # the Python writer's bytes
    xsi = str(tmp_path / "o.xsi")
    assert torch_cli(["-c", "-f", wide_vcf, "-o", xsi,
                      "--device", "numpy"]) == 0
    extracts = []
    real = native.native_extract
    monkeypatch.setattr(native, "native_extract",
                        lambda *a, **kw: (extracts.append(a[1]),
                                          real(*a, **kw))[1])

    def extract(route):
        outs = []
        for fmt in ("v", "b"):
            out = str(tmp_path / f"{route}.{fmt}")
            assert torch_cli(["-x", "-f", xsi, "-o", out, "-O", fmt,
                              "--device", "numpy"]) == 0
            outs.append(_read(out))
        return outs

    native_outs = extract("native")
    assert extracts == [str(tmp_path / "native.b")]
    orig = [(r.gt, r.n_alleles) for r in GtInput(wide_vcf)]
    acc = Accessor(xsi)
    assert acc._native() is not None
    r = BcfReader(acc.variant_filename())
    recs = list(r)
    r.close()
    assert len(recs) == len(orig)
    counts = []
    for rec, (gt, na) in zip(recs, orig):
        np.testing.assert_array_equal(acc.get_genotypes(rec), gt)
        alleles = (gt >> 1) - 1
        c = acc.get_allele_counts(rec)
        np.testing.assert_array_equal(
            c, np.bincount(alleles[alleles >= 0], minlength=na))
        counts.append(c)
    acc.close()
    monkeypatch.setenv("XSI_NATIVE", "0")
    assert extract("python") == native_outs
    assert extracts == [str(tmp_path / "native.b")]
    py = Accessor(xsi)
    assert py._native() is None
    for rec, c in zip(recs, counts):
        np.testing.assert_array_equal(py.get_allele_counts(rec), c)
