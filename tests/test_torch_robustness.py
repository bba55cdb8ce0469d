"""Corrupt input through the port: counterparts of tests/test_robustness.py
and tests/test_cli_errors.py through the port's Accessor, Decompressor and
CLI, on --device cpu (the torch block decode, its kernels' plain versions)
and --device numpy (the host codec, the native accessor), and the crafted
containers of xsqueezeit_tpu_torch/bench/corrupt.py: a stored index past
its line's width (a sparse carrier, a missing or EOV track entry, a
haploid sparse line's sample), WAH streams cut short or with a counter
past its line, and byte flips.

The contract: a corrupt container raises or mis-decodes, never crashes;
the CLI exits 1 with one `xsqueezeit: error:` line and no traceback.  An
index past its line raises on every device with the native accessor's
words ("sparse index out of range") before any tensor is built from it:
on a CUDA tensor it would be a device-side assert.  The JAX package drops
such an index on its device route and raises IndexError on its NumPy
route; test_reference_faults_the_port_does_not_repeat holds both."""
import os
import shutil
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from xsqueezeit_tpu.cli import main as jax_cli
from xsqueezeit_tpu_torch.accessor import Accessor
from xsqueezeit_tpu_torch.bench import corrupt
from xsqueezeit_tpu_torch.bench.synth import synth_bcf
from xsqueezeit_tpu_torch.cli import main as cli
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.codec.compressor import (
    CompressorOptions,
    compress_file,
)
from xsqueezeit_tpu_torch.codec.decompressor import (
    Decompressor,
    DecompressorOptions,
)
from xsqueezeit_tpu_torch.format.constants import GTDict
from xsqueezeit_tpu_torch.format.container import XsiReader
from xsqueezeit_tpu_torch.format.dictionary import (
    dictionary_n_bytes,
    write_dictionary,
)
from xsqueezeit_tpu_torch.format.header import XsiHeader
from xsqueezeit_tpu_torch.io.unified import GtInput
from tests import fixtures

DEVICES = ("cpu", "numpy")
#: the crafted stored-index cases: name -> (container, stream, haploid
#: line or not (None: either), the native accessor's words)
PAST_WIDTH = {
    "sparse": ("diploid", "sparse", None, "sparse index out of range"),
    "missing": ("tracks", "missing", None, "missing index out of range"),
    "eov": ("tracks", "eov", None, "EOV index out of range"),
    "haploid": ("mixed", "sparse", True, "sparse index out of range"),
}


@pytest.fixture(autouse=True)
def _no_debug(monkeypatch):
    monkeypatch.delenv("XSI_DEBUG", raising=False)


def _one_line_error(capsys) -> str:
    err = capsys.readouterr().err
    lines = [l for l in err.splitlines() if l.strip()]
    assert "Traceback" not in err
    assert len(lines) == 1 and lines[0].startswith("xsqueezeit: error:"), err
    return lines[0]


def _extract(path, out, device, *extra) -> int:
    return cli(["-x", "-f", path, "-o", out, "--device", device, *extra])


@pytest.fixture(scope="module")
def xsi(tmp_path_factory):
    d = tmp_path_factory.mktemp("robust")
    vcf = fixtures.random_vcf(str(d / "in.vcf"), n_samples=13, n_records=50,
                              seed=13)
    path = str(d / "f.xsi")
    compress_file(vcf, path, CompressorOptions(block_length=16,
                                               device="numpy"))
    return path


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    """Well-formed containers of 256 samples (H = 512), blocks of 32
    records, each holding one kind of stream the cases corrupt:
    "diploid" (uniformly diploid, --maf 0.4: most lines sparse),
    "tracks" (40 haploid males on diploid records: EOV; 1 % missing) and
    "mixed" (every third record haploid, --maf 0.4)."""
    d = tmp_path_factory.mktemp("crafted")
    synth_bcf(str(d / "diploid.bcf"), 96, 256, seed=3)
    corrupt.write_vcf(str(d / "tracks.vcf"), 256, 96, seed=4, males=40,
                      missing_frac=0.01)
    corrupt.write_vcf(str(d / "mixed.vcf"), 256, 96, seed=5, males=40,
                      haploid_every=3, missing_frac=0.01)
    out = {}
    for name, src, maf in (("diploid", "diploid.bcf", "0.4"),
                           ("tracks", "tracks.vcf", "0.01"),
                           ("mixed", "mixed.vcf", "0.4")):
        out[name] = str(d / f"{name}.xsi")
        assert cli(["-c", "-f", str(d / src), "-o", out[name], "--maf", maf,
                    "--variant-block-length", "32", "--device",
                    "numpy"]) == 0
    return out


# ------------------------------------------- counterparts: test_robustness
@pytest.mark.parametrize("device", DEVICES)
def test_bad_magic_rejected(xsi, tmp_path, device):
    data = bytearray(open(xsi, "rb").read())
    data[4] ^= 0xFF  # first magic
    with pytest.raises(Exception, match="[Mm]agic|endian"):
        XsiHeader.unpack(bytes(data[:256]))
    bad = corrupt.copy_container(xsi, str(tmp_path / "bad.xsi"), bytes(data))
    with pytest.raises(ValueError, match="[Mm]agic|endian"):
        Decompressor(bad, DecompressorOptions(device=device))


@pytest.mark.parametrize("device", DEVICES)
def test_bad_version_rejected(xsi, tmp_path, device):
    data = bytearray(open(xsi, "rb").read())
    assert XsiHeader.unpack(bytes(data[:256])).version == 5
    data[8] = 99  # version byte
    bad = corrupt.copy_container(xsi, str(tmp_path / "v99.xsi"), bytes(data))
    with pytest.raises(Exception, match="[Vv]ersion"):
        Accessor(bad)
    with pytest.raises(ValueError, match="[Vv]ersion"):
        Decompressor(bad, DecompressorOptions(device=device))


@pytest.mark.parametrize("device", DEVICES)
def test_truncated_file_clean_error(xsi, tmp_path, capsys, device):
    data = open(xsi, "rb").read()
    for cut in (100, 300, len(data) // 2):
        t = corrupt.copy_container(xsi, str(tmp_path / f"trunc{cut}.xsi"),
                                   data[:cut])
        if cut < 256:
            with pytest.raises(ValueError, match="truncated"):
                Accessor(t)
        assert _extract(t, str(tmp_path / "out.vcf"), device) == 1
        _one_line_error(capsys)


@pytest.mark.parametrize("device", DEVICES)
def test_fuzzed_block_bytes_no_crash(xsi, tmp_path, device):
    """Flipping bytes inside block payloads must raise one of the errors
    the CLI reports in one line, or mis-decode; never anything else."""
    rng = np.random.default_rng(0)
    for trial in range(12):
        f = corrupt.flip_bytes(xsi, str(tmp_path / "fuzz.xsi"), rng, 1)
        try:
            Decompressor(f, DecompressorOptions(output_type="v",
                                                device=device)) \
                .decompress(str(tmp_path / "fuzz.vcf"))
        except (ValueError, OSError, EOFError, struct.error):
            pass  # clean failure is acceptable


@pytest.mark.parametrize("device", DEVICES)
def test_missing_variant_file(xsi, tmp_path, device):
    lone = tmp_path / "lone.xsi"
    shutil.copyfile(xsi, lone)
    with pytest.raises(OSError):
        Decompressor(str(lone), DecompressorOptions(device=device)) \
            .decompress(str(tmp_path / "out.vcf"))


def test_bitmap_utils(tmp_path):
    from xsqueezeit_tpu_torch.utils import bitmap
    vcf = fixtures.random_vcf(str(tmp_path / "b.vcf"), n_samples=9,
                              n_records=40, seed=14)
    plain = bitmap.gt_bitmap(vcf)
    assert plain.shape == (40, 18)
    srt = bitmap.pbwt_sorted_bitmap(vcf, reset_every=16)
    assert srt.shape == plain.shape
    assert (srt.sum(axis=1) == plain.sum(axis=1)).all()
    img = tmp_path / "x.pbm"
    bitmap.save_pbm(str(img), srt)
    assert open(img, "rb").read(20).startswith(b"P4\n18 40\n")


@pytest.mark.parametrize("device", DEVICES)
def test_v4_container_read(tmp_path, xsi, device):
    """Version-4 containers (u32 index entries) decode as the version-5
    one does, on each device."""
    data = bytearray(open(xsi, "rb").read())
    hdr = XsiHeader.unpack(bytes(data[:256]))
    assert not hdr.zstd
    nb = hdr.number_of_ssas
    idx64 = np.frombuffer(bytes(
        data[hdr.indices_offset:hdr.indices_offset + nb * 8]), np.uint64)
    out = (bytearray(data[:hdr.indices_offset])
           + idx64.astype(np.uint32).tobytes()
           + bytes(data[hdr.samples_offset:]))
    struct.pack_into("<I", out, 8, 4)                       # version = 4
    struct.pack_into("<Q", out, 80, hdr.samples_offset - nb * 4)
    v4 = corrupt.copy_container(xsi, str(tmp_path / "v4.xsi"), bytes(out))
    rows = []
    for src, name in ((v4, "v4.vcf"), (xsi, "v5.vcf")):
        assert _extract(src, str(tmp_path / name), device, "-O", "v") == 0
        rows.append([l for l in open(tmp_path / name)
                     if not l.startswith("#")])
    assert rows[0] == rows[1] and len(rows[0]) == 50


@pytest.mark.parametrize("device", DEVICES)
def test_ws_mixed_block_read_tolerance(device):
    """WS_MIXED (=3) blocks read with WS_WAH semantics on each device
    (the torch block decode on the CPU, the host GtBlockDecoder); an
    unknown strategy is refused by both."""
    from tests.gt_synth import make_record
    from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
    from xsqueezeit_tpu_torch.codec.gt_block_decoder import GtBlockDecoder
    from xsqueezeit_tpu_torch.format.constants import (
        GTDict,
        WeirdnessStrategy,
    )

    rng = np.random.default_rng(21)
    records = [make_record(rng, 40, p_alt=0.3, p_missing=0.05, p_eov=0.02)
               for _ in range(12)]
    enc = GtBlockEncoder(40, block_bcf_lines=100, mac_threshold=2,
                         default_phasing=1, aet_dtype=np.uint16,
                         weirdness_strategy=WeirdnessStrategy.WS_WAH)
    for gt, na in records:
        enc.encode_record(gt, na)
    payload = bytearray(enc.serialize())
    pair = struct.pack("<II", GTDict.KEY_WEIRDNESS_STRATEGY,
                       WeirdnessStrategy.WS_WAH)
    at = payload.find(pair)
    assert 0 <= at < 8 + 16 * 64, "strategy pair must sit in the dictionary"
    payload[at:at + 8] = struct.pack("<II", GTDict.KEY_WEIRDNESS_STRATEGY, 3)
    nas = [na for _, na in records]

    def decode(p):
        if device == "cpu":
            return decoder_torch.decode_block_records(
                bytes(p), 40, 80, np.uint16, nas, device="cpu")
        dec = GtBlockDecoder(bytes(p), 40, 80, aet_dtype=np.uint16)
        return [dec.fill_genotype_array_advance(na) for na in nas]

    for got, (gt, _) in zip(decode(payload), records):
        np.testing.assert_array_equal(got, gt)
    payload[at:at + 8] = struct.pack("<II", GTDict.KEY_WEIRDNESS_STRATEGY, 7)
    with pytest.raises(ValueError, match="weirdness strategy"):
        decode(payload)


@pytest.mark.parametrize("device", DEVICES)
def test_ws_mixed_container(tmp_path, device):
    """A container whose block says WS_MIXED extracts the input's
    genotypes on each device (numpy: the native accessor)."""
    from xsqueezeit_tpu_torch.format.constants import (
        GTDict,
        WeirdnessStrategy,
    )

    vcf = fixtures.ALL_MICRO["micro_missing"](str(tmp_path / "m.vcf"))
    xsi = str(tmp_path / "m.xsi")
    assert cli(["-c", "-f", vcf, "-o", xsi, "--wah-encode-missing",
                "--device", "numpy"]) == 0
    data = bytearray(open(xsi, "rb").read())
    pair = struct.pack("<II", GTDict.KEY_WEIRDNESS_STRATEGY,
                       WeirdnessStrategy.WS_WAH)
    hits = [i for i in range(len(data) - 7) if data[i:i + 8] == pair]
    assert len(hits) == 1, "ambiguous patch site"
    data[hits[0]:hits[0] + 8] = struct.pack(
        "<II", GTDict.KEY_WEIRDNESS_STRATEGY, 3)
    with open(xsi, "wb") as f:
        f.write(bytes(data))
    out = str(tmp_path / "out.vcf")
    assert _extract(xsi, out, device, "-O", "v") == 0
    assert [r.gt.tolist() for r in GtInput(out)] == \
        [r.gt.tolist() for r in GtInput(vcf)]


def test_bitmap_variants(tmp_path):
    from xsqueezeit_tpu_torch.ops import pbwt_np
    from xsqueezeit_tpu_torch.utils import bitmap

    vcf = fixtures.random_vcf(str(tmp_path / "bm.vcf"), n_samples=25,
                              n_records=120, seed=77)
    plain = np.stack(list(bitmap._common_rows(vcf)))
    L, H = plain.shape
    assert L > 20
    srt = bitmap.final_sorted_bitmap(vcf)
    np.testing.assert_array_equal(srt.sum(axis=1), plain.sum(axis=1))
    last = srt[-1]
    k = int(last.sum())
    assert not last[:H - k].any() and last[H - k:].all()
    blk_p = bitmap.block_sorted_bitmap(vcf, block_size=16, pbwt=True)
    a = np.arange(H)
    ev_rows = []
    for bits in plain:
        ev_rows.append(bits[a])
        a = pbwt_np.stable_partition(a, bits[a])
    for start in range(0, L, 16):
        np.testing.assert_array_equal(blk_p[start], ev_rows[start])
    tree = bitmap.tree_sorted_bitmap(vcf)
    np.testing.assert_array_equal(tree.sum(axis=1), plain.sum(axis=1))
    np.testing.assert_array_equal(tree[0], plain[0])
    color = bitmap.pbwt_color_bitmap(vcf)
    np.testing.assert_array_equal(color[0], np.arange(H))
    for row in color[1:4]:
        np.testing.assert_array_equal(np.sort(row), np.arange(H))


def test_native_scan_records_corrupt_var_file(tmp_path):
    """The port's native accessor walks the variant file: a record frame
    word pointing past its end is a clean OSError."""
    import gzip

    from xsqueezeit_tpu_torch.interop.native import NativeAccessor
    from xsqueezeit_tpu_torch.io import bgzf

    vcf = fixtures.micro_basic(str(tmp_path / "m.vcf"))
    xsi = str(tmp_path / "m.xsi")
    assert cli(["-c", "-f", vcf, "-o", xsi, "--device", "numpy"]) == 0
    var = xsi + "_var.bcf"
    raw = gzip.decompress(open(var, "rb").read())
    blob = bytearray(raw)
    frame = 9 + int.from_bytes(raw[5:9], "little")
    blob[frame:frame + 4] = (0x7FFFFFF0).to_bytes(4, "little")
    w = bgzf.BgzfWriter(var)
    w.write(bytes(blob))
    w.close()
    acc = NativeAccessor(xsi)
    try:
        with pytest.raises(OSError):
            acc.scan_records()
    finally:
        acc.close()


# ------------------------------------------- counterparts: test_cli_errors
@pytest.mark.parametrize("device", DEVICES)
def test_missing_input_file(tmp_path, capsys, device):
    assert _extract(str(tmp_path / "nope.xsi"), str(tmp_path / "o.bcf"),
                    device) != 0
    _one_line_error(capsys)


@pytest.mark.parametrize("device", DEVICES)
def test_missing_compress_input(tmp_path, capsys, device):
    assert cli(["-c", "-f", str(tmp_path / "nope.vcf"), "-o",
                str(tmp_path / "o.xsi"), "--device", device]) != 0
    _one_line_error(capsys)


@pytest.mark.parametrize("device", DEVICES)
def test_corrupt_xsi(tmp_path, capsys, device):
    bad = tmp_path / "bad.xsi"
    bad.write_bytes(b"\x00" * 300)
    assert _extract(str(bad), str(tmp_path / "o.bcf"), device) != 0
    _one_line_error(capsys)


@pytest.fixture
def micro_xsi(tmp_path):
    vcf = fixtures.micro_basic(str(tmp_path / "m.vcf"))
    xsi = str(tmp_path / "m.xsi")
    assert cli(["-c", "-f", vcf, "-o", xsi, "--device", "numpy"]) == 0
    return xsi


@pytest.mark.parametrize("device", DEVICES)
def test_truncated_xsi(micro_xsi, tmp_path, capsys, device):
    data = open(micro_xsi, "rb").read()
    with open(micro_xsi, "wb") as f:
        f.write(data[:180])
    assert _extract(micro_xsi, str(tmp_path / "o.bcf"), device) != 0
    _one_line_error(capsys)


@pytest.mark.parametrize("device", DEVICES)
def test_unknown_sample(micro_xsi, tmp_path, capsys, device):
    assert _extract(micro_xsi, str(tmp_path / "o.bcf"), device,
                    "-s", "NOSUCH") != 0
    assert "NOSUCH" in _one_line_error(capsys)


@pytest.mark.parametrize("device", DEVICES)
def test_bad_region_string(micro_xsi, tmp_path, capsys, device):
    assert _extract(micro_xsi, str(tmp_path / "o.bcf"), device,
                    "-r", "20:abc-:") != 0
    _one_line_error(capsys)


@pytest.mark.parametrize("device", DEVICES)
def test_empty_ox_selection(micro_xsi, tmp_path, capsys, device):
    """-O x with a region matching nothing: one line, nonzero exit, no
    output file."""
    assert _extract(micro_xsi, str(tmp_path / "sub.xsi"), device,
                    "-O", "x", "-r", "20:1-2") != 0
    _one_line_error(capsys)
    assert not os.path.exists(tmp_path / "sub.xsi")


@pytest.mark.parametrize("device", DEVICES)
def test_zero_block_length(tmp_path, capsys, device):
    vcf = fixtures.micro_basic(str(tmp_path / "m.vcf"))
    assert cli(["-c", "-f", vcf, "-o", str(tmp_path / "m.xsi"),
                "--variant-block-length", "0", "--device", device]) != 0
    assert "variant-block-length" in _one_line_error(capsys)


def test_zero_block_length_library():
    with pytest.raises(ValueError):
        CompressorOptions(block_length=0)


@pytest.mark.parametrize("device", DEVICES)
def test_xsi_debug_reraises(tmp_path, monkeypatch, device):
    monkeypatch.setenv("XSI_DEBUG", "1")
    with pytest.raises(Exception):
        _extract(str(tmp_path / "nope.xsi"), str(tmp_path / "o.bcf"),
                 device)


# ---------------------------------------------- indices past their width
@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", sorted(PAST_WIDTH))
def test_index_past_width_is_one_clean_error(crafted, tmp_path, capsys,
                                             case, device):
    """A stored index at its line's width + 3 (515 for H = 512; the
    haploid case a sample index past n_samples): -x exits 1 with the
    native accessor's words on both devices, no traceback."""
    name, stream, haploid, words = PAST_WIDTH[case]
    bad = corrupt.index_past_width(crafted[name], str(tmp_path / "b.xsi"),
                                   stream, haploid=haploid)
    assert _extract(bad, str(tmp_path / "o.vcf"), device, "-O", "v") == 1
    assert _one_line_error(capsys) == f"xsqueezeit: error: {words}"


@pytest.mark.parametrize("case", sorted(PAST_WIDTH))
def test_index_past_width_on_the_device_routes(crafted, tmp_path, case):
    """The torch block decode refuses the same blocks before a tensor is
    built (CPU tensors here; on a CUDA tensor the index would assert):
    decode_block_records of the whole block (the mixed block on the
    mixed device route), decode_bits, and the fused track decode's
    carrier pairs."""
    name, stream, haploid, words = PAST_WIDTH[case]
    bad = corrupt.index_past_width(crafted[name], str(tmp_path / "b.xsi"),
                                   stream, haploid=haploid)
    rd = XsiReader(bad)
    payload = rd.gt_block_payload(0)
    nas = [2] * 32
    dec = decoder_torch.TorchBlockDecoder(payload, rd.n_samples, rd.n_haps,
                                          rd.aet_dtype, device="cpu")
    assert dec.eligible or dec.mixed_device_ok
    with pytest.raises(ValueError, match=words):
        decoder_torch.decode_block_records(payload, rd.n_samples, rd.n_haps,
                                           rd.aet_dtype, nas, device="cpu")
    if stream == "sparse":
        with pytest.raises(ValueError, match=words):
            dec.decode_bits()
    else:
        m = dec.meta
        flags, track = ((m.line_has_missing, m.missing_sparse)
                        if stream == "missing"
                        else (m.line_has_eov, m.eov_sparse))
        with pytest.raises(ValueError, match=words):
            decoder_torch.track_carriers(track, np.flatnonzero(flags),
                                         rd.aet_dtype, dec.line_width,
                                         words.split()[0])


def test_reference_faults_the_port_does_not_repeat(crafted, tmp_path,
                                                   monkeypatch):
    """The JAX package on the crafted sparse container: its NumPy route
    raises IndexError through its CLI (a traceback), and its device route
    drops the carrier (mode="drop") and decodes the block without an
    error.  The port raises ValueError on both of its routes."""
    from xsqueezeit_tpu.codec import decoder_jax

    bad = corrupt.index_past_width(crafted["diploid"],
                                   str(tmp_path / "b.xsi"), "sparse")
    monkeypatch.setenv("XSI_DEVICE", "numpy")
    with pytest.raises(IndexError):
        jax_cli(["-x", "-f", bad, "-o", str(tmp_path / "j.vcf"), "-O", "v"])
    rd = XsiReader(bad)
    got = decoder_jax.decode_block_records(
        rd.gt_block_payload(0), rd.n_samples, rd.n_haps, rd.aet_dtype,
        [2] * 32)
    assert len(got) == 32 and got[0].shape == (rd.n_haps,)


#: host-copy failures on a corrupt block -> (payload or sparse stream,
#: the ValueError's words); dictionary offsets point past the dictionary
_LINE_SELECT_AT_END = dictionary_n_bytes(3)
HOST_COPY_CASES = {
    "dictionary without line counts": (
        write_dictionary({GTDict.KEY_WEIRDNESS_STRATEGY: 0}),
        "block dictionary missing line counts"),
    "line track past its stream": (
        write_dictionary({GTDict.KEY_BCF_LINES: 5,
                          GTDict.KEY_BINARY_LINES: 5,
                          GTDict.KEY_LINE_SELECT: _LINE_SELECT_AT_END}),
        "corrupt line track"),
    "head count past the stream": (np.array([5, 1, 2], np.uint16),
                                   "sparse count exceeds stream"),
    "more lines than heads": (np.array([1, 7, 0], np.uint16),
                              "sparse count exceeds stream"),
}


@pytest.mark.parametrize("case", sorted(HOST_COPY_CASES))
def test_host_copy_errors_are_value_errors(case):
    """Where the JAX package's host decoder and sparse walk (copied
    unchanged) raise KeyError or IndexError on a corrupt block, the
    decoder raises ValueError, which the CLI reports in one line."""
    data, words = HOST_COPY_CASES[case]
    with pytest.raises(ValueError, match=words):
        if isinstance(data, bytes):
            decoder_torch.TorchBlockDecoder(data, 2, 4, np.uint16,
                                            device="cpu")
        else:
            decoder_torch.line_offsets(data, 1 if data[0] == 5 else 4,
                                       "sparse")


def test_block_without_gt_entry_is_one_clean_error(xsi, tmp_path, capsys,
                                                   monkeypatch):
    """A block dictionary without its GT entry: -x --device cpu exits 1
    with the native accessor's words (XsiReader raises KeyError)."""
    monkeypatch.setattr(XsiReader, "block_bytes",
                        lambda self, block_id: write_dictionary({0: 16}))
    assert _extract(xsi, str(tmp_path / "o.vcf"), "cpu", "-O", "v") == 1
    assert _one_line_error(capsys) == \
        "xsqueezeit: error: block has no GT entry"


# ------------------------------------------------- WAH streams, byte flips
@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("edit", ["dropped_words", "long_counter"])
def test_corrupt_wah_stream_is_clean(crafted, tmp_path, capsys, edit,
                                     device):
    """A WAH stream that starts 1 / 5 / 37 words late (short of its lines'
    groups), or with a counter of 16,383 groups at word 0 / 3 / 40 (past
    its line): exit 0 (a mis-decode) or 1 with one error line."""
    src = crafted["tracks"]
    for k in (1, 5, 37) if edit == "dropped_words" else (0, 3, 40):
        p = str(tmp_path / f"{edit}{k}.xsi")
        if edit == "dropped_words":
            corrupt.wah_dropped_words(src, p, k)
        else:
            corrupt.wah_long_counter(src, p, k)
        rc = _extract(p, str(tmp_path / "o.vcf"), device, "-O", "v")
        assert rc in (0, 1)
        if rc:
            _one_line_error(capsys)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", ["diploid", "tracks", "mixed"])
def test_byte_flips_are_clean(crafted, tmp_path, capsys, name, device):
    """20 containers with one to three random bytes of their blocks
    flipped: each -x exits 0 or 1 with one error line, no traceback (the
    CPU counterpart of chip_smoke.py's corrupt phase on the card)."""
    rng = np.random.default_rng(sorted(crafted).index(name))
    for trial in range(20):
        p = corrupt.flip_bytes(crafted[name], str(tmp_path / "f.xsi"), rng,
                               int(rng.integers(1, 4)))
        rc = _extract(p, str(tmp_path / "o.vcf"), device, "-O", "v")
        assert rc in (0, 1), trial
        if rc:
            _one_line_error(capsys)


# ---------------------------------------------- the WAH expand, corrupt
def _naive_groups(stream, lo, hi):
    """One line's 15-bit groups by the rule of csrc/wah.cu, word by word:
    a group takes the word covering it if that word ends by the line's
    end `hi`, else 0."""
    out = np.zeros(hi - lo, np.int64)
    start = 0
    for word in stream.astype(np.int64):
        span = word & 0x3FFF if word & 0x8000 else 1
        end = start + span
        if lo < end <= hi:
            value = (0x7FFF if word & 0x4000 else 0) if word & 0x8000 \
                else word
            out[max(start, lo) - lo:end - lo] = value
        start = end
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wah_expand_plain_on_corrupt_streams(seed):
    """The plain expands (what --device cpu decodes with) read a corrupt
    stream as the CUDA kernel does, held against a word-by-word reading
    of the rule: uniform lines, and lines of two widths (varw)."""
    import torch

    from xsqueezeit_tpu_torch.ops import wah_torch

    rng = np.random.default_rng(seed)
    n_lines, w = 9, 7
    for s in corrupt.wah_streams(rng, n_lines, w).values():
        st = torch.from_numpy(s.astype(np.int32))
        got = wah_torch.wah_expand_stream(st, n_lines, w).numpy()
        for l in range(n_lines):
            np.testing.assert_array_equal(
                got[l], _naive_groups(s, l * w, (l + 1) * w))
        widths = np.where(np.arange(n_lines) % 3 == 2, 4, w)
        goff = np.concatenate([[0], np.cumsum(widths)])
        got = wah_torch.wah_expand_stream_varw(
            st, torch.from_numpy(goff), w).numpy()
        for l in range(n_lines):
            want = np.zeros(w, np.int64)
            want[:widths[l]] = _naive_groups(s, goff[l], goff[l + 1])
            np.testing.assert_array_equal(got[l], want)
