"""The port's copies of the JAX package's host modules against the
originals, byte for byte, on every fixture: block payloads (the host
GtBlockEncoder, and TorchBlockEncoder without the JAX package's bucket
padding), per-record decode, the container and header, the variant BCF,
its CSI index, and the CLI's -c / -x files.  The JAX package is the
reference; its CLI runs on its host codec (the tests pin XSI_DEVICE=numpy,
tests/conftest.py).  Tolerance: exact equality."""
import difflib
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xsqueezeit_tpu import cli as jax_cli
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder as JaxEncoder
from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder as JaxDecoder
from xsqueezeit_tpu.format.container import XsiReader as JaxReader
from xsqueezeit_tpu.format.header import XsiHeader as JaxHeader
from xsqueezeit_tpu.io.unified import GtInput as JaxInput
from xsqueezeit_tpu_torch.cli import main as torch_cli
from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu_torch.format.container import XsiReader
from xsqueezeit_tpu_torch.format.header import XsiHeader
from xsqueezeit_tpu_torch.io.unified import GtInput
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _zero_alt(path):
    rows = [(".", ["0|0"] * 10), ("A", ["0|1"] + ["0|0"] * 9),
            (".", ["0|0"] * 10), ("A", ["1|1"] * 10),
            ("A,C", ["0|2", "1|0"] + ["0|0"] * 8)]
    return fixtures.write_vcf(path, rows)


#: name -> (writer(path), --variant-block-length)
FIXTURES = {
    "random": (lambda p: fixtures.random_vcf(p, n_samples=48, n_records=150,
                                             seed=3), 64),
    "missing": (fixtures.micro_missing, 2),
    "eov": (fixtures.micro_eov, 2),
    "mixed_ploidy": (fixtures.micro_mixed_ploidy, 2),
    "haploid": (fixtures.micro_haploid, 3),
    "missing_non_uniform_phasing_ploidy": (
        fixtures.micro_missing_non_uniform_phasing_ploidy, 2),
    "zero_alt": (_zero_alt, 2),
}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(params=sorted(FIXTURES))
def case(request, tmp_path):
    write, block = FIXTURES[request.param]
    return request.param, write(str(tmp_path / "in.vcf")), block


def _records(cls, vcf):
    inp = cls(vcf)
    out = [(r.gt, r.n_alleles) for r in inp]
    inp.close()
    return out


def test_reader_records_match(case):
    _, vcf, _ = case
    want = _records(JaxInput, vcf)
    got = _records(GtInput, vcf)
    assert len(got) == len(want) > 0
    for (g, ga), (w, wa) in zip(got, want):
        assert ga == wa and np.array_equal(g, w)


def test_block_payloads_and_decode_match(case, monkeypatch):
    """Per block: the port's GtBlockEncoder, and TorchBlockEncoder on the
    CPU with the device track route forced (no bucket padding of its
    lines or track capacity), write the JAX GtBlockEncoder's payload; the
    port's GtBlockDecoder gives the same records back."""
    monkeypatch.setenv("XSI_TRACKS_DEVICE_MIN", "1")
    name, vcf, block = case
    recs = _records(JaxInput, vcf)
    n_samples = len(JaxInput(vcf).samples)
    kw = dict(n_samples=n_samples, block_bcf_lines=block, mac_threshold=1,
              default_phasing=1, aet_dtype=np.uint16)
    for lo in range(0, len(recs), block):
        chunk = recs[lo:lo + block]
        encs = [JaxEncoder(**kw), GtBlockEncoder(**kw),
                TorchBlockEncoder(device="cpu", **kw)]
        payloads = []
        for enc in encs:
            for gt, na in chunk:
                enc.encode_record(gt, na)
            try:
                payloads.append(enc.serialize())
            except ValueError as exc:       # a flagged zero-ALT record
                payloads.append(str(exc))
        assert payloads[1] == payloads[0], f"{name} block {lo // block}"
        assert payloads[2] == payloads[0], f"{name} block {lo // block}"
        if isinstance(payloads[0], str):
            continue
        decs = [cls(payloads[0], n_samples, 2 * n_samples,
                    aet_dtype=np.uint16) for cls in (JaxDecoder,
                                                     GtBlockDecoder)]
        for _, na in chunk:
            a, b = (d.fill_genotype_array_advance(na) for d in decs)
            assert np.array_equal(a, b)


def _jax_compress(vcf, out, block, extra=()):
    assert jax_cli.main(["-c", "-f", vcf, "-o", out,
                         "--variant-block-length", str(block),
                         *extra]) == 0


@pytest.mark.parametrize("device", ["numpy", "cpu"])
def test_cli_compress_files_match(case, tmp_path, device):
    """.xsi, _var.bcf and its .csi equal the JAX package's (one file name
    in two directories: the name is in the variant file's header)."""
    _, vcf, block = case
    want, got = (str(tmp_path / d / "o.xsi") for d in ("jax", "port"))
    for d in (want, got):
        os.makedirs(os.path.dirname(d))
    _jax_compress(vcf, want, block)
    assert torch_cli(["-c", "-f", vcf, "-o", got, "--device", device,
                      "--variant-block-length", str(block)]) == 0
    for sfx in ("", "_var.bcf", "_var.bcf.csi"):
        assert _read(got + sfx) == _read(want + sfx), sfx


def test_cli_extract_matches(case, tmp_path):
    """-x of the port on its host codec and on the CPU tensors writes the
    JAX package's VCF, byte for byte."""
    _, vcf, block = case
    xsi = str(tmp_path / "o.xsi")
    _jax_compress(vcf, xsi, block)
    want = str(tmp_path / "jax.vcf")
    assert jax_cli.main(["-x", "-f", xsi, "-o", want]) == 0
    for device in ("numpy", "cpu"):
        got = str(tmp_path / f"{device}.vcf")
        assert torch_cli(["-x", "-f", xsi, "-o", got, "--device",
                          device]) == 0
        assert _read(got) == _read(want), device


@pytest.mark.parametrize("zstd", [False, True])
def test_container_and_header_match(tmp_path, zstd):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=20,
                              n_records=70, seed=5)
    extra = ["--zstd"] if zstd else []
    want, got = (str(tmp_path / d / "o.xsi") for d in ("jax", "port"))
    for d in (want, got):
        os.makedirs(os.path.dirname(d))
    _jax_compress(vcf, want, 16, extra)
    assert torch_cli(["-c", "-f", vcf, "-o", got, "--device", "numpy",
                      "--variant-block-length", "16", *extra]) == 0
    assert _read(got) == _read(want)
    raw = _read(got)[:256]
    h, jh = XsiHeader.unpack(raw), JaxHeader.unpack(raw)
    assert h.pack() == jh.pack() == raw
    assert h.info_string() == jh.info_string()
    r, jr = XsiReader(got), JaxReader(want)
    assert r.samples == jr.samples and r.n_blocks() == jr.n_blocks() > 1
    for b in range(r.n_blocks()):
        assert bytes(r.gt_block_payload(b)) == bytes(jr.gt_block_payload(b))


# ---------------------------------------------------------- the copies
#: The declared changes of the port's copies of native/: (removed, added)
#: text of each hunk.  xsi_accessor.cpp: zstd only where zstd.h is found;
#: a block with no binary lines may hold its line tracks at the payload's
#: end (offset == its size, under zstd); sparse streams not aligned to
#: their type in the block are read from aligned copies, each with its own
#: end.  c_api.cpp: the gzip read error reported as an error.  Every other
#: file is byte-equal.
DECLARED = {
    "xsi_accessor.cpp": [
        ("",
         '#ifdef XSI_HAVE_ZSTD\n'),
        ("",
         '#endif\n'),
        ('    sparse0_ = ptr<A_T>(KEY_MATRIX_SPARSE);\n',
         '    sparse0_ = stream(KEY_MATRIX_SPARSE, own_sparse_, &send_);\n'),
        ('    miss_sp0_ = ptr<A_T>(KEY_MATRIX_MISSING_SPARSE);\n',
         '    miss_sp0_ = stream(KEY_MATRIX_MISSING_SPARSE, own_miss_, '
         '&miss_end_);\n'),
        ('    eov_sp0_ = ptr<A_T>(KEY_MATRIX_END_OF_VECTORS_SPARSE);\n',
         '    eov_sp0_ = stream(KEY_MATRIX_END_OF_VECTORS_SPARSE, '
         'own_eov_, &eov_end_);\n'),
        ('    send_ = reinterpret_cast<const A_T *>(\n        p_ + (len_ '
         '& ~size_t(sizeof(A_T) - 1)));\n',
         ""),
        ("",
         "\n  // The sparse streams point into the decoder's own aligned "
         'copies.\n  GtBlockDecoder(const GtBlockDecoder &) = delete;\n  '
         'GtBlockDecoder &operator=(const GtBlockDecoder &) = delete;\n'),
        ('        if (!sp || sp >= send_) { set_error("missing track '
         'truncated"); return -1; }\n',
         '        if (!sp || sp >= miss_end_) { set_error("missing track '
         'truncated"); return -1; }\n'),
        ('        if (cnt > size_t(send_ - sp) || cnt > n) {\n',
         '        if (cnt > size_t(miss_end_ - sp) || cnt > n) {\n'),
        ('        if (!sp || sp >= send_) { set_error("EOV track '
         'truncated"); return -1; }\n',
         '        if (!sp || sp >= eov_end_) { set_error("EOV track '
         'truncated"); return -1; }\n'),
        ('        if (cnt > size_t(send_ - sp) || cnt > n) {\n',
         '        if (cnt > size_t(eov_end_ - sp) || cnt > n) {\n'),
        ('        if (!sp || sp >= send_) { set_error("missing track '
         'truncated"); return -1; }\n',
         '        if (!sp || sp >= miss_end_) { set_error("missing track '
         'truncated"); return -1; }\n'),
        ('        if (cnt > size_t(send_ - sp) || cnt > n) {\n',
         '        if (cnt > size_t(miss_end_ - sp) || cnt > n) {\n'),
        ('        if (!sp || sp >= send_) { set_error("EOV track '
         'truncated"); return -1; }\n',
         '        if (!sp || sp >= eov_end_) { set_error("EOV track '
         'truncated"); return -1; }\n'),
        ('        if (cnt > size_t(send_ - sp) || cnt > n) {\n',
         '        if (cnt > size_t(eov_end_ - sp) || cnt > n) {\n'),
        ('    if (it->second % 2 || it->second >= len_) {\n',
         '    // a block with no binary lines holds its line tracks at '
         "the payload's\n    // end: offset == len_ (the exact block size "
         'under zstd)\n    if (it->second % 2 || it->second > len_ ||\n   '
         '     (it->second == len_ && binary_lines_ != 0)) {\n'),
        ('    if (it->second % alignof(T) || it->second >= len_) return '
         'nullptr;\n',
         "    // offset == len_: an empty stream at the payload's end\n   "
         ' if (it->second % alignof(T) || it->second > len_) return '
         'nullptr;\n'),
        ("",
         "  }\n\n  // A sparse stream, from its offset to the payload's "
         'end (*end: past its\n  // last whole value).  The format does '
         'not align a 32-bit stream to 4\n  // bytes in the block: one '
         'that is not aligned is read from an aligned\n  // copy held in '
         '`own`.\n  const A_T *stream(uint32_t key, std::vector<A_T> '
         '&own, const A_T **end) {\n    auto it = dict_.find(key);\n    '
         'if (it == dict_.end() || it->second == VAL_UNDEF || it->second '
         '> len_)\n      return nullptr;\n    const uint8_t *s = p_ + '
         'it->second;\n    const size_t n = (len_ - it->second) / '
         'sizeof(A_T);\n    if (reinterpret_cast<uintptr_t>(s) % '
         'alignof(A_T)) {\n      own.resize(n);\n      if (n) '
         'memcpy(own.data(), s, n * sizeof(A_T));\n      s = '
         'reinterpret_cast<const uint8_t *>(own.data());\n    }\n    *end '
         '= reinterpret_cast<const A_T *>(s) + n;\n    return '
         'reinterpret_cast<const A_T *>(s);\n'),
        ('            if (!miss_sp_ || miss_sp_ >= send_) {\n',
         '            if (!miss_sp_ || miss_sp_ >= miss_end_) {\n'),
        ('            if (adv > size_t(send_ - miss_sp_)) { fail("missing '
         'track truncated"); return; }\n',
         '            if (adv > size_t(miss_end_ - miss_sp_)) { '
         'fail("missing track truncated"); return; }\n'),
        ('            if (!eov_sp_ || eov_sp_ >= send_) {\n',
         '            if (!eov_sp_ || eov_sp_ >= eov_end_) {\n'),
        ('            if (adv > size_t(send_ - eov_sp_)) { fail("EOV '
         'track truncated"); return; }\n',
         '            if (adv > size_t(eov_end_ - eov_sp_)) { fail("EOV '
         'track truncated"); return; }\n'),
        ('  const A_T *send_ = nullptr;        // payload end for sparse '
         'streams\n',
         '  const A_T *send_ = nullptr;        // end of the sparse '
         "stream\n  // the track sparse streams' ends; the aligned copies "
         'of the streams that\n  // need one (stream())\n  const A_T '
         '*miss_end_ = nullptr, *eov_end_ = nullptr;\n  std::vector<A_T> '
         'own_sparse_, own_miss_, own_eov_;\n'),
        ("",
         '#ifndef XSI_HAVE_ZSTD\n      set_error("zstd-compressed '
         'container, but this library was built "\n                '
         '"without zstd (zstd.h not found)");\n      return nullptr;\n'
         '#else\n'),
        ("",
         '#endif\n'),
        ("",
         '#ifndef XSI_HAVE_ZSTD\n  if (f->header.specific_bitset & 4) {\n '
         '   set_error("zstd-compressed container, but this library was '
         'built "\n              "without zstd (zstd.h not found)");\n    '
         'return nullptr;\n  }\n#endif\n'),
    ],
    "c_api.cpp": [
        ("", "  bool read_error = false;     // a gzip read error, not yet "
             "reported\n"),
        ('        if (g < 0) {\n          // a corrupt deflate stream must '
         'not read as a clean EOF —\n          // surface it once and stop '
         '(no errnum channel in the shim)\n          int errnum = 0;\n     '
         '     const char *msg = gzerror(gzf, &errnum);\n          fprintf('
         'stderr, "c_xcf: gzip read error (%s) — input truncated "\n       '
         '                   "at this point\\n",\n                  msg && '
         '*msg ? msg : "unknown zlib error");\n',
         '        int errnum = Z_OK;\n        const char *msg = g <= 0 ? '
         'gzerror(gzf, &errnum) : nullptr;\n        if (g < 0 || (g == 0 && '
         'errnum == Z_BUF_ERROR)) {\n          // a corrupt deflate stream, '
         'or one cut short (zlib reports\n          // Z_BUF_ERROR at its '
         'end), must not read as a clean EOF —\n          // report it once '
         'and stop (bcf_sr_next_line returns -2)\n          fprintf(stderr, '
         '"c_xcf: gzip read error (%s)\\n",\n                  g < 0 && msg '
         '&& *msg ? msg\n                                       : "input '
         'ends inside a gzip stream");\n          read_error = true;\n'),
        ("", "  bool read_error = false;\n"),
        ("", "    if (r->read_error) {\n      r->read_error = false;       "
             "// reported once; the reader is at EOF\n      read_error = "
             "true;\n    }\n"),
        ("", "  // htslib's convention for a failed read (bcf_read < -1): a "
             "corrupt or\n  // truncated input must not read as a clean end "
             "of file\n  if (read_error) return -2;\n"),
    ],
    "fuzz_enc.c": [
        (" *   var  file.bcf skip gt_key       \u2014 xsi_var_pass over a "
         "(possibly\n *                                     corrupt) BCF\n",
         " *   var  file.bcf skip gt_key out   \u2014 xsi_var_pass over a "
         "(possibly\n *                                     corrupt) BCF, "
         "writing to out\n"),
        ("static int run_var(const char *path, uint64_t skip, int gt_key) "
         "{\n",
         "static int run_var(const char *path, uint64_t skip, int gt_key,\n"
         "                   const char *out) {\n"),
        ('  int64_t n = xsi_var_pass(path, skip, "/tmp/fuzz_var_out.bcf", '
         'hdr, 4, 1,\n',
         "  int64_t n = xsi_var_pass(path, skip, out, hdr, 4, 1,\n"),
        ('  if (argc >= 5 && strcmp(argv[1], "var") == 0)\n    return '
         "run_var(argv[2], strtoull(argv[3], NULL, 10), atoi(argv[4]));\n",
         '  if (argc >= 6 && strcmp(argv[1], "var") == 0)\n    return '
         "run_var(argv[2], strtoull(argv[3], NULL, 10), atoi(argv[4]),\n"
         "                   argv[5]);\n"),
        ('                  "var file.bcf skip gt_key\\n", argv[0]);\n',
         '                  "var file.bcf skip gt_key out.bcf\\n", '
         "argv[0]);\n"),
    ],
}


def _tree(root):
    out = set()
    for d, _, files in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, f), root) for f in files}
    return out


def test_native_copies_equal_the_originals_but_the_declared_changes():
    """The port's copy of native/ (its C++ sources and headers, the htslib
    shim, the two C API test programs and the four sanitizer programs:
    fuzz_accessor.c, fuzz_gtb.c, fuzz_enc.c, tsan_extract.c) is byte-equal
    to the JAX package's but for the declared changes (DECLARED): zstd
    only where zstd.h is found, the line tracks of a block with no binary
    lines at the payload's end, sparse streams read from aligned copies
    where the block does not align them, the C API's gzip read error
    reported as an error, and fuzz_enc's variant pass writing to the path
    its caller gives in place of one fixed path that every run shares.
    Its comments name the xSqueezeIt reference's files without the
    directory the originals give for the reference tree."""
    orig_dir = os.path.join(REPO, "native")
    port_dir = os.path.join(REPO, "xsqueezeit_tpu_torch", "native")
    want = {f for f in _tree(orig_dir)
            if f.endswith((".cpp", ".h")) or f.startswith("hts_shim")
            or f in ("c_api_test.c", "c_xcf_test.c", "fuzz_accessor.c",
                     "fuzz_gtb.c", "fuzz_enc.c", "tsan_extract.c")}
    assert _tree(port_dir) == want
    for rel in sorted(want):
        a, b = (_read(os.path.join(d, rel)).decode()
                for d in (orig_dir, port_dir))
        a = re.sub(r"/\w+/reference/", "the xSqueezeIt reference's ", a)
        if rel not in DECLARED:
            assert a == b, rel
            continue
        al, bl = a.splitlines(keepends=True), b.splitlines(keepends=True)
        hunks = [("".join(al[i1:i2]), "".join(bl[j1:j2]))
                 for op, i1, i2, j1, j2 in difflib.SequenceMatcher(
                     None, al, bl, autojunk=False).get_opcodes()
                 if op != "equal"]
        assert hunks == DECLARED[rel], rel
