"""The port's native host library under ASan/UBSan and TSan on corrupt
input: the counterparts of tests/test_native_fuzz.py, run against the
port's sanitized builds (interop/native.build_sanitized) and on containers
that the port's CLI writes.

Each case runs on the build made as on a machine without zstd or
libdeflate ("nozstd", the GPU host's own configuration) and on the build
with zstd ("zstd").  The accessor matrix (truncations, header and
dictionary corruption, byte flips of the .xsi and of its variant file,
block payload garbage, swapped companions) takes four containers: a
plain one and one of 32,800 samples (H = 65,600: 32-bit sparse streams,
which the format need not align) on both builds; a zstd one and a zstd
container with a block of zero-ALT records only (whose line tracks sit
at the payload's end) on the zstd build, which the no-zstd build refuses
at open by name.  The GT
batch reader, the block encoder and the variant pass take adversarial
values and geometry; the threaded emitter runs under TSan and must write
the synchronous writer's bytes.

Pass criterion, the reference's: any clean exit code (an open error, a
fill error, a short walk); a sanitizer report (exit 99 from ASan or UBSan,
66 from TSan) or a raw signal fails.  The programs run four at a time."""
import os
import shutil
import struct
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("torch")

from xsqueezeit_tpu_torch.bench import corrupt
from xsqueezeit_tpu_torch.bench.synth import synth_bcf
from xsqueezeit_tpu_torch.cli import main as cli
from xsqueezeit_tpu_torch.codec.compressor import (
    CompressorOptions,
    compress_file,
)
from xsqueezeit_tpu_torch.codec.decompressor import (
    Decompressor,
    DecompressorOptions,
)
from xsqueezeit_tpu_torch.interop import native
from xsqueezeit_tpu_torch.io.bcf import BcfReader
from tests import fixtures

#: build -> build_flags arguments
BUILDS = {"nozstd": dict(zstd=False, libdeflate=False),
          "zstd": dict(zstd=True)}
#: container -> (the builds it runs on, records)
CONTAINERS = {"plain": (("nozstd", "zstd"), 80), "zstd": (("zstd",), 80),
              "zero_alt_zstd": (("zstd",), 4),
              "wide32": (("nozstd", "zstd"), 6)}
_ENV = {
    **os.environ,
    # exitcode marks sanitizer findings unambiguously; leaks in the
    # error paths count too (detect_leaks on by default)
    "ASAN_OPTIONS": "exitcode=99:abort_on_error=0",
    "UBSAN_OPTIONS": "exitcode=99:print_stacktrace=1",
    "TSAN_OPTIONS": "halt_on_error=1 exitcode=66",
}


def _need_compilers():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no C/C++ toolchain")


@pytest.fixture(scope="module")
def asan(tmp_path_factory):
    """build -> {program: executable} of the ASan/UBSan builds."""
    _need_compilers()
    return {b: native.build_sanitized("asan", str(tmp_path_factory.mktemp(
        f"asan_{b}")), **kw) for b, kw in BUILDS.items()}


def _run(args, timeout=120) -> subprocess.CompletedProcess:
    return subprocess.run([str(a) for a in args], env=_ENV,
                          capture_output=True, text=True, timeout=timeout)


def _check_clean(r: subprocess.CompletedProcess, what: str) -> None:
    blob = r.stdout + r.stderr
    assert r.returncode >= 0, f"{what}: died on signal {-r.returncode}\n{blob}"
    assert r.returncode not in (66, 99), f"{what}: sanitizer report\n{blob}"
    assert ("AddressSanitizer" not in blob and "runtime error" not in blob
            and "ThreadSanitizer" not in blob), \
        f"{what}: sanitizer output without its exit code\n{blob}"


def _check_all(cases: list[tuple[str, list]]) -> None:
    """Run (what, argv) cases four at a time; each must exit cleanly."""
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda c: _run(c[1]), cases))
    for (what, _), r in zip(cases, results):
        _check_clean(r, what)


def _wide_vcf(path: str) -> str:
    return corrupt.write_vcf(path, 32800, CONTAINERS["wide32"][1], seed=41,
                             missing_frac=0.01)


def _zero_alt_vcf(path: str) -> str:
    rows = [("A", ["0|1", "0|0", "1|1"]), (".", ["0|0"] * 3),
            (".", ["0|0"] * 3), ("C", ["1|0", "0|0", "0|1"])]
    return fixtures.write_vcf(path, rows, n_samples=3)


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    """name -> .xsi path: each container written once by the port's
    CLI."""
    td = tmp_path_factory.mktemp("fuzz_containers")
    out = {}
    for name in CONTAINERS:
        args = ["--variant-block-length", "32"]
        vcf = str(td / f"{name}.vcf")
        if name == "wide32":
            _wide_vcf(vcf)
        elif name == "zero_alt_zstd":
            _zero_alt_vcf(vcf)
            args = ["--variant-block-length", "1", "--zstd"]
        else:
            fixtures.random_vcf(vcf, n_samples=21, n_records=80, seed=29,
                                p_multi=0.2)
            if name == "zstd":
                args.append("--zstd")
        out[name] = str(td / f"{name}.xsi")
        assert cli(["-c", "-f", vcf, "-o", out[name], "--device", "numpy",
                    *args]) == 0
    return out


@pytest.fixture(scope="module", params=[
    (name, build) for name in sorted(CONTAINERS)
    for build in CONTAINERS[name][0]], ids="-".join)
def container(request, asan, containers):
    """(fuzz_accessor, container path, records): one container with the
    fuzz program of one build."""
    name, build = request.param
    return asan[build]["fuzz_accessor"], containers[name], \
        CONTAINERS[name][1]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_pair(tmp_path, name: str, xsi_bytes: bytes,
                var_bytes: bytes) -> str:
    p = str(tmp_path / f"{name}.xsi")
    with open(p, "wb") as f:
        f.write(xsi_bytes)
    with open(p + "_var.bcf", "wb") as f:
        f.write(var_bytes)
    return p


# ---------------------------------------------------------------- accessor
def test_happy_path_sanitized(container):
    """The well-formed container walks to its end under ASan, leaks
    included."""
    prog, xsi, n_records = container
    r = _run([prog, xsi])
    _check_clean(r, "happy path")
    assert r.returncode == 0 and f"done records={n_records}" in r.stdout, \
        r.stdout


def test_no_zstd_build_refuses_zstd_containers(asan, tmp_path):
    """The build without zstd refuses a zstd container at open, by name."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=5,
                              n_records=10, seed=3)
    xsi = str(tmp_path / "z.xsi")
    assert cli(["-c", "-f", vcf, "-o", xsi, "--zstd", "--device",
                "numpy"]) == 0
    r = _run([asan["nozstd"]["fuzz_accessor"], xsi])
    _check_clean(r, "zstd container, no-zstd build")
    assert r.returncode == 3 and "without zstd" in r.stdout, r.stdout


def test_truncated_xsi(container, tmp_path):
    prog, xsi, _ = container
    data, var = _read(xsi), _read(xsi + "_var.bcf")
    _check_all([(f"xsi truncated at {cut}",
                 [prog, _write_pair(tmp_path, f"t{cut}", data[:cut], var)])
                for cut in (0, 7, 100, 255, 256, 300, len(data) // 2,
                            len(data) - 3)])


def test_truncated_var_bcf(container, tmp_path):
    prog, xsi, _ = container
    data, var = _read(xsi), _read(xsi + "_var.bcf")
    _check_all([(f"var.bcf truncated at {cut}",
                 [prog, _write_pair(tmp_path, f"v{cut}", data, var[:cut])])
                for cut in (0, 10, 64, len(var) // 3, len(var) - 5)])


def test_corrupt_header_fields(container, tmp_path):
    """Huge and zero values in every 32-bit word of the 256-byte header
    (counters, offsets, sample counts) must not overread."""
    prog, xsi, _ = container
    data, var = _read(xsi), _read(xsi + "_var.bcf")
    cases = []
    for off in range(8, 256, 4):
        for val in (0, 0xFFFFFFFF, 0x7FFFFFFF, len(data) * 2):
            mut = bytearray(data)
            struct.pack_into("<I", mut, off, val & 0xFFFFFFFF)
            cases.append((f"header word {off} set to {val:#x}",
                          [prog, _write_pair(tmp_path, f"h{off}_{val:x}",
                                            bytes(mut), var)]))
    _check_all(cases)


def test_random_flips_xsi(container, tmp_path):
    prog, xsi, _ = container
    rng = np.random.default_rng(31)
    data, var = _read(xsi), _read(xsi + "_var.bcf")
    cases = []
    for trial in range(60):
        mut = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            mut[int(rng.integers(0, len(mut)))] ^= int(rng.integers(1, 256))
        cases.append((f"random flip trial {trial}",
                      [prog, _write_pair(tmp_path, f"r{trial}", bytes(mut),
                                        var)]))
    _check_all(cases)


def test_random_flips_var_bcf(container, tmp_path):
    prog, xsi, _ = container
    rng = np.random.default_rng(37)
    data, var = _read(xsi), _read(xsi + "_var.bcf")
    cases = []
    for trial in range(40):
        mut = bytearray(var)
        for _ in range(int(rng.integers(1, 4))):
            mut[int(rng.integers(0, len(mut)))] ^= int(rng.integers(1, 256))
        cases.append((f"var.bcf flip trial {trial}",
                      [prog, _write_pair(tmp_path, f"b{trial}", data,
                                        bytes(mut))]))
    _check_all(cases)


def test_block_payload_garbage(container, tmp_path):
    """Whole stretches after the header replaced with garbage (zstd
    frames in the zstd containers, dictionary and stream bytes in all)."""
    prog, xsi, _ = container
    rng = np.random.default_rng(41)
    data, var = _read(xsi), _read(xsi + "_var.bcf")
    cases = []
    for trial in range(12):
        mut = bytearray(data)
        start = int(rng.integers(256, len(mut) - 32))
        span = int(rng.integers(8, min(256, len(mut) - start)))
        mut[start:start + span] = rng.integers(0, 256, span,
                                               dtype=np.uint8).tobytes()
        cases.append((f"garbage stretch trial {trial}",
                      [prog, _write_pair(tmp_path, f"g{trial}", bytes(mut),
                                        var)]))
    _check_all(cases)


def test_swapped_companions(container, tmp_path):
    """The variant file's bytes in the .xsi's place and the other way."""
    prog, xsi, _ = container
    p = _write_pair(tmp_path, "swap", _read(xsi + "_var.bcf"), _read(xsi))
    _check_clean(_run([prog, p]), "swapped companion files")


# ---------------------------------------------------------------- gt_batch
@pytest.fixture(scope="module")
def gtb_bcf(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("gtb") / "in.bcf")
    synth_bcf(p, 90, 31)
    r = BcfReader(p)
    skip = 9 + r.header_text_len
    gt_key = r.header.str2idx["GT"]
    r.close()
    return p, skip, gt_key, 31


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_gtb_happy_path_sanitized(asan, gtb_bcf, build):
    p, skip, key, n = gtb_bcf
    r = _run([asan[build]["fuzz_gtb"], p, skip, key, n])
    _check_clean(r, "gtb happy path")
    assert "records 90" in r.stdout


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_gtb_truncations(asan, gtb_bcf, tmp_path, build):
    p, skip, key, n = gtb_bcf
    data = _read(p)
    cases = []
    for frac in (0.1, 0.5, 0.9, 0.99):
        cut = str(tmp_path / f"cut{int(frac * 100)}.bcf")
        with open(cut, "wb") as f:
            f.write(data[:int(len(data) * frac)])
        cases.append((f"gtb truncated {frac}",
                      [asan[build]["fuzz_gtb"], cut, skip, key, n]))
    _check_all(cases)


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_gtb_bit_flips(asan, gtb_bcf, tmp_path, build):
    p, skip, key, n = gtb_bcf
    data = _read(p)
    rng = np.random.default_rng(17)
    cases = []
    for trial in range(12):
        mut = bytearray(data)
        for pos in rng.integers(0, len(mut), 24):
            mut[pos] ^= 1 << int(rng.integers(0, 8))
        f = str(tmp_path / f"flip{trial}.bcf")
        with open(f, "wb") as fh:
            fh.write(bytes(mut))
        cases.append((f"gtb flips trial {trial}",
                      [asan[build]["fuzz_gtb"], f, skip, key, n]))
    _check_all(cases)


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_gtb_wrong_geometry(asan, gtb_bcf, build):
    """Mismatched skip, key and sample count fail cleanly."""
    p, skip, key, n = gtb_bcf
    _check_all([(f"gtb geometry {args}", [asan[build]["fuzz_gtb"], p, *args])
                for args in ((0, key, n), (skip + 13, key, n),
                             (skip, key + 5, n), (skip, key, n * 3),
                             (skip, key, 1))])


# -------------------------------------------------------- encoder/var pass
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_enc_adversarial_values_sanitized(asan, build):
    """Random gt arrays with sentinel, huge and corrupt values through
    every weirdness strategy of the native block encoder."""
    _check_all([(f"enc seed {seed}", [asan[build]["fuzz_enc"], "enc", seed,
                                      17 + seed * 13, 300])
                for seed in (1, 2, 3, 4)])


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_var_pass_corrupt_inputs_sanitized(asan, gtb_bcf, tmp_path, build):
    """xsi_var_pass over intact, truncated and bit-flipped BCFs, and with
    wrong skip and gt_key geometry."""
    p, skip, key, _ = gtb_bcf
    prog = asan[build]["fuzz_enc"]
    data = _read(p)
    cases = [("var intact", [prog, "var", p, skip, key]),
             ("var bad skip", [prog, "var", p, 0, key]),
             ("var off geometry", [prog, "var", p, skip + 7, key + 3])]
    for frac in (0.3, 0.95):
        cut = str(tmp_path / f"vcut{int(frac * 100)}.bcf")
        with open(cut, "wb") as f:
            f.write(data[:int(len(data) * frac)])
        cases.append((f"var truncated {frac}", [prog, "var", cut, skip, key]))
    rng = np.random.default_rng(5)
    for trial in range(6):
        mut = bytearray(data)
        for pos in rng.integers(0, len(mut), 16):
            mut[pos] ^= 1 << int(rng.integers(0, 8))
        f = str(tmp_path / f"vflip{trial}.bcf")
        with open(f, "wb") as fh:
            fh.write(bytes(mut))
        cases.append((f"var flip {trial}", [prog, "var", f, skip, key]))
    # each case writes its variant file apart: they run side by side
    _check_all([(what, [*argv, str(tmp_path / f"var_out{i}.bcf")])
                for i, (what, argv) in enumerate(cases)])


# -------------------------------------------------------------------- TSan
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_tsan_threaded_emitter_extract(tmp_path, build):
    """The bcf_emit deflate worker pool under ThreadSanitizer: a threaded
    extract finishes race-free and writes the synchronous writer's
    bytes."""
    _need_compilers()
    tsan = native.build_sanitized("tsan", str(tmp_path), **BUILDS[build])
    inp = str(tmp_path / "in.bcf")
    synth_bcf(inp, 1200, 101)
    xsi = str(tmp_path / "o.xsi")
    compress_file(inp, xsi, CompressorOptions(block_length=256,
                                              device="numpy"))
    header = Decompressor(xsi, DecompressorOptions(
        output_type="b", device="numpy")).output_header()
    hpath = str(tmp_path / "hdr.bin")
    with open(hpath, "wb") as f:
        f.write(header.to_text().encode() + b"\0")
    outs = {}
    for threads in (3, 0):
        outs[threads] = str(tmp_path / f"t{threads}.bcf")
        r = _run([tsan["tsan_extract"], xsi, outs[threads], hpath,
                  header.str2idx["GT"], threads], timeout=300)
        _check_clean(r, f"tsan extract, {threads} threads")
        assert r.returncode == 0, r.stderr[-3000:]
    assert _read(outs[0]) == _read(outs[3]), \
        "threaded output differs from sync"


# ------------------------------------------------------------ the builds
def test_sanitized_builds_are_never_loaded(asan, tmp_path):
    """Each sanitized library lies under a name of its own beside the
    production one, and load_path refuses it (a Python process that
    loads it dies); the production library still loads."""
    _need_compilers()
    native.build_sanitized("tsan", str(tmp_path), **BUILDS["nozstd"])
    prod = native.library_path(**BUILDS["nozstd"])
    for san in native.SANITIZERS:
        path = native.library_path(sanitize=san, **BUILDS["nozstd"])
        assert path != prod and os.path.exists(path)
        with pytest.raises(native.NativeBuildError, match="sanitized"):
            native.load_path(path)
    assert native.load_library(**BUILDS["nozstd"]) is not None
