"""ctypes binding for the port's native host library, and its build.

The port's copy of xsqueezeit_tpu/interop/native.py.  The library is the
C-linkage integration surface for third-party tools (the reference
exports libxsqueezeit.a consumed by e.g. SHAPEIT4) and the host stages
around the block codec: the batched BCF parse, the one-pass ingest, the
variant-file pass, the track-stream offset walk, the VCF GT text, and the
host codec (block encoder, accessor, extract loop).

The sources are the port's own copy of the JAX package's native/, in
xsqueezeit_tpu_torch/native/, byte-equal to it but for two changes: zstd
is compiled in only where zstd.h is found (without it a zstd container is
refused by name), and the C API's plain-gzip reader reports a read error
as one (bcf_sr_next_line returns -2, htslib's bcf_read < -1 convention)
where the original reads it as a clean end of file.

At first use they are compiled with g++ (the flags of native/Makefile:
-O3, -march=native where the compiler takes it, libdeflate where it is
found, zstd where zstd.h is found) into xsqueezeit_tpu_torch/build/:
libxsqueezeit_tpu.so (accessor, emitter, extract loop, batch parse, block
encoder, variant pass) and libxsqueezeit.so (the drop-in c_xcf_* C API
with its htslib shim).  A library is rebuilt when a source is newer than
it, its flags changed or another host built it; builds are serialised
across processes with a file lock, and each library is linked under a
temporary name and renamed into place.  A failed build raises
NativeBuildError with the compiler's output: nothing falls back
silently.  Which routes use the library is decided by the callers
(enabled()).
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import platform
import subprocess
import tempfile
import threading
import time

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(PKG_DIR, "build")

#: The compilers (native/Makefile's CXX and CC).
CXX = "g++"
CC = "gcc"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")

#: library stem -> (its sources, extra compile flags)
TARGETS = {
    "libxsqueezeit_tpu": (("xsi_accessor.cpp", "bcf_emit.cpp",
                           "xsi_extract.cpp", "gt_batch.cpp",
                           "gt_encoder.cpp", "var_pass.cpp"), ()),
    "libxsqueezeit": (("c_api.cpp", "xsi_accessor.cpp"),
                      ("-I" + SRC_DIR, "-I" + os.path.join(SRC_DIR,
                                                           "hts_shim"))),
}

#: sanitizer -> (its compile and link flags, the test programs that are
#: built against its library), native/Makefile's sanitize, fuzz_*_asan and
#: tsan_extract targets.  ASan and TSan cannot share a process.  -O1 (the
#: sanitizers' own advice, and the programs' level in native/Makefile) in
#: place of -O3: with ASan and UBSan, xsi_accessor.cpp compiles in less
#: than half the time.
SANITIZERS = {
    "asan": (("-O1", "-fsanitize=address,undefined",
              "-fno-omit-frame-pointer", "-g"),
             ("fuzz_accessor", "fuzz_gtb", "fuzz_enc")),
    "tsan": (("-O1", "-fsanitize=thread", "-g"), ("tsan_extract",)),
}

_OFF = ("0", "off", "no")
_lock = threading.Lock()
_probes: dict = {}
_libs: dict = {}
#: Seconds the last library build of this process took (None: none ran).
last_build_seconds: float | None = None


class NativeBuildError(OSError):
    """The native library could not be built or loaded."""


def enabled(switch: str | None = None) -> bool:
    """Whether a native route is on: XSI_NATIVE=0 turns every route off,
    `switch` (XSI_NATIVE_PARSE or XSI_NATIVE_ENCODE) its own routes."""
    if os.environ.get("XSI_NATIVE", "1") in _OFF:
        return False
    return switch is None or os.environ.get(switch, "1") not in _OFF


def _compiles(flags: tuple, code: str) -> bool:
    """Whether CXX compiles and links `code` with `flags` (cached)."""
    key = (CXX, flags, code)
    if key not in _probes:
        with tempfile.TemporaryDirectory() as td:
            r = subprocess.run(
                [CXX, "-x", "c++", "-", *flags, "-o",
                 os.path.join(td, "probe")],
                input=code, capture_output=True, text=True)
        _probes[key] = r.returncode == 0
    return _probes[key]


def build_flags(zstd: bool | None = None,
                libdeflate: bool | None = None) -> tuple[list, list]:
    """(compile flags, link libraries) of a build.  None probes the
    compiler as native/Makefile does (zstd also needs zstd.h); False
    leaves the library out; True demands it."""
    flags = list(CXXFLAGS)
    if _compiles(("-march=native",), "int main(){return 0;}\n"):
        flags.append("-march=native")
    libs = ["-lz"]
    for on, define, lib, header in (
            (libdeflate, "-DUSE_LIBDEFLATE", "-ldeflate", "libdeflate.h"),
            (zstd, "-DXSI_HAVE_ZSTD", "-lzstd", "zstd.h")):
        if on is None:
            on = _compiles((lib,), f"#include <{header}>\n"
                                   "int main(){return 0;}\n")
        if on:
            flags.append(define)
            libs.append(lib)
    return flags, libs


def library_path(stem: str = "libxsqueezeit_tpu",
                 zstd: bool | None = None,
                 libdeflate: bool | None = None,
                 sanitize: str | None = None) -> str:
    """Where a build goes: the probed build under its own name; a build
    with zstd or libdeflate fixed by the caller under a separate name; a
    sanitized build (SANITIZERS) with the sanitizer in its name."""
    tag = "".join(f"-{'' if on else 'no'}{name}" for on, name in
                  ((zstd, "zstd"), (libdeflate, "deflate"))
                  if on is not None)
    san = f"_{sanitize}" if sanitize else ""
    return os.path.join(BUILD_DIR, f"{stem}{san}{tag}.so")


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise NativeBuildError(
                f"{c[0]} failed (exit {p.returncode}):\n{' '.join(c)}\n"
                f"{out}")


def _deps() -> list[str]:
    out = []
    for root, _, files in os.walk(SRC_DIR):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".cpp", ".h"))]
    return out


def _build(stem: str, force: bool, zstd, libdeflate,
           sanitize: str | None = None) -> str:
    """Compile `stem` if it is missing or stale; returns its path.  Each
    source compiles to an object in its own process, all at once, and one
    more links them.  `sanitize` adds a sanitizer's flags (SANITIZERS)."""
    global last_build_seconds
    path = library_path(stem, zstd, libdeflate, sanitize)
    try:
        flags, libs = build_flags(zstd, libdeflate)
    except OSError as exc:          # no compiler at all
        raise NativeBuildError(f"{CXX}: {exc}") from exc
    if sanitize:
        flags += SANITIZERS[sanitize][0]
    sources, extra = TARGETS[stem]
    # -march=native targets the building host: another host rebuilds
    stamp = " ".join([platform.node(), CXX, *flags, *extra, *libs])

    def fresh() -> bool:
        try:
            built = os.path.getmtime(path)
            with open(path + ".flags") as f:
                same = f.read() == stamp
        except OSError:
            return False
        return same and all(os.path.getmtime(p) <= built for p in _deps())

    if not force and fresh():
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one build at a time, any process
        if not force and fresh():
            return path                      # another process built it
        tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
        objs = [os.path.join(BUILD_DIR, f"{stem}.{src[:-4]}.{tag}.o")
                for src in sources]
        tmp = f"{path}.{tag}"
        t0 = time.perf_counter()
        try:
            _run_all([[CXX, *flags, *extra, "-c", "-o", obj,
                       os.path.join(SRC_DIR, src)]
                      for src, obj in zip(sources, objs)])
            _run_all([[CXX, *flags, "-shared", "-o", tmp, *objs, *libs]])
            os.replace(tmp, path)
        except NativeBuildError:
            raise
        except OSError as exc:          # no compiler, no disk space
            raise NativeBuildError(f"{CXX}: {exc}") from exc
        finally:
            for p in (*objs, tmp):
                if os.path.exists(p):
                    os.unlink(p)
        with open(path + ".flags", "w") as f:
            f.write(stamp)
        last_build_seconds = time.perf_counter() - t0
    return path


def build_native(force: bool = False, zstd: bool | None = None,
                 libdeflate: bool | None = None) -> str:
    """Build libxsqueezeit_tpu.so if needed; returns its path."""
    return _build("libxsqueezeit_tpu", force, zstd, libdeflate)


def build_c_api(force: bool = False, zstd: bool | None = None,
                libdeflate: bool | None = None) -> str:
    """Build the drop-in C API, libxsqueezeit.so, if needed; returns its
    path."""
    return _build("libxsqueezeit", force, zstd, libdeflate)


def build_c_api_tests(out_dir: str, zstd: bool | None = None,
                      libdeflate: bool | None = None) -> dict[str, str]:
    """Compile the C API's two test programs into `out_dir` with CC, as
    native/Makefile does: c_api_test against libxsqueezeit_tpu.so and
    c_xcf_test against libxsqueezeit.so.  Returns name -> executable."""
    _, libs = build_flags(zstd, libdeflate)
    out = {}
    cmds = []
    for name, lib in (("c_api_test", build_native(False, zstd, libdeflate)),
                      ("c_xcf_test", build_c_api(False, zstd, libdeflate))):
        out[name] = os.path.join(out_dir, name)
        cmds.append([CC, "-O2", "-I" + os.path.join(SRC_DIR, "hts_shim"),
                     "-o", out[name], os.path.join(SRC_DIR, name + ".c"),
                     "-L" + os.path.dirname(lib),
                     "-l:" + os.path.basename(lib),
                     "-Wl,-rpath," + os.path.dirname(lib), *libs])
    try:
        _run_all(cmds)
    except FileNotFoundError as exc:
        raise NativeBuildError(f"{CC}: {exc}") from exc
    return out


def build_sanitized(sanitize: str, out_dir: str, zstd: bool | None = None,
                    libdeflate: bool | None = None) -> dict[str, str]:
    """A sanitized libxsqueezeit_tpu and its test programs (SANITIZERS:
    "asan", ASan and UBSan with the three fuzz programs; "tsan", TSan with
    tsan_extract).  The library is built as the production one is, into
    BUILD_DIR under the file lock with build_flags(zstd, libdeflate), under
    a name of its own; the programs are compiled into `out_dir` with CC,
    as native/Makefile does.  Returns name -> executable.  No Python
    process loads the library (load_path refuses it)."""
    san_flags, programs = SANITIZERS[sanitize]
    lib = _build("libxsqueezeit_tpu", False, zstd, libdeflate, sanitize)
    _, libs = build_flags(zstd, libdeflate)
    out = {name: os.path.join(out_dir, name) for name in programs}
    try:
        _run_all([[CC, *san_flags, "-I" + SRC_DIR, "-o", out[name],
                   os.path.join(SRC_DIR, name + ".c"),
                   "-L" + os.path.dirname(lib), "-l:" + os.path.basename(lib),
                   "-Wl,-rpath," + os.path.dirname(lib), *libs]
                  for name in programs])
    except FileNotFoundError as exc:
        raise NativeBuildError(f"{CC}: {exc}") from exc
    return out


def load_path(path: str) -> ctypes.CDLL:
    """ctypes-load the library at `path`.  A sanitized build is refused:
    its runtime must start before the process does, and a Python process
    that loads it dies."""
    with open(path, "rb") as f:
        image = f.read()
    if b"__asan_init" in image or b"__tsan_init" in image:
        raise NativeBuildError(f"{path} is a sanitized build: it runs only "
                               "in its test programs (build_sanitized)")
    try:
        return ctypes.CDLL(path)
    except OSError as exc:
        raise NativeBuildError(f"cannot load {path}: {exc}") from exc


def load_library(zstd: bool | None = None,
                 libdeflate: bool | None = None) -> ctypes.CDLL:
    """The loaded libxsqueezeit_tpu.so of this build (built at first use;
    one load per process)."""
    with _lock:
        path = build_native(False, zstd, libdeflate)
        lib = _libs.get(path)
        if lib is None:
            lib = load_path(path)
            lib.xsi_last_error.restype = ctypes.c_char_p
            _libs[path] = lib
    return lib


def _lib() -> ctypes.CDLL:
    """The library every binding below calls."""
    return load_library()


class NativeAccessor:
    def __init__(self, xsi_path: str):
        lib = _lib()
        lib.xsi_open.restype = ctypes.c_void_p
        lib.xsi_open.argtypes = [ctypes.c_char_p]
        lib.xsi_close.argtypes = [ctypes.c_void_p]
        for name, res in [("xsi_num_samples", ctypes.c_uint64),
                          ("xsi_num_variants", ctypes.c_uint64),
                          ("xsi_num_records", ctypes.c_uint64),
                          ("xsi_version", ctypes.c_uint32),
                          ("xsi_ploidy", ctypes.c_uint32)]:
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = [ctypes.c_void_p]
        lib.xsi_sample_name.restype = ctypes.c_char_p
        lib.xsi_sample_name.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.xsi_next_record.argtypes = [ctypes.c_void_p]
        lib.xsi_record_n_allele.argtypes = [ctypes.c_void_p]
        lib.xsi_record_bm.argtypes = [ctypes.c_void_p]
        lib.xsi_get_genotypes.restype = ctypes.c_int64
        lib.xsi_get_genotypes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t]
        lib.xsi_fill_genotypes_bm.restype = ctypes.c_int64
        lib.xsi_fill_genotypes_bm.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t]
        lib.xsi_fill_allele_counts_bm.restype = ctypes.c_int
        lib.xsi_fill_allele_counts_bm.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        lib.xsi_count_alleles_range.restype = ctypes.c_int64
        lib.xsi_count_alleles_range.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.xsi_last_error.restype = ctypes.c_char_p
        self._lib = lib
        self._f = lib.xsi_open(xsi_path.encode())
        if not self._f:
            raise OSError(lib.xsi_last_error().decode())
        self.n_samples = lib.xsi_num_samples(self._f)
        self._buf = np.zeros(self.n_samples * 2, np.int32)

    def close(self):
        if self._f:
            self._lib.xsi_close(self._f)
            self._f = None

    def sample_name(self, i: int) -> str:
        return self._lib.xsi_sample_name(self._f, i).decode()

    def __iter__(self):
        lib = self._lib
        ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while True:
            rc = lib.xsi_next_record(self._f)
            if rc == 0:
                return
            if rc < 0:
                raise OSError(lib.xsi_last_error().decode())
            n = lib.xsi_get_genotypes(self._f, ptr, self._buf.shape[0])
            if n < 0:
                raise OSError(lib.xsi_last_error().decode())
            yield (lib.xsi_record_n_allele(self._f), self._buf[:n].copy())

    def fill_genotypes_bm(self, bm: int, n_allele: int) -> np.ndarray:
        ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n = self._lib.xsi_fill_genotypes_bm(self._f, bm, n_allele, ptr,
                                            self._buf.shape[0])
        if n < 0:
            raise OSError(self._lib.xsi_last_error().decode())
        return self._buf[:n].copy()

    def fill_allele_counts_bm(self, bm: int, n_allele: int) -> np.ndarray:
        """Count-only path: AC per allele straight off the compressed
        forms (WAH popcount / sparse lengths), no gt materialization
        (native/xsi_accessor.cpp xsi_fill_allele_counts_bm; reference:
        accessor_internals_new.hpp:407-438 fill_allele_counts_advance)."""
        counts = np.zeros(max(int(n_allele), 1), np.int64)
        rc = self._lib.xsi_fill_allele_counts_bm(
            self._f, bm, n_allele,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise OSError(self._lib.xsi_last_error().decode())
        return counts

    def count_alleles_range(self, bms, n_alleles) -> np.ndarray:
        """Batched count-only walk: one ctypes crossing for many records
        (native xsi_count_alleles_range — sparse heads + WAH run-word
        popcounts, no gt materialization, no PBWT arrangement upkeep).
        Returns the flat int64 counts, back-to-back per record (sum of
        n_alleles entries)."""
        bms = np.ascontiguousarray(bms, np.int32)
        nas = np.ascontiguousarray(n_alleles, np.int32)
        out = np.zeros(int(nas.sum()), np.int64)
        n = self._lib.xsi_count_alleles_range(
            self._f, bms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(bms), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if n != out.shape[0]:
            raise OSError(self._lib.xsi_last_error().decode())
        return out

    def scan_records(self) -> tuple[np.ndarray, np.ndarray]:
        """All (BM, n_allele) pairs of the variant file in one crossing
        (native xsi_scan_records) — af_stats' front walk; the Python
        BCF-parse equivalent costs ~100x.  Must be called on a freshly
        opened accessor (the variant cursor starts at record 0)."""
        fn = self._lib.xsi_scan_records
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                       ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        cap = int(self._lib.xsi_num_records(self._f))
        bms = np.zeros(cap, np.int32)
        nas = np.zeros(cap, np.int32)
        n = fn(self._f, bms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
               nas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n < 0:
            raise OSError(self._lib.xsi_last_error().decode())
        return bms[:n], nas[:n]


def native_extract(xsi_path: str, out_path: str, header_text: bytes,
                   gt_key: int, level: int = 6) -> int:
    """Whole-file native extract (.xsi -> .bcf), entirely in C++.

    The C loop (native/xsi_extract.cpp) mirrors the reference's
    decompress_inner_loop (gt_decompressor_new.hpp:158-206): decode each
    record's genotypes from the compressed block, re-emit the stored site
    bytes with the sample-count word patched, and BGZF-deflate via the
    native emitter.  Byte-identical to the Python writer at the same level.
    Returns the number of records written; raises OSError on failure.
    """
    lib = _lib()
    lib.xsi_extract_file.restype = ctypes.c_int64
    lib.xsi_extract_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_int32, ctypes.c_int]
    lib.xsi_last_error.restype = ctypes.c_char_p
    n = lib.xsi_extract_file(xsi_path.encode(), out_path.encode(),
                             header_text, len(header_text), gt_key, level)
    if n < 0:
        raise OSError(f"native extract failed ({n}): "
                      f"{lib.xsi_last_error().decode()}")
    return int(n)


class NativeBcfEmitter:
    """ctypes binding for the native BCF record emitter (native/bcf_emit.h).

    Streams [l_shared][l_indiv][shared][prefix+row] record batches through
    BGZF deflate in C; output is byte-identical to io/bcf.py BcfWriter at
    the same zlib level.  Used by tests and by drivers that decode in
    Python but want native serialization.
    """

    def __init__(self, path: str, header_text: bytes, level: int = 6):
        lib = _lib()
        lib.bcf_emit_open.restype = ctypes.c_void_p
        lib.bcf_emit_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_uint32, ctypes.c_int]
        lib.bcf_emit_records.restype = ctypes.c_int
        lib.bcf_emit_records.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32]
        lib.bcf_emit_close.restype = ctypes.c_int
        lib.bcf_emit_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._e = lib.bcf_emit_open(path.encode(), header_text,
                                    len(header_text), level)
        if not self._e:
            raise OSError(f"bcf_emit_open failed for {path}")

    def write_batch(self, shared: bytes, sh_off: np.ndarray, prefix: bytes,
                    gt_bytes: np.ndarray) -> None:
        """gt_bytes: uint8 [n_rec, row_bytes]; sh_off: uint64 [n_rec+1]."""
        gt_bytes = np.ascontiguousarray(gt_bytes, np.uint8)
        sh_off = np.ascontiguousarray(sh_off, np.uint64)
        n_rec, row_bytes = gt_bytes.shape
        rc = self._lib.bcf_emit_records(
            self._e, shared,
            sh_off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            prefix, len(prefix),
            gt_bytes.ctypes.data_as(ctypes.c_char_p), n_rec, row_bytes)
        if rc != 0:
            raise OSError(f"bcf_emit_records failed ({rc})")

    def close(self) -> None:
        if self._e:
            rc = self._lib.bcf_emit_close(self._e)
            self._e = None
            if rc != 0:
                raise OSError(f"bcf_emit_close failed ({rc})")


class NativeGtBatchReader:
    """Batch BCF genotype reader (native/gt_batch.cpp) — the read-side
    counterpart of native_extract.  Python parses the header once and
    hands the record-stream offset + GT key to the native walker, which
    returns whole batches of (shared bytes, decoded int32 GT rows).

    Iterates (shared: bytes, gt: int32 ndarray, n_alleles: int,
    ploidy: int) in record order.  Reference analog: htslib
    bcf_read/bcf_get_genotypes driving the compressor
    (the xSqueezeIt reference's include/xcf.hpp traversal).
    """

    def __init__(self, path: str, header_skip: int, gt_key: int,
                 n_samples: int, batch_recs: int = 1024,
                 skip_recs: int = 0, start_voff: int = 0):
        lib = _lib()
        lib.xsi_gtb_open.restype = ctypes.c_void_p
        lib.xsi_gtb_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_uint64]
        lib.xsi_gtb_batch.restype = ctypes.c_int
        lib.xsi_gtb_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.xsi_gtb_error.restype = ctypes.c_char_p
        lib.xsi_gtb_error.argtypes = [ctypes.c_void_p]
        lib.xsi_gtb_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.xsi_gtb_open(path.encode(), header_skip, gt_key,
                                   n_samples, skip_recs, start_voff)
        if not self._h:
            raise OSError(f"native GT reader failed to open {path}")
        self.batch_recs = batch_recs
        self._alloc(max(n_samples, 1) * 2 * batch_recs + 64,
                    max(1 << 20, 512 * batch_recs))

    def _alloc(self, gt_cap: int, sh_cap: int) -> None:
        self._gt = np.empty(gt_cap, np.int32)
        self._sh = np.empty(sh_cap, np.uint8)
        self._gt_off = np.empty(self.batch_recs + 1, np.int64)
        self._sh_off = np.empty(self.batch_recs + 1, np.int64)
        self._na = np.empty(self.batch_recs, np.int32)
        self._pl = np.empty(self.batch_recs, np.int32)

    def _next_batch(self, max_recs: int | None = None) -> int:
        """Fill the internal buffers with the next batch; returns the
        record count (0 at EOF), growing the buffers on -5."""
        while True:
            n = self._lib.xsi_gtb_batch(
                self._h, min(max_recs or self.batch_recs, self.batch_recs),
                self._gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self._gt.shape[0],
                self._gt_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._sh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._sh.shape[0],
                self._sh_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._na.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self._pl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n == -5:
                # one record larger than the buffers: double and retry
                self._alloc(self._gt.shape[0] * 2, self._sh.shape[0] * 2)
                continue
            if n < 0:
                raise ValueError(
                    f"native BCF parse failed ({n}): "
                    f"{self._lib.xsi_gtb_error(self._h).decode()}")
            return n

    def iter_batches(self, limit: int | None = None):
        """Batch iteration for the compress hot loop: yields
        (gt_all, offs, na, pl, n) with OWNERSHIP of gt_all transferred to
        the consumer (the reader swaps in a fresh buffer for the next
        fill, exactly like the per-record __iter__; short batches copy the
        used region so a retained reference never pins the capacity
        allocation).  offs/na/pl are small copies.  Consumers may hold the
        arrays as long as they like — the dispatcher's block segments do,
        until the block's encode completes.

        `limit` bounds the TOTAL records parsed: a multihost worker's
        window may end mid-batch, and without the bound the final call
        would decode a whole batch of genotypes past the window (up to a
        full batch of wasted C-side GT decode per worker)."""
        remaining = limit
        while True:
            want = self.batch_recs
            if remaining is not None:
                if remaining <= 0:
                    return
                want = min(want, remaining)
            n = self._next_batch(want)
            if n == 0:
                return
            if remaining is not None:
                remaining -= n
            offs = self._gt_off[:n + 1].copy()
            if n >= self.batch_recs:
                gt_all = self._gt
                self._gt = np.empty_like(self._gt)
            else:
                gt_all = self._gt[: offs[n]].copy()
            yield (gt_all, offs, self._na[:n].copy(), self._pl[:n].copy(), n)

    def __iter__(self):
        while True:
            n = self._next_batch()
            if n == 0:
                return
            # Full batches: hand consumers views into THIS batch's gt
            # buffer and grab a fresh one for the next fill (consumers may
            # retain rows, e.g. the dispatcher's pending list) — one memory
            # pass instead of fill+copy.  Short batches (final/carry) copy
            # the used region instead: a retained view would otherwise pin
            # the whole capacity allocation (~266 MB at HRC width).
            sh_bytes = self._sh[: self._sh_off[n]].tobytes()
            offs = self._gt_off[: n + 1].copy()
            na = self._na[:n].copy()
            pl = self._pl[:n].copy()
            sh_offs = self._sh_off[: n + 1].copy()
            if n >= self.batch_recs:
                gt_all = self._gt
                self._gt = np.empty_like(self._gt)
            else:
                gt_all = self._gt[: offs[n]].copy()
            for r in range(n):
                gt = gt_all[offs[r]:offs[r + 1]]
                yield (sh_bytes[sh_offs[r]:sh_offs[r + 1]],
                       gt, int(na[r]), int(pl[r]))

    def close(self) -> None:
        if self._h:
            self._lib.xsi_gtb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBlockEncoder:
    """ctypes binding for the native GT block encoder (native/gt_encoder.cpp)
    — same interface as codec.gt_block.GtBlockEncoder, byte-identical
    payloads (pinned by tests/test_native_encode.py).  The host -c hot
    loop in C++: the compress counterpart of native_extract."""

    def __init__(self, n_samples: int, block_bcf_lines: int,
                 mac_threshold: int, default_phasing: int = 0,
                 aet_dtype=np.uint32, weirdness_strategy: int = 2):
        lib = _lib()
        lib.xsi_enc_open.restype = ctypes.c_void_p
        lib.xsi_enc_open.argtypes = [ctypes.c_int] * 6
        lib.xsi_enc_record.restype = ctypes.c_int
        lib.xsi_enc_record.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int]
        lib.xsi_enc_records.restype = ctypes.c_int
        lib.xsi_enc_records.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.xsi_enc_serialize.restype = ctypes.c_int64
        lib.xsi_enc_serialize.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.xsi_enc_bcf_lines.restype = ctypes.c_int
        lib.xsi_enc_bcf_lines.argtypes = [ctypes.c_void_p]
        lib.xsi_enc_error.restype = ctypes.c_char_p
        lib.xsi_enc_error.argtypes = [ctypes.c_void_p]
        lib.xsi_enc_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self.block_bcf_lines = block_bcf_lines
        self.n_samples = n_samples
        self._h = lib.xsi_enc_open(
            n_samples, block_bcf_lines, int(mac_threshold),
            int(default_phasing), np.dtype(aet_dtype).itemsize,
            int(weirdness_strategy))
        if not self._h:
            raise OSError("xsi_enc_open failed")
        self._lines = 0   # mirrored host-side: valid after close too

    @property
    def bcf_lines(self) -> int:
        return self._lines

    @property
    def full(self) -> bool:
        return self.bcf_lines >= self.block_bcf_lines

    def encode_record(self, gt: np.ndarray, n_alleles: int) -> None:
        if not self._h:
            raise RuntimeError("encoder already serialized/closed")
        gt = np.ascontiguousarray(gt, np.int32)
        rc = self._lib.xsi_enc_record(
            self._h, gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            gt.shape[0], int(n_alleles))
        if rc != 0:
            raise ValueError(self._lib.xsi_enc_error(self._h).decode())
        self._lines += 1

    def encode_records(self, gt_all: np.ndarray, offs: np.ndarray,
                       na: np.ndarray, lo: int, hi: int) -> None:
        """Batched encode_record over records [lo, hi): record i occupies
        gt_all[offs[i]:offs[i+1]] with na[i] alleles.  One ctypes crossing
        for the whole range (the per-record crossing dominates sparse
        blocks).  Payload bytes identical to per-record calls."""
        if not self._h:
            raise RuntimeError("encoder already serialized/closed")
        n = int(hi) - int(lo)
        if n <= 0:
            return
        assert gt_all.dtype == np.int32 and gt_all.flags.c_contiguous
        o = np.ascontiguousarray(offs[lo:hi + 1], np.int64)
        a = np.ascontiguousarray(na[lo:hi], np.int32)
        done = ctypes.c_int(0)
        rc = self._lib.xsi_enc_records(
            self._h, gt_all.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            o.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, ctypes.byref(done))
        self._lines += int(done.value)
        if rc != 0:
            raise ValueError(self._lib.xsi_enc_error(self._h).decode())

    def serialize(self) -> bytes:
        if not self._h:
            raise RuntimeError("encoder already serialized/closed")
        cap = 1 << 20
        while True:
            buf = np.empty(cap, np.uint8)
            n = self._lib.xsi_enc_serialize(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                cap)
            if n >= 0:
                out = buf[:n].tobytes()
                self.close()
                return out
            cap = -int(n)

    def close(self) -> None:
        if self._h:
            self._lib.xsi_enc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_offsets_state: dict = {}


def sparse_offsets_native(stream: np.ndarray, n_lines: int) -> np.ndarray:
    """Sparse-stream line-offset walk in C (gt_encoder.cpp
    xsi_sparse_offsets16/32) — semantics identical to the Python walks in
    ops/sparse_np.sparse_line_offsets (raises ValueError on a truncated
    stream).  stream dtype picks the head mask (A_T width)."""
    if not _offsets_state:
        lib = _lib()
        for name in ("xsi_sparse_offsets16", "xsi_sparse_offsets32"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int64)]
        _offsets_state["lib"] = lib
    lib = _offsets_state["lib"]
    stream = np.ascontiguousarray(stream)
    if stream.dtype == np.uint16:
        fn = lib.xsi_sparse_offsets16
    elif stream.dtype == np.uint32:
        fn = lib.xsi_sparse_offsets32
    else:
        raise TypeError(f"sparse stream dtype {stream.dtype}")
    out = np.empty(n_lines + 1, np.int64)
    rc = fn(stream.ctypes.data_as(ctypes.c_void_p), stream.shape[0],
            n_lines, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise ValueError("sparse stream truncated: line walk exceeds stream")
    return out


_ingest_state: dict = {}


def ingest_codes_native(gt_mat: np.ndarray, na: np.ndarray,
                        default_phasing: int, check_phase: bool):
    """One-pass batch ingest (gt_encoder.cpp xsi_ingest_codes): htslib gt
    matrix [n, W] int32 -> (codes int8 [n, W], miss[n], eov[n],
    alt_flat int64, alt_offs[n+1], nup_flags[n] bool).  Semantics
    identical to the numpy passes in encoder_base._encode_uniform_batch
    (the oracle; pinned by tests/test_encoder_batch.py).  Requires
    max(na) <= 127 (int8 codes) — callers fall back to numpy otherwise."""
    if not _ingest_state:
        lib = _lib()
        fn = lib.xsi_ingest_codes
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _ingest_state["fn"] = fn
    fn = _ingest_state["fn"]
    gt_mat = np.ascontiguousarray(gt_mat, np.int32)
    n, W = gt_mat.shape
    na = np.ascontiguousarray(na, np.int32)
    codes = np.empty((n, W), np.int8)
    miss = np.empty(n, np.int32)
    eov = np.empty(n, np.int32)
    alt_offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.maximum(na - 1, 0), out=alt_offs[1:])
    alt_flat = np.zeros(int(alt_offs[-1]), np.int64)
    nup = np.zeros(n, np.uint8)
    rc = fn(gt_mat.ctypes.data_as(ctypes.c_void_p),
            na.ctypes.data_as(ctypes.c_void_p), n, W,
            int(default_phasing), int(check_phase),
            codes.ctypes.data_as(ctypes.c_void_p),
            miss.ctypes.data_as(ctypes.c_void_p),
            eov.ctypes.data_as(ctypes.c_void_p),
            alt_flat.ctypes.data_as(ctypes.c_void_p),
            alt_offs.ctypes.data_as(ctypes.c_void_p),
            nup.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError("xsi_ingest_codes failed")
    return codes, miss, eov, alt_flat, alt_offs, nup.astype(bool)


_fmt_state: dict = {}


def format_gt_region_bytes_native(gt: np.ndarray, ploidy: int,
                                  n_samples: int) -> bytes:
    """Tab-separated VCF genotype region of one record via the native
    renderer (bcf_emit.cpp xsi_format_gt_region) — semantics identical to
    io/vcf.py format_gt (the oracle; pinned by tests/test_vcf_fast.py).
    Returns ASCII bytes (the binary VcfWriter consumes them directly).
    Not thread-safe (shared scratch buffer); record emission is
    single-threaded."""
    if not _fmt_state:
        lib = _lib()
        lib.xsi_format_gt_region.restype = ctypes.c_int64
        lib.xsi_format_gt_region.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        _fmt_state["lib"] = lib
        _fmt_state["buf"] = np.empty(1 << 16, np.uint8)
    lib = _fmt_state["lib"]
    gt = np.ascontiguousarray(gt, np.int32)
    while True:
        buf = _fmt_state["buf"]
        n = lib.xsi_format_gt_region(
            gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ploidy, n_samples,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.shape[0])
        if n >= 0:
            return buf[:n].tobytes()
        if n != -1:
            raise ValueError(f"xsi_format_gt_region failed ({n})")
        _fmt_state["buf"] = np.empty(buf.shape[0] * 2, np.uint8)



def native_extract_ranges(xsi_path: str, out_path: str, header_text: bytes,
                          gt_key: int, level: int = 6,
                          chunks=None, regions=None, targets=None) -> int:
    """Region/target-filtered native extract (native/xsi_extract.cpp
    xsi_extract_ranges).  chunks: [(beg_voff, end_voff)] CSI chunk pairs
    (None = stream whole file); regions/targets: (rid, start1, end1)
    triplets with INT64 sentinels for open bounds, pre-resolved by the
    Python driver (reference analog: htslib
    initialize_bcf_file_reader_with_region, xcf.cpp:115-139)."""
    lib = _lib()
    lib.xsi_extract_ranges.restype = ctypes.c_int64
    lib.xsi_extract_ranges.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_int32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.xsi_last_error.restype = ctypes.c_char_p

    def flat(arr, dtype):
        if not arr:
            return None, 0
        a = np.ascontiguousarray(np.asarray(arr, dtype).reshape(-1))
        return a, len(arr)

    ch, n_ch = flat(chunks, np.uint64)
    rg, n_rg = flat(regions, np.int64)
    tg, n_tg = flat(targets, np.int64)
    n = lib.xsi_extract_ranges(
        xsi_path.encode(), out_path.encode(), header_text, len(header_text),
        gt_key, level,
        ch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)) if n_ch else None,
        n_ch,
        rg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if n_rg else None,
        n_rg,
        tg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if n_tg else None,
        n_tg)
    if n < 0:
        raise OSError(f"native ranged extract failed ({n}): "
                      f"{lib.xsi_last_error().decode()}")
    return int(n)


def native_extract_segment(xsi_path: str, out_path: str, header_text: bytes,
                           gt_key: int, level: int,
                           start_blk: int, end_blk: int,
                           write_header: bool, write_eof: bool,
                           chunks=None) -> int:
    """BM-block-windowed native extract producing a BCF segment
    (records-only body when write_header/write_eof are False) — the
    multi-process decompress workers' fast path
    (parallel/distributed.decompress_file_multihost)."""
    lib = _lib()
    lib.xsi_extract_segment.restype = ctypes.c_int64
    lib.xsi_extract_segment.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_int32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.xsi_last_error.restype = ctypes.c_char_p
    ch, n_ch = None, 0
    if chunks:
        ch = np.ascontiguousarray(np.asarray(chunks, np.uint64).reshape(-1))
        n_ch = len(chunks)
    n = lib.xsi_extract_segment(
        xsi_path.encode(), out_path.encode(), header_text, len(header_text),
        gt_key, level,
        ch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)) if n_ch else None,
        n_ch, None, 0, None, 0,
        start_blk, end_blk, int(write_header), int(write_eof))
    if n < 0:
        raise OSError(f"native segment extract failed ({n}): "
                      f"{lib.xsi_last_error().decode()}")
    return int(n)


def native_var_pass(in_path: str, header_skip: int, out_path: str,
                    header_text: bytes, level: int, bm_prefix: bytes,
                    block_length: int, gt_key: int, cap_hint: int = 0):
    """Native variant-file pass (native/var_pass.cpp): walks the input
    BCF's records, writes the `_var.bcf` (patched shared + FORMAT/BM),
    and returns the CSI tuples + counters for the Python CsiBuilder.

    Returns (rid, pos, rlen, bm, vbeg, vend arrays sliced to n,
    n_variants, max_ploidy).  Raises ValueError on ploidy > 2 (driver
    parity) and OSError on I/O or malformed input."""
    lib = _lib()
    lib.xsi_var_pass.restype = ctypes.c_int64
    lib.xsi_var_pass.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    cap = max(int(cap_hint), 1 << 16)
    while True:
        rid = np.empty(cap, np.int32)
        pos = np.empty(cap, np.int32)
        rlen = np.empty(cap, np.int32)
        bm = np.empty(cap, np.int32)
        vbeg = np.empty(cap, np.uint64)
        vend = np.empty(cap, np.uint64)
        nv = ctypes.c_int64(0)
        mp = ctypes.c_int64(0)

        def p32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

        n = lib.xsi_var_pass(
            in_path.encode(), header_skip, out_path.encode(), header_text,
            len(header_text), level, bm_prefix, len(bm_prefix),
            block_length, gt_key, p32(rid), p32(pos), p32(rlen), p32(bm),
            p64(vbeg), p64(vend), cap, ctypes.byref(nv), ctypes.byref(mp))
        if n == -5:
            cap *= 4
            continue
        if n == -4:
            raise ValueError("Ploidy higher than 2 is not yet supported")
        if n == -3:
            raise ValueError(
                "BM offset cannot be represented on 15 bits")
        if n < 0:
            raise OSError(f"native variant pass failed ({n})")
        n = int(n)
        return (rid[:n], pos[:n], rlen[:n], bm[:n], vbeg[:n], vend[:n],
                int(nv.value), int(mp.value))


def native_var_pass_segment(in_path: str, out_path: str, header_text: bytes,
                            level: int, bm_prefix: bytes, block_length: int,
                            gt_key: int, start_voff: int, start_entry: int,
                            max_recs: int, write_header: bool,
                            header_skip: int = 0, cap_hint: int = 0):
    """Windowed variant pass (distributed form): seek to `start_voff`,
    render `max_recs` records starting at global ordinal `start_entry`
    (a block boundary) into a records-only BGZF body segment (or a
    header-carrying one for rank 0).  vbeg/vend are segment-local
    voffsets; the assembler shifts them by the preceding bytes << 16.
    Same outputs as native_var_pass."""
    lib = _lib()
    lib.xsi_var_pass_segment.restype = ctypes.c_int64
    lib.xsi_var_pass_segment.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    cap = max(int(cap_hint), max_recs if max_recs > 0 else 0, 1 << 16)
    while True:
        rid = np.empty(cap, np.int32)
        pos = np.empty(cap, np.int32)
        rlen = np.empty(cap, np.int32)
        bm = np.empty(cap, np.int32)
        vbeg = np.empty(cap, np.uint64)
        vend = np.empty(cap, np.uint64)
        nv = ctypes.c_int64(0)
        mp = ctypes.c_int64(0)

        def p32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

        n = lib.xsi_var_pass_segment(
            in_path.encode(), header_skip, out_path.encode(), header_text,
            len(header_text), level, bm_prefix, len(bm_prefix),
            block_length, gt_key, start_voff, start_entry,
            max_recs, 1 if write_header else 0, 0,
            p32(rid), p32(pos), p32(rlen), p32(bm),
            p64(vbeg), p64(vend), cap, ctypes.byref(nv), ctypes.byref(mp))
        if n == -5:
            cap *= 4
            continue
        if n == -4:
            raise ValueError("Ploidy higher than 2 is not yet supported")
        if n == -3:
            raise ValueError(
                "BM offset cannot be represented on 15 bits")
        if n < 0:
            raise OSError(f"native variant pass segment failed ({n})")
        n = int(n)
        return (rid[:n], pos[:n], rlen[:n], bm[:n], vbeg[:n], vend[:n],
                int(nv.value), int(mp.value))
