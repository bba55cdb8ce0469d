"""Unified genotype-file input: VCF text (.vcf/.vcf.gz) or BCF.

Yields records carrying both the raw BCF shared block (site columns) and the
htslib-style genotype array, so downstream stages are format-agnostic.
The port's copy of xsqueezeit_tpu/io/unified.py: BCF records and the
record count come from the native batch reader and frame walk
(interop/native.py) unless XSI_NATIVE_PARSE=0 or XSI_NATIVE=0, which
take the Python reader and a Python frame walk.  A native failure raises.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..interop import native
from .bcf import BCF_MAGIC, BcfHeader, BcfReader
from .bgzf import BgzfReader
from .sites import encode_shared_from_vcf_cols
from .vcf import VcfReader


@dataclass
class GtInputRecord:
    shared: bytes          # BCF shared block (n_fmt/n_sample word unspecified)
    gt: np.ndarray | None  # int32 gt array
    n_alleles: int
    ploidy: int


def sniff_format(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"\x1f\x8b":
        # gzip container: BCF or vcf.gz -- peek decompressed magic.
        # Plain-gzip (non-BGZF) .vcf.gz is accepted like htslib does;
        # gzip.open decodes both framings (BGZF is valid gzip).
        import gzip
        with gzip.open(path, "rb") as r:
            magic = r.read(5)
        return "bcf" if magic == BCF_MAGIC else "vcf"
    if head[:3] == b"BCF":
        return "bcf"
    return "vcf"


class _PastTheEnd:
    """The batch reader of a stream skipped past its last record."""

    def __iter__(self):
        return iter(())

    def iter_batches(self, limit=None):
        return iter(())

    def close(self) -> None:
        pass


class GtInput:
    """Opens a VCF/BCF and exposes header info + record iteration."""

    def __init__(self, path: str):
        self.path = path
        self.format = sniff_format(path)
        self._consumed = 0      # records advanced past (iteration or skip)
        self._py_consumed = 0   # records the PYTHON _bcf reader advanced
        self._seek_voff = 0     # seek_fast's frame offset (0: none)
        self._seek_consumed = 0
        self._native = None
        if self.format == "bcf":
            self._bcf = BcfReader(path)
            self.header = self._bcf.header
            self.samples = self.header.samples
        else:
            self._vcf = VcfReader(path)
            self.samples = self._vcf.samples
            header_text = "\n".join(self._vcf.header_lines)
            self.header = BcfHeader.from_text(
                header_text + "\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                + ("\tFORMAT\t" + "\t".join(self.samples) if self.samples else ""))

    def _native_reader(self):
        """The native batch GT walker (interop/native.NativeGtBatchReader):
        ~an order of magnitude faster than the Python record parse, which
        is the compress pipeline's ceiling.  None when XSI_NATIVE_PARSE=0
        (or XSI_NATIVE=0) or the header has no GT key; a build or open
        failure raises."""
        if not native.enabled("XSI_NATIVE_PARSE"):
            return None
        gt_key = self.header.str2idx.get("GT")
        if gt_key is None:
            return None
        # record stream starts after magic(5) + l_text(4) + header text;
        # records already consumed through THIS GtInput (skip_records /
        # a partial prior iteration) are frame-skipped natively so both
        # parsers expose the same stream position semantics.
        skip = 9 + self._bcf.header_text_len
        voff = self._seek_voff
        base = self._seek_consumed if voff else 0
        try:
            return native.NativeGtBatchReader(
                self.path, skip, gt_key, len(self.samples),
                skip_recs=self._consumed - base, start_voff=voff)
        except OSError:
            # the open frame-skips the records consumed so far and fails
            # on a skip past the end: that window iterates empty
            if (self._consumed - base > 0 and not voff
                    and self._consumed >= count_entries(self.path)):
                return _PastTheEnd()
            raise

    def __iter__(self):
        if self.format == "bcf":
            reader = self._native_reader()
            if reader is not None:
                self._native = reader
                try:
                    for shared, gt, n_alleles, ploidy in reader:
                        self._consumed += 1
                        # ploidy 0 = record without usable GT (Python
                        # reader parity: gt is None, consumers skip)
                        yield GtInputRecord(shared,
                                            gt if ploidy > 0 else None,
                                            n_alleles, ploidy)
                finally:
                    reader.close()
                    self._native = None
                return
            self._reconcile_py_position()
            for rec in self._bcf:
                self._consumed += 1
                self._py_consumed += 1
                out = rec.genotypes()
                gt, ploidy = out if out is not None else (None, 0)
                yield GtInputRecord(rec.shared, gt, rec.n_allele, ploidy)
        else:
            for rec in self._vcf:
                shared = encode_shared_from_vcf_cols(
                    self.header, rec.fixed, 0, 0)
                yield GtInputRecord(shared, rec.gt, rec.n_alleles, rec.ploidy)

    def iter_gt_batches(self, limit: int | None = None):
        """Batch GT iteration for the compress hot loop: a generator of
        (gt_all, offs, na, pl, n) with gt_all OWNERSHIP transferred to the
        consumer (interop.native.NativeGtBatchReader.iter_batches swaps in
        a fresh buffer per full batch), so consumers may hold references
        across async block encodes without copying — the dispatcher's
        segment blocks do.  Returns None when the native batch reader is
        off (VCF text, XSI_NATIVE_PARSE=0, no GT key); callers take
        per-record iteration.  `limit` bounds the records PARSED (a
        multihost worker's window; without it the tail batch decodes past
        the window)."""
        if self.format != "bcf":
            return None
        reader = self._native_reader()
        if reader is None:
            return None
        # registered like __iter__'s reader so close() reaches a partially
        # consumed stream (error paths break/raise before exhaustion)
        self._native = reader

        def gen():
            try:
                for batch in reader.iter_batches(limit):
                    self._consumed += batch[4]
                    yield batch
            finally:
                reader.close()
                if self._native is reader:
                    self._native = None

        return gen()

    def iter_sites(self):
        """Sites-only iteration: GtInputRecord with gt=None but real
        n_alleles/ploidy, skipping genotype value decode (BCF reads only
        the GT type descriptor; VCF counts separators).  Used by the
        distributed variant pass, where genotypes are encoded by other
        workers and decoding them here would serialize the pipeline."""
        if self.format == "bcf":
            self._reconcile_py_position()
            for rec in self._bcf:
                self._consumed += 1
                self._py_consumed += 1
                yield GtInputRecord(rec.shared, None, rec.n_allele,
                                    rec.gt_ploidy())
        else:
            for rec in self._vcf.iter_sites():
                shared = encode_shared_from_vcf_cols(
                    self.header, rec.fixed, 0, 0)
                yield GtInputRecord(shared, None, rec.n_alleles, rec.ploidy)

    def skip_records(self, n: int) -> int:
        """Fast-forward past n records without parsing site/genotype data.
        BCF: LAZY — returns n unconditionally (the skip is applied when
        iteration positions the parser; beyond-EOF skips iterate empty).
        VCF: raw line reads, short at EOF."""
        if n <= 0:
            return 0
        if self.format == "bcf":
            # LAZY: only the consumed counter advances here.  Whichever
            # parser serves the next iteration positions itself from it
            # (the native reader frame-skips in C, the Python branch
            # reconciles via _reconcile_py_position) — an eager Python
            # skip would decompress the prefix a second time under the
            # native parser (multi-process workers pay that per worker).
            self._consumed += n
            return n
        done = 0
        for line in self._vcf._f:
            if line.strip():
                done += 1
                if done >= n:
                    break
        return done

    def seek_fast(self, n_consumed: int, voffset: int) -> None:
        """Position the stream at record `n_consumed` whose frame starts
        at BGZF virtual offset `voffset` (from count_entries_offsets) —
        O(1), no prefix decompression.  BCF only."""
        self._consumed = n_consumed
        self._py_consumed = n_consumed
        self._seek_voff = voffset
        self._seek_consumed = n_consumed
        self._bcf.seek_virtual(voffset)

    def _reconcile_py_position(self) -> None:
        behind = self._consumed - self._py_consumed
        if behind > 0:
            self._py_consumed += self._bcf.skip_records(behind)

    def close(self):
        if self._native is not None:
            self._native.close()
            self._native = None
        if self.format == "bcf":
            self._bcf.close()
        else:
            self._vcf.close()


def sniff_default_phased(path: str, limit: int = 3) -> int:
    """Majority phasedness of the second allele over the first `limit` records
    (reference: xcf.cpp seek_default_phased)."""
    inp = GtInput(path)
    counts = [0, 0]
    n = 0
    for rec in inp:
        if rec.gt is None:
            continue
        if rec.ploidy == 1:
            inp.close()
            return 0
        second = rec.gt.reshape(-1, rec.ploidy)[:, 1]
        phased = int((second & 1).sum())
        counts[1] += phased
        counts[0] += second.shape[0] - phased
        n += 1
        if n >= limit:
            break
    inp.close()
    return 1 if counts[1] >= counts[0] else 0


def sniff_max_ploidy_first_entry(path: str) -> int:
    inp = GtInput(path)
    for rec in inp:
        inp.close()
        return rec.ploidy if rec.gt is not None else 0
    inp.close()
    return 0


def _scan_cache_path(path: str) -> str:
    return path + ".gtscan"


def _scan_cache_load(path: str, every: int):
    """Validated sidecar scan index, or None.  The scan is a full-input
    serial pass per process (the multihost Amdahl floor once encode is
    parallel); like htslib's .csi, a sidecar amortizes it across runs.
    Gated by XSI_SCAN_CACHE=1 (writing files next to user inputs is
    opt-in)."""
    if os.environ.get("XSI_SCAN_CACHE", "0") in ("0", "off", "no"):
        return None
    try:
        st = os.stat(path)
        with np.load(_scan_cache_path(path)) as z:
            if (int(z["size"]) != st.st_size
                    or int(z["mtime_ns"]) != st.st_mtime_ns):
                return None
            stored = int(z["every"])
            voffs = z["voffs"]
            if stored == every:
                return int(z["count"]), (voffs if voffs.size else None)
            if every == 0:      # count-only request: any entry serves
                return int(z["count"]), None
            if stored > 0 and voffs.size and every % stored == 0:
                return int(z["count"]), voffs[::every // stored]
    except (OSError, KeyError, ValueError):
        pass    # no sidecar, or one that is not ours: scan the input
    return None


def _scan_cache_store(path: str, every: int, count: int, voffs) -> None:
    import tempfile
    if os.environ.get("XSI_SCAN_CACHE", "0") in ("0", "off", "no"):
        return
    try:
        st = os.stat(path)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".gtscan.npz")
        os.close(fd)
        np.savez(tmp, size=st.st_size, mtime_ns=st.st_mtime_ns,
                 every=every, count=count,
                 voffs=voffs if voffs is not None else np.zeros(0, np.uint64))
        os.replace(tmp, _scan_cache_path(path))
    except OSError:
        pass    # read-only dir, races: the cache is best-effort


def count_entries_offsets(path: str, every: int
                          ) -> tuple[int, "np.ndarray | None"]:
    """(record count, BGZF virtual offsets of records 0, every, 2*every..)
    for a BCF — one native frame walk (a Python one with
    XSI_NATIVE_PARSE=0); the offsets let workers seek straight to their
    block range (no prefix decompression).  Returns (count, None) for VCF
    text or every <= 0.  XSI_SCAN_CACHE=1 reads/writes a
    `<path>.gtscan` sidecar (size+mtime validated) so repeated runs skip
    the pass entirely."""
    cached = _scan_cache_load(path, every)
    if cached is not None:
        return cached
    count, voffs = _count_entries_offsets_uncached(path, every)
    if every > 0:     # count-only results never overwrite a finer index
        _scan_cache_store(path, every, count, voffs)
    return count, voffs


def _count_entries_offsets_uncached(path: str, every: int
                                    ) -> tuple[int, "np.ndarray | None"]:
    if sniff_format(path) != "bcf":
        return count_entries(path), None
    if not native.enabled("XSI_NATIVE_PARSE"):
        return _count_entries_offsets_py(path, every)
    import ctypes
    import struct

    lib = native.load_library()
    lib.xsi_bcf_count_offsets.restype = ctypes.c_int64
    lib.xsi_bcf_count_offsets.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
    r0 = BgzfReader(path)
    r0.read(5)
    (l_text,) = struct.unpack("<I", r0.read(4))
    r0.close()
    if every > 0:
        cap = max(os.path.getsize(path) // 28 // every + 2, 16)
        voffs = np.zeros(cap, np.uint64)
        vp = voffs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    else:
        cap, voffs, vp = 0, None, None
    n = lib.xsi_bcf_count_offsets(path.encode(), 9 + l_text, every, vp, cap)
    if n < 0:
        raise ValueError(f"{path}: corrupt or truncated BCF record stream")
    if every <= 0:
        return int(n), None
    n_marks = min((int(n) + every - 1) // every, cap)
    return int(n), voffs[:n_marks]


def _count_entries_offsets_py(path: str, every: int
                              ) -> tuple[int, "np.ndarray | None"]:
    """The frame walk of xsi_bcf_count_offsets on BcfReader: the virtual
    offset of a record's frame is taken before it is skipped."""
    r = BcfReader(path)
    try:
        n = 0
        marks = []
        while True:
            mark = every > 0 and n % every == 0
            voff = r.tell_virtual() if mark else 0
            if not r.skip_records(1):
                break
            if mark:
                marks.append(voff)
            n += 1
    finally:
        r.close()
    if every <= 0:
        return n, None
    return n, np.asarray(marks, np.uint64)


def count_entries(path: str) -> int:
    """Number of variant records in a VCF/BCF (reference: count_entries,
    xcf.cpp:318-340).  BCF records are skipped without decoding genotypes
    (natively unless XSI_NATIVE_PARSE=0 — count_entries_offsets)."""
    fmt = sniff_format(path)
    if fmt == "bcf":
        n, _ = count_entries_offsets(path, 0)
        return n
    from .vcf import VcfReader
    n = 0
    v = VcfReader(path)
    for _ in v:
        n += 1
    v.close()
    return n

