"""BCF 2.2 reader/writer (native Python implementation of the binary VCF spec).

Replaces htslib for this framework's needs: reading arbitrary BCF inputs,
writing the `_var.bcf` variant file (samples replaced by the BIN_MATRIX_POS
pseudo-sample carrying FORMAT/BM), and rendering records back to VCF text.

Spec: https://samtools.github.io/hts-specs/ (BCFv2.2).  Layout summary:

    "BCF\\2\\2" | l_text:u32 | header text (NUL-terminated VCF header)
    records: l_shared:u32 l_indiv:u32
      shared: rid:s32 pos:s32 rlen:s32 qual:f32
              (n_allele<<16|n_info):u32 (n_fmt<<24|n_sample):u32
              id:typed_str alleles:typed_str*n_allele filter:typed_int_vec
              info: n_info * (typed_int_key, typed_value)
      indiv:  n_fmt * (typed_int_key, value_type_descriptor,
                       n_sample * fixed-length values)

All multi-byte values little-endian; the whole stream lives in BGZF blocks.
"""
from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BgzfReader, BgzfWriter

BCF_MAGIC = b"BCF\x02\x02"

# typed-value type codes
T_MISSING = 0
T_INT8 = 1
T_INT16 = 2
T_INT32 = 3
T_FLOAT = 5
T_CHAR = 7

INT8_MISSING = -128
INT8_EOV = -127
INT16_MISSING = -32768
INT16_EOV = -32767
INT32_MISSING = -2147483648
INT32_EOV = -2147483647
FLOAT_MISSING_BITS = 0x7F800001
FLOAT_EOV_BITS = 0x7F800002
QUAL_MISSING = struct.unpack("<f", struct.pack("<I", FLOAT_MISSING_BITS))[0]

_INT_SPECS = {
    T_INT8: ("<b", 1, INT8_MISSING, INT8_EOV),
    T_INT16: ("<h", 2, INT16_MISSING, INT16_EOV),
    T_INT32: ("<i", 4, INT32_MISSING, INT32_EOV),
}

_TYPE_SIZE = {T_MISSING: 0, T_INT8: 1, T_INT16: 2, T_INT32: 4,
              T_FLOAT: 4, T_CHAR: 1}


# ---------------------------------------------------------------------------
# typed values
# ---------------------------------------------------------------------------
def pack_typed_int(v: int) -> bytes:
    """A single integer as a (1, intN) typed value, smallest width."""
    if -120 <= v <= 127:
        return bytes([(1 << 4) | T_INT8]) + struct.pack("<b", v)
    if -32000 <= v <= 32767:
        return bytes([(1 << 4) | T_INT16]) + struct.pack("<h", v)
    return bytes([(1 << 4) | T_INT32]) + struct.pack("<i", v)


def pack_type_descriptor(type_code: int, length: int) -> bytes:
    if length < 15:
        return bytes([(length << 4) | type_code])
    return bytes([(15 << 4) | type_code]) + pack_typed_int(length)


def pack_typed_string(s: str) -> bytes:
    b = s.encode()
    return pack_type_descriptor(T_CHAR, len(b)) + b


def pack_typed_int_vector(vals: list[int]) -> bytes:
    if not vals:
        return bytes([T_MISSING])
    lo, hi = min(vals), max(vals)
    if -120 <= lo and hi <= 127:
        t = T_INT8
    elif -32000 <= lo and hi <= 32767:
        t = T_INT16
    else:
        t = T_INT32
    fmt, size, _, _ = _INT_SPECS[t]
    return (pack_type_descriptor(t, len(vals))
            + b"".join(struct.pack(fmt, v) for v in vals))


def pack_typed_float_vector(vals: list[float]) -> bytes:
    out = pack_type_descriptor(T_FLOAT, len(vals))
    parts = []
    for v in vals:
        if v is None:
            parts.append(struct.pack("<I", FLOAT_MISSING_BITS))
        else:
            parts.append(struct.pack("<f", v))
    return out + b"".join(parts)


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read_type(self) -> tuple[int, int]:
        d = self.buf[self.pos]
        self.pos += 1
        t = d & 0x0F
        n = d >> 4
        if n == 15:
            n = self.read_typed_scalar_int()
        return t, n

    def read_typed_scalar_int(self) -> int:
        t, n = self.read_type()
        fmt, size, _, _ = _INT_SPECS[t]
        v = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += size * n
        return v

    def read_values(self, t: int, n: int):
        if t == T_MISSING or n == 0:
            return []
        if t == T_CHAR:
            s = self.buf[self.pos:self.pos + n].decode(errors="replace")
            self.pos += n
            return s
        if t == T_FLOAT:
            vals = np.frombuffer(self.buf, "<f4", n, self.pos).copy()
            self.pos += 4 * n
            return vals
        fmt, size, _, _ = _INT_SPECS[t]
        dt = {T_INT8: "<i1", T_INT16: "<i2", T_INT32: "<i4"}[t]
        vals = np.frombuffer(self.buf, dt, n, self.pos).copy()
        self.pos += size * n
        return vals


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------
_IDX_RE = re.compile(r"[<,]IDX=(\d+)")
_ID_RE = re.compile(r"[<,]ID=([^,>]+)")
_NUMBER_RE = re.compile(r"[<,]Number=([^,>]+)")
_TYPE_RE = re.compile(r"[<,]Type=([^,>]+)")
_LENGTH_RE = re.compile(r"[<,]length=(\d+)")


@dataclass
class BcfHeader:
    lines: list[str] = field(default_factory=list)  # ## lines, verbatim
    samples: list[str] = field(default_factory=list)
    # string dictionary (FILTER/INFO/FORMAT ids) and contig dictionary
    dict_strings: list[str] = field(default_factory=list)
    dict_contigs: list[str] = field(default_factory=list)
    str2idx: dict[str, int] = field(default_factory=dict)
    contig2idx: dict[str, int] = field(default_factory=dict)
    info_meta: dict[str, tuple[str, str]] = field(default_factory=dict)  # id -> (Number, Type)
    format_meta: dict[str, tuple[str, str]] = field(default_factory=dict)
    contig_lengths: dict[str, int] = field(default_factory=dict)  # from length=
    explicit_idx: bool = False
    frozen: bool = False  # set once serialized; new dict keys then error

    @staticmethod
    def _assign(entries: list[tuple[str, int | None]]) -> list[str]:
        """Build a dictionary table from (ident, explicit_idx_or_None) pairs
        in order of appearance (htslib semantics: explicit slots first, the
        rest fill free slots in order)."""
        explicit = {i for _, i in entries if i is not None}
        size = (max(explicit) + 1) if explicit else 0
        table: list[str | None] = [None] * size
        # place explicit
        for ident, idx in entries:
            if idx is not None:
                while idx >= len(table):
                    table.append(None)
                table[idx] = ident
        # fill implicit in order
        free = 0
        for ident, idx in entries:
            if idx is None:
                while free < len(table) and table[free] is not None:
                    free += 1
                if free < len(table):
                    table[free] = ident
                else:
                    table.append(ident)
        return [s if s is not None else f"__gap{i}__" for i, s in enumerate(table)]

    @classmethod
    def from_text(cls, text: str) -> "BcfHeader":
        h = cls()
        h.explicit_idx = "IDX=" in text
        str_entries: list[tuple[str, int | None]] = []
        contig_entries: list[tuple[str, int | None]] = []
        seen_str: set[str] = set()
        seen_ctg: set[str] = set()
        has_pass = False

        for line in text.splitlines():
            if line.startswith("#CHROM"):
                cols = line.split("\t")
                h.samples = cols[9:] if len(cols) > 9 else []
                continue
            if not line.startswith("##"):
                continue
            h.lines.append(line)
            key = line[2:].split("=", 1)[0]
            idm = _ID_RE.search(line)
            idxm = _IDX_RE.search(line)
            idx = int(idxm.group(1)) if (h.explicit_idx and idxm) else None
            if key in ("FILTER", "INFO", "FORMAT") and idm:
                ident = idm.group(1)
                if ident == "PASS":
                    has_pass = True
                if ident not in seen_str:
                    seen_str.add(ident)
                    str_entries.append((ident, idx))
                num_m = _NUMBER_RE.search(line)
                type_m = _TYPE_RE.search(line)
                meta = (num_m.group(1) if num_m else ".",
                        type_m.group(1) if type_m else "String")
                if key == "INFO":
                    h.info_meta[ident] = meta
                elif key == "FORMAT":
                    h.format_meta[ident] = meta
            elif key == "contig" and idm:
                ident = idm.group(1)
                if ident not in seen_ctg:
                    seen_ctg.add(ident)
                    contig_entries.append((ident, idx))
                lm = _LENGTH_RE.search(line)
                if lm:
                    h.contig_lengths[ident] = int(lm.group(1))
        if not has_pass:
            # PASS is always index 0 when not declared
            str_entries.insert(0, ("PASS", 0 if any(
                i is not None for _, i in str_entries) else None))
        h.dict_strings = cls._assign(str_entries)
        h.str2idx = {s: i for i, s in enumerate(h.dict_strings)}
        h.dict_contigs = cls._assign(contig_entries)
        h.contig2idx = {s: i for i, s in enumerate(h.dict_contigs)}
        return h

    def to_text(self) -> str:
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.samples:
            cols += ["FORMAT"] + list(self.samples)
        return "\n".join(self.lines + ["\t".join(cols)]) + "\n"

    def _with_idx(self, line: str, idx: int) -> str:
        if self.explicit_idx and line.endswith(">"):
            return line[:-1] + f",IDX={idx}>"
        return line

    def freeze(self) -> None:
        """Mark the header serialized.  Declaring new dictionary entries
        after the header bytes went to disk would write records whose
        FILTER/INFO/FORMAT keys the on-disk header never declares — a
        self-inconsistent file.  htslib prevents this structurally
        (bcf_update_info_int32 refuses undeclared tags, relied on by the
        reference at gt_decompressor_new.hpp:251-252); here ensure_string /
        ensure_contig on a NEW ident raise instead."""
        self.frozen = True

    def _register_meta(self, line: str) -> None:
        """Record Number/Type for an INFO/FORMAT declaration added via
        ensure_string, so value encoding honors the declared type."""
        key = line[2:].split("=", 1)[0]
        if key not in ("INFO", "FORMAT"):
            return
        idm = _ID_RE.search(line)
        if not idm:
            return
        num_m = _NUMBER_RE.search(line)
        type_m = _TYPE_RE.search(line)
        meta = (num_m.group(1) if num_m else ".",
                type_m.group(1) if type_m else "String")
        (self.info_meta if key == "INFO" else self.format_meta)[
            idm.group(1)] = meta

    def ensure_string(self, ident: str, header_line: str | None = None) -> int:
        if ident not in self.str2idx:
            if self.frozen:
                raise ValueError(
                    f"BCF header already serialized: cannot declare new "
                    f"dictionary key {ident!r} (records would carry a tag "
                    f"the written header does not declare)")
            idx = len(self.dict_strings)
            self.str2idx[ident] = idx
            self.dict_strings.append(ident)
            if header_line:
                line = self._with_idx(header_line, idx)
                self.lines.append(line)
                self._register_meta(line)
        return self.str2idx[ident]

    def ensure_contig(self, ident: str) -> int:
        if ident not in self.contig2idx:
            if self.frozen:
                raise ValueError(
                    f"BCF header already serialized: cannot declare new "
                    f"contig {ident!r}")
            idx = len(self.dict_contigs)
            self.contig2idx[ident] = idx
            self.dict_contigs.append(ident)
            self.lines.append(self._with_idx(f"##contig=<ID={ident}>", idx))
        return self.contig2idx[ident]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------
@dataclass
class BcfRecord:
    rid: int
    pos: int            # 0-based
    rlen: int
    qual: float | None
    n_allele: int
    n_info: int
    n_fmt: int
    n_sample: int
    shared: bytes       # raw shared block (for fast variant-file rewrites)
    indiv: bytes        # raw indiv block
    # lazily parsed pieces
    _id: str | None = None
    _alleles: list[str] | None = None
    _after_alleles: int = 0  # cursor offset of FILTER within shared

    _FIXED = 24  # rid..n_fmt_sample

    @classmethod
    def parse(cls, shared: bytes, indiv: bytes) -> "BcfRecord":
        rid, pos, rlen = struct.unpack_from("<iii", shared, 0)
        (qual_bits,) = struct.unpack_from("<I", shared, 12)
        qual = None if qual_bits == FLOAT_MISSING_BITS else \
            struct.unpack_from("<f", shared, 12)[0]
        (n_allele_info,) = struct.unpack_from("<I", shared, 16)
        (n_fmt_sample,) = struct.unpack_from("<I", shared, 20)
        return cls(rid=rid, pos=pos, rlen=rlen, qual=qual,
                   n_allele=n_allele_info >> 16, n_info=n_allele_info & 0xFFFF,
                   n_fmt=n_fmt_sample >> 24, n_sample=n_fmt_sample & 0xFFFFFF,
                   shared=shared, indiv=indiv)

    def _parse_site(self):
        if self._alleles is not None:
            return
        c = _Cursor(self.shared, self._FIXED)
        t, n = c.read_type()
        v = c.read_values(t, n)
        self._id = v if isinstance(v, str) else ""
        alleles = []
        for _ in range(self.n_allele):
            t, n = c.read_type()
            alleles.append(c.read_values(t, n))
        self._alleles = alleles
        self._filter_pos = c.pos

    @property
    def id(self) -> str:
        self._parse_site()
        return self._id or "."

    @property
    def alleles(self) -> list[str]:
        self._parse_site()
        return self._alleles

    def filters(self) -> list[int]:
        self._parse_site()
        c = _Cursor(self.shared, self._filter_pos)
        t, n = c.read_type()
        vals = c.read_values(t, n)
        self._info_pos = c.pos
        return [int(x) for x in vals] if not isinstance(vals, str) else []

    def info_fields(self) -> list[tuple[int, object]]:
        self.filters()
        c = _Cursor(self.shared, self._info_pos)
        out = []
        for _ in range(self.n_info):
            key = c.read_typed_scalar_int()
            t, n = c.read_type()
            vals = c.read_values(t, n)
            out.append((key, t, vals))
        return out

    def format_fields(self) -> list[tuple[int, int, int, np.ndarray | str]]:
        """Returns [(key_idx, type, per_sample_len, values flat)]."""
        c = _Cursor(self.indiv, 0)
        out = []
        for _ in range(self.n_fmt):
            key = c.read_typed_scalar_int()
            t, per = c.read_type()
            total = per * self.n_sample
            vals = c.read_values(t, total)
            out.append((key, t, per, vals))
        return out

    def gt_ploidy(self) -> int:
        """FORMAT/GT vector length read from the typed descriptors alone
        (no value decode) — the cheap ploidy probe for sites-only scans.
        Returns 0 when the record carries no GT field."""
        assert self._header is not None
        gt_idx = self._header.str2idx.get("GT")
        if gt_idx is None:
            return 0
        c = _Cursor(self.indiv, 0)
        for _ in range(self.n_fmt):
            key = c.read_typed_scalar_int()
            t, per = c.read_type()
            if key == gt_idx:
                return per
            c.pos += _TYPE_SIZE[t] * per * self.n_sample
        return 0

    def genotypes(self) -> tuple[np.ndarray, int] | None:
        """FORMAT/GT as an htslib-style int32 array, or None.

        Special int values map to: missing -> 0 (allele -1 slot with phase
        bit preserved? no -- BCF GT missing entries are stored as int 0
        (allele -1 unphased) or 1; the INT*_MISSING sentinel should not
        appear in GT), EOV -> INT32_VECTOR_END.
        """
        for key, t, per, vals in self._format_with_ids():
            if key == "GT":
                fmt, _, miss, eov = _INT_SPECS[t]
                arr = np.asarray(vals).astype(np.int32)
                arr[np.asarray(vals) == eov] = INT32_EOV
                arr[np.asarray(vals) == miss] = INT32_MISSING
                return arr, per
        return None

    _header: BcfHeader | None = None

    def _format_with_ids(self):
        assert self._header is not None
        for key, t, per, vals in self.format_fields():
            yield self._header.dict_strings[key], t, per, vals


# ---------------------------------------------------------------------------
# reader / writer
# ---------------------------------------------------------------------------
class BcfReader:
    def __init__(self, path: str):
        self._f = BgzfReader(path)
        magic = self._f.read(5)
        if magic != BCF_MAGIC:
            raise ValueError(f"{path}: not a BCF2.2 file")
        (l_text,) = struct.unpack("<I", self._f.read(4))
        text = self._f.read(l_text).rstrip(b"\0").decode()
        self.header = BcfHeader.from_text(text)
        self.header_text = text
        self.header_text_len = l_text   # on-disk length incl. NUL padding

    def __iter__(self):
        while True:
            rec = self.read_record()
            if rec is None:
                return
            yield rec

    def read_record(self) -> BcfRecord | None:
        head = self._f.read(8)
        if len(head) < 8:
            return None
        l_shared, l_indiv = struct.unpack("<II", head)
        shared = self._f.read(l_shared)
        indiv = self._f.read(l_indiv)
        rec = BcfRecord.parse(shared, indiv)
        rec._header = self.header
        return rec

    def skip_records(self, n: int) -> int:
        """Skip n records reading only the frame words (no site/genotype
        parse — the cheap fast-forward for block-partitioned workers).
        Returns the number actually skipped (short at EOF)."""
        done = 0
        while done < n:
            head = self._f.read(8)
            if len(head) < 8:
                break
            l_shared, l_indiv = struct.unpack("<II", head)
            self._f.read(l_shared + l_indiv)
            done += 1
        return done

    def tell_virtual(self) -> int:
        return self._f.tell_virtual()

    def seek_virtual(self, voffset: int) -> None:
        """Jump to a record boundary addressed by a CSI chunk offset."""
        self._f.seek_virtual(voffset)

    def close(self):
        self._f.close()


class BcfWriter:
    def __init__(self, path_or_file, header: BcfHeader, level: int = 6,
                 threads: int = 0, write_header: bool = True):
        """write_header=False emits a records-only BODY segment (for
        parallel writers whose segments are concatenated after a single
        header segment; see BgzfWriter.finish)."""
        self._f = BgzfWriter(path_or_file, level=level, threads=threads)
        self.header = header
        self._n_str = self._n_ctg = None
        if write_header:
            text = header.to_text().encode() + b"\0"
            self._f.write(BCF_MAGIC)
            self._f.write(struct.pack("<I", len(text)))
            self._f.write(text)
            # Dictionary consistency: the header bytes are now on disk.
            # Freeze the object, and snapshot the dict sizes so growth
            # through an ALIASED header (make_variant_header shares dict
            # lists with its source) is caught at the offending record
            # instead of producing a self-inconsistent file.
            header.freeze()
            self._n_str = len(header.dict_strings)
            self._n_ctg = len(header.dict_contigs)

    def write_raw(self, shared: bytes, indiv: bytes,
                  want_offsets: bool = True) -> tuple[int, int] | None:
        """Write one record; returns its (start, end) BGZF virtual offsets
        (used by the CSI index builder).  Pass want_offsets=False on bulk
        writers that don't index: tell_virtual() must drain the threaded
        deflate pipeline, which would serialize it per record."""
        if self._n_str is not None and (
                len(self.header.dict_strings) != self._n_str
                or len(self.header.dict_contigs) != self._n_ctg):
            new = (self.header.dict_strings[self._n_str:]
                   + self.header.dict_contigs[self._n_ctg:])
            raise ValueError(
                f"BCF header dictionary grew after the header was written "
                f"(new: {','.join(map(str, new))}); records would reference "
                f"tags the on-disk header does not declare")
        vbeg = self._f.tell_virtual() if want_offsets else 0
        self._f.write(struct.pack("<II", len(shared), len(indiv)))
        self._f.write(shared)
        self._f.write(indiv)
        if not want_offsets:
            return None
        return vbeg, self._f.tell_virtual()

    def write_record(self, rec: BcfRecord) -> None:
        self.write_raw(rec.shared, rec.indiv)

    def close(self, write_eof: bool = True):
        """write_eof=False ends a records-only BODY segment without the
        BGZF EOF marker (BgzfWriter.finish)."""
        if not self._f.closed:
            self._f.finish(write_eof=write_eof)
        self._f.close()


def patch_shared_sample_counts(shared: bytes, n_fmt: int, n_sample: int) -> bytes:
    """Rewrite the n_fmt/n_sample word of a shared block (variant-file path)."""
    out = bytearray(shared)
    struct.pack_into("<I", out, 20, (n_fmt << 24) | n_sample)
    return bytes(out)
