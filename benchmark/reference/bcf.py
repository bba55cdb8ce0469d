"""A BCF reader of the reference's own, from the BCF2 layout of the VCF
specification (hts-specs, VCFv4.2, section 6): the benchmark reads the
program's output files with it.

    "BCF\\2\\1" or "BCF\\2\\2" | l_text: u32 | header text, NUL-terminated
    a record: l_shared: u32, l_indiv: u32, then
      shared: CHROM s32, POS s32 (0-based), rlen s32, QUAL f32,
              n_allele << 16 | n_info: u32, n_fmt << 24 | n_sample: u32,
              ID typed string, n_allele typed strings, FILTER typed ints,
              n_info x (key: typed int, value: typed vector)
      indiv:  n_fmt x (key: typed int, type byte, n_sample x values)

A typed value starts with a byte: its type in the low four bits (0 none,
1/2/3 int8/16/32, 5 float32, 7 char) and its count in the high four, 15
meaning the count follows as a typed int.  Everything is little-endian,
and the whole stream may be BGZF: gzip members back to back, which
gzip.decompress reads whole.
"""
from __future__ import annotations

import gzip
import re
import struct
from dataclasses import dataclass

import numpy as np

TYPES = {0: None, 1: np.dtype("<i1"), 2: np.dtype("<i2"),
         3: np.dtype("<i4"), 5: np.dtype("<f4"), 7: np.dtype("u1")}


@dataclass
class Record:
    pos: int                    # 0-based
    id: str
    alleles: list
    gt: np.ndarray | None       # the GT field's values, n_sample x ploidy


def _typed(buf: bytes, at: int) -> tuple[np.dtype | None, int, int]:
    """(dtype, count, offset after the descriptor) of the typed value at
    `at`."""
    b = buf[at]
    t, n, at = b & 0xF, b >> 4, at + 1
    if t not in TYPES:
        raise ValueError(f"BCF type code {t}")
    if n == 15:
        dt, _, at = _typed(buf, at)
        n = int(np.frombuffer(buf, dt, 1, at)[0])
        at += dt.itemsize
    return TYPES[t], n, at


def _values(buf: bytes, at: int):
    """(values, offset after them) of the typed vector at `at`."""
    dt, n, at = _typed(buf, at)
    if dt is None:
        return np.empty(0, np.int8), at
    return np.frombuffer(buf, dt, n, at), at + n * dt.itemsize


def _string(buf: bytes, at: int) -> tuple[str, int]:
    v, at = _values(buf, at)
    return v.tobytes().rstrip(b"\0").decode(), at


def dictionary(text: str) -> list[str]:
    """The header's string dictionary: PASS first, then each FILTER, INFO
    and FORMAT ID in order of first appearance, or at its IDX=."""
    out = {0: "PASS"}
    seen = {"PASS"}
    for m in re.finditer(r"^##(?:FILTER|INFO|FORMAT)=<ID=([^,>]+)(.*)$",
                         text, re.M):
        ident, rest = m.group(1), m.group(2)
        if ident in seen:
            continue
        seen.add(ident)
        idx = re.search(r"IDX=(\d+)", rest)
        out[int(idx.group(1)) if idx else max(out) + 1] = ident
    return [out.get(i, "") for i in range(max(out) + 1)]


class BcfFile:
    """A BCF file read whole: `samples`, and its records in order."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:2] == b"\x1f\x8b":
            data = gzip.decompress(data)
        if data[:3] != b"BCF" or data[3] != 2:
            raise ValueError("not a BCF 2 file")
        (n,) = struct.unpack_from("<I", data, 5)
        self.text = data[9:9 + n].rstrip(b"\0").decode()
        self.keys = dictionary(self.text)
        self.samples = self.text.rstrip("\n").split("\n")[-1].split("\t")[9:]
        self.data, self.at = data, 9 + n

    def __iter__(self):
        buf = self.data
        at = self.at
        while at < len(buf):
            l_shared, l_indiv = struct.unpack_from("<II", buf, at)
            at += 8
            yield self._record(buf, at, at + l_shared, at + l_shared + l_indiv)
            at += l_shared + l_indiv

    def _record(self, buf: bytes, s: int, i: int, end: int) -> Record:
        _, pos, _, _, allele_info, fmt_sample = struct.unpack_from(
            "<iiifII", buf, s)
        n_info, n_allele = allele_info & 0xFFFF, allele_info >> 16
        n_sample, n_fmt = fmt_sample & 0xFFFFFF, fmt_sample >> 24
        at = s + 24
        ident, at = _string(buf, at)
        alleles = []
        for _ in range(n_allele):
            a, at = _string(buf, at)
            alleles.append(a)
        _, at = _values(buf, at)                   # FILTER
        for _ in range(n_info):
            _, at = _values(buf, at)
            _, at = _values(buf, at)
        if at != i:
            raise ValueError("a record's shared part does not end at l_shared")
        gt = None
        at = i
        for _ in range(n_fmt):
            key, at = _values(buf, at)
            dt, n, at = _typed(buf, at)
            size = 0 if dt is None else n_sample * n * dt.itemsize
            if self.keys[int(key[0])] == "GT":
                gt = np.frombuffer(buf, dt, n_sample * n, at)
            at += size
        if at != end:
            raise ValueError("a record's sample part does not end at l_indiv")
        return Record(pos, ident, alleles, gt)
