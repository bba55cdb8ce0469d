"""Unified genotype-file input: VCF text (.vcf/.vcf.gz) or BCF.

Yields records carrying both the raw BCF shared block (site columns) and the
htslib-style genotype array, so downstream stages are format-agnostic.
The port's copy of xsqueezeit_tpu/io/unified.py: the Python readers and
the record count (the JAX package's native batch reader, its record
skipping and its block-offset scan serve its native and multi-process
paths, which the port does not have).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bcf import BCF_MAGIC, BcfHeader, BcfReader
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


class GtInput:
    """Opens a VCF/BCF and exposes header info + record iteration."""

    def __init__(self, path: str):
        self.path = path
        self.format = sniff_format(path)
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

    def __iter__(self):
        if self.format == "bcf":
            for rec in self._bcf:
                out = rec.genotypes()
                gt, ploidy = out if out is not None else (None, 0)
                yield GtInputRecord(rec.shared, gt, rec.n_allele, ploidy)
        else:
            for rec in self._vcf:
                shared = encode_shared_from_vcf_cols(
                    self.header, rec.fixed, 0, 0)
                yield GtInputRecord(shared, rec.gt, rec.n_alleles, rec.ploidy)

    def close(self):
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


def count_entries(path: str) -> int:
    """Number of variant records in a VCF/BCF (reference: count_entries,
    xcf.cpp:318-340).  BCF records are skipped without decoding genotypes."""
    fmt = sniff_format(path)
    if fmt == "bcf":
        return _count_entries_bcf_py(path)
    from .vcf import VcfReader
    n = 0
    v = VcfReader(path)
    for _ in v:
        n += 1
    v.close()
    return n


def _count_entries_bcf_py(path: str) -> int:
    import struct
    from .bgzf import BgzfReader
    r = BgzfReader(path)
    r.read(5)
    (l_text,) = struct.unpack("<I", r.read(4))
    r.read(l_text)
    n = 0
    while True:
        head = r.read(8)
        if len(head) < 8:
            break
        l_shared, l_indiv = struct.unpack("<II", head)
        r.read(l_shared + l_indiv)
        n += 1
    r.close()
    return n
