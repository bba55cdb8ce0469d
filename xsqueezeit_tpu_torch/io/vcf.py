"""VCF text reader/writer.

Parses VCF into htslib-compatible int32 genotype arrays:

  * allele slot value = (allele_index + 1) << 1 | phased
  * '.'  -> 0 (missing, allele -1); the phase bit of a missing allele follows
    its separator like any other allele
  * samples with fewer alleles than the line maximum are padded with
    INT32_VECTOR_END (BCF padding semantics)
  * the first allele of each sample carries no phase information (separator
    precedes an allele; there is none before the first) -> phase bit 0

Only FORMAT/GT is compressed by the codec (like the reference, which drops
all other FORMAT fields); the eight fixed columns are carried verbatim.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass

import numpy as np

from ..format.constants import INT32_VECTOR_END
from ..interop import native


@dataclass
class VcfRecord:
    fixed: list[str]          # CHROM POS ID REF ALT QUAL FILTER INFO (8 cols)
    gt: np.ndarray | None     # int32[n_samples * line_max_ploidy], None if no GT
    n_alleles: int            # 1 + number of ALTs ('.' ALT counts as 0 ALTs)
    ploidy: int               # line max ploidy

    @property
    def chrom(self) -> str:
        return self.fixed[0]

    @property
    def pos(self) -> int:
        return int(self.fixed[1])


def _open_text(path: str):
    if path == "-":
        import sys
        return sys.stdin
    with open(path, "rb") as probe:
        head = probe.read(2)
    if head == b"\x1f\x8b":
        # bgzip and plain gzip both decode with gzip
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "rt")


def parse_gt_field(field: str, scratch: list[int]) -> int:
    """Parse one sample's GT string into scratch; returns allele count."""
    n = 0
    i = 0
    ln = len(field)
    phased = 0
    while i < ln:
        c = field[i]
        if c == ":":  # further FORMAT subfields are ignored
            break
        if c == ".":
            scratch[n] = 0 | phased
            n += 1
            i += 1
        else:
            j = i
            while j < ln and field[j].isdigit():
                j += 1
            allele = int(field[i:j])
            scratch[n] = ((allele + 1) << 1) | phased
            n += 1
            i = j
        if i < ln:
            sep = field[i]
            if sep == "|":
                phased = 1
                i += 1
            elif sep == "/":
                phased = 0
                i += 1
            elif sep == ":":
                break
    return n


def _fast_diploid_gt(region: str, n_samples: int) -> np.ndarray | None:
    """Vectorized parse of a GT-only genotype region in the uniform diploid
    single-character-allele layout 'a|b\\tc/d\\t...' (alleles 0-9 or '.').

    Returns int32[n_samples*2] htslib-encoded genotypes, or None when the
    region doesn't match the fast layout (multi-digit alleles, haploid or
    mixed-ploidy cells, extra FORMAT subfields), in which case the caller
    falls back to the general per-cell parser.  This path is ~30x faster
    than per-cell parsing and covers the overwhelming majority of cohort
    VCF lines.
    """
    if len(region) != 4 * n_samples - 1:
        return None
    b = np.frombuffer(region.encode(), np.uint8)
    if b.shape[0] != 4 * n_samples - 1:
        return None  # non-ascii characters
    cells = np.concatenate([b, np.frombuffer(b"\t", np.uint8)]) \
        .reshape(n_samples, 4)
    a0 = cells[:, 0].astype(np.int32) - 0x30
    sep = cells[:, 1]
    a1 = cells[:, 2].astype(np.int32) - 0x30
    tail = cells[:, 3]
    ok_allele = (((a0 >= 0) & (a0 <= 9)) | (a0 == -2)) \
        & (((a1 >= 0) & (a1 <= 9)) | (a1 == -2))
    if not (ok_allele.all()
            and ((sep == 0x7C) | (sep == 0x2F)).all()
            and (tail == 0x09).all()):
        return None
    phase = (sep == 0x7C).astype(np.int32)
    gt = np.empty(n_samples * 2, np.int32)
    # '.' maps to allele -1 (missing): encoded 0|phase, same formula
    gt[0::2] = np.where(a0 == -2, 0, (a0 + 1) << 1)
    gt[1::2] = np.where(a1 == -2, phase, ((a1 + 1) << 1) | phase)
    return gt


class VcfReader:
    """Iterates VcfRecord from a .vcf / .vcf.gz file."""

    def __init__(self, path: str):
        self.path = path
        self.header_lines: list[str] = []
        self.samples: list[str] = []
        self._f = _open_text(path)
        for line in self._f:
            line = line.rstrip("\r\n")
            if line.startswith("##"):
                self.header_lines.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                self.samples = cols[9:] if len(cols) > 9 else []
                self._chrom_line_prefix = "\t".join(cols[:9])
                break
            else:
                raise ValueError("VCF: missing #CHROM header line")

    def __iter__(self):
        n_samples = len(self.samples)
        scratch = [0] * 64
        for line in self._f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            cols = line.split("\t", 9)
            fixed = cols[:8]
            alt = fixed[4]
            n_alleles = 1 + (0 if alt in (".", "") else alt.count(",") + 1)
            if len(cols) <= 9 or n_samples == 0:
                yield VcfRecord(fixed, None, n_alleles, 0)
                continue
            fmt = cols[8]
            if fmt != "GT" and "GT" not in fmt.split(":"):
                yield VcfRecord(fixed, None, n_alleles, 0)
                continue
            if fmt == "GT":
                gt = _fast_diploid_gt(cols[9], n_samples)
                if gt is not None:
                    yield VcfRecord(fixed, gt, n_alleles, 2)
                    continue
            cols = fixed + [fmt] + cols[9].split("\t")
            gt_index = fmt.split(":").index("GT")
            per_sample: list[list[int]] = []
            max_ploidy = 1
            for s in cols[9:9 + n_samples]:
                f = s if gt_index == 0 else s.split(":")[gt_index]
                n = parse_gt_field(f, scratch)
                per_sample.append(scratch[:n])
                if n > max_ploidy:
                    max_ploidy = n
            gt = np.full(n_samples * max_ploidy, INT32_VECTOR_END, np.int32)
            for i, vals in enumerate(per_sample):
                gt[i * max_ploidy:i * max_ploidy + len(vals)] = vals
            yield VcfRecord(fixed, gt, n_alleles, max_ploidy)

    def iter_sites(self):
        """Sites-only iteration: yields records with gt=None but real
        n_alleles and line max ploidy (separator counts on the GT
        subfields — no allele parsing).  The variant-pass fast path."""
        for line in self._f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            cols = line.split("\t", 9)
            fixed = cols[:8]
            alt = fixed[4]
            n_alleles = 1 + (0 if alt in (".", "") else alt.count(",") + 1)
            if len(cols) <= 9 or not self.samples:
                yield VcfRecord(fixed, None, n_alleles, 0)
                continue
            parts = cols[8].split(":")
            if "GT" not in parts:
                yield VcfRecord(fixed, None, n_alleles, 0)
                continue
            gi = parts.index("GT")
            mp = 1
            for cell in cols[9].split("\t"):
                g = cell.split(":", gi + 1)[gi] if ":" in cell else cell
                mp = max(mp, g.count("/") + g.count("|") + 1)
            yield VcfRecord(fixed, None, n_alleles, mp)

    def close(self):
        self._f.close()


def format_gt_region_bytes(gt: np.ndarray, ploidy: int,
                           n_samples: int) -> bytes:
    """Tab-separated genotype region of one record as ASCII bytes.

    Native C renderer (bcf_emit.cpp xsi_format_gt_region: the -O v/-O z
    per-record hot spot — the numpy formulation in format_gt_region costs
    ~70 us/record at 2504 samples in small-array overhead alone); the
    Python paths are the oracle (equality pinned by tests), taken with
    XSI_NATIVE=0.  (The switch is read per call — cheap, and the tests
    set it mid-process.)"""
    if native.enabled():
        return native.format_gt_region_bytes_native(gt, ploidy, n_samples)
    return _format_gt_region_py(gt, ploidy, n_samples)


def _format_gt_region_py(gt: np.ndarray, ploidy: int,
                         n_samples: int) -> bytes:
    """Python renderer core (bytes): vectorized fast path for uniform
    diploid rows with single-digit alleles (bulk of cohort data); falls
    back to the per-cell renderer otherwise."""
    if ploidy == 2 and gt.shape[0] == 2 * n_samples:
        allele = (gt >> 1) - 1
        eov = np.int32(INT32_VECTOR_END)
        if allele.max(initial=-1) <= 9 and allele.min(initial=0) >= -1 \
                and not (gt == eov).any():
            cells = np.empty((n_samples, 4), np.uint8)
            a = allele.reshape(n_samples, 2)
            cells[:, 0] = np.where(a[:, 0] < 0, 0x2E, 0x30 + a[:, 0])
            cells[:, 1] = np.where(gt.reshape(n_samples, 2)[:, 1] & 1,
                                   0x7C, 0x2F)
            cells[:, 2] = np.where(a[:, 1] < 0, 0x2E, 0x30 + a[:, 1])
            cells[:, 3] = 0x09
            return cells.tobytes()[:-1]
    return "\t".join(format_gt(gt, ploidy, n_samples)).encode()


def format_gt_region(gt: np.ndarray, ploidy: int, n_samples: int) -> str:
    """Render the whole tab-separated genotype region of one record
    (str convenience wrapper; the hot paths use the bytes forms)."""
    return _format_gt_region_py(gt, ploidy, n_samples).decode()


def format_gt(gt: np.ndarray, ploidy: int, n_samples: int) -> list[str]:
    """Render genotype strings from an htslib-style int array."""
    out = []
    eov = np.int32(INT32_VECTOR_END)
    for i in range(n_samples):
        parts = []
        for j in range(ploidy):
            v = int(gt[i * ploidy + j])
            if v == eov:
                break
            allele = (v >> 1) - 1
            txt = "." if allele < 0 else str(allele)
            if j == 0:
                parts.append(txt)
            else:
                parts.append(("|" if (v & 1) else "/") + txt)
        out.append("".join(parts) if parts else ".")
    return out


class VcfWriter:
    """Writes VCF text (optionally bgzip).

    Operates on a BINARY stream: the genotype region (95%+ of every
    line's bytes) comes from the renderer as ASCII bytes, so no
    str<->bytes round trips of ~20 KB/record happen on the hot path."""

    def __init__(self, path: str, header_lines: list[str], samples: list[str],
                 compress: bool = False, no_header: bool = False):
        self.samples = samples
        if path == "-":
            import sys
            self._f = sys.stdout.buffer
            self._close = False
        elif compress:
            import os as _os

            from .bgzf import BgzfWriter
            # text deflate dominates -O z; parallel BGZF members on
            # multi-core hosts (same pool the BCF writers use)
            self._f = BgzfWriter(path,
                                 threads=min(4, _os.cpu_count() or 1))
            self._close = True
        else:
            self._f = open(path, "wb")
            self._close = True
        if not no_header:
            for line in header_lines:
                self._f.write(line.encode() + b"\n")
            cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                    "INFO"]
            if samples:
                cols += ["FORMAT"] + list(samples)
            self._f.write("\t".join(cols).encode() + b"\n")

    def write_record(self, fixed: list[str], gt: np.ndarray | None,
                     ploidy: int) -> None:
        head = "\t".join(fixed).encode()
        if gt is None or not self.samples:
            self._f.write(head + b"\n")
            return
        region = format_gt_region_bytes(gt, ploidy, len(self.samples))
        # separate writes: concatenating would copy the ~20 KB region again
        w = self._f.write
        w(head)
        w(b"\tGT\t")
        w(region)
        w(b"\n")

    def close(self):
        if self._close:
            self._f.close()
