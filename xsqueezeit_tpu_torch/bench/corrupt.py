"""Corrupt containers, for the robustness tests and chip_smoke.py's
`corrupt` phase.

Each writer copies a well-formed container that is not zstd-compressed,
with its variant file, and changes bytes of one GT block: a stored index
set past its line's width (a sparse carrier, a WS_SPARSE missing or EOV
track entry, a haploid sparse line's sample), the WAH stream with its
first words dropped or with a counter that runs past its line, or random
byte flips; wah_streams makes corrupt WAH streams for the expand
kernels.  write_vcf makes small inputs whose blocks hold every one of
those streams: diploid records with rare and common alleles, males that
are haploid on every diploid record (end-of-vector entries), all-haploid
records (a mixed-ploidy block) and missing entries.
"""
from __future__ import annotations

import os
import shutil
import struct

import numpy as np

from ..codec.gt_block_decoder import GtBlockDecoder
from ..format.constants import BlockDict, GTDict
from ..format.container import XsiReader
from ..format.dictionary import read_dictionary
from ..ops import wah_np
from ..ops.sparse_np import msb, sparse_line_offsets

#: stored-index stream -> (its dictionary key, its line flags' attribute;
#: None: the sparse lines, those that are not WAH lines)
STREAMS = {
    "sparse": (GTDict.KEY_MATRIX_SPARSE, None),
    "missing": (GTDict.KEY_MATRIX_MISSING_SPARSE, "line_has_missing"),
    "eov": (GTDict.KEY_MATRIX_END_OF_VECTORS_SPARSE, "line_has_eov"),
}
#: the companions of a container that a copy takes along
COMPANIONS = ("_var.bcf", "_var.bcf.csi")


def write_vcf(path: str, n_samples: int, n_records: int, seed: int = 0,
              males: int = 0, haploid_every: int = 0,
              missing_frac: float = 0.0) -> str:
    """A phased VCF on chromosome 20: each record draws an ALT frequency
    from a rare-heavy mix.  The first `males` samples are haploid on
    every diploid record; every `haploid_every`-th record (0: none) is
    haploid for all samples; `missing_frac` of the entries are missing."""
    rng = np.random.default_rng(seed)
    samples = [f"S{i}" for i in range(n_samples)]
    lines = ["##fileformat=VCFv4.2",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             "##contig=<ID=20,length=63025520>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(samples)]
    for r in range(n_records):
        freq = rng.choice([0.002, 0.01, 0.05, 0.3, 0.6])
        alle = (rng.random((n_samples, 2)) < freq).astype(int).astype(str)
        alle[rng.random((n_samples, 2)) < missing_frac] = "."
        haploid = haploid_every and r % haploid_every == haploid_every - 1
        cells = [a if haploid or s < males else f"{a}|{b}"
                 for s, (a, b) in enumerate(alle)]
        lines.append(f"20\t{60000 + 37 * r}\trs{r}\tG\tA\t.\tPASS\t.\tGT\t"
                     + "\t".join(cells))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def wah_streams(rng: np.random.Generator, n_lines: int,
                w: int) -> dict[str, np.ndarray]:
    """Corrupt u16 WAH streams for lines of w groups: "random" words, a
    well-formed stream of n_lines random lines "cut" at two thirds, and
    the same stream with four counters of 16,383 one-groups spliced in
    ("long": past their line).  No counter has a zero count (the host
    refuses those before a kernel runs)."""
    bits = rng.random((n_lines, w * 15)) < 0.3
    good = np.concatenate([wah_np.wah_encode(b) for b in bits])
    long = good.copy()
    long[rng.integers(0, len(long), 4)] = 0xFFFF
    out = {"random": rng.integers(0, 1 << 16, len(good), dtype=np.uint16),
           "cut": good[:len(good) * 2 // 3], "long": long}
    for s in out.values():
        s[(s & 0xBFFF) == 0x8000] |= 1
    return out


def copy_container(src: str, dst: str, data: bytes | None = None) -> str:
    """Copy the container `src` to `dst` with its companions; `data`, if
    given, is written as the new container's bytes."""
    if data is None:
        shutil.copyfile(src, dst)
    else:
        with open(dst, "wb") as f:
            f.write(data)
    for ext in COMPANIONS:
        if os.path.exists(src + ext):
            shutil.copyfile(src + ext, dst + ext)
    return dst


def _block(src: str, block: int) -> tuple[XsiReader, GtBlockDecoder, int]:
    """The reader, block `block`'s parsed GT payload, and the payload's
    offset in the file."""
    rd = XsiReader(src)
    if rd.header.zstd:
        raise ValueError(f"{src}: zstd blocks are not edited in place")
    start = int(rd.indices[block])
    top, _ = read_dictionary(rd.block_bytes(block), 0)
    meta = GtBlockDecoder(rd.gt_block_payload(block), rd.n_samples,
                          rd.n_haps, rd.aet_dtype)
    return rd, meta, start + top[BlockDict.KEY_GT_ENTRY]


def stored_index(src: str, kind: str, block: int = 0,
                 haploid: bool | None = None) -> tuple[int, int, int]:
    """(file offset, item size, line width) of the first stored index of
    stream `kind` ("sparse", "missing" or "eov") in a line that stores
    one (haploid True / False: only haploid / diploid lines)."""
    rd, m, payload = _block(src, block)
    key, flags = STREAMS[kind]
    stream = m._typed(key, m.aet_dtype)
    lines = np.flatnonzero(~m.line_is_wah.astype(bool) if flags is None
                           else getattr(m, flags))
    if stream is None or not lines.size:
        raise ValueError(f"{src}: block {block} has no {kind} stream")
    offs = sparse_line_offsets(stream, len(lines))
    counts = stream[offs[:-1]].astype(np.int64) & (msb(m.aet_dtype) - 1)
    hap = m.haploid_line.astype(bool)[lines]
    ok = (counts > 0) & (True if haploid is None else hap == haploid)
    if not ok.any():
        raise ValueError(f"{src}: block {block} stores no {kind} index "
                         f"in a line of that ploidy")
    k = int(np.flatnonzero(ok)[0])
    width = rd.n_samples if hap[k] else rd.n_haps
    item = m.aet_dtype.itemsize
    return payload + m.dictionary[key] + (int(offs[k]) + 1) * item, item, \
        width


def index_past_width(src: str, dst: str, kind: str, block: int = 0,
                     haploid: bool | None = None, past: int = 3) -> str:
    """Copy `src` to `dst` with one stored index of stream `kind` set to
    its line's width + `past` (stored_index)."""
    at, item, width = stored_index(src, kind, block, haploid)
    data = bytearray(open(src, "rb").read())
    data[at:at + item] = (width + past).to_bytes(item, "little")
    return copy_container(src, dst, bytes(data))


def _wah_entry(src: str, block: int) -> tuple[bytearray, int, int]:
    """The container's bytes, the file offset of block `block`'s
    KEY_MATRIX_WAH dictionary value (the stream's offset in the payload),
    and the payload's file offset."""
    _, _, payload = _block(src, block)
    data = bytearray(open(src, "rb").read())
    _, n = struct.unpack_from("<II", data, payload)
    for i in range(n):
        at = payload + 8 + 8 * i
        if struct.unpack_from("<I", data, at)[0] == GTDict.KEY_MATRIX_WAH:
            return data, at + 4, payload
    raise ValueError(f"{src}: block {block} has no WAH stream")


def wah_dropped_words(src: str, dst: str, n_words: int,
                      block: int = 0) -> str:
    """Copy with block `block`'s WAH stream starting `n_words` words
    late: the stream is short of the lines' groups and every line reads
    the words of the one after it."""
    data, at, _ = _wah_entry(src, block)
    struct.pack_into("<I", data, at,
                     struct.unpack_from("<I", data, at)[0] + 2 * n_words)
    return copy_container(src, dst, bytes(data))


def wah_long_counter(src: str, dst: str, word: int = 0,
                     block: int = 0) -> str:
    """Copy with word `word` of block `block`'s WAH stream set to a
    counter of 16,383 one-groups (0xFFFF), which runs past its line and
    past the stream's lines."""
    data, at, payload = _wah_entry(src, block)
    w0 = payload + struct.unpack_from("<I", data, at)[0] + 2 * word
    data[w0:w0 + 2] = b"\xff\xff"
    return copy_container(src, dst, bytes(data))


def flip_bytes(src: str, dst: str, rng: np.random.Generator,
               n: int = 3) -> str:
    """Copy with `n` random bytes of the blocks' region (between the
    256-byte header and the block index) XOR-ed with random nonzero
    values."""
    rd = XsiReader(src)
    lo, hi = 256, rd.header.indices_offset
    data = bytearray(open(src, "rb").read())
    for at in rng.integers(lo, hi, n):
        data[int(at)] ^= int(rng.integers(1, 256))
    return copy_container(src, dst, bytes(data))
