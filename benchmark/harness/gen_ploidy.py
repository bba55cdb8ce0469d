"""The traffic generator of the mixed-ploidy cells: a panel of male samples
on chrX, diploid inside the configuration's ``diploid_ranges`` (the
pseudo-autosomal regions) and haploid outside them, and the BCF that
carries it.

A diploid record is ``gen``'s panel over the 2N haplotypes of the N
samples: its ALT count from the spectrum over 2N, its alleles from the
copying model over 2N, written phased.  A haploid record gets its ALT
count in [1, N - 1] from the same spectrum over N haplotypes, and its
alleles from the same copying model over N haplotypes, one a sample: a
male's single X outside the PARs.  The two draws have generator streams
of their own, each seeded from (seed, stream, chunk) as ``gen`` seeds, so
any chunk can be drawn again alone.

The BCF layout is ``gen``'s, but for the haploid records' GT: one int8 a
sample (type byte 0x11, ``l_indiv`` with N bytes of GT), the htslib code
(allele + 1) << 1, as plink 2's VCF export writes a male's non-PAR call.
"""
from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import gen

#: Added to gen's stream numbers for the haploid draw.
HAPLOID_STREAMS = 10


def diploid(cfg: dict) -> np.ndarray:
    """bool[records]: the records whose POS lies in a diploid range
    (1-based, both ends inside)."""
    pos = gen.positions(cfg)
    out = np.zeros(pos.shape, bool)
    for lo, hi in cfg["diploid_ranges"]:
        out |= (pos >= int(lo)) & (pos <= int(hi))
    return out


def ploidy(cfg: dict) -> np.ndarray:
    """int64[records]: each record's GT values a sample, 2 or 1."""
    return np.where(diploid(cfg), 2, 1).astype(np.int64)


def logical_bytes(cfg: dict) -> int:
    """The panel's htslib gt arrays: n_gt x 4 B over the records, n_gt
    being ploidy x samples."""
    return int(ploidy(cfg).sum()) * int(cfg["samples"]) * 4


def record_counts(cfg: dict, seed: int, H: int, stream: int) -> np.ndarray:
    """int64[records]: ALT counts in [1, H - 1] from the spectrum over H
    haplotypes (gen.record_counts, at width H and generator `stream`)."""
    n = int(cfg["records"])
    rng = np.random.default_rng(gen.chunk_seed(seed, stream, 0))
    bins = np.asarray(cfg["spectrum"], np.float64)     # [share, lo, hi]
    edges = np.cumsum(bins[:, 0]) / bins[:, 0].sum()
    b = np.minimum(np.searchsorted(edges, rng.random(n), side="right"),
                   len(bins) - 1)
    lo = np.log(np.maximum(bins[b, 1] * H, 1.0))
    hi = np.log(np.maximum(bins[b, 2] * H, 1.0))
    c = np.floor(np.exp(lo + (hi - lo) * rng.random(n)))
    return np.clip(c, 1, H - 1).astype(np.int64)


class HaploidDraw(gen.Draw):
    """gen.Draw over the N haplotypes of N haploid samples, on generator
    streams of its own."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.H, self.K = int(cfg["samples"]), int(cfg["founders"])
        self.p = gen.switch_prob(cfg)
        self.counts = record_counts(cfg, seed, self.H,
                                    gen.S_COUNTS + HAPLOID_STREAMS)
        g = self._gen(gen.S_START, 0)
        self.starts = [torch.randint(self.K, (self.H,), generator=g,
                                     device=self.device)]
        self._last = (-1, None)

    def _gen(self, stream: int, chunk: int) -> torch.Generator:
        return super()._gen(stream + HAPLOID_STREAMS, chunk)


class PloidyDraw:
    """The seed's panel a chunk of gen.CHUNK records at a time: the
    diploid records from gen.Draw, the haploid ones from HaploidDraw."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.dip = diploid(cfg)
        self.diploid = gen.Draw(cfg, seed, device)
        self.haploid = HaploidDraw(cfg, seed, device)

    def alleles(self, c: int) -> tuple[np.ndarray, torch.Tensor | None,
                                       torch.Tensor | None]:
        """(bool[n] which of chunk c's records are diploid, their alleles
        bool[n_dip, 2N], the haploid records' alleles bool[n_hap, N]); a
        part with no record is None."""
        lo, hi = self.diploid.rows(c)
        dip = self.dip[lo:hi]
        a2 = a1 = None
        if dip.any():
            a2 = self.diploid.alleles(c)[torch.from_numpy(dip).to(
                self.diploid.device)]
        if not dip.all():
            a1 = self.haploid.alleles(c)[torch.from_numpy(~dip).to(
                self.haploid.device)]
        return dip, a2, a1

    def rows(self, c: int) -> list[np.ndarray]:
        """Chunk c's records as htslib gt codes, int8[2N] phased for a
        diploid record, int8[N] for a haploid one, in record order."""
        dip, a2, a1 = self.alleles(c)
        two = iter(gen.gt_codes(a2).cpu().numpy() if a2 is not None else [])
        one = iter(haploid_codes(a1).cpu().numpy() if a1 is not None
                   else [])
        return [next(two) if d else next(one) for d in dip]


def haploid_codes(alleles: torch.Tensor) -> torch.Tensor:
    """int8 htslib gt codes of haploid biallelic alleles: (allele + 1) << 1
    (a haploid call has no phase bit)."""
    return (alleles.to(torch.int8) + 1) << 1


def _record_head(i: int, pos1: int, n_samples: int, ploidy_: int) -> bytes:
    """gen's record head with the GT field's type for `ploidy_` int8
    values a sample (0x21 two, 0x11 one)."""
    shared = (struct.pack("<iiiIII", 0, pos1 - 1, 1, gen.QUAL_MISSING,
                          2 << 16, (1 << 24) | n_samples)
              + gen._typed_str(b"rs%d" % i) + b"\x17G\x17A" + b"\x11\x00")
    indiv = b"\x11\x01" + bytes([(ploidy_ << 4) | 1])
    return (struct.pack("<II", len(shared),
                        len(indiv) + ploidy_ * n_samples)
            + shared + indiv)


def write_bcf(path: str, cfg: dict, seed: int, device,
              threads: int = 8) -> None:
    """Write the seed's panel as a BGZF-compressed BCF at `path`."""
    text = gen.header_text(cfg).encode() + b"\0"
    head = b"BCF\x02\x02" + struct.pack("<I", len(text)) + text
    draw = PloidyDraw(cfg, seed, device)
    pos = gen.positions(cfg)
    n_samples = int(cfg["samples"])
    pending = bytearray(head)
    with open(path, "wb") as f, ThreadPoolExecutor(threads) as pool:
        def flush(final: bool) -> None:
            cut = len(pending) if final else (
                len(pending) // gen.BGZF_BLOCK * gen.BGZF_BLOCK)
            pieces = [bytes(pending[i:i + gen.BGZF_BLOCK])
                      for i in range(0, cut, gen.BGZF_BLOCK)]
            del pending[:cut]
            for blk in pool.map(gen._bgzf_block, pieces):
                f.write(blk)

        for c in range(gen.n_chunks(cfg)):
            lo = c * gen.CHUNK
            for j, row in enumerate(draw.rows(c)):
                i = lo + j
                pending += _record_head(i, int(pos[i]), n_samples,
                                        row.shape[0] // n_samples)
                pending += row.tobytes()
            flush(False)
        flush(True)
        f.write(gen.BGZF_EOF)
