"""The benchmark's traffic generator: a phased, biallelic panel drawn from
the seed, and the BCF that carries it.

The haplotypes follow the copying model of Li and Stephens (Genetics
165:2213, 2003) over a founder set: each haplotype copies one of
``founders`` founders at a time, and at each record switches to a founder
drawn uniformly with their probability of a switch over the record's
spacing d, 1 - exp(-4 Ne r d / K), for an effective size Ne, a
recombination rate r a base and K founders (the configuration's
``effective_size``, ``recombination_per_bp``, ``founders``).  So records
near each other share their carriers, as in a real panel.

Each record's ALT count comes from the site-frequency spectrum of the
1000 Genomes phase 3 paper (Nature 526:68, 2015): of its 84.7 million
SNPs, 64 million below 0.5 %, 12 million 0.5-5 %, 8 million above 5 %.
The configuration's ``spectrum`` gives those shares; within a bin the
frequency has the neutral density, proportional to 1/f (log-uniform).
The carriers of a record: its founders, in an order drawn for the record,
give all their current copiers in turn until the count is reached; the
last founder gives a random subset of its copiers, as a mutation on that
founder's lineage would.

The record layout is that of ``bench/synth.py`` ``synth_bcf`` of
xsqueezeit_tpu_torch at commit 020efb0f1b2610896c6d201383d65c226e80c5d3:
one contig, a fixed spacing, ``rs<i>`` ids, REF G, ALT A, FILTER PASS,
FORMAT GT only, each sample phased (htslib's gt code ((allele + 1) << 1)
| phased, the phase bit on the second slot of a sample).  The BCF and
BGZF bytes are written here, not by the program's writer, and deflated
on a thread pool at a low level: the level changes no record.

The draws run on the torch device the caller names, in chunks of
``CHUNK`` records, each from generators seeded by (seed, chunk); the
founder each haplotype copies is carried from one chunk to the next.  The
same seed gives the same panel on that device.
"""
from __future__ import annotations

import math
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: Records a chunk of the draw: each chunk has generators of its own.
CHUNK = 1024
#: Payload bytes of one BGZF block (htslib's own cut, below the 64 KiB cap).
BGZF_BLOCK = 0xFF00
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
#: deflate level of the BGZF blocks: the level changes no record.
LEVEL = 1
#: htslib's missing QUAL.
QUAL_MISSING = 0x7F800001
#: Generator streams of a run.
S_COUNTS, S_CARRIERS, S_SWITCH, S_START = 1, 2, 3, 4


def chunk_seed(seed: int, stream: int, chunk: int) -> int:
    """A 63-bit generator seed for one chunk of one stream of a run."""
    state = np.random.SeedSequence([seed, stream, chunk]).generate_state(
        2, np.uint32)
    return ((int(state[0]) << 32) | int(state[1])) & ((1 << 63) - 1)


def n_haps(cfg: dict) -> int:
    return 2 * int(cfg["samples"])


def n_chunks(cfg: dict) -> int:
    return -(-int(cfg["records"]) // CHUNK)


def switch_prob(cfg: dict) -> float:
    """A haplotype's chance to switch founders between two records."""
    rho = (4.0 * float(cfg["effective_size"])
           * float(cfg["recombination_per_bp"]) * int(cfg["spacing_bp"]))
    return -math.expm1(-rho / int(cfg["founders"]))


def record_counts(cfg: dict, seed: int) -> np.ndarray:
    """int64[records]: each record's ALT count, in [1, H - 1], from the
    spectrum's bins, log-uniform in a bin."""
    n, H = int(cfg["records"]), n_haps(cfg)
    rng = np.random.default_rng(chunk_seed(seed, S_COUNTS, 0))
    bins = np.asarray(cfg["spectrum"], np.float64)     # [share, lo, hi]
    edges = np.cumsum(bins[:, 0]) / bins[:, 0].sum()
    b = np.minimum(np.searchsorted(edges, rng.random(n), side="right"),
                   len(bins) - 1)
    lo = np.log(np.maximum(bins[b, 1] * H, 1.0))
    hi = np.log(np.maximum(bins[b, 2] * H, 1.0))
    c = np.floor(np.exp(lo + (hi - lo) * rng.random(n)))
    return np.clip(c, 1, H - 1).astype(np.int64)


def positions(cfg: dict) -> np.ndarray:
    """int64[records]: each record's 1-based POS."""
    return (int(cfg["first_pos"])
            + int(cfg["spacing_bp"]) * np.arange(int(cfg["records"]),
                                                 dtype=np.int64))


class Draw:
    """The seed's panel, a chunk of records at a time.  The founder each
    haplotype copies at the start of each chunk is kept, so any chunk can
    be drawn again alone."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.H, self.K = n_haps(cfg), int(cfg["founders"])
        self.p = switch_prob(cfg)
        self.counts = record_counts(cfg, seed)
        g = self._gen(S_START, 0)
        self.starts = [torch.randint(self.K, (self.H,), generator=g,
                                     device=self.device)]
        self._last = (-1, None)

    def _gen(self, stream: int, chunk: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(chunk_seed(self.seed, stream, chunk))
        return g

    def rows(self, c: int) -> tuple[int, int]:
        lo = c * CHUNK
        return lo, min(lo + CHUNK, int(self.cfg["records"]))

    def founders(self, c: int) -> torch.Tensor:
        """int64[n, H]: the founder each haplotype copies at each record
        of chunk c."""
        while len(self.starts) <= c:
            j = len(self.starts) - 1
            self.starts.append(self._founders(j)[-1])
        return self._founders(c)

    def _founders(self, c: int) -> torch.Tensor:
        if self._last[0] == c:
            return self._last[1]
        lo, hi = self.rows(c)
        n, dev = hi - lo, self.device
        g = self._gen(S_SWITCH, c)
        switch = torch.rand((n, self.H), generator=g, device=dev) < self.p
        fresh = torch.randint(self.K, (n, self.H), generator=g, device=dev)
        at = torch.arange(n, device=dev)[:, None].expand(n, self.H)
        last = torch.cummax(torch.where(switch, at, -1), dim=0).values
        lab = torch.where(last >= 0, fresh.gather(0, last.clamp(min=0)),
                          self.starts[c][None, :])
        self._last = (c, lab)
        return lab

    def alleles(self, c: int) -> torch.Tensor:
        """bool[n, H]: the ALT alleles of chunk c's records."""
        lab = self.founders(c)
        lo, hi = self.rows(c)
        n, K, dev = hi - lo, self.K, self.device
        g = self._gen(S_CARRIERS, c)
        order = torch.rand((n, K), generator=g, device=dev).argsort(dim=1)
        u = torch.rand((n, self.H), generator=g, device=dev)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(K, device=dev).expand(n, K).contiguous())
        copiers = torch.zeros((n, K), dtype=torch.int64, device=dev)
        copiers.scatter_add_(1, lab, torch.ones_like(lab))
        given = copiers.gather(1, order).cumsum(1)   # by the record's order
        want = torch.from_numpy(self.counts[lo:hi]).to(dev)
        whole = (given <= want[:, None]).sum(1)      # < K: want < H
        before = torch.where(
            whole > 0, given.gather(1, (whole - 1).clamp(min=0)[:, None])[:, 0],
            0)
        need = want - before
        last = order.gather(1, whole.clamp(max=K - 1)[:, None])
        alt = rank.gather(1, lab) < whole[:, None]
        key = torch.where(lab == last, u, 2.0)
        cut = key.sort(dim=1).values.gather(1, (need - 1).clamp(min=0)[:, None])
        return alt | ((key <= cut) & (need > 0)[:, None])


def gt_codes(alleles: torch.Tensor, phased: bool = True) -> torch.Tensor:
    """int8 htslib gt codes of biallelic alleles: phased, the phase bit
    is set on the second slot of each sample."""
    phase = (torch.arange(alleles.shape[1], device=alleles.device) & 1)
    return (((alleles.to(torch.int8) + 1) << 1)
            | (phase.to(torch.int8) * int(phased)))


def header_text(cfg: dict) -> str:
    samples = "\t".join(f"S{i}" for i in range(int(cfg["samples"])))
    return ("##fileformat=VCFv4.2\n"
            '##FILTER=<ID=PASS,Description="All filters passed">\n'
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
            f"##contig=<ID={cfg['chrom']},length={cfg['contig_length']}>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + samples + "\n")


def _typed_str(s: bytes) -> bytes:
    if len(s) < 15:
        return bytes([(len(s) << 4) | 7]) + s
    return b"\xf7\x11" + bytes([len(s)]) + s


def _record_head(i: int, pos1: int, n_samples: int, n_haps: int) -> bytes:
    """l_shared, l_indiv and the shared part of record i, then the GT
    field's key (string 1: PASS is 0) and type (two int8 a sample)."""
    shared = (struct.pack("<iiiIII", 0, pos1 - 1, 1, QUAL_MISSING, 2 << 16,
                          (1 << 24) | n_samples)
              + _typed_str(b"rs%d" % i) + b"\x17G\x17A" + b"\x11\x00")
    indiv = b"\x11\x01\x21"
    return struct.pack("<II", len(shared), len(indiv) + n_haps) + shared + indiv


def _bgzf_block(data: bytes) -> bytes:
    c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", len(body) + 25) + body
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data)))


def write_bcf(path: str, cfg: dict, seed: int, device, threads: int = 8,
              phased: bool = True) -> None:
    """Write the seed's panel as a BGZF-compressed BCF at `path`;
    `phased=False` drops the phase bits (the lossless cells' control)."""
    text = header_text(cfg).encode() + b"\0"
    head = b"BCF\x02\x02" + struct.pack("<I", len(text)) + text
    draw = Draw(cfg, seed, device)
    pos = positions(cfg)
    n_samples = int(cfg["samples"])
    pending = bytearray(head)
    with open(path, "wb") as f, ThreadPoolExecutor(threads) as pool:
        def flush(final: bool) -> None:
            cut = len(pending) if final else (
                len(pending) // BGZF_BLOCK * BGZF_BLOCK)
            pieces = [bytes(pending[i:i + BGZF_BLOCK])
                      for i in range(0, cut, BGZF_BLOCK)]
            del pending[:cut]
            for blk in pool.map(_bgzf_block, pieces):
                f.write(blk)

        for c in range(n_chunks(cfg)):
            rows = gt_codes(draw.alleles(c), phased).cpu().numpy()
            lo = c * CHUNK
            for j in range(rows.shape[0]):
                i = lo + j
                pending += _record_head(i, int(pos[i]), n_samples,
                                        rows.shape[1])
                pending += rows[j].tobytes()
            flush(False)
        flush(True)
        f.write(BGZF_EOF)
