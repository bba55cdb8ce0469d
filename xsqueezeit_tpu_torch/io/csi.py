"""CSI (coordinate-sorted index) writer/reader for the variant BCF.

The reference always builds a CSI index for `*_var.bcf` after compression
(the xSqueezeIt reference's xcf.cpp:39-57 `create_index_file`, called from
xsqueezeit.cpp:127) so downstream htslib tools and the accessor's region
queries can seek.  This is a from-scratch implementation of the CSI v1
format (hts-specs CSIv1.pdf): an R-tree of binning intervals keyed by
`reg2bin`, chunks expressed as BGZF virtual offsets, the whole index
BGZF-compressed, magic "CSI\\x01".

Defaults match htslib for BCF: min_shift=14, depth=5.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .bgzf import BgzfReader, BgzfWriter

CSI_MAGIC = b"CSI\x01"
DEFAULT_MIN_SHIFT = 14
DEFAULT_DEPTH = 5


def n_bins(depth: int) -> int:
    return ((1 << 3 * (depth + 1)) - 1) // 7


def depth_for_max_len(max_len: int | None,
                      min_shift: int = DEFAULT_MIN_SHIFT) -> int:
    """Index depth (n_lvls) that makes the longest contig addressable.

    htslib's bcf_index grows n_lvls until max_contig_len + 256 fits a single
    level-0 bin (vcf.c).  We apply the same growth rule but never go below
    htslib's BCF default of 5, so human-scale files keep the depth they have
    always had here and only >537 Mbp contigs (plants, amphibia) deepen the
    tree.  Readers take depth from the index file, so both are compatible.
    """
    depth = DEFAULT_DEPTH
    if max_len:
        need = max_len + 256
        while (1 << (min_shift + 3 * depth)) < need:
            depth += 1
    return depth


def reg2bin(beg: int, end: int, min_shift: int = DEFAULT_MIN_SHIFT,
            depth: int = DEFAULT_DEPTH) -> int:
    """Smallest bin fully containing the 0-based half-open interval."""
    end -= 1
    s = min_shift
    t = ((1 << depth * 3) - 1) // 7
    for level in range(depth, 0, -1):
        if beg >> s == end >> s:
            return t + (beg >> s)
        s += 3
        t -= 1 << (3 * (level - 1))
    return 0


def reg2bins(beg: int, end: int, min_shift: int = DEFAULT_MIN_SHIFT,
             depth: int = DEFAULT_DEPTH) -> list[int]:
    """Every bin that may hold records overlapping [beg, end)."""
    out = []
    end -= 1
    s = min_shift + depth * 3
    t = 0
    for level in range(depth + 1):
        b = t + (beg >> s)
        e = t + (end >> s)
        out.extend(range(b, e + 1))
        s -= 3
        t += 1 << (3 * level)
    return out


@dataclass
class _RefIndex:
    bins: dict[int, list[list[int]]] = field(default_factory=dict)  # bin -> chunks
    # linear index: leaf window -> min voffset of any record OVERLAPPING it
    # (htslib lidx semantics; bins' loff derives from it at write time)
    lidx: dict[int, int] = field(default_factory=dict)
    off_beg: int = -1
    off_end: int = 0
    n_mapped: int = 0


def _reg2bin_vec(beg, end, min_shift: int, depth: int):
    """Vectorized reg2bin over int64 arrays (0-based half-open)."""
    import numpy as np

    e = end - 1
    out = np.zeros(beg.shape[0], np.int64)
    done = np.zeros(beg.shape[0], bool)
    s = min_shift
    t = ((1 << depth * 3) - 1) // 7
    for level in range(depth, 0, -1):
        hit = ~done & ((beg >> s) == (e >> s))
        out[hit] = t + (beg[hit] >> s)
        done |= hit
        s += 3
        t -= 1 << (3 * (level - 1))
    return out


class CsiBuilder:
    """Accumulates (rid, beg, end, voffsets) and writes a .csi file.

    Records must arrive in coordinate-sorted order (the variant file is).
    Adjacent chunks within a bin are merged when contiguous.
    """

    def __init__(self, min_shift: int = DEFAULT_MIN_SHIFT,
                 depth: int = DEFAULT_DEPTH):
        self.min_shift = min_shift
        self.depth = depth
        self.refs: dict[int, _RefIndex] = {}

    def add(self, rid: int, beg: int, end: int, voff_beg: int,
            voff_end: int) -> None:
        """beg/end: 0-based half-open record interval; voff_*: BGZF virtual
        offsets of the record's byte range in the file."""
        ref = self.refs.setdefault(rid, _RefIndex())
        end = max(end, beg + 1)
        if end > (1 << (self.min_shift + 3 * self.depth)):
            raise ValueError(
                f"record at [{beg}, {end}) exceeds the CSI addressable range "
                f"2^{self.min_shift + 3 * self.depth} for min_shift="
                f"{self.min_shift} depth={self.depth}; the contig is longer "
                f"than its ##contig length= declared")
        b = reg2bin(beg, end, self.min_shift, self.depth)
        chunks = ref.bins.setdefault(b, [])
        if chunks and chunks[-1][1] == voff_beg:
            chunks[-1][1] = voff_end
        else:
            chunks.append([voff_beg, voff_end])
        # records arrive position-sorted, so the first voffset seen for a
        # window is the minimum over records overlapping it
        for w in range(beg >> self.min_shift,
                       ((end - 1) >> self.min_shift) + 1):
            ref.lidx.setdefault(w, voff_beg)
        if ref.off_beg < 0:
            ref.off_beg = voff_beg
        ref.off_end = voff_end
        ref.n_mapped += 1

    def add_many(self, rid, beg, end, voff_beg, voff_end) -> None:
        """Vectorized bulk `add` over position-sorted record arrays — the
        per-record loop caps at ~300k adds/s (minutes at chromosome scale
        now that everything around it is native).  Byte-identical .csi to
        the scalar path (pinned by tests/test_csi.py)."""
        import numpy as np

        rid = np.asarray(rid, np.int64)
        beg = np.asarray(beg, np.int64)
        end = np.maximum(np.asarray(end, np.int64), beg + 1)
        vb = np.asarray(voff_beg, np.uint64)
        ve = np.asarray(voff_end, np.uint64)
        n = rid.shape[0]
        if n == 0:
            return
        limit = 1 << (self.min_shift + 3 * self.depth)
        if int(end.max()) > limit:
            bad = int(end.max())
            raise ValueError(
                f"record at [?, {bad}) exceeds the CSI addressable range "
                f"2^{self.min_shift + 3 * self.depth} for min_shift="
                f"{self.min_shift} depth={self.depth}; the contig is longer "
                f"than its ##contig length= declared")
        bins = _reg2bin_vec(beg, end, self.min_shift, self.depth)

        # process per rid (records are rid-grouped in a sorted BCF)
        change = np.flatnonzero(np.diff(rid)) + 1
        starts = np.concatenate([[0], change, [n]])
        for si in range(starts.shape[0] - 1):
            lo, hi = int(starts[si]), int(starts[si + 1])
            if lo == hi:
                continue
            r = int(rid[lo])
            ref = self.refs.setdefault(r, _RefIndex())
            b = bins[lo:hi]
            vbr, ver = vb[lo:hi], ve[lo:hi]
            # chunk building: stable-sort records by bin, keeping file
            # order within each bin; a new chunk starts when the bin
            # changes or the voffsets aren't contiguous
            order = np.argsort(b, kind="stable")
            bs = b[order]
            vbs, ves = vbr[order], ver[order]
            split = np.empty(bs.shape[0], bool)
            split[0] = True
            split[1:] = (bs[1:] != bs[:-1]) | (vbs[1:] != ves[:-1])
            seg_starts = np.flatnonzero(split)
            seg_ends = np.concatenate([seg_starts[1:] - 1,
                                       [bs.shape[0] - 1]])
            for k in range(seg_starts.shape[0]):
                a, z = int(seg_starts[k]), int(seg_ends[k])
                chunks = ref.bins.setdefault(int(bs[a]), [])
                if chunks and chunks[-1][1] == int(vbs[a]):
                    chunks[-1][1] = int(ves[z])
                else:
                    chunks.append([int(vbs[a]), int(ves[z])])
            # linear index: first (= minimum, records are file-ordered)
            # voffset per overlapped leaf window
            w_lo = beg[lo:hi] >> self.min_shift
            w_hi = (end[lo:hi] - 1) >> self.min_shift
            if bool((w_hi == w_lo).all()):
                # no spanning records: w_lo is non-decreasing (positions
                # sorted), so the first occurrence per window is a
                # boundary scan, not a sort
                windows, voffs = w_lo, vbr
                first = np.empty(windows.shape[0], bool)
                first[0] = True
                first[1:] = windows[1:] != windows[:-1]
                first_idx = np.flatnonzero(first)
            else:
                # a spanning record's trailing windows can exceed the
                # NEXT record's start window, so the expanded stream is
                # not monotone -- take first occurrence per unique value
                # (voffsets ascend in file order, so first == minimum)
                spans = (w_hi - w_lo + 1).astype(np.int64)
                reps = np.repeat(np.arange(hi - lo), spans)
                offs = np.arange(reps.shape[0]) - np.repeat(
                    np.cumsum(spans) - spans, spans)
                windows = w_lo[reps] + offs
                voffs = vbr[reps]
                _, first_idx = np.unique(windows, return_index=True)
            wvals = windows[first_idx]
            wvoffs = voffs[first_idx]
            if ref.lidx:
                for w, v in zip(wvals.tolist(), wvoffs.tolist()):
                    if w not in ref.lidx or ref.lidx[w] > v:
                        ref.lidx[w] = v
            else:
                ref.lidx = dict(zip(wvals.tolist(), wvoffs.tolist()))
            if ref.off_beg < 0:
                ref.off_beg = int(vbr[0])
            ref.off_end = int(ver[-1])
            ref.n_mapped += hi - lo

    def write(self, path: str, n_ref: int | None = None) -> None:
        if n_ref is None:
            n_ref = (max(self.refs) + 1) if self.refs else 0
        meta_bin = n_bins(self.depth) + 1
        out = bytearray()
        out += CSI_MAGIC
        out += struct.pack("<iii", self.min_shift, self.depth, 0)  # l_aux=0
        out += struct.pack("<i", n_ref)
        for rid in range(n_ref):
            ref = self.refs.get(rid)
            if ref is None:
                out += struct.pack("<i", 0)
                continue
            # loff of a bin = linear-index value at its first leaf window,
            # forward-filled (htslib semantics: the virtual offset of the
            # first record that may overlap the bin's genomic window -- keyed
            # on overlap, not on which bin a record was filed under, so
            # spanning records are never pruned away by readers)
            import bisect
            wins = sorted(ref.lidx)
            voffs = [ref.lidx[w] for w in wins]

            def loff_of(b: int) -> int:
                level = 0
                t = 0
                while True:
                    t_next = t + (1 << (3 * level))
                    if b < t_next or level == self.depth:
                        break
                    t = t_next
                    level += 1
                first_win = (b - t) << (3 * (self.depth - level))
                i = bisect.bisect_right(wins, first_win) - 1
                return voffs[i] if i >= 0 else 0

            out += struct.pack("<i", len(ref.bins) + 1)  # + pseudo bin
            for b in sorted(ref.bins):
                chunks = ref.bins[b]
                out += struct.pack("<IQi", b, loff_of(b), len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            # htslib pseudo-bin: file range + mapped/unmapped counts
            out += struct.pack("<IQi", meta_bin, 0, 2)
            out += struct.pack("<QQ", ref.off_beg, ref.off_end)
            out += struct.pack("<QQ", ref.n_mapped, 0)
        out += struct.pack("<Q", 0)  # n_no_coor
        w = BgzfWriter(path)
        w.write(bytes(out))
        w.close()


class CsiIndex:
    """Reads a .csi file and answers region -> chunk queries."""

    def __init__(self, min_shift: int, depth: int,
                 bins: list[dict[int, list[tuple[int, int]]]]):
        self.min_shift = min_shift
        self.depth = depth
        self.bins = bins  # per rid

    @classmethod
    def load(cls, path: str) -> "CsiIndex":
        r = BgzfReader(path)
        data = r.read()
        r.close()
        if data[:4] != CSI_MAGIC:
            raise ValueError(f"{path}: not a CSI index")
        min_shift, depth, l_aux = struct.unpack_from("<iii", data, 4)
        pos = 16 + l_aux
        (num_ref,) = struct.unpack_from("<i", data, pos)
        pos += 4
        meta_bin = n_bins(depth) + 1
        refs = []
        for _ in range(num_ref):
            (nb,) = struct.unpack_from("<i", data, pos)
            pos += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(nb):
                b, _loff, nc = struct.unpack_from("<IQi", data, pos)
                pos += 16
                chunks = []
                for _ in range(nc):
                    cb, ce = struct.unpack_from("<QQ", data, pos)
                    pos += 16
                    chunks.append((cb, ce))
                if b != meta_bin:
                    bins[b] = chunks
            refs.append(bins)
        return cls(min_shift, depth, refs)

    def query(self, rid: int, beg: int, end: int) -> list[tuple[int, int]]:
        """Merged chunk list possibly containing records overlapping
        the 0-based half-open interval [beg, end) of reference `rid`."""
        if rid < 0 or rid >= len(self.bins) or not self.bins[rid]:
            return []
        bins = self.bins[rid]
        chunks = []
        for b in reg2bins(beg, max(end, beg + 1), self.min_shift, self.depth):
            chunks.extend(bins.get(b, ()))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                if ce > merged[-1][1]:
                    merged[-1] = (merged[-1][0], ce)
            else:
                merged.append((cb, ce))
        return merged
