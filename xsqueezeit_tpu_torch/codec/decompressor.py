"""Decompression driver on the torch codec: .xsi + _var.bcf -> VCF/BCF/XSI.

The port's copy of xsqueezeit_tpu/codec/decompressor.py (after the
reference's gt_decompressor_new.hpp NewDecompressor): iterate the variant
BCF, map each record's FORMAT/BM pointer to (block, offset), decode the
genotype matrix rows, and emit the record with its samples restored.
Supports region (-r) and target (-t) filtering and sample subsetting (-s)
with AC/AN recomputation, and re-compression to a fresh XSI (-O x).
Whole blocks decode with decoder_torch on the chosen device and -O x
re-encodes with TorchBlockEncoder on it; device="numpy" keeps the host
codec: the native accessor per record and, for a full-sample BCF, the
native extract loop (interop/native.py; XSI_NATIVE=0 takes
GtBlockDecoder and the Python writer).  With more than one device of that
kind (or `DecompressorOptions.devices`), consecutive blocks decode in
batches over the pool (decoder_torch.mesh_decode_all), as the JAX
package's mesh decode does.  `block_range` and records-only BGZF
segments serve the multi-process extract (parallel/distributed.py).  The
JAX package's device route is not copied.
"""
from __future__ import annotations

import os
import re
import struct
import tempfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from itertools import chain

import numpy as np

from ..format.constants import (
    BM_BLOCK_BITS,
    XSI_BCF_VAR_EXTENSION,
    BlockDict,
    WeirdnessStrategy,
)
from ..format.container import XsiReader, XsiWriter
from ..format.dictionary import read_dictionary
from ..format.header import XsiHeader
from ..interop import native
from ..io.bcf import (
    BcfHeader,
    BcfReader,
    BcfRecord,
    BcfWriter,
    patch_shared_sample_counts,
)
from ..io.csi import CsiBuilder, CsiIndex, depth_for_max_len
from ..io.sites import (
    encode_bm_indiv,
    encode_gt_indiv,
    encode_shared_from_vcf_cols,
    render_vcf_cols,
)
from ..io.vcf import VcfWriter
from ..utils.devprobe import torch_device
from .compressor import (
    CompressorOptions,
    TorchEncodeDispatcher,
    compress_file,
    make_variant_header,
)
from .decoder_torch import (
    TorchBlockDecoder,
    decode_block_records,
    host_decoder,
    mesh_decode_all,
)
from .gt_block_decoder import GtBlockDecoder

_OFFSET_MASK = (1 << BM_BLOCK_BITS) - 1


@dataclass
class Region:
    chrom: str
    start: int | None = None  # 1-based inclusive
    end: int | None = None

    @classmethod
    def parse(cls, text: str) -> "Region":
        m = re.match(r"^([^:]+)(?::(\d+)(-)?(\d+)?)?$", text)
        if not m:
            raise ValueError(f"Bad region: {text}")
        chrom, start, dash, end = m.groups()
        if start and not dash:
            end = start        # "chr:pos" is that single position (htslib)
        return cls(chrom, int(start) if start else None,
                   int(end) if end else None)

    def overlaps(self, chrom: str, pos: int, rlen: int) -> bool:
        """Region semantics (-r): record overlap including its length."""
        if chrom != self.chrom:
            return False
        if self.start is not None and pos + rlen - 1 < self.start:
            return False
        if self.end is not None and pos > self.end:
            return False
        return True

    def targets(self, chrom: str, pos: int) -> bool:
        """Target semantics (-t): POS-only check."""
        if chrom != self.chrom:
            return False
        if self.start is not None and pos < self.start:
            return False
        if self.end is not None and pos > self.end:
            return False
        return True


def parse_region_list(text: str) -> list[Region]:
    return [Region.parse(t) for t in text.split(",") if t]


@dataclass
class DecompressorOptions:
    regions: str = ""
    targets: str = ""
    samples: str = ""          # comma list, ^-prefixed to exclude
    samples_file: str = ""
    output_type: str = "b"     # b|u|z|v|x
    no_header: bool = False
    verbose: bool = False
    device: str = "cuda"       # "cuda" | "cpu" | "numpy"
    block_range: tuple[int, int] | None = None  # [start, end) block window
    #                 (multi-host partition; parallel/distributed.py)
    #: The block pool: torch devices blocks spread over; None takes every
    #: local device of `device`'s kind (parallel/shard.local_mesh), or
    #: `device` alone.
    devices: tuple | None = None


def _block_of(bm: int) -> int:
    return (bm & 0xFFFFFFFF) >> BM_BLOCK_BITS


class Decompressor:
    _nat_acc = None     # the native accessor, opened at first decode

    def __init__(self, xsi_path: str, opts: DecompressorOptions | None = None):
        self.xsi_path = xsi_path
        self.opts = opts or DecompressorOptions()
        # resolve the device before any work: "cuda" without a card fails
        self.torch_device = torch_device(self.opts.device)
        self.xsi = XsiReader(xsi_path)
        self.var_path = xsi_path + XSI_BCF_VAR_EXTENSION
        if not os.path.exists(self.var_path):
            raise FileNotFoundError(self.var_path)
        self.n_samples = self.xsi.n_samples
        self.n_haps = self.xsi.header.hap_samples
        # The genotype matrix is sized for diploid samples regardless of the
        # file max ploidy recorded in the header.
        if self.xsi.header.ploidy == 1:
            self.n_haps = self.n_samples * 2

        self._decoders: dict[int, GtBlockDecoder] = {}
        self._select = self._build_sample_selection()

    # ------------------------------------------------------------- samples
    def _build_sample_selection(self) -> np.ndarray | None:
        opt = self.opts
        names: list[str] = []
        invert = False
        if opt.samples_file:
            with open(opt.samples_file) as f:
                names = [l.strip() for l in f if l.strip()]
            if names and names[0].startswith("^"):
                invert = True
                names[0] = names[0][1:]
        elif opt.samples:
            s = opt.samples
            if s.startswith("^"):
                invert = True
                s = s[1:]
            names = [n for n in s.split(",") if n]
        else:
            return None
        index = {n: i for i, n in enumerate(self.xsi.samples)}
        missing = [n for n in names if n not in index]
        if missing:
            raise ValueError(f"Unknown samples: {','.join(missing)}")
        if invert:
            drop = set(names)
            return np.array([i for n, i in
                             ((n, index[n]) for n in self.xsi.samples)
                             if n not in drop], np.int64)
        return np.array([index[n] for n in names], np.int64)

    @property
    def output_samples(self) -> list[str]:
        # cached: emit paths read this per record (it was the TOP cost of
        # a subsetting extract before caching — 24k list rebuilds)
        out = getattr(self, "_output_samples", None)
        if out is None:
            if self._select is None:
                out = self.xsi.samples
            else:
                out = [self.xsi.samples[i] for i in self._select]
            self._output_samples = out
        return out

    # ------------------------------------------------------------- decode
    def _gt_payload(self, block_id: int) -> memoryview:
        """The block's GT payload.  A block id past the block index, or a
        block dictionary without its GT entry, raises the native
        accessor's ValueError (XsiReader, the JAX package's, copied,
        raises IndexError and KeyError)."""
        if not 0 <= block_id < len(self.xsi.indices):
            raise ValueError("block id out of range (bad BM / mismatched "
                             "variant file)")
        d, _ = read_dictionary(self.xsi.block_bytes(block_id), 0)
        if BlockDict.KEY_GT_ENTRY not in d:
            raise ValueError("block has no GT entry")
        return self.xsi.gt_block_payload(block_id)

    def _decoder_for(self, block_id: int) -> GtBlockDecoder:
        dec = self._decoders.get(block_id)
        if dec is None:
            self._decoders.clear()  # keep at most one block resident
            dec = host_decoder(self._gt_payload(block_id), self.n_samples,
                               self.n_haps, self.xsi.aet_dtype)
            self._decoders[block_id] = dec
        return dec

    def _seek_bm(self, bm: int) -> GtBlockDecoder:
        """The block decoder of FORMAT/BM value `bm`, at its record."""
        dec = self._decoder_for(_block_of(bm))
        dec.seek(bm & _OFFSET_MASK)
        return dec

    def _native_accessor(self):
        """BM-keyed native decode (native/xsi_accessor.cpp), the host
        codec's per-record engine (device="numpy"): ~9x the per-record
        NumPy decode.  None on a torch device or with XSI_NATIVE=0; a
        build or open failure raises."""
        if (self._nat_acc is None and self.torch_device is None
                and native.enabled()):
            self._nat_acc = native.NativeAccessor(self.xsi_path)
        return self._nat_acc

    def close(self) -> None:
        if self._nat_acc is not None:
            self._nat_acc.close()
            self._nat_acc = None

    def __del__(self):
        self.close()

    def decode_bm(self, bm: int, n_alleles: int) -> np.ndarray:
        acc = self._native_accessor()
        if acc is not None:
            return acc.fill_genotypes_bm(bm, n_alleles)
        return self._seek_bm(bm).fill_genotype_array_advance(n_alleles)

    def allele_counts_bm(self, bm: int, n_alleles: int) -> np.ndarray:
        acc = self._native_accessor()
        if acc is not None:
            return acc.fill_allele_counts_bm(bm, n_alleles)
        return self._seek_bm(bm).fill_allele_counts_advance(n_alleles)

    # ------------------------------------------------------------ records
    def _region_chunks(self, reader: BcfReader,
                       regions: list[Region]) -> list[tuple[int, int]] | None:
        """CSI-indexed chunk ranges covering `regions`, or None when no
        index is available (reference parity: region queries seek through
        the variant file's .csi, xcf.cpp initialize_bcf_file_reader_with_region)."""
        idx_path = self.var_path + ".csi"
        if not os.path.exists(idx_path):
            return None
        idx = CsiIndex.load(idx_path)
        contigs = reader.header.dict_contigs
        chunks: list[tuple[int, int]] = []
        for r in regions:
            if r.chrom not in contigs:
                continue
            rid = contigs.index(r.chrom)
            beg0 = (r.start - 1) if r.start else 0
            end0 = r.end if r.end is not None else (1 << 31) - 1
            chunks.extend(idx.query(rid, beg0, max(end0, beg0 + 1)))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                if ce > merged[-1][1]:
                    merged[-1] = (merged[-1][0], ce)
            else:
                merged.append((cb, ce))
        return merged

    def _iter_reader_records(self, reader: BcfReader, regions):
        """Iterate variant records; seek via the CSI index when regions are
        given and an index exists, else stream linearly."""
        chunks = self._region_chunks(reader, regions) if regions else None
        if chunks is None:
            yield from reader
            return
        for cb, ce in chunks:
            reader.seek_virtual(cb)
            while reader.tell_virtual() < ce:
                rec = reader.read_record()
                if rec is None:
                    break
                yield rec

    def iter_variant_records(self):
        """Yields (rec, bm, chrom, keep) over the variant file."""
        reader = BcfReader(self.var_path)
        self.var_header = reader.header
        regions = parse_region_list(self.opts.regions) if self.opts.regions else None
        targets = parse_region_list(self.opts.targets) if self.opts.targets else None
        for rec in self._iter_reader_records(reader, regions):
            bm = None
            for key, t, per, vals in rec.format_fields():
                if reader.header.dict_strings[key] == "BM":
                    bm = int(np.asarray(vals)[0])
                    break
            if bm is None:
                raise ValueError("Variant record without BM field")
            if self.opts.block_range is not None:
                blk = _block_of(bm)
                if not (self.opts.block_range[0] <= blk
                        < self.opts.block_range[1]):
                    continue
            if regions is not None or targets is not None:
                chrom = (reader.header.dict_contigs[rec.rid]
                         if rec.rid < len(reader.header.dict_contigs) else "")
                pos1 = rec.pos + 1
                if regions is not None and not any(
                        r.overlaps(chrom, pos1, rec.rlen) for r in regions):
                    continue
                if targets is not None and not any(
                        r.targets(chrom, pos1) for r in targets):
                    continue
            yield rec, bm
        reader.close()

    def output_header(self) -> BcfHeader:
        """Output header: the variant header with samples restored and the
        XSI bookkeeping lines removed."""
        reader = BcfReader(self.var_path)
        h = reader.header
        reader.close()
        out = BcfHeader.from_text(h.to_text())
        out.lines = [l for l in out.lines if not l.startswith("##XSI=")]
        out.samples = self.output_samples
        out.dict_strings = h.dict_strings
        out.str2idx = h.str2idx
        out.dict_contigs = h.dict_contigs
        out.contig2idx = h.contig2idx
        # Drop the BM pseudo-format declaration (reference parity: plain
        # extraction removes it, gt_decompressor_new.hpp:506-507; -O x
        # re-adds it via make_variant_header).  Safe only as the TRAILING
        # dictionary entry (make_variant_header appends it last at
        # compress time): popping it shifts no other index, and output
        # records never reference BM (extraction emits GT only).
        if out.dict_strings and out.dict_strings[-1] == "BM":
            out.lines = [l for l in out.lines
                         if not (l.startswith("##FORMAT=")
                                 and re.search(r"[<,]ID=BM[,>]", l))]
            out.dict_strings = out.dict_strings[:-1]
            out.str2idx = {s: i for i, s in enumerate(out.dict_strings)}
            out.format_meta.pop("BM", None)
        return out

    # AC/AN are recomputed on sample subsetting (reference parity:
    # gt_decompressor_new.hpp:324-365, like bcftools); both tags must be
    # declared in the output header BEFORE it is serialized — a late
    # ensure_string would write records carrying INFO keys the on-disk
    # header lacks (the htslib-side invariant the reference gets from
    # bcf_update_info_int32 refusing undeclared tags,
    # gt_decompressor_new.hpp:251-252).
    _ACAN_DECLS = (
        ("AC", '##INFO=<ID=AC,Number=A,Type=Integer,Description='
               '"Allele count in genotypes, for each ALT allele, in the '
               'same order as listed">'),
        ("AN", '##INFO=<ID=AN,Number=1,Type=Integer,Description='
               '"Total number of alleles in called genotypes">'),
    )

    def _declare_subset_tags(self, header: BcfHeader) -> None:
        if self._select is None:
            return
        for ident, line in self._ACAN_DECLS:
            header.ensure_string(ident, line)

    def _subset_gt(self, gt: np.ndarray, ploidy: int) -> np.ndarray:
        if self._select is None:
            return gt
        view = gt.reshape(self.n_samples, ploidy)
        return view[self._select].reshape(-1)

    def _line_ploidy(self, gt_len: int) -> int:
        return gt_len // self.n_samples

    @staticmethod
    def _recompute_ac_an(gt: np.ndarray, n_alleles: int) -> tuple[list[int], int]:
        alleles = (gt >> 1) - 1
        valid = alleles >= 0
        counts = np.bincount(alleles[valid], minlength=n_alleles)
        return [int(c) for c in counts[1:n_alleles]], int(valid.sum())

    # ------------------------------------------------------------- drivers
    def decompress(self, output_path: str) -> dict:
        ot = self.opts.output_type
        if ot == "x":
            return self._decompress_to_xsi(output_path)
        if ot in ("b", "u"):
            # "u": uncompressed BCF (BGZF framing at level 0), the -p fast
            # pipe format for downstream bcftools (README.md:202-218)
            return self._decompress_to_bcf(output_path,
                                           level=0 if ot == "u" else 6)
        return self._decompress_to_vcf(output_path, compress=(ot == "z"))

    def _emit_stats(self, n):
        return {"records": n, "samples": len(self.output_samples)}

    def _decompress_to_vcf(self, output_path: str, compress: bool) -> dict:
        header = self.output_header()
        self._declare_subset_tags(header)
        writer = VcfWriter(output_path, header.lines, self.output_samples,
                           compress=compress, no_header=self.opts.no_header)
        n = 0
        for rec, gt in self.iter_decoded_records():
            ploidy = self._line_ploidy(gt.shape[0])
            gt = self._subset_gt(gt, ploidy)
            cols = render_vcf_cols(self.var_header, rec)
            if self._select is not None:
                cols[7] = self._patch_info_ac_an(cols[7], gt, rec.n_allele)
            writer.write_record(cols, gt, ploidy)
            n += 1
        writer.close()
        return self._emit_stats(n)

    @staticmethod
    def _patch_info_ac_an(info: str, gt: np.ndarray, n_alleles: int) -> str:
        ac, an = Decompressor._recompute_ac_an(gt, n_alleles)
        items = [] if info in (".", "") else info.split(";")
        out = []
        seen_ac = seen_an = False
        for item in items:
            if item.startswith("AC="):
                out.append("AC=" + ",".join(map(str, ac)))
                seen_ac = True
            elif item.startswith("AN="):
                out.append(f"AN={an}")
                seen_an = True
            else:
                out.append(item)
        if not seen_ac and ac:
            out.append("AC=" + ",".join(map(str, ac)))
        if not seen_an:
            out.append(f"AN={an}")
        return ";".join(out) if out else "."

    def _can_extract_native(self, output_path, write_header: bool,
                            write_eof: bool) -> bool:
        """The native extract loop is the host codec's (device="numpy")
        full-sample-set BCF output to a plain path (header + EOF),
        unfiltered or region/target-restricted (the CSI chunk lookup
        stays in Python; the C loop seeks the chunk voffsets and applies
        the same overlap rules).  XSI_NATIVE=0 takes the Python loop."""
        o = self.opts
        return (isinstance(output_path, str) and output_path != "-"
                and self._select is None and o.block_range is None
                and write_header and write_eof
                and self.torch_device is None and native.enabled())

    def _decompress_to_bcf_native(self, output_path: str, level: int) -> dict:
        header = self.output_header()
        gt_key = header.ensure_string(
            "GT",
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        text = header.to_text().encode() + b"\0"
        o = self.opts
        if not o.regions and not o.targets:
            n = native.native_extract(self.xsi_path, output_path, text,
                                      gt_key, level)
            return self._emit_stats(n)

        # Region/target extract: resolve chrom names + CSI chunks here,
        # hand the C loop pre-computed voffsets and filter triplets.
        reader = BcfReader(self.var_path)
        contigs = reader.header.dict_contigs
        LO, HI = -(1 << 62), 1 << 62

        regions = parse_region_list(o.regions) if o.regions else None
        reg_t = ([(contigs.index(r.chrom) if r.chrom in contigs else -1,
                   r.start if r.start is not None else LO,
                   r.end if r.end is not None else HI)
                  for r in regions] if regions else None)
        tgt_t = None
        if o.targets:
            tgt_t = [(contigs.index(r.chrom) if r.chrom in contigs else -1,
                      r.start if r.start is not None else LO,
                      r.end if r.end is not None else HI)
                     for r in parse_region_list(o.targets)]
        chunks = self._region_chunks(reader, regions) if regions else None
        reader.close()
        if chunks is not None and not chunks:
            chunks = [(0, 0)]   # indexed, nothing overlaps: emit no records
        n = native.native_extract_ranges(self.xsi_path, output_path, text,
                                         gt_key, level, chunks=chunks,
                                         regions=reg_t, targets=tgt_t)
        return self._emit_stats(n)

    def _decompress_to_bcf(self, output_path, level: int = 6,
                           write_header: bool = True,
                           write_eof: bool = True) -> dict:
        """output_path: path or file object.  write_header/write_eof=False
        emit a records-only BGZF body segment (multi-host partition;
        segments concatenate into one valid BCF)."""
        if self._can_extract_native(output_path, write_header, write_eof):
            return self._decompress_to_bcf_native(output_path, level)
        header = self.output_header()
        self._declare_subset_tags(header)
        header.ensure_string(
            "GT",
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        n_out = len(self.output_samples)
        # Parallel BGZF deflate: block compression is the reference's own
        # dominant decompress cost (>60% bcf_write1,
        # gt_decompressor_new.hpp:315); the output writer never calls
        # tell_virtual, so the threaded pipeline stays fully async.
        writer = BcfWriter(output_path, header, level=level,
                           threads=min(os.cpu_count() or 1, 8),
                           write_header=write_header)
        n = 0
        for rec, gt in self.iter_decoded_records():
            ploidy = self._line_ploidy(gt.shape[0])
            gt = self._subset_gt(gt, ploidy)
            shared = patch_shared_sample_counts(rec.shared, 1, n_out)
            if self._select is not None:
                shared = self._patch_shared_ac_an(shared, gt, rec.n_allele,
                                                  header)
            indiv = encode_gt_indiv(header, gt, ploidy, n_out)
            writer.write_raw(shared, indiv, want_offsets=False)
            n += 1
        writer.close(write_eof=write_eof)
        return self._emit_stats(n)

    def _patch_shared_ac_an(self, shared: bytes, gt: np.ndarray,
                            n_alleles: int, out_header: BcfHeader) -> bytes:
        # Re-encode the whole site from text for simplicity on the subset
        # path.  Decode with the variant file's header (the record's dict
        # indices live there); RE-encode against the OUTPUT header, whose
        # dictionary — including the pre-declared AC/AN — is what the
        # on-disk header actually declares.  Both derive from the same
        # variant-file text, so pre-existing indices coincide.
        rec = BcfRecord.parse(shared, b"")
        rec._header = self.var_header
        cols = render_vcf_cols(self.var_header, rec)
        cols[7] = self._patch_info_ac_an(cols[7], gt, n_alleles)
        return encode_shared_from_vcf_cols(out_header, cols, 1,
                                           len(self.output_samples))

    def _recompress_options(self) -> CompressorOptions:
        """Carry over the source's rare/common split: the header stores
        the MAC threshold (rare_threshold = n_haps * maf); +0.5 keeps
        int(n_haps * maf) == rare_threshold under float rounding when the
        sample set is unchanged.  Encoded on this decompressor's device."""
        maf = (self.xsi.header.rare_threshold + 0.5) / max(self.n_haps, 1)
        return CompressorOptions(maf=maf, zstd=self.xsi.header.zstd,
                                 block_length=self.xsi.header.ss_rate,
                                 device=self.opts.device)

    def _decompress_to_xsi_via_bcf(self, output_path: str) -> dict:
        """Decode to an intermediate BCF, then compress it with the port's
        compress_file (XSI_FUSED_RECOMPRESS=0, and empty selections)."""
        with tempfile.TemporaryDirectory() as td:
            tmp = os.path.join(td, "recompress.bcf")
            self._decompress_to_bcf(tmp)
            return compress_file(tmp, output_path, self._recompress_options())

    def _decompress_to_xsi(self, output_path: str) -> dict:
        """Re-compress the (possibly subset or filtered) records into a
        fresh XSI with the BM rewrite inside the decode loop
        (decompressor.py:686-851 of the JAX package, its device encoder
        replaced by TorchEncodeDispatcher).  Bytes equal the detour's and
        every device's; XSI_FUSED_RECOMPRESS=0 takes the detour."""
        if os.environ.get("XSI_FUSED_RECOMPRESS", "1") in ("0", "off", "no"):
            return self._decompress_to_xsi_via_bcf(output_path)
        opts = self._recompress_options()
        n_out = len(self.output_samples)
        n_haps_out = n_out * 2    # A_T selection assumes diploid (ref parity)
        mac_threshold = int(n_haps_out * opts.maf)
        aet_dtype = np.uint16 if n_haps_out <= 0xFFFF else np.uint32

        # The lead records give phasedness and first-entry ploidy, as
        # compress_file's sniffers would on the intermediate BCF.
        stream = self.iter_decoded_records()
        lead = []
        for item in stream:
            lead.append(item)
            if len(lead) >= 3:
                break
        if not lead:
            # empty selection: raise as compressing an empty BCF would
            return self._decompress_to_xsi_via_bcf(output_path)

        def out_ploidy(gt):
            return self._line_ploidy(gt.shape[0])

        counts = [0, 0]
        default_phased = None
        for _, gt in lead:
            p = out_ploidy(gt)
            if p == 1:
                default_phased = 0
                break
            second = self._subset_gt(gt, p).reshape(-1, p)[:, 1]
            phased = int((second & 1).sum())
            counts[1] += phased
            counts[0] += second.shape[0] - phased
        if default_phased is None:
            default_phased = 1 if counts[1] >= counts[0] else 0
        max_ploidy = out_ploidy(lead[0][1])

        header = XsiHeader(
            version=5, ind_bytes=4,
            aet_bytes=np.dtype(aet_dtype).itemsize, wah_bytes=2,
            iota_ppa=True, no_sort=False,
            default_phased=bool(default_phased),
            ss_rate=opts.block_length, rare_threshold=mac_threshold)
        xsi = XsiWriter(output_path, header, self.output_samples,
                        zstd_on=opts.zstd, zstd_level=opts.zstd_level)
        var_path = output_path + XSI_BCF_VAR_EXTENSION
        out_hdr = self.output_header()
        self._declare_subset_tags(out_hdr)   # before the header hits disk
        var_header = make_variant_header(out_hdr,
                                         os.path.basename(output_path))
        var_writer = BcfWriter(var_path, var_header)
        csi = CsiBuilder(depth=depth_for_max_len(
            max(var_header.contig_lengths.values(), default=0)))
        block = TorchEncodeDispatcher(
            n_out, opts.block_length, mac_threshold,
            default_phasing=default_phased, aet_dtype=aet_dtype,
            weirdness_strategy=WeirdnessStrategy.WS_SPARSE,
            device=self.torch_device, devices=self.opts.devices)
        entry_counter = variant_counter = 0
        bm_block = bm_offset = 0
        pending: deque = deque()
        try:
            for rec, gt in chain(lead, stream):
                ploidy = out_ploidy(gt)
                max_ploidy = max(max_ploidy, ploidy)
                gt = self._subset_gt(gt, ploidy)
                if entry_counter and entry_counter % opts.block_length == 0:
                    bm_block += 1
                    bm_offset = 0
                if bm_offset >> BM_BLOCK_BITS:
                    raise ValueError(f"BM offset cannot be represented on "
                                     f"{BM_BLOCK_BITS} bits")
                bm = (bm_block << BM_BLOCK_BITS) | bm_offset
                shared = patch_shared_sample_counts(rec.shared, 1, n_out)
                if self._select is not None:
                    shared = self._patch_shared_ac_an(shared, gt,
                                                      rec.n_allele,
                                                      var_header)
                shared = patch_shared_sample_counts(shared, 1, 1)
                vbeg, vend = var_writer.write_raw(
                    shared, encode_bm_indiv(var_header, bm))
                rid, pos0, rlen = struct.unpack_from("<iii", shared, 0)
                csi.add(rid, pos0, pos0 + max(rlen, 1), vbeg, vend)

                if block.full:
                    pending.append(block.submit())
                    while pending and pending[0].done():
                        xsi.write_block(pending.popleft().result())
                    while len(pending) > block.inflight_target:
                        if not pending[0].done():
                            block.flush()
                        xsi.write_block(pending.popleft().result())
                block.encode_record(gt, rec.n_allele)

                bm_offset += rec.n_allele - 1
                variant_counter += rec.n_allele - 1
                entry_counter += 1

            if block.bcf_lines:      # the tail block joins the last batch
                pending.append(block.submit())
            block.flush()
            while pending:
                xsi.write_block(pending.popleft().result())
            xsi.finalize(num_variants=variant_counter,
                         xcf_entries=entry_counter, max_ploidy=max_ploidy)
            var_writer.close()
            csi.write(var_path + ".csi",
                      n_ref=len(var_header.dict_contigs))
        except BaseException:
            block.shutdown()
            for f in (getattr(xsi, "f", None),
                      getattr(var_writer, "_f", None)):
                try:
                    if f is not None and not f.closed:
                        f.close()
                except OSError:
                    pass      # the exception in flight is the one to raise
            for path in (output_path, var_path, var_path + ".csi"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            raise
        finally:
            block.shutdown()
        return {
            "entries": entry_counter,
            "variants": variant_counter,
            "n_samples": n_out,
            "xsi_bytes": os.path.getsize(output_path),
            "variant_bytes": os.path.getsize(var_path),
        }

    def _local_mesh(self) -> list:
        """Decode-side device pool: the option's list, else every local
        device of the decoder's kind, else the decoder's device alone."""
        from ..parallel.shard import device_pool
        return device_pool(self.opts.devices, self.torch_device)

    def iter_decoded_records(self):
        """Yields (variant_rec, gt) in file order, decoding whole blocks on
        the device.  Batch k of consecutive blocks decodes on a worker
        thread while batch k-1's records are emitted (one worker keeps the
        order).  A batch holds one block per pool device and its eligible
        blocks decode over the pool (mesh_decode_all), the read-side
        counterpart of the compressor's batching; other blocks decode on
        the decompressor's device."""
        if self.torch_device is None:
            for rec, bm in self.iter_variant_records():
                yield rec, self.decode_bm(bm, rec.n_allele)
            return

        mesh = self._local_mesh()
        batch_target = len(mesh)

        def decode_batch(groups):
            """groups: [(block_id, [(rec, offset), ...]), ...] consecutive.
            Returns [gts_list_per_group]."""
            payloads = [self._gt_payload(block_id) for block_id, _ in groups]
            decs = [TorchBlockDecoder(p, self.n_samples, self.n_haps,
                                      self.xsi.aet_dtype,
                                      device=self.torch_device)
                    for p in payloads]
            mesh_decode_all([d for d in decs if d.eligible], mesh)
            return [decode_block_records(
                p, self.n_samples, self.n_haps, self.xsi.aet_dtype,
                [r.n_allele for r, _ in recs], [off for _, off in recs],
                predecoded=d)
                for p, d, (_, recs) in zip(payloads, decs, groups)]

        pending: list = []        # (rec, offset) of the current block
        pending_block = -1
        batch: list = []          # [(block_id, recs)] awaiting decode
        in_flight = None          # (groups, Future[list[gts]])

        def emit(done):
            for (_, recs), gts in zip(done[0], done[1].result()):
                yield from zip((r for r, _ in recs), gts)

        with ThreadPoolExecutor(max_workers=1) as executor:
            def flush_batch():
                nonlocal in_flight, batch
                groups, batch = batch, []
                prev = in_flight
                in_flight = (groups, executor.submit(decode_batch, groups))
                return prev

            for rec, bm in self.iter_variant_records():
                block_id = _block_of(bm)
                if block_id != pending_block:
                    if pending:
                        batch.append((pending_block, pending))
                        pending = []
                    pending_block = block_id
                    if len(batch) >= batch_target:
                        prev = flush_batch()
                        if prev is not None:
                            yield from emit(prev)
                pending.append((rec, bm & _OFFSET_MASK))
            if pending:
                batch.append((pending_block, pending))
            if batch:
                prev = flush_batch()
                if prev is not None:
                    yield from emit(prev)
            if in_flight is not None:
                yield from emit(in_flight)
