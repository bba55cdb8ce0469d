"""Random-access Accessor API.

The port's copy of xsqueezeit_tpu/accessor.py: genotypes decode on the
host with the port's GtBlockDecoder; allele counts come from the native
count-only engine (interop/native.py) unless XSI_NATIVE=0.

Python counterpart of the reference's `Accessor` class
(the xSqueezeIt reference's include/accessor.hpp): open a `.xsi` file,
then fill genotype arrays / allele counts for arbitrary records addressed
by their FORMAT/BM value (block << 15 | offset), or expose the raw
compressed forms for compressive computation (dot products over
WAH/sparse without decoding).

Typical third-party integration (the SHAPEIT4 pattern):

    acc = Accessor("file.xsi")
    for rec in BcfReader(acc.variant_filename()):
        gt = acc.get_genotypes(rec)          # htslib-style int32 array
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .format.constants import BM_BLOCK_BITS, XSI_BCF_VAR_EXTENSION
from .format.container import XsiReader
from .interop import native
from .codec.gt_block_decoder import GtBlockDecoder


@dataclass
class InternalGtAccess:
    """Raw compressed forms of one record (compressive-computation hook).

    Mirrors the reference's InternalGtAccess
    (accessor_internals.hpp:374-397): per binary line either a WAH word
    stream slice or a sparse index slice, plus the arrangement `a` the line
    was encoded under.  `haploid` lines hold one slot per sample: their WAH
    lines are n_samples bits wide in the arrangement
    pbwt_np.haploid_rearrangement_from_diploid(a), and their sparse lines
    store sample indices.
    """
    position: int
    n_alleles: int
    default_allele: int
    a: np.ndarray                   # arrangement before the first line
    sparse: list[bool]              # per binary line
    pointers: list[np.ndarray]      # WAH words or sparse stream slice
    wah_bytes: int = 2
    haploid: bool = False

    @property
    def a_bytes(self) -> int:
        return self.a.dtype.itemsize


class Accessor:
    _nat_acc = None     # the native engine, opened at first count

    def __init__(self, path: str):
        self.path = path
        self.xsi = XsiReader(path)
        self.n_samples = self.xsi.n_samples
        self.n_haps = self.n_samples * 2
        self._decoders: dict[int, GtBlockDecoder] = {}

    # -------------------------------------------------------------- naming
    def variant_filename(self) -> str:
        return self.path + XSI_BCF_VAR_EXTENSION

    @staticmethod
    def xsi_filename_from_variant(var_path: str) -> str:
        if var_path.endswith(XSI_BCF_VAR_EXTENSION):
            return var_path[: -len(XSI_BCF_VAR_EXTENSION)]
        raise ValueError(f"not a variant file name: {var_path}")

    # ------------------------------------------------------------- samples
    def get_sample_list(self) -> list[str]:
        return self.xsi.samples

    # -------------------------------------------------------------- decode
    def _decoder(self, block_id: int) -> GtBlockDecoder:
        dec = self._decoders.get(block_id)
        if dec is None:
            if len(self._decoders) > 2:
                self._decoders.clear()
            dec = GtBlockDecoder(self.xsi.gt_block_payload(block_id),
                                 self.n_samples, self.n_haps,
                                 aet_dtype=self.xsi.aet_dtype)
            self._decoders[block_id] = dec
        return dec

    @staticmethod
    def split_bm(bm: int) -> tuple[int, int]:
        return ((bm & 0xFFFFFFFF) >> BM_BLOCK_BITS,
                bm & ((1 << BM_BLOCK_BITS) - 1))

    def position_from_bm_entry(self, rec) -> int:
        """Extract FORMAT/BM from a variant-file record (io.bcf.BcfRecord)."""
        for key, t, per, vals in rec.format_fields():
            if rec._header.dict_strings[key] == "BM":
                return int(np.asarray(vals)[0])
        raise ValueError("record has no FORMAT/BM")

    def fill_genotype_array(self, bm: int, n_alleles: int) -> np.ndarray:
        block_id, offset = self.split_bm(bm)
        dec = self._decoder(block_id)
        dec.seek(offset)
        return dec.fill_genotype_array_advance(n_alleles)

    def _native(self):
        """Native count-only engine (native/xsi_accessor.cpp), opened at
        first use; None with XSI_NATIVE=0.  A build or open failure
        raises."""
        if self._nat_acc is None and native.enabled():
            self._nat_acc = native.NativeAccessor(self.path)
        return self._nat_acc

    def close(self) -> None:
        if self._nat_acc is not None:
            self._nat_acc.close()
            self._nat_acc = None

    def __del__(self):
        self.close()

    def fill_allele_counts(self, bm: int, n_alleles: int) -> np.ndarray:
        """AC per allele without materializing genotypes (reference
        count-only path accessor_internals_new.hpp:407-438): WAH popcounts
        and sparse lengths straight off the compressed forms — natively
        (xsi_fill_allele_counts_bm), or off the block decoder's cursor
        with XSI_NATIVE=0."""
        acc = self._native()
        if acc is not None:
            return acc.fill_allele_counts_bm(bm, n_alleles)
        block_id, offset = self.split_bm(bm)
        dec = self._decoder(block_id)
        dec.seek(offset)
        return dec.fill_allele_counts_advance(n_alleles)

    def fill_allele_counts_range(self, bms, n_alleles) -> "np.ndarray":
        """AC of many records, flat int64 counts back-to-back (sum of
        n_alleles entries): the af_stats walk, in ONE native crossing
        (xsi_count_alleles_range: sparse heads + WAH run-word popcounts,
        no gt arrays, no PBWT upkeep), or one record at a time with
        XSI_NATIVE=0."""
        acc = self._native()
        if acc is not None:
            return acc.count_alleles_range(bms, n_alleles)
        return np.concatenate(
            [self.fill_allele_counts(int(bm), int(na))
             for bm, na in zip(bms, n_alleles)]) if len(bms) else \
            np.zeros(0, np.int64)

    def get_genotypes(self, rec) -> np.ndarray:
        """htslib bcf_get_genotypes-shaped convenience wrapper."""
        return self.fill_genotype_array(self.position_from_bm_entry(rec),
                                        rec.n_allele)

    def get_allele_counts(self, rec) -> np.ndarray:
        return self.fill_allele_counts(self.position_from_bm_entry(rec),
                                       rec.n_allele)

    # ------------------------------------------- compressive-compute access
    def get_internal_access(self, bm: int, n_alleles: int) -> InternalGtAccess:
        block_id, offset = self.split_bm(bm)
        dec = self._decoder(block_id)
        dec.seek(offset)
        msb = 1 << (dec.aet_dtype.itemsize * 8 - 1)
        sparse_flags: list[bool] = []
        pointers: list[np.ndarray] = []
        default_allele = 0
        a_snapshot = dec.a.copy()
        for i in range(max(n_alleles - 1, 0)):
            pos = offset + i
            dec.seek(pos)
            if dec.line_is_wah[pos]:
                sparse_flags.append(False)
                pointers.append(dec.wah_stream[dec.wah_pos:])
            else:
                sparse_flags.append(True)
                head = int(dec.sparse_stream[dec.sparse_pos])
                if i == 0 and (head & msb):
                    default_allele = 1
                pointers.append(dec.sparse_stream[dec.sparse_pos:])
            if i == 0:
                a_snapshot = dec.a.copy()
        haploid = (n_alleles > 1 and offset < dec.binary_lines
                   and bool(dec.haploid_line[offset]))
        return InternalGtAccess(
            position=offset, n_alleles=n_alleles,
            default_allele=default_allele, a=a_snapshot,
            sparse=sparse_flags, pointers=pointers, haploid=haploid)
