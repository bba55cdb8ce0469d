"""GT block encoder — the portable (NumPy) reference path.

A GT block holds up to `block_bcf_lines` BCF records worth of genotype data.
Per record, each ALT allele becomes one *binary line*, encoded either as a
PBWT-permuted WAH bitmap (common variants, minor allele count above the MAC
threshold) or as a sparse index list (rare variants).  Exception tracks cover
missing values, end-of-vector padding (mixed in-line ploidy), non-uniform
phasing, and fully-haploid lines.

Semantics restated from the xSqueezeIt reference's include/gt_block.hpp (encode_line,
scan_genotypes, write_writables); the serialization is the XSI v4/v5 GT block
payload.  One deliberate fix over the reference: the haploid line-flag vector
is emitted per *binary* line (replicated across a record's ALTs) rather than
per BCF line, which the reference conflates -- identical bytes for files
where every haploid record is bi-allelic (the only case the reference
handles), correct for multi-allelic haploid records.

This module is pure NumPy and covers every format feature; the JAX device
pipeline (codec/encoder_jax.py) accelerates the common regular case and is
validated against this implementation.
"""
from __future__ import annotations

import numpy as np

from ..format.constants import (
    GTDict,
    INT32_MISSING,
    INT32_VECTOR_END,
    WeirdnessStrategy,
)
from ..format.dictionary import write_dictionary
from ..ops import pbwt_np, sparse_np, wah_np


def allele_of(gt: np.ndarray) -> np.ndarray:
    return (gt >> 1) - 1


def missing_mask(gt: np.ndarray) -> np.ndarray:
    return ((gt >> 1) == 0) | (gt == np.int32(INT32_MISSING))


def eov_mask(gt: np.ndarray) -> np.ndarray:
    return gt == np.int32(INT32_VECTOR_END)


class GtBlockEncoder:
    def __init__(
        self,
        n_samples: int,
        block_bcf_lines: int,
        mac_threshold: int,
        default_phasing: int = 0,
        aet_dtype=np.uint32,
        weirdness_strategy: int = WeirdnessStrategy.WS_SPARSE,
    ):
        self.n_samples = n_samples
        self.n_haps = n_samples * 2
        self.block_bcf_lines = block_bcf_lines
        self.mac_threshold = mac_threshold
        self.default_phasing = int(default_phasing)
        self.aet_dtype = np.dtype(aet_dtype)
        self.weirdness_strategy = weirdness_strategy

        self.a = np.arange(self.n_haps, dtype=np.int64)
        self.a_weird = np.arange(self.n_haps, dtype=np.int64)

        self.bcf_lines = 0
        self.binary_lines = 0
        self.max_vector_length = 1

        self.line_is_wah: list[bool] = []          # per binary line
        self.haploid_binary_line: list[bool] = []  # per binary line (see note)
        self.line_has_missing: list[bool] = []     # per BCF line
        self.line_has_eov: list[bool] = []
        self.line_has_nup: list[bool] = []
        self.alt_counts: list[int] = []            # n_allele-1 per BCF line

        self.wah_lines: list[np.ndarray] = []
        self.sparse_lines: list[np.ndarray] = []
        self.missing_tracks: list[np.ndarray] = []   # sparse or WAH per strategy
        self.eov_tracks: list[np.ndarray] = []
        self.phase_tracks: list[np.ndarray] = []

        self.missing_found = False
        self.eov_found = False
        self.nup_found = False
        self.haploid_found = False

        # Per-line allele counts (for tests / stats parity)
        self.line_allele_counts: list[np.ndarray] = []

    @property
    def full(self) -> bool:
        return self.bcf_lines >= self.block_bcf_lines

    def encode_record(self, gt: np.ndarray, n_alleles: int) -> None:
        """Encode one BCF record.

        gt: htslib-style int32 array of length n_samples * line_max_ploidy.
        n_alleles: REF + ALTs (binary lines added = n_alleles - 1).
        """
        assert not self.full, "block is full"
        gt = np.asarray(gt, dtype=np.int32)
        ngt = gt.shape[0]
        ploidy = ngt // self.n_samples
        if ploidy > 2:
            raise ValueError("Ploidy higher than 2 is not supported")
        self.max_vector_length = max(self.max_vector_length, ploidy)
        haploid = ploidy == 1

        alleles = allele_of(gt)
        miss = missing_mask(gt)
        eov = eov_mask(gt)

        # Allele counts over non-missing, non-EOV entries
        valid = ~(miss | eov)
        ac = np.bincount(alleles[valid], minlength=n_alleles).astype(np.int64)
        self.line_allele_counts.append(ac[:n_alleles].copy())

        has_missing = bool(miss.any())
        has_eov = bool(eov.any())
        # Phase applies to second+ alleles only (BCF quirk: first allele's
        # phase bit is unused).  Checked against raw entries, incl. specials.
        if ploidy >= 2:
            second = gt.reshape(self.n_samples, ploidy)[:, 1:].reshape(-1)
            has_nup = bool(((second & 1) != self.default_phasing).any())
        else:
            has_nup = False

        if n_alleles <= 1 and (has_missing or has_eov or has_nup):
            # Zero-ALT records own no binary line, and the v4/v5 exception
            # tracks are keyed per binary line -- an orphan track would
            # shift every later overlay in the block (the reference's
            # reindexer corrupts its block on such input, gt_block.hpp:
            # 649-665; we fail loudly instead of silently losing data).
            raise ValueError(
                "record with no ALT allele carries missing/end-of-vector/"
                "non-uniform-phasing data, which XSI v5 cannot represent")
        self.line_has_missing.append(has_missing)
        self.line_has_eov.append(has_eov)
        self.line_has_nup.append(has_nup)
        self.alt_counts.append(n_alleles - 1)
        self.missing_found |= has_missing
        self.eov_found |= has_eov
        self.nup_found |= has_nup
        self.haploid_found |= haploid

        # --- main genotype matrix: one binary line per ALT ------------------
        for alt in range(1, n_alleles):
            mac = min(int(ac[alt]), ngt - int(ac[alt]))
            self.haploid_binary_line.append(haploid)
            if mac > self.mac_threshold:
                self.line_is_wah.append(True)
                if haploid:
                    a1 = pbwt_np.haploid_rearrangement_from_diploid(self.a)
                    bits = (alleles[a1] == alt).astype(np.uint8)
                    self.wah_lines.append(wah_np.wah_encode(bits))
                    self.a = pbwt_np.pbwt_sort_haploid(self.a, gt, alt)
                else:
                    bits = (alleles[self.a] == alt).astype(np.uint8)
                    self.wah_lines.append(wah_np.wah_encode(bits))
                    self.a = pbwt_np.pbwt_sort(self.a, gt, alt)
            else:
                self.line_is_wah.append(False)
                sparse_allele = alt if int(ac[alt]) == mac else 0
                idx = np.flatnonzero(alleles == sparse_allele)
                self.sparse_lines.append(
                    sparse_np.sparse_encode(idx, negated=(sparse_allele == 0),
                                            dtype=self.aet_dtype))
            self.binary_lines += 1

        # --- exception tracks ----------------------------------------------
        ws = self.weirdness_strategy
        if ws == WeirdnessStrategy.WS_SPARSE:
            if has_missing:
                self.missing_tracks.append(
                    sparse_np.sparse_encode(np.flatnonzero(miss), False, self.aet_dtype))
            if has_eov:
                self.eov_tracks.append(
                    sparse_np.sparse_encode(np.flatnonzero(eov), False, self.aet_dtype))
        elif ws in (WeirdnessStrategy.WS_WAH, WeirdnessStrategy.WS_PBWT_WAH):
            if has_missing:
                aw = (pbwt_np.haploid_rearrangement_from_diploid(self.a_weird)
                      if haploid else self.a_weird)
                self.missing_tracks.append(wah_np.wah_encode(miss[aw].astype(np.uint8)))
            if has_eov:
                aw = (pbwt_np.haploid_rearrangement_from_diploid(self.a_weird)
                      if haploid else self.a_weird)
                self.eov_tracks.append(wah_np.wah_encode(eov[aw].astype(np.uint8)))
            if (has_missing or has_eov) and ws == WeirdnessStrategy.WS_PBWT_WAH:
                if not haploid:
                    self.a_weird = pbwt_np.pbwt_sort_weirdness(self.a_weird, gt)
                # haploid weirdness sort intentionally skipped (matches ref)
        else:
            raise ValueError("unsupported weirdness strategy")

        # Phase info: natural order, odd indices only, never PBWT-permuted.
        if has_nup:
            pos_is_second = (np.arange(ngt) & 1).astype(bool)
            bits = (pos_is_second & ((gt & 1) != self.default_phasing)).astype(np.uint8)
            self.phase_tracks.append(wah_np.wah_encode(bits))

        self.bcf_lines += 1

    # -----------------------------------------------------------------------
    def _reindex_to_binary(self, per_bcf: list[bool]) -> np.ndarray:
        """Expand a per-BCF-line flag vector to binary lines (flag on the
        record's first binary line, zeros for the extra ALT lines)."""
        out = np.zeros(self.binary_lines, np.uint8)
        off = 0
        for i, n_alt in enumerate(self.alt_counts):
            if n_alt <= 0:
                continue  # record with no ALT contributes no binary line
            out[off] = per_bcf[i]
            off += n_alt
        return out

    def serialize(self) -> bytes:
        """Produce the GT block payload (dictionary + writables)."""
        d: dict[int, int] = {
            GTDict.KEY_BCF_LINES: self.bcf_lines,
            GTDict.KEY_BINARY_LINES: self.binary_lines,
            GTDict.KEY_MAX_LINE_PLOIDY: self.max_vector_length,
            GTDict.KEY_DEFAULT_PHASING: self.default_phasing,
            GTDict.KEY_WEIRDNESS_STRATEGY: self.weirdness_strategy,
            GTDict.KEY_LINE_SORT: GTDict.VAL_UNDEFINED,
            GTDict.KEY_LINE_SELECT: GTDict.VAL_UNDEFINED,
            GTDict.KEY_MATRIX_WAH: GTDict.VAL_UNDEFINED,
            GTDict.KEY_MATRIX_SPARSE: GTDict.VAL_UNDEFINED,
        }
        ws = self.weirdness_strategy
        wah_weird = ws in (WeirdnessStrategy.WS_WAH, WeirdnessStrategy.WS_PBWT_WAH)
        if self.missing_found:
            d[GTDict.KEY_LINE_MISSING] = GTDict.VAL_UNDEFINED
            d[GTDict.KEY_MATRIX_MISSING if wah_weird
              else GTDict.KEY_MATRIX_MISSING_SPARSE] = GTDict.VAL_UNDEFINED
        if self.eov_found:
            d[GTDict.KEY_LINE_END_OF_VECTORS] = GTDict.VAL_UNDEFINED
            d[GTDict.KEY_MATRIX_END_OF_VECTORS if wah_weird
              else GTDict.KEY_MATRIX_END_OF_VECTORS_SPARSE] = GTDict.VAL_UNDEFINED
        if self.nup_found:
            d[GTDict.KEY_LINE_NON_UNIFORM_PHASING] = GTDict.VAL_UNDEFINED
            d[GTDict.KEY_MATRIX_NON_UNIFORM_PHASING] = GTDict.VAL_UNDEFINED
        if self.haploid_found:
            d[GTDict.KEY_LINE_HAPLOID] = GTDict.VAL_UNDEFINED

        dict_bytes = write_dictionary(d)
        payload = bytearray(dict_bytes)

        def mark(key: int) -> None:
            d[key] = len(payload)

        def put(arr: np.ndarray) -> None:
            payload.extend(np.ascontiguousarray(arr).tobytes())

        def put_bool_wah(v: np.ndarray) -> None:
            put(wah_np.wah_encode(np.asarray(v, np.uint8)))

        mark(GTDict.KEY_LINE_SORT)
        put_bool_wah(np.asarray(self.line_is_wah, np.uint8))
        d[GTDict.KEY_LINE_SELECT] = d[GTDict.KEY_LINE_SORT]  # shared track

        mark(GTDict.KEY_MATRIX_WAH)
        for w in self.wah_lines:
            put(w)
        mark(GTDict.KEY_MATRIX_SPARSE)
        for s in self.sparse_lines:
            put(s)

        if self.missing_found:
            mark(GTDict.KEY_LINE_MISSING)
            put_bool_wah(self._reindex_to_binary(self.line_has_missing))
            mark(GTDict.KEY_MATRIX_MISSING if wah_weird
                 else GTDict.KEY_MATRIX_MISSING_SPARSE)
            for t in self.missing_tracks:
                put(t)
        if self.eov_found:
            mark(GTDict.KEY_LINE_END_OF_VECTORS)
            put_bool_wah(self._reindex_to_binary(self.line_has_eov))
            mark(GTDict.KEY_MATRIX_END_OF_VECTORS if wah_weird
                 else GTDict.KEY_MATRIX_END_OF_VECTORS_SPARSE)
            for t in self.eov_tracks:
                put(t)
        if self.nup_found:
            mark(GTDict.KEY_LINE_NON_UNIFORM_PHASING)
            put_bool_wah(self._reindex_to_binary(self.line_has_nup))
            mark(GTDict.KEY_MATRIX_NON_UNIFORM_PHASING)
            for t in self.phase_tracks:
                put(t)
        if self.haploid_found:
            mark(GTDict.KEY_LINE_HAPLOID)
            put_bool_wah(np.asarray(self.haploid_binary_line, np.uint8))

        # Rewrite the dictionary with final offsets (same size, same order).
        payload[: len(dict_bytes)] = write_dictionary(d)
        return bytes(payload)
