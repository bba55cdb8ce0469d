"""GT block decoder — portable (NumPy) reference path.

Mirrors the reference's random-access block decompressor
(the xSqueezeIt reference's include/accessor_internals_new.hpp DecompressPointerGTBlock):
a cursor over the block's binary lines that can `seek` forward (replaying PBWT
arrangement updates) and materialize one record's htslib-style genotype array,
overlaying the exception tracks (missing / end-of-vector / non-uniform phase).

The JAX batch decoder (codec/decoder_jax.py) decodes whole regular blocks on
device; this class is the always-correct path and the oracle for it.
"""
from __future__ import annotations

import numpy as np

from ..format.constants import (
    GTDict,
    INT32_VECTOR_END,
    WeirdnessStrategy,
)
from ..format.dictionary import read_dictionary
from ..ops import pbwt_np, wah_np


class GtBlockDecoder:
    def __init__(self, payload: memoryview | bytes, n_samples: int, n_haps: int,
                 aet_dtype=np.uint32):
        self.buf = memoryview(payload)
        self.n_samples = n_samples
        self.n_haps = n_haps
        self.aet_dtype = np.dtype(aet_dtype)
        self._msb = 1 << (self.aet_dtype.itemsize * 8 - 1)

        self._wah_cache = None   # None = unbuilt, False = ineligible
        self.dictionary, _ = read_dictionary(self.buf, 0)
        d = self.dictionary
        self.bcf_lines = d[GTDict.KEY_BCF_LINES]
        self.binary_lines = d[GTDict.KEY_BINARY_LINES]
        self.max_ploidy = d.get(GTDict.KEY_MAX_LINE_PLOIDY, 2)
        if self.max_ploidy == GTDict.VAL_UNDEFINED:
            self.max_ploidy = 2
        dp = d.get(GTDict.KEY_DEFAULT_PHASING, 0)
        self.default_phasing = dp if dp == 1 else 0
        self.weirdness_strat = d.get(GTDict.KEY_WEIRDNESS_STRATEGY,
                                     WeirdnessStrategy.WS_PBWT_WAH)
        if self.weirdness_strat == WeirdnessStrategy.WS_MIXED:
            # WS_MIXED is enumerated in the format (gt_block.hpp:70) but
            # the reference THROWS at encode time whenever its per-line
            # sparse heuristic fires (gt_block.hpp:346-348, 358-360), so
            # any WS_MIXED block that exists on disk is WAH-track-only —
            # read it with exact WS_WAH semantics.
            self.weirdness_strat = WeirdnessStrategy.WS_WAH
        elif self.weirdness_strat not in (
                WeirdnessStrategy.WS_PBWT_WAH, WeirdnessStrategy.WS_WAH,
                WeirdnessStrategy.WS_SPARSE):
            raise ValueError(
                f"unknown weirdness strategy {self.weirdness_strat} "
                "(corrupt dictionary or future format?)")

        # Offsets of every offset-valued section (keys >= 0x10; lower keys
        # are scalars like KEY_BCF_LINES), used to bound section views.
        self._section_offsets = sorted(
            v for k, v in self.dictionary.items()
            if k >= GTDict.KEY_LINE_SORT and v != GTDict.VAL_UNDEFINED)

        self.line_is_wah = self._bool_vec(GTDict.KEY_LINE_SELECT)
        sort = self._bool_vec(GTDict.KEY_LINE_SORT)
        self.line_is_sorting = sort if sort is not None else self.line_is_wah
        self.line_has_missing = self._bool_vec(GTDict.KEY_LINE_MISSING)
        self.line_has_eov = self._bool_vec(GTDict.KEY_LINE_END_OF_VECTORS)
        self.line_has_nup = self._bool_vec(GTDict.KEY_LINE_NON_UNIFORM_PHASING)
        self.haploid_line = self._bool_vec(GTDict.KEY_LINE_HAPLOID)
        if self.haploid_line is None:
            self.haploid_line = np.zeros(self.binary_lines, np.uint8)
        self.has_weirdness = (self.line_has_missing is not None
                              or self.line_has_eov is not None)
        self.has_nup = self.line_has_nup is not None

        self.wah_stream = self._typed(GTDict.KEY_MATRIX_WAH, np.uint16)
        self.sparse_stream = self._typed(GTDict.KEY_MATRIX_SPARSE, self.aet_dtype)
        self.missing_wah = self._typed(GTDict.KEY_MATRIX_MISSING, np.uint16)
        self.missing_sparse = self._typed(GTDict.KEY_MATRIX_MISSING_SPARSE, self.aet_dtype)
        self.eov_wah = self._typed(GTDict.KEY_MATRIX_END_OF_VECTORS, np.uint16)
        self.eov_sparse = self._typed(GTDict.KEY_MATRIX_END_OF_VECTORS_SPARSE, self.aet_dtype)
        self.phase_wah = self._typed(GTDict.KEY_MATRIX_NON_UNIFORM_PHASING, np.uint16)
        # Zero-count counters from corrupt/foreign streams would silently
        # break the device expansion kernels; reject them at parse time.
        # Only sections some line actually references are validated: an
        # EMPTY section shares its offset with whatever was written after it
        # (the dictionary stores no sizes), so its bounded view aliases a
        # neighbour's bytes and must not be interpreted as WAH words.
        def used(vec):
            return vec is not None and bool(np.any(vec))

        for stream, in_use, name in (
                (self.wah_stream, used(self.line_is_wah), "MATRIX_WAH"),
                (self.missing_wah, used(self.line_has_missing),
                 "MATRIX_MISSING"),
                (self.eov_wah, used(self.line_has_eov),
                 "MATRIX_END_OF_VECTORS"),
                (self.phase_wah, used(self.line_has_nup),
                 "MATRIX_NON_UNIFORM_PHASING")):
            if stream is not None and in_use:
                wah_np.validate_wah_stream(stream, name)

        self.reset()

    # ------------------------------------------------------------------ IO
    def _bool_vec(self, key: int) -> np.ndarray | None:
        off = self.dictionary.get(key)
        if off is None or off == GTDict.VAL_UNDEFINED:
            return None
        words = np.frombuffer(self.buf[off:], np.uint16,
                              count=min((len(self.buf) - off) // 2, 4 + self.binary_lines))
        bits, _ = wah_np.wah_decode(words, self.binary_lines)
        return bits

    def _typed(self, key: int, dtype) -> np.ndarray | None:
        off = self.dictionary.get(key)
        if off is None or off == GTDict.VAL_UNDEFINED:
            return None
        # Bound the view at the next section's offset: the dictionary stores
        # offsets only (no sizes, interfaces.hpp:37-97), and reading through
        # to end-of-payload would alias later sections' bytes into this one.
        end = min((o for o in self._section_offsets if o > off),
                  default=len(self.buf))
        dtype = np.dtype(dtype)
        n = (end - off) // dtype.itemsize
        return np.frombuffer(self.buf[off:off + n * dtype.itemsize], dtype)

    # ------------------------------------------------------- WAH bit cache
    def _ensure_wah_cache(self) -> None:
        """Vectorised one-shot decode of every WAH line's bits.

        All WAH lines share one width when the block's ploidy is uniform,
        so the whole stream expands in a single pass (wah_expand_block)
        instead of per-line wah_decode calls whose fixed numpy overhead
        dominated the host block decode (~0.6 s of 1.0 s per 4k-record
        chr20-scale block).  Mixed-ploidy blocks keep the per-line path.
        """
        if self._wah_cache is not None or self.wah_stream is None:
            return
        is_wah = self.line_is_wah.astype(bool)
        n_wah = int(is_wah.sum())
        if n_wah == 0:
            return
        hap = self.haploid_line.astype(bool)
        if hap.any() and not hap.all():
            self._wah_cache = False  # mixed widths: per-line fallback
            return
        n = self.n_samples if hap.any() else self.n_haps
        w = (n + 14) // 15
        s = self.wah_stream.astype(np.int64)
        spans = np.where((s & wah_np.WAH_HIGH_BIT) != 0,
                         s & wah_np.WAH_MAX_COUNTER, 1)
        if spans.sum() < n_wah * w:  # truncated stream: per-line fallback
            self._wah_cache = False
            return
        groups = wah_np.wah_expand_block(self.wah_stream, n_wah, w)
        bits = wah_np.unpack_words(groups, w * 15)  # [n_wah, w*15]
        # popcount over the full padded span == reference count_ones for
        # conforming streams (padding bits are zeros by construction)
        ones = bits.sum(axis=1).astype(np.int64)
        # word offset of each line (+ end sentinel): keeps wah_pos exact for
        # the raw-pointer API (get_internal_access compressive compute)
        ecum = np.cumsum(spans) - spans
        offsets = np.searchsorted(ecum,
                                  np.arange(n_wah + 1, dtype=np.int64) * w,
                                  side="left")
        self._wah_cache = (bits, ones, offsets)

    # --------------------------------------------------------------- cursor
    def reset(self) -> None:
        self.pos = 0
        self.a = np.arange(self.n_haps, dtype=np.int64)
        self.a_weird = np.arange(self.n_haps, dtype=np.int64)
        self.wah_pos = 0
        self.wah_rank = 0            # WAH lines consumed (bit-cache cursor)
        self.sparse_pos = 0
        self.weird_pos = 0
        self.phase_pos = 0
        self.missing_wah_pos = 0
        self.missing_sparse_pos = 0
        self.eov_wah_pos = 0
        self.eov_sparse_pos = 0
        self.phase_wah_pos = 0
        self.ones = 0
        self.sparse = np.zeros(0, np.int64)
        self.sparse_negated = False
        self.allele_counts: np.ndarray | None = None

    def _current_n_haps(self, pos: int) -> int:
        return self.n_samples if self.haploid_line[pos] else self.n_haps

    def _sparse_head(self, stream: np.ndarray, pos: int) -> tuple[bool, int]:
        head = int(stream[pos])
        return bool(head & self._msb), head & (self._msb - 1)

    def _advance_main(self, extract: bool) -> tuple[np.ndarray | None, np.ndarray]:
        """Consume the binary line at the cursor (without moving self.pos).

        Returns (y, a_before): y are the decoded bits in arrangement order for
        WAH lines (None for sparse or skipped lines); a_before is the
        arrangement the line was encoded under (before this line's PBWT
        update).
        """
        pos = self.pos
        n = self._current_n_haps(pos)
        a_before = self.a
        y = None
        sorting = bool(self.line_is_sorting[pos])
        if self.line_is_wah[pos]:
            # The oracle always decodes (ones are needed by allele counts);
            # the device path has a dedicated skip-with-popcount kernel.
            self._ensure_wah_cache()
            if self._wah_cache:
                bits, ones_arr, line_offsets = self._wah_cache
                y = bits[self.wah_rank]
                self.ones = int(ones_arr[self.wah_rank])
                self.wah_rank += 1
                self.wah_pos = int(line_offsets[self.wah_rank])
            else:
                y, used, self.ones = wah_np.wah_decode_count_ones(
                    self.wah_stream[self.wah_pos:], n)
                self.wah_pos += used
            if sorting:
                if self.haploid_line[pos]:
                    self.a = pbwt_np.pbwt_sort_bool_haploid(a_before, y[:n], self.n_samples)
                else:
                    self.a = pbwt_np.pbwt_sort_bool(a_before, y[:self.n_haps])
        else:
            self.sparse_negated, count = self._sparse_head(self.sparse_stream, self.sparse_pos)
            if extract:
                self.sparse = self.sparse_stream[
                    self.sparse_pos + 1:self.sparse_pos + 1 + count].astype(np.int64)
            self.sparse_pos += 1 + count
            self.ones = (n - count) if self.sparse_negated else count
            # sparse lines never sort in v4/v5 (select == sort track)
        return y, a_before

    def _weird_arrangement(self, haploid: bool, n: int) -> np.ndarray:
        if haploid:
            return pbwt_np.haploid_rearrangement_from_diploid(self.a_weird)
        return self.a_weird[:n]

    def _weirdness_advance(self, steps: int) -> None:
        for _ in range(steps):
            p = self.weird_pos
            n = self._current_n_haps(min(p, self.binary_lines - 1))
            has_miss = self.line_has_missing is not None and self.line_has_missing[p]
            has_eov = self.line_has_eov is not None and self.line_has_eov[p]
            if self.weirdness_strat == WeirdnessStrategy.WS_SPARSE:
                if has_miss:
                    _, cnt = self._sparse_head(self.missing_sparse, self.missing_sparse_pos)
                    self.missing_sparse_pos += 1 + cnt
                if has_eov:
                    _, cnt = self._sparse_head(self.eov_sparse, self.eov_sparse_pos)
                    self.eov_sparse_pos += 1 + cnt
            else:
                y_m = y_e = None
                if has_miss:
                    y_m, used = wah_np.wah_decode(self.missing_wah[self.missing_wah_pos:], n)
                    self.missing_wah_pos += used
                if has_eov:
                    y_e, used = wah_np.wah_decode(self.eov_wah[self.eov_wah_pos:], n)
                    self.eov_wah_pos += used
                if (self.weirdness_strat == WeirdnessStrategy.WS_PBWT_WAH
                        and not self.haploid_line[p]):
                    if y_m is not None and y_e is not None:
                        self.a_weird = pbwt_np.pbwt_sort_two_bool(
                            self.a_weird, y_m[:self.n_haps], y_e[:self.n_haps])
                    elif y_m is not None:
                        self.a_weird = pbwt_np.pbwt_sort_bool(self.a_weird, y_m[:self.n_haps])
                    elif y_e is not None:
                        self.a_weird = pbwt_np.pbwt_sort_bool(self.a_weird, y_e[:self.n_haps])
            self.weird_pos += 1

    def _phase_advance(self, steps: int) -> None:
        for _ in range(steps):
            p = self.phase_pos
            if self.line_has_nup is not None and self.line_has_nup[p]:
                n = self._current_n_haps(min(p, self.binary_lines - 1))
                self.phase_wah_pos += wah_np.wah_words_consumed(
                    self.phase_wah[self.phase_wah_pos:], n)
            self.phase_pos += 1

    def seek(self, position: int) -> None:
        if position == self.pos:
            return
        if position < self.pos:
            self.reset()
        while self.pos < position:
            self._advance_main(extract=False)
            if self.has_weirdness:
                self._weirdness_advance(1)
            if self.has_nup:
                self._phase_advance(1)
            self.pos += 1

    # ---------------------------------------------------------------- fill
    def fill_genotype_array_advance(self, n_alleles: int) -> np.ndarray:
        """Decode the record starting at the cursor into an int32 gt array."""
        if n_alleles <= 1:
            # zero-ALT (monomorphic) records own no binary line: all-REF
            # with default phasing, nothing consumed (the encoder rejects
            # such records when they carry exception data)
            idx = np.arange(self.n_haps, dtype=np.int64)
            phase = ((idx & 1) & self.default_phasing).astype(np.int32)
            return np.int32(1 << 1) | phase
        start = self.pos
        n = self._current_n_haps(start)
        haploid = bool(self.haploid_line[start])
        dp = self.default_phasing
        gt = np.zeros(n, np.int32)
        counts = np.zeros(max(n_alleles, 2), np.int64)
        total_alt = 0
        n_missing = 0
        n_eovs = 0

        idx = np.arange(n, dtype=np.int64)
        # Haploid lines carry one slot per sample: no phase bit anywhere
        # (the encoder never writes one; the WAH branches below already
        # omit it -- the sparse/missing paths share this term).
        phase_term = (np.zeros(n, np.int32) if haploid
                      else ((idx & 1) & dp).astype(np.int32))

        # REF / first ALT
        y, a_before = self._advance_main(extract=True)
        if y is None:  # sparse line
            default_gt, sparse_gt = (1, 0) if self.sparse_negated else (0, 1)
            gt[:] = np.int32((default_gt + 1) << 1) | phase_term
            gt[self.sparse] = (np.int32((sparse_gt + 1) << 1)
                               | phase_term[self.sparse])
        elif haploid:
            a1 = pbwt_np.haploid_rearrangement_from_diploid(a_before)
            gt[a1] = (y[:n].astype(np.int32) + 1) << 1
        else:
            a = a_before
            gt[a] = ((y[:n].astype(np.int32) + 1) << 1) | ((a & 1) & dp).astype(np.int32)
        counts[1] = self.ones
        total_alt = self.ones
        self.pos += 1

        # further ALTs
        for alt in range(2, n_alleles):
            y, a_before = self._advance_main(extract=True)
            if y is None:  # sparse
                if self.sparse_negated:
                    ref_mask = (gt >> 1) == 1  # currently REF
                    gt[ref_mask] = np.int32((alt + 1) << 1) | phase_term[ref_mask]
                    restore = self.sparse[((gt[self.sparse] >> 1) - 1) == alt]
                    gt[restore] = np.int32(1 << 1) | phase_term[restore]
                else:
                    gt[self.sparse] = (np.int32((alt + 1) << 1)
                                       | phase_term[self.sparse])
            elif haploid:
                a1 = pbwt_np.haploid_rearrangement_from_diploid(a_before)
                sel = y[:n].astype(bool)
                gt[a1[sel]] = np.int32((alt + 1) << 1)
            else:
                tgt = a_before[y[:self.n_haps].astype(bool)]
                gt[tgt] = np.int32((alt + 1) << 1) | ((tgt & 1) & dp).astype(np.int32)
            counts[alt] = self.ones
            total_alt += self.ones
            self.pos += 1

        # Exception overlays (do not advance the track cursors; the bulk
        # advance below replays them, mirroring the reference).
        if self.has_weirdness:
            if self.line_has_missing is not None and self.line_has_missing[start]:
                if self.weirdness_strat == WeirdnessStrategy.WS_SPARSE:
                    _, cnt = self._sparse_head(self.missing_sparse, self.missing_sparse_pos)
                    midx = self.missing_sparse[
                        self.missing_sparse_pos + 1:
                        self.missing_sparse_pos + 1 + cnt].astype(np.int64)
                    n_missing = cnt
                    gt[midx] = phase_term[midx]  # missing == 0 | phase
                else:
                    y_m, _ = wah_np.wah_decode(self.missing_wah[self.missing_wah_pos:], n)
                    sel = y_m[:n].astype(bool)
                    tgt = self._weird_arrangement(haploid, n)[sel]
                    n_missing = int(sel.sum())
                    gt[tgt] = phase_term[tgt]
            if self.line_has_eov is not None and self.line_has_eov[start]:
                if self.weirdness_strat == WeirdnessStrategy.WS_SPARSE:
                    _, cnt = self._sparse_head(self.eov_sparse, self.eov_sparse_pos)
                    eidx = self.eov_sparse[
                        self.eov_sparse_pos + 1:
                        self.eov_sparse_pos + 1 + cnt].astype(np.int64)
                    n_eovs = cnt
                    gt[eidx] = np.int32(INT32_VECTOR_END)
                else:
                    y_e, _ = wah_np.wah_decode(self.eov_wah[self.eov_wah_pos:], n)
                    sel = y_e[:n].astype(bool)
                    tgt = self._weird_arrangement(haploid, n)[sel]
                    n_eovs = int(sel.sum())
                    gt[tgt] = np.int32(INT32_VECTOR_END)
            self._weirdness_advance(n_alleles - 1)

        if self.has_nup:
            if self.line_has_nup is not None and self.line_has_nup[start]:
                y_p, _ = wah_np.wah_decode(self.phase_wah[self.phase_wah_pos:], n)
                sel = y_p[:n].astype(bool) & (gt != np.int32(INT32_VECTOR_END))
                gt[sel] ^= (idx[sel] & 1).astype(np.int32)
            self._phase_advance(n_alleles - 1)

        counts[0] = n - (total_alt + n_missing + n_eovs)
        self.allele_counts = counts[:n_alleles]
        return gt

    def fill_allele_counts_advance(self, n_alleles: int) -> np.ndarray:
        if n_alleles <= 1:
            # a zero-ALT record owns no binary line: every slot REF.  One
            # count per allele, as the native engine gives them: the
            # flat walks (Accessor.fill_allele_counts_range) lay records'
            # counts back to back, so a second entry here shifts them all
            counts = np.array([self.n_haps], np.int64)
            self.allele_counts = counts
            return counts
        start = self.pos
        n = self._current_n_haps(start)
        counts = np.zeros(max(n_alleles, 2), np.int64)
        total_alt = 0
        for alt in range(1, n_alleles):
            self._advance_main(extract=False)
            counts[alt] = self.ones
            total_alt += self.ones
            self.pos += 1
        # AN excludes missing/EOV slots, matching fill_genotype_array_advance
        # (and the reference's FULL decode, accessor_internals_new.hpp:380;
        # its count-only path skips the subtraction behind a
        # "- total missing/eovs ?" comment — the two paths here stay
        # consistent instead of mirroring that quirk).  Peek the start
        # line's track counts before the bulk advance replays the streams.
        n_missing = 0
        n_eovs = 0
        if self.has_weirdness:
            if (self.line_has_missing is not None
                    and self.line_has_missing[start]):
                if self.weirdness_strat == WeirdnessStrategy.WS_SPARSE:
                    _, n_missing = self._sparse_head(
                        self.missing_sparse, self.missing_sparse_pos)
                else:
                    y_m, _ = wah_np.wah_decode(
                        self.missing_wah[self.missing_wah_pos:], n)
                    n_missing = int(y_m[:n].sum())
            if self.line_has_eov is not None and self.line_has_eov[start]:
                if self.weirdness_strat == WeirdnessStrategy.WS_SPARSE:
                    _, n_eovs = self._sparse_head(
                        self.eov_sparse, self.eov_sparse_pos)
                else:
                    y_e, _ = wah_np.wah_decode(
                        self.eov_wah[self.eov_wah_pos:], n)
                    n_eovs = int(y_e[:n].sum())
            self._weirdness_advance(max(n_alleles - 1, 0))
        if self.has_nup:
            self._phase_advance(max(n_alleles - 1, 0))
        counts[0] = n - (total_alt + int(n_missing) + int(n_eovs))
        self.allele_counts = counts[:n_alleles]
        return counts[:n_alleles]
