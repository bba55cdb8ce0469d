"""PBWT-neighbor heuristic phasing (the reference's experimental L9 tool).

Re-implements the reachable capability of the xSqueezeIt reference's include/phasing.hpp
(`phase_xcf`, `rephase_samples_given_permutation`,
`score_sample_given_permutation_neighbors`): stream a diploid VCF/BCF,
maintain a PBWT haplotype arrangement (MAF > 0.01 lines sort, like the
compressor), and phase each record's heterozygous samples by majority vote
of their four phased haplotype neighbours in arrangement order; homozygous
samples phase trivially; votes from unphased neighbours don't count.  The
threshold walks 4 -> 1, re-scoring after every round so freshly phased
samples vote for their neighbours.

Two documented deviations from the reference's literal (experimental,
CLI-unreachable) code:
  * a sample phases when |score| >= threshold (sign picks min-first vs
    max-first); the reference compares the SIGNED score, so max-first
    evidence (score <= -threshold) never fires even though its
    phase_sample(polarity) handles it — an evident slip in debug code
    (phasing.hpp:150-153);
  * scoring covers every sample (the reference passes n_samples where its
    loop bound expects the gt-array length, phasing.hpp:120-124, so only
    the first half of the cohort is scored).

Everything per record is vectorised numpy; the scoring rounds move O(het)
data only.
"""
from __future__ import annotations

import numpy as np

from ..ops import pbwt_np

PLOIDY = 2
MAF = 0.01  # phasing.hpp:203


def rephase_record(gt: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Phase one record's genotypes given the PBWT arrangement `a`.

    gt: htslib int32 codes [n_haps]; returns the phased copy.
    """
    gt = np.asarray(gt, np.int32).copy()
    n_haps = gt.shape[0]
    alleles = (gt >> 1) - 1
    pair = alleles.reshape(-1, 2)
    amin = pair.min(axis=1)
    amax = pair.max(axis=1)

    # homozygous (incl. ./. and half-missing pairs with equal codes):
    # phased as-is, min|max
    hom = amin == amax
    out_pair = np.empty_like(pair)
    out_pair[:, 0] = amin
    out_pair[:, 1] = amax
    phased_flag = np.zeros(pair.shape[0], bool)
    phased_flag[hom] = True

    a = np.asarray(a)
    a_index = np.empty(n_haps, np.int64)
    a_index[a] = np.arange(n_haps)

    todo = np.flatnonzero(~hom)
    threshold = 4
    while todo.size and threshold:
        # phased-neighbour votes, fully vectorised over `todo`
        cur_alleles = np.where(phased_flag.repeat(2),
                               out_pair.reshape(-1),
                               -9)  # unphased samples don't vote
        first_pos = a_index[todo * 2]
        second_pos = a_index[todo * 2 + 1]

        def vote(pos, sign):
            ok = (pos >= 0) & (pos < n_haps)
            nb_hap = a[np.clip(pos, 0, n_haps - 1)]
            nb_allele = cur_alleles[nb_hap]
            s = np.where(nb_allele == amin[todo], 1,
                         np.where(nb_allele == amax[todo], -1, 0))
            return np.where(ok, s * sign, 0)

        score = (vote(first_pos - 1, +1) + vote(first_pos + 1, +1)
                 + vote(second_pos - 1, -1) + vote(second_pos + 1, -1))
        fire = np.abs(score) >= threshold
        if not fire.any():
            threshold -= 1
            continue
        hit = todo[fire]
        sc = score[fire]
        out_pair[hit, 0] = np.where(sc >= 0, amin[hit], amax[hit])
        out_pair[hit, 1] = np.where(sc >= 0, amax[hit], amin[hit])
        phased_flag[hit] = True
        todo = todo[~fire]

    # default-phase inconclusive samples min|max (already in out_pair)
    return (((out_pair.reshape(-1) + 1) << 1) | 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Word-window parsimony phasing (the reference's PhasingMachineryNew<T>,
# phasing.hpp:582-743, driven by new_phase_xcf, phasing.hpp:810-896)
# ---------------------------------------------------------------------------
class WindowPhaser:
    """Parsimony phasing of one W-site window (W <= 64 biallelic sites).

    Re-implements PhasingMachineryNew<T> (phasing.hpp:582-743): each
    sample's two haplotypes over the window are W-bit words (earliest
    site at the most significant bit, like extract_haplotypes_as_words,
    phasing.hpp:267-283).  Samples with <= 1 het site phase trivially and
    seed the known-haplotype multiset; remaining samples phase when a
    known haplotype explains them (same homozygous sites,
    Sample::can_be_phased_by, phasing.hpp:306-309), preferring the
    most-frequent candidate; when stuck, the first unphased sample is
    phased from its closest known haplotype by Hamming distance on
    homozygous sites (phase_a_sample_as_close_as_possible,
    phasing.hpp:686-715).

    Documented deviations from the reference's (experimental,
    CLI-unreachable) code: direct phasing runs in vectorised rounds to a
    fixpoint instead of a sequential in-pass update (the reference
    already repeats its pass until no change, phasing.hpp:619-622, so
    the fixpoint set is the same; only count tie-breaks can differ), and
    ties break deterministically (highest count, then smallest word)
    where the reference iterates an unordered_map.

    NOT ported (dead code, compiled out with `#if 0`): PhasingMachinery2
    (phasing.hpp:745-807) and the exponential-decay context rephasers
    (phasing.hpp:900-1137) — the reference's own benchmark comments
    record them losing to trivial 0|1 phasing (phasing.hpp:930-931).
    """

    def __init__(self, hap_a: np.ndarray, hap_b: np.ndarray,
                 width: int = 64):
        a = np.asarray(hap_a, np.uint64)
        b = np.asarray(hap_b, np.uint64)
        self.width = width
        self.hap_a = np.minimum(a, b)
        self.hap_b = np.maximum(a, b)
        self.het = self.hap_a ^ self.hap_b
        self.phased = np.bitwise_count(self.het) <= 1
        # known-haplotype multiset: words -> counts (hom seeds count 2,
        # phasing.hpp:627-645)
        seed = np.concatenate([self.hap_a[self.phased],
                               self.hap_b[self.phased]])
        self.haps, self.counts = self._tally(seed)
        self._run()

    @staticmethod
    def _tally(words: np.ndarray):
        if words.size == 0:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        return np.unique(words, return_counts=True)

    def _merge(self, words: np.ndarray, counts: np.ndarray):
        allw = np.concatenate([self.haps, words])
        allc = np.concatenate([self.counts, counts])
        u, inv = np.unique(allw, return_inverse=True)
        c = np.zeros(u.shape[0], np.int64)
        np.add.at(c, inv, allc)
        self.haps, self.counts = u, c

    def _direct_rounds(self, new_w: np.ndarray, new_c: np.ndarray):
        """do_direct_phasing to fixpoint against the NEW haplotypes only
        (the reference scans new_haplotypes, phasing.hpp:655), growing
        them with each newly phased sample's pair."""
        while True:
            todo = np.flatnonzero(~self.phased)
            if todo.size == 0 or new_w.size == 0:
                return new_w, new_c
            hom = self.hap_a[todo] & ~self.het[todo]
            ok = (new_w[None, :] & ~self.het[todo][:, None]) == hom[:, None]
            hit = ok.any(axis=1)
            if not hit.any():
                return new_w, new_c
            rows = todo[hit]
            # highest count wins (phasing.hpp:658-661); smallest word on tie
            score = np.where(ok[hit], new_c[None, :], -1)
            best = np.argmax(score, axis=1)
            cand = new_w[best]
            a = cand
            b = cand ^ self.het[rows]
            self.hap_a[rows] = np.minimum(a, b)
            self.hap_b[rows] = np.maximum(a, b)
            self.phased[rows] = True
            w, c = self._tally(np.concatenate(
                [self.hap_a[rows], self.hap_b[rows]]))
            allw = np.concatenate([new_w, w])
            allc = np.concatenate([new_c, c])
            u, inv = np.unique(allw, return_inverse=True)
            nc = np.zeros(u.shape[0], np.int64)
            np.add.at(nc, inv, allc)
            new_w, new_c = u, nc

    def _run(self):
        new_w, new_c = self.haps.copy(), self.counts.copy()
        self.haps = np.zeros(0, np.uint64)
        self.counts = np.zeros(0, np.int64)
        new_w, new_c = self._direct_rounds(new_w, new_c)
        self._merge(new_w, new_c)
        while not self.phased.all():
            i = int(np.flatnonzero(~self.phased)[0])
            het = self.het[i]
            hom = self.hap_a[i] & ~het
            if self.haps.size:
                d = np.bitwise_count((self.haps & ~het) ^ hom)
                m = d == d.min()
                cand_w = self.haps[m]
                cand_c = self.counts[m]
                order = np.lexsort((cand_w, -cand_c))
                h = cand_w[order[0]]
                # phase_from_imperfect_match (phasing.hpp:388-395)
                phasing = h & het
                a = hom | phasing
                b = hom | (phasing ^ het)
            else:  # no known haps at all: arbitrary 0-on-A phasing
                a, b = hom, hom | het
            self.hap_a[i] = min(a, b)
            self.hap_b[i] = max(a, b)
            self.phased[i] = True
            new_w, new_c = self._tally(
                np.array([self.hap_a[i], self.hap_b[i]], np.uint64))
            new_w, new_c = self._direct_rounds(new_w, new_c)
            self._merge(new_w, new_c)

    def allele_pair(self, j: int):
        """Alleles of every sample at window site j (MSB-first layout,
        new_phase_xcf's SHIFT, phasing.hpp:879)."""
        shift = np.uint64(self.width - 1 - j)
        one = np.uint64(1)
        return ((self.hap_a >> shift) & one).astype(np.int32), \
               ((self.hap_b >> shift) & one).astype(np.int32)


def phase_file_windows(input_path: str, output_path: str,
                       word_bits: int = 64) -> dict:
    """new_phase_xcf (phasing.hpp:810-896): window the biallelic diploid
    sites into word_bits-wide words, parsimony-phase each window
    independently, write the phased BCF.  Deviation: the tail window
    (fewer than word_bits sites) is phased too, at its natural width —
    the reference leaves those records untouched (its own
    `@todo phase the last remainder samples`, phasing.hpp:853)."""
    from ..io.bcf import BcfWriter, patch_shared_sample_counts
    from ..io.sites import encode_gt_indiv
    from ..io.unified import GtInput

    if not 1 <= word_bits <= 64:
        raise ValueError("word_bits must be in [1, 64]")

    inp = GtInput(input_path)
    n_samples = len(inp.samples)
    records = []
    for rec in inp:
        if rec.gt is None or rec.ploidy != PLOIDY:
            raise ValueError("phasing requires uniformly diploid GT data")
        if rec.n_alleles > 2:
            raise ValueError("window phasing handles biallelic sites only")
        records.append((rec.shared, (rec.gt >> 1) - 1))
    header = inp.header
    inp.close()

    # pack windows: site j of a window at bit width-1-j
    n = len(records)
    out_alleles = []
    for start in range(0, n, word_bits):
        w = min(word_bits, n - start)
        hap_a = np.zeros(n_samples, np.uint64)
        hap_b = np.zeros(n_samples, np.uint64)
        for j in range(w):
            al = records[start + j][1].reshape(-1, 2)
            shift = np.uint64(w - 1 - j)
            hap_a |= (al[:, 0].astype(np.uint64) & np.uint64(1)) << shift
            hap_b |= (al[:, 1].astype(np.uint64) & np.uint64(1)) << shift
        ph = WindowPhaser(hap_a, hap_b, width=w)
        for j in range(w):
            a, b = ph.allele_pair(j)
            out_alleles.append(np.stack([a, b], axis=1).reshape(-1))

    writer = BcfWriter(output_path, header)
    for (shared, _), alleles in zip(records, out_alleles):
        phased = (((alleles + 1) << 1) | 1).astype(np.int32)
        writer.write_raw(
            patch_shared_sample_counts(shared, n_fmt=1, n_sample=n_samples),
            encode_gt_indiv(header, phased, PLOIDY, n_samples))
    writer.close()
    return {"records": n, "samples": n_samples,
            "windows": -(-n // word_bits), "word_bits": word_bits}


def phase_file(input_path: str, output_path: str) -> dict:
    """Stream-phase a diploid VCF/BCF into a BCF (reference: phase_xcf
    writes BCF too, phasing.hpp:186)."""
    from ..io.bcf import BcfWriter, patch_shared_sample_counts
    from ..io.sites import encode_gt_indiv
    from ..io.unified import GtInput

    inp = GtInput(input_path)
    n_samples = len(inp.samples)
    n_haps = n_samples * PLOIDY
    mac_threshold = int(n_haps * MAF)
    a = np.arange(n_haps, dtype=np.int64)

    writer = BcfWriter(output_path, inp.header)

    n = 0
    for rec in inp:
        if rec.gt is None or rec.ploidy != PLOIDY:
            raise ValueError("phasing requires uniformly diploid GT data")
        phased = rephase_record(rec.gt, a)
        shared = patch_shared_sample_counts(rec.shared, n_fmt=1,
                                            n_sample=n_samples)
        writer.write_raw(shared,
                         encode_gt_indiv(inp.header, phased, PLOIDY,
                                         n_samples))
        # PBWT update on the phased output, MAF-gated like the compressor
        alleles = (phased >> 1) - 1
        for alt in range(1, rec.n_alleles):
            ac = int((alleles == alt).sum())
            if min(ac, n_haps - ac) > mac_threshold:
                a = pbwt_np.pbwt_sort(a, phased, alt)
        n += 1
    writer.close()
    inp.close()
    return {"records": n, "samples": n_samples}
