"""Adversarial test-data generators and comparison metrics.

Counterparts of the reference's xcf.cpp utilities used to manufacture
fixture files and evaluate phasing:

  unphase             sort each diploid genotype, write unphased
                      (xcf.cpp:385-442 unphase_xcf)
  unphase_random      randomly order each genotype, write unphased
                      (xcf.cpp:444-509 unphase_xcf_random)
  sprinkle_missing    set each allele missing with probability `rate`,
                      keeping its phase bit (xcf.cpp:511-578)
  count_entries       record count without genotype parsing (xcf.cpp:318-340)
  extract_matrix /    genotype bit matrices + comparison (xcf.cpp:348-373)
  matrices_differ
  unique_id           rid_pos_alleles identity string (xcf.cpp:375-383)
  extract_phase_vectors / compute_phase_switch_errors
                      per-sample phase sequences over heterozygous sites and
                      the XOR switch-error metric (xcf.cpp:732-809)

All functions read VCF/BCF through io.unified.GtInput and write BCF
(io.bcf.BcfWriter) or VCF text by extension, so they are drop-in fixture
factories for the integration tests.
"""
from __future__ import annotations

import numpy as np

from ..format.constants import INT32_VECTOR_END
from ..io.bcf import BcfRecord, BcfWriter, patch_shared_sample_counts
from ..io.sites import encode_gt_indiv, render_vcf_cols
from ..io.unified import GtInput
from ..io.vcf import VcfWriter


class _RecordWriter:
    """Writes (shared, gt) records to BCF or VCF text by output extension."""

    def __init__(self, path: str, inp: GtInput):
        self.header = inp.header
        self.samples = inp.samples
        self.is_vcf = path.endswith(".vcf") or path.endswith(".vcf.gz") \
            or path == "-"
        if self.is_vcf:
            lines = [l for l in self.header.to_text().splitlines()
                     if l.startswith("##")]
            self._w = VcfWriter(path, lines, self.samples)
        else:
            self._w = BcfWriter(path, self.header)

    def write(self, shared: bytes, gt: np.ndarray | None, ploidy: int):
        if self.is_vcf:
            rec = BcfRecord.parse(
                patch_shared_sample_counts(shared, 0, len(self.samples)), b"")
            cols = render_vcf_cols(self.header, rec)
            self._w.write_record(cols, gt, ploidy)
        else:
            if gt is None:
                self._w.write_raw(
                    patch_shared_sample_counts(shared, 0, len(self.samples)),
                    b"")
            else:
                indiv = encode_gt_indiv(self.header, gt, ploidy,
                                        len(self.samples))
                self._w.write_raw(
                    patch_shared_sample_counts(shared, 1, len(self.samples)),
                    indiv)

    def close(self):
        self._w.close()


def _mutate_file(in_path: str, out_path: str, fn) -> int:
    inp = GtInput(in_path)
    out = _RecordWriter(out_path, inp)
    n = 0
    for rec in inp:
        gt = rec.gt
        if gt is not None:
            gt = fn(np.array(gt, np.int32), rec.ploidy)
        out.write(rec.shared, gt, rec.ploidy)
        n += 1
    out.close()
    inp.close()
    return n


def unphase(in_path: str, out_path: str) -> int:
    """Sort each diploid genotype's alleles and mark both unphased."""

    def fn(gt, ploidy):
        if ploidy != 2:
            raise ValueError("unphase requires diploid records")
        alleles = (gt >> 1) - 1
        pairs = alleles.reshape(-1, 2)
        lo = pairs.min(axis=1)
        hi = pairs.max(axis=1)
        out = np.empty_like(gt)
        out[0::2] = (lo + 1) << 1
        out[1::2] = (hi + 1) << 1
        return out

    return _mutate_file(in_path, out_path, fn)


def unphase_random(in_path: str, out_path: str, seed: int | None = None) -> int:
    """Randomly order each diploid genotype's alleles, mark unphased."""
    rng = np.random.default_rng(seed)

    def fn(gt, ploidy):
        if ploidy != 2:
            raise ValueError("unphase_random requires diploid records")
        pairs = ((gt >> 1) - 1).reshape(-1, 2)
        swap = rng.integers(0, 2, pairs.shape[0]).astype(bool)
        lo = np.where(swap, pairs[:, 1], pairs[:, 0])
        hi = np.where(swap, pairs[:, 0], pairs[:, 1])
        out = np.empty_like(gt)
        out[0::2] = (lo + 1) << 1
        out[1::2] = (hi + 1) << 1
        return out

    return _mutate_file(in_path, out_path, fn)


def sprinkle_missing(in_path: str, out_path: str, rate: float = 0.01,
                     seed: int | None = None) -> int:
    """Set each allele to missing with probability `rate`, keeping phase."""
    rng = np.random.default_rng(seed)

    def fn(gt, ploidy):
        hit = rng.random(gt.shape[0]) < rate
        # missing with same phase bit: bcf encoding of allele -1 is 0|phase
        return np.where(hit, gt & 1, gt).astype(np.int32)

    return _mutate_file(in_path, out_path, fn)


def inject_phase_switches(in_path: str, out_path: str, prob: float = 0.01,
                          seed: int | None = None) -> int:
    """Per-sample phase-switch error injection: at each het site a sample
    toggles its phase state with probability `prob`, and while toggled its
    two allele values are swapped (the reference's
    BcfMatrix::inject_phase_switch_errors, bcf_traversal.hpp:196-218 —
    deterministic here via `seed`; the reference uses random_device).
    Returns the number of switch events injected."""
    rng = np.random.default_rng(seed)
    state: dict = {}
    events = 0

    def fn(gt, ploidy):
        nonlocal events
        if ploidy != 2:
            raise ValueError("inject_phase_switches requires diploid records")
        n = gt.shape[0] // 2
        tog = state.setdefault("tog", np.zeros(n, bool))
        a = (gt[0::2] >> 1) - 1
        b = (gt[1::2] >> 1) - 1
        het = a != b
        flips = het & (rng.random(n) < prob)
        tog ^= flips
        events += int(flips.sum())
        # swap allele VALUES between the slots, keep positional phase bits
        # (matches the reference's carrier-matrix view, which has no
        # per-slot phase payload); leave EOV-padded samples untouched
        from ..format.constants import INT32_VECTOR_END
        eov = np.int32(INT32_VECTOR_END)
        sw = tog & (gt[0::2] != eov) & (gt[1::2] != eov)
        va, vb = gt[0::2] >> 1, gt[1::2] >> 1
        pa, pb = gt[0::2] & 1, gt[1::2] & 1
        out = np.array(gt, np.int32)
        out[0::2] = (np.where(sw, vb, va) << 1) | pa
        out[1::2] = (np.where(sw, va, vb) << 1) | pb
        return out

    _mutate_file(in_path, out_path, fn)
    return events


def count_entries(path: str) -> int:
    inp = GtInput(path)
    n = sum(1 for _ in inp)
    inp.close()
    return n


def unique_id(rec: BcfRecord) -> str:
    return "_".join([str(rec.rid), str(rec.pos)] + list(rec.alleles)) + "_"


def extract_matrix(path: str) -> np.ndarray:
    """Genotype carrier-bit matrix [variants, haplotypes] (bi-allelic view:
    bit = allele != 0), mirroring the reference's extract_matrix."""
    inp = GtInput(path)
    rows = []
    for rec in inp:
        if rec.gt is None:
            continue
        alleles = (rec.gt >> 1) - 1
        rows.append(alleles > 0)
    inp.close()
    return (np.stack(rows) if rows else np.zeros((0, 0), bool))


def matrices_differ(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape != b.shape or not np.array_equal(a, b)


def extract_phase_vectors(path: str) -> list[np.ndarray]:
    """Per-sample phase sequence over heterozygous sites: 1 if the second
    allele is larger, 0 if smaller; homozygous sites are skipped."""
    inp = GtInput(path)
    seqs: list[list[int]] = [[] for _ in inp.samples]
    for rec in inp:
        if rec.gt is None:
            continue
        if rec.ploidy != 2:
            raise ValueError("phase vectors require diploid records")
        alleles = (rec.gt >> 1) - 1
        pairs = alleles.reshape(-1, 2)
        diff = pairs[:, 1] - pairs[:, 0]
        for s in np.flatnonzero(diff != 0):
            seqs[s].append(1 if diff[s] > 0 else 0)
    inp.close()
    return [np.asarray(s, np.uint8) for s in seqs]


def compute_phase_switch_errors(test_path: str, ref_path: str) -> dict:
    """Count phase switch errors per sample between two files.

    A switch error at het site i is test[i-1]^test[i]^ref[i-1]^ref[i]
    (consecutive-het XOR metric, xcf.cpp:768-781).
    """
    test = extract_phase_vectors(test_path)
    ref = extract_phase_vectors(ref_path)
    if len(test) != len(ref):
        raise ValueError("sample count differs")
    per_sample = []
    total_sites = 0
    for t, r in zip(test, ref):
        if t.shape != r.shape:
            raise ValueError("heterozygous-site counts differ")
        if len(t) < 2:
            per_sample.append(0)
            continue
        x = (t[:-1] ^ t[1:] ^ r[:-1] ^ r[1:]).astype(bool)
        per_sample.append(int(x.sum()))
        total_sites += len(t) - 1
    return {"per_sample": per_sample, "total": int(sum(per_sample)),
            "comparable_sites": total_sites,
            "rate": (sum(per_sample) / total_sites) if total_sites else 0.0}
