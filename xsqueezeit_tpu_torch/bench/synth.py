"""Synthetic chr20-like BCF input for the file-level runs.

The port's copy of xsqueezeit_tpu/bench/e2e.py synth_bcf: 2504 samples by
default, a rare-heavy site-frequency mix, phased diploid.
"""
from __future__ import annotations

import numpy as np

from ..io.bcf import (
    BcfHeader,
    BcfWriter,
    pack_type_descriptor,
    pack_typed_int,
)
from ..io.sites import encode_shared_from_vcf_cols


def synth_bcf(path: str, n_records: int, n_samples: int, seed: int = 5,
              block: int = 4096, missing_frac: float = 0.0) -> None:
    """Vectorised synthetic chr20-like BCF writer (phased diploid).

    missing_frac sprinkles that fraction of genotype slots missing
    (phase bit kept), the reference's own stress fixture
    (sprinkle_missing_xcf, xcf.cpp:444-578) — every record then carries
    a missing exception track."""
    rng = np.random.default_rng(seed)
    h = BcfHeader.from_text(
        "##fileformat=VCFv4.2\n"
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "##contig=<ID=20,length=63025520>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"S{i}" for i in range(n_samples)))
    w = BcfWriter(path, h)
    H = n_samples * 2
    gt_key = h.str2idx["GT"]
    prefix = pack_typed_int(gt_key) + pack_type_descriptor(1, 2)
    pos = 60000
    for start in range(0, n_records, block):
        n = min(block, n_records - start)
        kind = rng.random(n)
        freqs = np.where(
            kind < 0.55, rng.uniform(0.0, 0.0015, n),
            np.where(kind < 0.80, rng.uniform(0.0015, 0.05, n),
                     rng.uniform(0.05, 0.95, n)))
        # u16-threshold draw instead of float64 uniforms: the float matrix
        # alone was ~530 MB/block and dominated HRC-scale synthesis (the
        # 1/65536 frequency quantisation is irrelevant for a fixture).
        draw = rng.integers(0, 65536, (n, H), dtype=np.uint16)
        thresh = (freqs * 65536.0).astype(np.uint16)
        alleles = (draw < thresh[:, None]).astype(np.int8)
        codes = ((alleles + 1) << 1) | 1
        codes[:, ::2] &= ~1          # phase bit on second slots only
        if missing_frac:
            m = rng.random((n, H)) < missing_frac
            codes[m] &= 1            # allele -> missing, phase bit kept
        for i in range(n):
            shared = encode_shared_from_vcf_cols(
                h, ["20", str(pos), f"rs{start+i}", "G", "A", ".", "PASS",
                    "."], n_fmt=1, n_sample=n_samples)
            w.write_raw(shared, prefix + codes[i].tobytes())
            pos += 37
    w.close()
