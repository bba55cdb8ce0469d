"""PBWT arrangement updates — NumPy oracle.

The Durbin-2014 positional Burrows-Wheeler transform step is a stable
partition of the haplotype arrangement `a` by the current column's bit:
haplotypes whose bit is 0 keep their relative order at the front, those with
bit 1 are appended (also order-preserving).  Semantics restated from
the xSqueezeIt reference's include/internal_gt_record.hpp:33-59 and gt_block.hpp:106-151.

All functions are vectorised; the stable partition of a binary key is exactly
`a[argsort(key, stable)]`, computed here with cumulative sums (O(N), no sort).
"""
from __future__ import annotations

import numpy as np


def stable_partition(a: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Return `a` stably partitioned by boolean `key` (False first).

    key[i] applies to element a[i] (i.e. the key is already in arrangement
    order, as produced by gathering the column through `a`).
    """
    key = np.asarray(key, bool)
    return np.concatenate([a[~key], a[key]])


def pbwt_sort(a: np.ndarray, column: np.ndarray, alt_allele: int) -> np.ndarray:
    """Arrangement update for a diploid WAH line.

    `column` is the htslib-encoded gt array in natural order; the predicate is
    allele == alt_allele, evaluated through the arrangement.
    """
    allele = (np.asarray(column) >> 1) - 1
    key = allele[a] == alt_allele
    return stable_partition(a, key)


def pbwt_sort_haploid(a: np.ndarray, column: np.ndarray, alt_allele: int) -> np.ndarray:
    """Arrangement update for an all-haploid line over a diploid arrangement.

    The column has one entry per *sample*; arrangement entries index
    haplotypes, so entry a[i] looks up column[a[i] // 2]
    (reference: pbwt_sort1 -> pbwt_sort_<T, 2>).
    """
    allele = (np.asarray(column) >> 1) - 1
    key = allele[np.asarray(a) // 2] == alt_allele
    return stable_partition(a, key)


def pbwt_sort_bool(a: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Arrangement update from a decoded bit vector in arrangement order."""
    return stable_partition(a, np.asarray(y, bool))


def pbwt_sort_bool_haploid(a: np.ndarray, y: np.ndarray, n_samples: int) -> np.ndarray:
    """Decoder-side arrangement update for a haploid line.

    y has n_samples entries ordered by the haploid arrangement a1 (even
    entries of `a`, divided by 2); scatter it back to natural sample order,
    then partition the diploid arrangement by x[a[i] // 2]
    (reference: accessor_internals_new.hpp private_pbwt_sort<2>).
    """
    a = np.asarray(a)
    a1 = haploid_rearrangement_from_diploid(a)
    x = np.zeros(n_samples, bool)
    x[a1] = np.asarray(y[:n_samples], bool)
    return stable_partition(a, x[a // 2])


def pbwt_sort_two_bool(a: np.ndarray, y1: np.ndarray, y2: np.ndarray) -> np.ndarray:
    """Partition by the OR of two bit vectors (weirdness arrangement)."""
    key = np.asarray(y1, bool) | np.asarray(y2, bool)
    return stable_partition(a, key)


def haploid_rearrangement_from_diploid(a: np.ndarray) -> np.ndarray:
    """Derive the haploid arrangement: even haplotype ids of `a`, halved.

    (reference: interfaces.hpp haploid_rearrangement_from_diploid)
    """
    a = np.asarray(a)
    return (a[(a & 1) == 0] // 2).astype(a.dtype)


def pbwt_encode_parity(alleles: np.ndarray, alts: np.ndarray,
                       sorts: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle for the parity-carrying block encode (mixed-ploidy blocks).

    alleles[L, H] are allele codes per line in SLOT-DUPLICATED form: a
    haploid line stores each sample's allele in both of its slots, so the
    partition predicate `alleles[l, a] == alt` evaluates per SAMPLE through
    the diploid arrangement — exactly `pbwt_sort_haploid`'s
    `allele[a // 2] == alt` (reference pbwt_sort1 -> pbwt_sort_<T, 2>).

    Returns (ys uint8[L, H] bits in arrangement order,
             par uint8[L, H] slot parity a & 1 in arrangement order,
             a_final int32[H]).
    A haploid line's emitted WAH bits are ys[l] restricted to par[l] == 0
    (the even-slot subsequence = haploid_rearrangement_from_diploid order).
    """
    alleles = np.asarray(alleles)
    L, H = alleles.shape
    a = np.arange(H, dtype=np.int32)
    ys = np.zeros((L, H), np.uint8)
    par = np.zeros((L, H), np.uint8)
    for l in range(L):
        key = alleles[l][a] == alts[l]
        ys[l] = key
        par[l] = a & 1
        if sorts[l]:
            a = stable_partition(a, key)
    return ys, par, a


def pbwt_sort_weirdness(a: np.ndarray, column: np.ndarray) -> np.ndarray:
    """Encoder-side weirdness arrangement update (WS_PBWT_WAH strategy).

    Predicate: entry is missing or end-of-vector
    (reference: gt_block.hpp WeirdnessPred + pred_pbwt_sort).
    """
    col = np.asarray(column)
    is_missing = (col >> 1) == 0
    is_missing |= col == np.int32(-0x80000000)
    is_eov = col == np.int32(-0x7FFFFFFF)
    key = (is_missing | is_eov)[a]
    return stable_partition(a, key)
