"""PBWT bitmap visualizations — counterpart of the reference's debug layer
(the xSqueezeIt reference's include/bitmap.hpp: plain / PBWT-sorted genotype bitmaps,
reachable there via commented-out debug flags, xsqueezeit.hpp:60-82).

Bitmaps render the carrier matrix of bi-allelic views: rows = variants,
columns = haplotypes.  The sorted variant applies the evolving PBWT
arrangement to each row, which makes the haplotype-block structure the
codec exploits visible (long same-value runs -> WAH fills).
"""
from __future__ import annotations

import numpy as np

from ..io.unified import GtInput
from ..ops import pbwt_np


def gt_bitmap(path: str, max_records: int | None = None) -> np.ndarray:
    """Carrier-bit matrix bool[variants, haplotypes] in natural order."""
    inp = GtInput(path)
    rows = []
    for i, rec in enumerate(inp):
        if max_records is not None and i >= max_records:
            break
        if rec.gt is None:
            continue
        rows.append(((rec.gt >> 1) - 1) > 0)
    inp.close()
    return np.stack(rows) if rows else np.zeros((0, 0), bool)


def pbwt_sorted_bitmap(path: str, max_records: int | None = None,
                       reset_every: int | None = None) -> np.ndarray:
    """Carrier bits with each row permuted by the PBWT arrangement built
    from the previous rows (reset to identity every `reset_every` rows to
    mirror block boundaries)."""
    plain = gt_bitmap(path, max_records)
    if plain.size == 0:
        return plain
    L, H = plain.shape
    a = np.arange(H)
    out = np.zeros_like(plain)
    for l in range(L):
        if reset_every and l % reset_every == 0:
            a = np.arange(H)
        out[l] = plain[l][a]
        a = pbwt_np.stable_partition(a, plain[l][a])
    return out


def _common_rows(path: str, threshold: float = 0.01):
    """Carrier-bit rows of 'common' binary lines (one per ALT allele with
    minor allele count above threshold*haplotypes — the gate all of
    bitmap.hpp's extract_common_* variants apply; the reference computes
    the minor count against n_samples rather than haplotypes, a
    debug-layer quirk not copied here)."""
    inp = GtInput(path)
    for rec in inp:
        if rec.gt is None:
            continue
        alleles = (rec.gt >> 1) - 1
        h = alleles.shape[0]
        for alt in range(1, rec.n_alleles):
            bits = alleles == alt
            c = int(bits.sum())
            if min(c, h - c) > h * threshold:
                yield bits
    inp.close()


def final_sorted_bitmap(path: str, threshold: float = 0.01) -> np.ndarray:
    """Every common line rendered under the FINAL PBWT arrangement (built
    by sorting through all lines first) — the 'how much structure does the
    end-state ordering expose retroactively' view
    (bitmap.hpp:304 extract_common_to_file_sorted)."""
    rows = [r for r in _common_rows(path, threshold)]
    if not rows:
        return np.zeros((0, 0), bool)
    h = rows[0].shape[0]
    a = np.arange(h)
    for bits in rows:
        a = pbwt_np.stable_partition(a, bits[a])
    return np.stack([bits[a] for bits in rows])


def block_sorted_bitmap(path: str, block_size: int, pbwt: bool = False,
                        threshold: float = 0.01) -> np.ndarray:
    """Each block of `block_size` common lines rendered under ONE fixed
    arrangement: the PBWT state at the block's start (pbwt=True, the
    codec's own per-block view) or at its end (pbwt=False, the
    'arrangement built from the block applied to itself' view) —
    bitmap.hpp:485 extract_common_to_file_block_sorted, including its
    snapshot placement."""
    rows = [r for r in _common_rows(path, threshold)]
    if not rows:
        return np.zeros((0, 0), bool)
    h = rows[0].shape[0]
    a = np.arange(h)
    snaps = []
    for i, bits in enumerate(rows):
        if (i + pbwt) and i % block_size == 0:
            snaps.append(a.copy())
        a = pbwt_np.stable_partition(a, bits[a])
    snaps.append(a.copy())
    out = np.zeros((len(rows), h), bool)
    block = 0
    cur = snaps[0]
    for i, bits in enumerate(rows):
        if i and i % block_size == 0:
            block += 1
            cur = snaps[min(block, len(snaps) - 1)]
        out[i] = bits[cur]
    return out


def tree_sorted_bitmap(path: str, threshold: float = 0.01,
                       max_splits: int = 32) -> np.ndarray:
    """Partial 'tree-like' PBWT: lines partition only WITHIN the segments
    delimited by previously-kept split points; a split survives when the
    line divides its segment roughly evenly (0.4-0.6), and the split set
    clears when fragmentation exceeds `max_splits`
    (bitmap.hpp:198 extract_common_to_file_tree_sorted)."""
    rows = [r for r in _common_rows(path, threshold)]
    if not rows:
        return np.zeros((0, 0), bool)
    h = rows[0].shape[0]
    a = np.arange(h)
    splits: set[int] = set()
    out = np.zeros((len(rows), h), bool)
    for i, bits in enumerate(rows):
        out[i] = bits[a]
        bounds = sorted(splits) + [h]
        new_splits = []
        prev = 0
        for b in bounds:
            seg = a[prev:b]
            y = bits[seg]
            zeros, ones = seg[~y], seg[y]
            a[prev:prev + zeros.shape[0]] = zeros
            a[prev + zeros.shape[0]:b] = ones
            ratio = zeros.shape[0] / max(b - prev, 1)
            if 0.4 < ratio < 0.6:
                new_splits.append(prev + zeros.shape[0])
            prev = b
        splits.update(new_splits)
        if len(splits) > max_splits:
            splits.clear()
    return out


def pbwt_color_bitmap(path: str, threshold: float = 0.01) -> np.ndarray:
    """The evolving arrangement itself, one row per common line: cell
    (l, i) is the haplotype index at arrangement slot i before line l's
    sort — rendering haplotype IDENTITY movement through the PBWT as
    color (bitmap.hpp:406 extract_common_to_file_pbwt_color)."""
    rows = [r for r in _common_rows(path, threshold)]
    if not rows:
        return np.zeros((0, 0), np.int32)
    h = rows[0].shape[0]
    a = np.arange(h)
    out = np.zeros((len(rows), h), np.int32)
    for i, bits in enumerate(rows):
        out[i] = a
        a = pbwt_np.stable_partition(a, bits[a])
    return out


def dump_common(path: str, ofname: str, mode: str = "plain",
                block_size: int = 32, threshold: float = 0.01) -> dict:
    """Write a bitmap in the reference's raw dump format (0xFF/0x00 bytes
    per cell; u16 haplotype ids for 'color'), one row per common line.
    Modes: plain, pbwt, sorted, block, block_pbwt, tree, color."""
    if mode == "plain":
        rows = np.stack(list(_common_rows(path, threshold)))
    elif mode == "pbwt":
        rows = []
        a = None
        for bits in _common_rows(path, threshold):
            if a is None:
                a = np.arange(bits.shape[0])
            rows.append(bits[a])
            a = pbwt_np.stable_partition(a, bits[a])
        rows = (np.stack(rows) if rows else np.zeros((0, 0), bool))
    elif mode == "sorted":
        rows = final_sorted_bitmap(path, threshold)
    elif mode in ("block", "block_pbwt"):
        rows = block_sorted_bitmap(path, block_size,
                                   pbwt=(mode == "block_pbwt"),
                                   threshold=threshold)
    elif mode == "tree":
        rows = tree_sorted_bitmap(path, threshold)
    elif mode == "color":
        arr = pbwt_color_bitmap(path, threshold)
        with open(ofname, "wb") as f:
            f.write(arr.astype(np.uint16).tobytes())
        return {"rows": arr.shape[0], "haps": arr.shape[1] if arr.size else 0,
                "bytes": arr.size * 2}
    else:
        raise ValueError(f"unknown bitmap mode {mode!r}")
    with open(ofname, "wb") as f:
        f.write(np.where(rows, 0xFF, 0).astype(np.uint8).tobytes())
    return {"rows": rows.shape[0], "haps": rows.shape[1] if rows.size else 0,
            "bytes": rows.size}


def save_pbm(path: str, bitmap: np.ndarray) -> None:
    """Write a portable bitmap (P4) image: black = carrier."""
    h, w = bitmap.shape
    packed = np.packbits(bitmap.astype(np.uint8), axis=1)
    with open(path, "wb") as f:
        f.write(f"P4\n{w} {h}\n".encode())
        f.write(packed.tobytes())
