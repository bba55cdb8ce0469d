"""Word-Aligned-Hybrid (WAH2) 16-bit run-length codec — NumPy implementation.

This is the portable oracle for the WAH2 wire format used by XSI
(format spec restated from the xSqueezeIt reference's include/wah.hpp:75-105):

  * A WAH word is 16 bits.  Bit 15 (MSB) selects the word kind:
      - 0: literal.  Bits 0..14 are 15 payload bits, LSB-first, i.e. bit j of
        the word is input bit (word_index*15 + j).
      - 1: counter.  Bit 14 is the fill value; bits 0..13 are a 14-bit count
        of *words* (15-bit groups), max 16383.
  * Input bit vectors are conceptually padded with zeros to a multiple of 15.
  * An encoder run is flushed when the class of the next word changes, when
    a literal word appears, or when the counter saturates at 16383.

Everything here is vectorised numpy (no Python per-bit loops) so the oracle
itself is fast enough for multi-million-variant regression tests.  The JAX /
Pallas device kernels in xsqueezeit_tpu.ops.wah_jax are tested against this.
"""
from __future__ import annotations

import numpy as np

WAH_BITS = 15
WAH_HIGH_BIT = 1 << 15          # counter-word flag
WAH_COUNT_1_BIT = 1 << 14       # fill-value bit
WAH_MAX_COUNTER = (1 << 14) - 1  # 16383
WAH_ALL_SET = 0x7FFF

_POW2 = (1 << np.arange(WAH_BITS, dtype=np.uint16)).astype(np.uint16)


def pack_words(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 vector into 15-bit LSB-first words (zero padded).

    Routes through np.packbits on 16-bit-aligned groups (high bit zero)
    rather than a multiply-reduce over a [..., W, 15] intermediate — the
    packbits form is ~20x faster and this sits on the host encode's
    critical path (wah_encode_rows over every sorting line of a block)."""
    bits = np.asarray(bits)
    n = bits.shape[-1]
    n_words = (n + WAH_BITS - 1) // WAH_BITS
    lead = bits.shape[:-1]
    if n == 0:
        return np.zeros(lead + (0,), np.uint16)
    rows = int(np.prod(lead)) if lead else 1
    buf = np.zeros((rows, n_words, 16), np.uint8)
    flat_in = bits.reshape(rows, n)
    full = n // WAH_BITS
    whole = full * WAH_BITS
    if full:
        buf[:, :full, :WAH_BITS] = flat_in[:, :whole].reshape(rows, full, WAH_BITS)
    if whole != n:
        buf[:, -1, : n - whole] = flat_in[:, whole:]
    packed = np.packbits(buf, axis=-1, bitorder="little")   # [..., W, 2]
    return packed.reshape(lead + (n_words, 2)).view("<u2")[..., 0]


def unpack_words(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Inverse of pack_words (literal words only).

    np.unpackbits over the little-endian byte view (drop bit 15 of each
    word) — ~10x faster than the shift-broadcast form; this feeds the
    host decoder's whole-block WAH bit cache."""
    words = np.ascontiguousarray(words, dtype="<u2")
    lead = words.shape[:-1]
    w = words.shape[-1]
    if w == 0:
        return np.zeros(lead + (0,), np.uint8)
    by = words.reshape(-1, w).view(np.uint8)          # [rows, 2w]
    bits16 = np.unpackbits(by, axis=-1, bitorder="little")
    bits = bits16.reshape(-1, w, 16)[:, :, :WAH_BITS]
    return bits.reshape(lead + (w * WAH_BITS,))[..., :n_bits]


def wah_encode(bits: np.ndarray) -> np.ndarray:
    """WAH2-encode a 1-D 0/1 vector. Returns uint16 word array."""
    words = pack_words(np.asarray(bits))
    return wah_encode_words(words)


def wah_encode_words(words: np.ndarray) -> np.ndarray:
    """WAH2-encode already-packed 15-bit words (1-D uint16)."""
    words = np.asarray(words, dtype=np.uint16)
    n = words.shape[0]
    if n == 0:
        return np.zeros(0, np.uint16)

    is_zero = words == 0
    is_ones = words == WAH_ALL_SET
    is_fill = is_zero | is_ones
    # Class id: 0 = zero-fill, 1 = one-fill, 2+i = literal i (unique per literal
    # so every literal is its own run).
    cls = np.where(is_zero, 0, np.where(is_ones, 1, 2 + np.arange(n)))
    boundary = np.empty(n, bool)
    boundary[0] = True
    boundary[1:] = cls[1:] != cls[:-1]
    run_id = np.cumsum(boundary) - 1
    run_starts = np.flatnonzero(boundary)
    # Position within run; saturated counters split runs every WAH_MAX_COUNTER.
    pos_in_run = np.arange(n) - run_starts[run_id]
    sub_boundary = boundary | (is_fill & (pos_in_run % WAH_MAX_COUNTER == 0) & (pos_in_run > 0))
    sub_id = np.cumsum(sub_boundary) - 1
    sub_starts = np.flatnonzero(sub_boundary)
    # Last element of each sub-run emits the output word.
    emit = np.empty(n, bool)
    emit[:-1] = sub_id[1:] != sub_id[:-1]
    emit[-1] = True
    sub_len = (np.arange(n) - sub_starts[sub_id] + 1).astype(np.uint16)
    fill_word = (WAH_HIGH_BIT | np.where(is_ones, WAH_COUNT_1_BIT, 0) | sub_len).astype(np.uint16)
    out_word = np.where(is_fill, fill_word, words)
    return out_word[emit]


def wah_encode_rows(bits2d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """WAH2-encode every row of a [R, H] 0/1 matrix in ONE vectorised pass.

    Returns (concatenated output words in row order, words-emitted-per-row).
    Byte-identical to `np.concatenate([wah_encode(row) for row in bits2d])`
    (run boundaries are forced at row starts, all scans stay global) —
    the batched form the block encoders use so per-row Python call
    overhead never dominates (~150 us/row for the loop form).
    """
    bits2d = np.asarray(bits2d)
    R = bits2d.shape[0]
    if R == 0 or bits2d.shape[1] == 0:
        return np.zeros(0, np.uint16), np.zeros(R, np.int64)
    words = pack_words(bits2d)            # [R, W]
    W = words.shape[1]
    flat = words.reshape(-1)
    n = flat.shape[0]
    idx = np.arange(n)
    is_zero = flat == 0
    is_ones = flat == WAH_ALL_SET
    is_fill = is_zero | is_ones
    cls = np.where(is_zero, 0, np.where(is_ones, 1, 2 + idx))
    boundary = np.empty(n, bool)
    boundary[0] = True
    boundary[1:] = cls[1:] != cls[:-1]
    boundary |= (idx % W) == 0            # rows never share a run
    run_id = np.cumsum(boundary) - 1
    run_starts = np.flatnonzero(boundary)
    pos_in_run = idx - run_starts[run_id]
    sub_boundary = boundary | (is_fill & (pos_in_run % WAH_MAX_COUNTER == 0)
                               & (pos_in_run > 0))
    sub_id = np.cumsum(sub_boundary) - 1
    sub_starts = np.flatnonzero(sub_boundary)
    emit = np.empty(n, bool)
    emit[:-1] = sub_id[1:] != sub_id[:-1]
    emit[-1] = True
    sub_len = (idx - sub_starts[sub_id] + 1).astype(np.uint16)
    fill_word = (WAH_HIGH_BIT | np.where(is_ones, WAH_COUNT_1_BIT, 0)
                 | sub_len).astype(np.uint16)
    out_word = np.where(is_fill, fill_word, flat)
    lens = np.bincount(idx[emit] // W, minlength=R)
    return out_word[emit], lens


def validate_wah_stream(words: np.ndarray, name: str = "WAH") -> None:
    """Reject counter words with a zero count.

    The in-repo encoder never emits them, but the decoder also accepts
    foreign/corrupt files, where a zero-count counter would make two words
    claim the same output slot — the device expansion kernels
    (wah_jax.wah_expand_stream, wah_pallas) would then produce silently
    wrong genotypes instead of an error.  One vectorised pass at block-parse
    time; padding zeros are literal words and pass.
    """
    words = np.asarray(words, dtype=np.uint16)
    bad = ((words & WAH_HIGH_BIT) != 0) & ((words & WAH_MAX_COUNTER) == 0)
    if bad.any():
        raise ValueError(
            f"{name} stream: counter word with zero count at word index "
            f"{int(np.flatnonzero(bad)[0])} (corrupt or non-conforming "
            f"encoder)")


def wah_words_consumed(words: np.ndarray, n_bits: int) -> int:
    """Number of leading WAH words that cover n_bits decoded bits.

    Mirrors wah2_advance_pointer semantics: consume words while the running
    decoded bit count is < n_bits.
    """
    if n_bits == 0:
        return 0
    words = np.asarray(words, dtype=np.uint16)
    # A line of n_bits bits consumes at most ceil(n_bits/15) words (every
    # word covers >= 15 decoded bits).  Callers hand in the whole remaining
    # stream; without this window the per-line cumsum makes a sequential
    # block decode O(stream^2) (round-2 profile: 8.4 s of an 10.8 s
    # chr20-scale decompress).
    cap = (n_bits + WAH_BITS - 1) // WAH_BITS + 1
    if words.shape[0] > cap:
        words = words[:cap]
    is_counter = (words & WAH_HIGH_BIT) != 0
    span = np.where(is_counter, (words & WAH_MAX_COUNTER).astype(np.int64) * WAH_BITS, WAH_BITS)
    cum = np.cumsum(span)
    return int(np.searchsorted(cum, n_bits, side="left")) + 1


def wah_decode(words: np.ndarray, n_bits: int) -> tuple[np.ndarray, int]:
    """Decode n_bits from a WAH2 stream.

    Returns (bits[uint8, n_bits], words_consumed).
    """
    if n_bits == 0:
        return np.zeros(0, np.uint8), 0
    words = np.asarray(words, dtype=np.uint16)
    n_used = wah_words_consumed(words, n_bits)
    used = words[:n_used]
    is_counter = (used & WAH_HIGH_BIT) != 0
    span = np.where(is_counter, (used & WAH_MAX_COUNTER).astype(np.int64) * WAH_BITS, WAH_BITS)
    starts = np.concatenate([[0], np.cumsum(span)[:-1]])
    total = int(starts[-1] + span[-1])
    out = np.zeros(total, np.uint8)
    # Fill-one runs
    one_runs = np.flatnonzero(is_counter & ((used & WAH_COUNT_1_BIT) != 0))
    for idx in one_runs:  # rare: python loop over runs, each a slice assign
        out[starts[idx]:starts[idx] + span[idx]] = 1
    # Literals
    lit_idx = np.flatnonzero(~is_counter)
    if lit_idx.size:
        lit_bits = unpack_words(used[lit_idx], lit_idx.size * WAH_BITS)
        dest = (starts[lit_idx][:, None] + np.arange(WAH_BITS)[None, :]).reshape(-1)
        out[dest] = lit_bits
    return out[:n_bits], n_used


def wah_expand_block(stream: np.ndarray, n_lines: int, w: int) -> np.ndarray:
    """Expand a uniform-width WAH stream to packed 15-bit groups, whole
    block at once (the numpy mirror of wah_jax.wah_expand_stream).

    stream holds the WAH words of `n_lines` lines back to back, each line
    spanning exactly w 15-bit groups (the codec invariant: lines pad to
    w*15 bits, so fill counters never straddle a line boundary).  Trailing
    words beyond the grid are ignored.  Returns uint16[n_lines, w].

    One vectorised pass replaces per-line wah_decode calls, whose fixed
    numpy overhead dominates the host-path block decode.
    """
    s = np.asarray(stream).astype(np.int64)
    is_counter = (s & WAH_HIGH_BIT) != 0
    span = np.where(is_counter, s & WAH_MAX_COUNTER, 1)
    start = np.cumsum(span) - span
    total = n_lines * w
    valid = start < total
    # plant (pos_in_row+1) << 16 | word at each run start; an in-row
    # running max forward-fills counter coverage (zero-count counters --
    # which would collide -- are rejected at parse time)
    packed = (((start % w) + 1) << 16) | s
    z = np.zeros(total, np.int64)
    z[start[valid]] = packed[valid]
    z = z.reshape(n_lines, w)
    np.maximum.accumulate(z, axis=1, out=z)
    word = z & 0xFFFF
    fill = np.where((word & WAH_COUNT_1_BIT) != 0, WAH_ALL_SET, 0)
    return np.where((word & WAH_HIGH_BIT) != 0, fill, word).astype(np.uint16)


def wah_decode_count_ones(words: np.ndarray, n_bits: int) -> tuple[np.ndarray, int, int]:
    """Decode and also return the popcount over the *full decoded span*.

    Note the reference's wah2_extract_count_ones counts ones over every bit the
    consumed words expand to, including padding bits past n_bits; padding bits
    of the final literal word are zeros by construction so the count equals the
    popcount of bits[:n_bits] for conforming streams -- except fill-ones runs,
    whose padding can exceed n_bits.  We mirror the reference exactly.
    """
    if n_bits == 0:
        return np.zeros(0, np.uint8), 0, 0
    words = np.asarray(words, dtype=np.uint16)
    n_used = wah_words_consumed(words, n_bits)
    used = words[:n_used]
    is_counter = (used & WAH_HIGH_BIT) != 0
    is_one_fill = is_counter & ((used & WAH_COUNT_1_BIT) != 0)
    counter_span = (used & WAH_MAX_COUNTER).astype(np.int64) * WAH_BITS
    # popcount of literal words
    lit = used & np.uint16(WAH_ALL_SET)
    pop = np.zeros(n_used, np.int64)
    lit_mask = ~is_counter
    if lit_mask.any():
        v = lit[lit_mask].astype(np.int64)
        # 15-bit popcount
        v = v - ((v >> 1) & 0x5555)
        v = (v & 0x3333) + ((v >> 2) & 0x3333)
        v = (v + (v >> 4)) & 0x0F0F
        pop[lit_mask] = (v + (v >> 8)) & 0x1F
    pop[is_one_fill] = counter_span[is_one_fill]
    ones = int(pop.sum())
    bits, _ = wah_decode(words, n_bits)
    return bits, n_used, ones
