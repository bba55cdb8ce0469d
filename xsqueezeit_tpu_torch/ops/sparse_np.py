"""Sparse index-list codec for rare variants — NumPy oracle.

Wire format (restated from the xSqueezeIt reference's include/block.hpp:54-99 and
accessor_internals_new.hpp:619-653): one line is

    [count: A_T][indices: A_T x count]

where A_T is uint16 when the number of samples fits, else uint32, and the MSB
of `count` is a "negated" flag used by the genotype matrix (set when REF is
the minor allele, i.e. the stored indices are the positions NOT carrying the
sparse allele's complement).  The exception tracks (missing / end-of-vector)
use the same framing without ever setting the flag.
"""
from __future__ import annotations

import numpy as np

from ..interop import native


def msb(dtype: np.dtype) -> int:
    return 1 << (np.dtype(dtype).itemsize * 8 - 1)


def sparse_encode(indices: np.ndarray, negated: bool, dtype=np.uint32) -> np.ndarray:
    """Encode one sparse line into its wire array (count word + indices)."""
    dtype = np.dtype(dtype)
    indices = np.asarray(indices)
    count = indices.shape[0]
    if count >= msb(dtype):
        raise ValueError("sparse line too long for index type")
    head = count | (msb(dtype) if negated else 0)
    out = np.empty(count + 1, dtype)
    out[0] = head
    out[1:] = indices.astype(dtype)
    return out


def sparse_decode(stream: np.ndarray, pos: int = 0) -> tuple[np.ndarray, bool, int]:
    """Decode one sparse line starting at element `pos`.

    Returns (indices, negated, next_pos).
    """
    stream = np.asarray(stream)
    head = int(stream[pos])
    flag = msb(stream.dtype)
    negated = bool(head & flag)
    count = head & (flag - 1)
    start = pos + 1
    return stream[start:start + count], negated, start + count


def sparse_line_offsets(stream: np.ndarray, n_lines: int) -> np.ndarray:
    """Start offsets (in elements) of the first n_lines lines of a stream.

    The walk is pointer-chasing (each head stores its line's length), so
    the naive form is a Python loop — too slow on the block decode path
    (~0.5 us per line x thousands of sparse lines per block).  The native
    walk (gt_encoder.cpp xsi_sparse_offsets*) does it in microseconds;
    with XSI_NATIVE=0, large inputs vectorise with binary lifting: jump table
    J_b[p] = position reached after 2^b line-advances from p (computed for
    EVERY position, head or not; only values reached from offset 0 are
    ever read), then offset i composes the set bits of i.
    O(N log n_lines) fully-vectorised numpy.  All paths raise on a
    truncated/corrupt stream; equality across them is pinned by tests.
    """
    stream = np.asarray(stream)
    flag = msb(stream.dtype)
    if n_lines <= 0:
        return np.zeros(1, np.int64)
    if n_lines >= 128 and native.enabled():
        return native.sparse_offsets_native(stream, n_lines)
    if n_lines < 128 or stream.shape[0] < 4096:
        offsets = np.empty(n_lines + 1, np.int64)
        pos = 0
        for i in range(n_lines):
            offsets[i] = pos
            pos += 1 + (int(stream[pos]) & (flag - 1))
        offsets[n_lines] = pos
        return offsets

    N = stream.shape[0]
    counts = stream.astype(np.int64) & (flag - 1)
    bits = int(n_lines).bit_length()
    # J[p] = position after one line-advance from p; slot N is the saturating
    # sentinel so levels compose with plain fancy indexing.
    J = np.empty(N + 1, np.int64)
    np.minimum(np.arange(1, N + 1, dtype=np.int64) + counts, N, out=J[:N])
    J[N] = N
    tables = [J]
    for _ in range(bits - 1):
        J = J[J]          # 2^(b+1) advances; sentinel self-maps
        tables.append(J)
    i = np.arange(n_lines + 1, dtype=np.int64)
    off = np.zeros(n_lines + 1, np.int64)
    for b in range(bits):  # n_lines < 2^bits, so bits bit-positions suffice
        sel = ((i >> b) & 1) == 1
        if sel.any():
            off[sel] = tables[b][off[sel]]
    # The jump tables saturate at the sentinel N, so a truncated/corrupt
    # stream would silently clamp instead of erroring like the scalar path.
    # Re-verify the walk: every head must lie inside the stream and each
    # line's true length must reproduce the next offset exactly.
    heads = off[:n_lines]
    if heads.size and (int(heads.max()) >= N
                       or not np.array_equal(
                           heads + 1 + counts[heads], off[1:])):
        raise ValueError("sparse stream truncated: line walk exceeds stream")
    return off
