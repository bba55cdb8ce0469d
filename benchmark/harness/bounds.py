"""Byte bounds of the device decode, for its roofline share.

Frozen from chip_smoke.py at commit
020efb0f1b2610896c6d201383d65c226e80c5d3 (HBM_BYTES_PER_S, bound_ms): no
kernel on the codec's path does tensor-core or float work, so a kernel's
bound is the bytes it must move, each input read once and each output
written once, at the H100 SXM's memory rate (NVIDIA's data sheet).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def decode_block_bytes(stream, sorts, rank, is_wah, neg, car_line, car_idx,
                       h: int, w: int) -> int:
    """Bytes a whole block's device decode must move, from the block's
    shapes and stored payload (the arguments of the program's
    decoder_torch._decode_block_vals): its WAH words as stored (2 bytes),
    its sparse lines' heads and indices as stored (2 bytes a value up to
    65,535 haplotypes, 4 above) read once, and its L x h decoded entries
    (one byte each) written once."""
    n_lines = is_wah.shape[0]
    n_sparse = n_lines - sorts.shape[0]
    aet = 2 if h <= 0xFFFF else 4
    return (stream.numel() * 2 + (car_idx.numel() + n_sparse) * aet
            + n_lines * h)
