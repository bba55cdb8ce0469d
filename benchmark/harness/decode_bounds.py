"""Byte bounds of the decode chain and the run flush, for their roofline
shares (the traced run's chain_roofline and flush_roofline).

Frozen from chip_smoke.py at commit
020efb0f1b2610896c6d201383d65c226e80c5d3 (chain_bytes of "chain_decode",
flush_bytes), as bounds.py froze the block's: each input read once and
each output written once, at bounds.HBM_BYTES_PER_S.
"""
from __future__ import annotations


def chain_decode_bytes(n_ch: int, C: int, W: int) -> int:
    """Bytes a decode chain call must move, at the arguments the program's
    pbwt_torch._decode_run passes: its lines, uint8[n_ch, C, W], and sort
    flags, bool[n_ch, C], read, and one 32-bit state a slot and chunk
    written."""
    return n_ch * C * W + n_ch * C + n_ch * W * 4


def flush_bytes(n_ch: int, C: int, W: int, H: int, n: int,
                history: bool) -> int:
    """Bytes a run flush must move: the chains' states, int32[n_ch, W], the
    start map, int64[W], and the sort flags, bool[n_ch, C], read; the run's
    n x H rows, its end map, int64[W], and with `history` (a haploid run's
    end) its histories T, int32[n_ch, H], written."""
    return (4 * n_ch * W + 2 * 8 * W + n_ch * C + n * H
            + (4 * n_ch * H if history else 0))
