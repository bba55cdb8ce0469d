"""Byte bounds of the mixed-ploidy decode and of the block's product, for
their roofline shares (the traced run's mixed_roofline and
product_roofline).

Frozen from chip_smoke.py: its product_bytes (the bound of dot_rows),
with a byte a row more for the haploid flags of a mixed block
(csrc/dot_rows.cu: "plus keep (8 B), out (4 B) and the flags (1 B) a row
and the weights (4 B a sample)"), and the whole block's decode bound that
bounds.py froze from it (decode_block_bytes), taken at a mixed block's
shapes.  Each input read once and each output written once, at
bounds.HBM_BYTES_PER_S (3.35 TB/s, chip_smoke.py's rate).
"""
from __future__ import annotations


def mixed_block_bytes(stream_words: int, sparse_values: int, lines: int,
                      haps: int) -> int:
    """Bytes a mixed block's device decode must move: its WAH words as
    stored (2 bytes each), its sparse heads and indices at their stored
    width (2 bytes up to 65,535 haplotypes, 4 above), and its lines x haps
    plane (one byte an entry) written once."""
    aet = 2 if haps <= 0xFFFF else 4
    return stream_words * 2 + sparse_values * aet + lines * haps


def product_bytes(rows: int, width: int, samples: int, mode: str) -> int:
    """Bytes one dot_rows call must move: the kept rows read once as uint8
    (rows x width), each row's keep (8 B) and dot (4 B), the weights (4 B a
    sample), and in mode "mixed" each row's haploid flag (1 B)."""
    return (rows * width + 8 * rows + 4 * rows + 4 * samples
            + (rows if mode == "mixed" else 0))
