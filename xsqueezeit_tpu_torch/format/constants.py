"""XSI on-disk format constants.

The XSI container format is defined by the reference implementation
(rwk-unil/xSqueezeIt); this module re-states the constants of that format so
files produced here are readable by any conforming reader and vice versa.

References into the C++ (for parity checking only, no code is shared):
  - magics / header:      the xSqueezeIt reference's include/compression.hpp:35-104
  - GT block dict keys:   the xSqueezeIt reference's include/gt_block.hpp:34-72
  - top-level block keys: the xSqueezeIt reference's include/interfaces.hpp:161-168
  - BM packing:           the xSqueezeIt reference's xcf.cpp:641-714 (lower 15 bits =
                          offset in binary lines, upper bits = block id; the
                          README states the reverse -- the code is authoritative)
"""

# ---------------------------------------------------------------------------
# File header
# ---------------------------------------------------------------------------
ENDIANNESS = 0xAABBCCDD
MAGIC = 0xFEED1767
VERSION = 5  # We write v5 (64-bit block index entries + 64-bit zstd sizes)
PLOIDY_DEFAULT = 2
HEADER_SIZE = 256

# ---------------------------------------------------------------------------
# Binary-matrix position (BM) packing: FORMAT/BM = block << 15 | offset
# ---------------------------------------------------------------------------
BM_BLOCK_BITS = 15

# Default CLI / format parameters
DEFAULT_BLOCK_LENGTH = 8192      # BCF lines per block (--variant-block-length)
DEFAULT_MAF = 0.001              # --maf
DEFAULT_ZSTD_LEVEL = 7           # --zstd-level

XSI_BCF_VAR_EXTENSION = "_var.bcf"
PSEUDO_SAMPLE_NAME = "BIN_MATRIX_POS"


# ---------------------------------------------------------------------------
# Top-level binary block dictionary (interfaces.hpp)
# ---------------------------------------------------------------------------
class BlockDict:
    KEY_DICTIONARY_SIZE = 0xFFFFFFFF
    KEY_BCF_LINES = 0
    KEY_GT_ENTRY = 256
    VAL_UNDEFINED = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# GT block dictionary (gt_block.hpp)
# ---------------------------------------------------------------------------
class GTDict:
    KEY_DICTIONARY_SIZE = 0xFFFFFFFF
    # Scalar keys
    KEY_BCF_LINES = 0x0
    KEY_BINARY_LINES = 0x1
    KEY_MAX_LINE_PLOIDY = 0x2
    KEY_DEFAULT_PHASING = 0x3
    KEY_WEIRDNESS_STRATEGY = 0x4
    # Line (per-binary-line boolean vector, WAH encoded) keys
    KEY_LINE_SORT = 0x10
    KEY_LINE_SELECT = 0x11
    KEY_LINE_HAPLOID = 0x12
    KEY_LINE_VECTOR_LENGTH = 0x15
    KEY_LINE_MISSING = 0x16
    KEY_LINE_NON_UNIFORM_PHASING = 0x17
    KEY_LINE_END_OF_VECTORS = 0x18
    # Matrix keys
    KEY_MATRIX_WAH = 0x20
    KEY_MATRIX_SPARSE = 0x21
    KEY_MATRIX_MISSING = 0x26
    KEY_MATRIX_NON_UNIFORM_PHASING = 0x27
    KEY_MATRIX_END_OF_VECTORS = 0x28
    KEY_MATRIX_MISSING_SPARSE = 0x36
    KEY_MATRIX_END_OF_VECTORS_SPARSE = 0x38

    VAL_UNDEFINED = 0xFFFFFFFF


class WeirdnessStrategy:
    """How missing / end-of-vector ("weird") values are encoded."""
    WS_PBWT_WAH = 0   # WAH through a dedicated PBWT arrangement (v4 default)
    WS_WAH = 1        # WAH through identity-ish arrangement (--wah-encode-missing)
    WS_SPARSE = 2     # sparse index lists (current default)
    WS_MIXED = 3      # per-line heuristic; on-disk blocks are WAH-only
                      # (reference throws when the sparse branch fires,
                      # gt_block.hpp:346-348) -> decoders read as WS_WAH


# ---------------------------------------------------------------------------
# htslib-compatible genotype integer encoding.
#
# The in-memory genotype representation is the BCF one: for each allele slot
#   value = (allele_index + 1) << 1 | phased
# with two special sentinels for missing data and for padding slots of
# samples whose ploidy is below the line maximum.
# ---------------------------------------------------------------------------
GT_MISSING = 0                     # unphased missing ('.'), allele == -1
INT32_MISSING = -0x80000000        # bcf_int32_missing
INT32_VECTOR_END = -0x7FFFFFFF     # bcf_int32_vector_end (padding)


def gt_unphased(allele: int) -> int:
    return (allele + 1) << 1


def gt_phased(allele: int) -> int:
    return ((allele + 1) << 1) | 1


def gt_allele(value: int) -> int:
    return (value >> 1) - 1


def gt_is_phased(value: int) -> int:
    return value & 1


def gt_is_missing(value: int) -> bool:
    # Matches bcf_gt_is_missing: allele index is -1 (value 0 or 1)
    return (value >> 1) == 0
