"""Binary block dictionaries.

A block (top-level or GT) starts with a dictionary:

    [0xFFFFFFFF][n_entries: u32] ([key: u32][value: u32]) * n_entries

Values are byte offsets relative to the enclosing block start (or scalars for
the GT block's scalar keys).  The reference writes entries in C++ hash-map
iteration order; readers load them into a map so order is irrelevant -- we
write keys in ascending order for determinism.
(reference: the xSqueezeIt reference's include/interfaces.hpp:37-97)
"""
from __future__ import annotations

import struct

DICT_SIZE_SYMBOL = 0xFFFFFFFF


def write_dictionary(d: dict[int, int]) -> bytes:
    parts = [struct.pack("<II", DICT_SIZE_SYMBOL, len(d))]
    for k in sorted(d):
        parts.append(struct.pack("<II", k & 0xFFFFFFFF, d[k] & 0xFFFFFFFF))
    return b"".join(parts)


def dictionary_n_bytes(n_entries: int) -> int:
    return 8 * (n_entries + 1)


def read_dictionary(buf: bytes | memoryview, pos: int = 0) -> tuple[dict[int, int], int]:
    """Read a dictionary starting at byte `pos`. Returns (dict, next_pos)."""
    (_, n) = struct.unpack_from("<II", buf, pos)
    d = {}
    off = pos + 8
    for _ in range(n):
        k, v = struct.unpack_from("<II", buf, off)
        d[k] = v
        off += 8
    return d, off
