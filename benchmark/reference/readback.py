"""Reads the program's output files back with the reference's own BCF
reader and tallies them against the seed's panel."""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .bcf import BcfFile
from .panel import Panel, Tally

#: What a truncated, missing or malformed output raises in the reader.
UNREADABLE = (OSError, ValueError, KeyError, IndexError, EOFError,
              struct.error, zlib.error, UnicodeDecodeError)


def bcf_tally(path: str, panel: Panel, want: np.ndarray) -> Tally:
    """Every record of the BCF at `path` against the panel's records
    `want` (their indices, in order), and its sample names."""
    t = Tally(panel, want)
    try:
        f = BcfFile(path)
        t.names(f.samples)
        for rec in f:
            t.record(rec.pos + 1, rec.id, rec.alleles, rec.gt)
    except UNREADABLE as exc:
        t.fail(exc)
    return t
