"""Mixed XSI/BCF genotype reading — counterpart of the reference's Xcf
(the xSqueezeIt reference's xsi_mixed_vcf.hpp, xsi_mixed_vcf.cpp): a
consumer iterates
ordinary BCF records and calls get_genotypes(); files that are XSI variant
files (detected by their ##XSI= header entry, xsi_mixed_vcf.cpp:46-57)
route the call through the Accessor, plain VCF/BCF files answer directly.
This is the integration surface third-party tools (SHAPEIT4-style) use, and
what the native C API mirrors.  The port's copy of xsqueezeit_tpu/mixed.py.
"""
from __future__ import annotations

import os

import numpy as np

from .accessor import Accessor
from .io.bcf import BcfReader
from .io.unified import GtInput


def xsi_path_from_variant_header(var_path: str, header) -> str | None:
    """Reconstruct the .xsi path from a reader's ##XSI= header entry
    (reference: get_entry_from_bcf + reader_file_is_xsi)."""
    for line in getattr(header, "lines", []):
        if line.startswith("##XSI="):
            base = line.split("=", 1)[1].strip()
            cand = os.path.join(os.path.dirname(var_path) or ".", base)
            if os.path.exists(cand):
                return cand
            if os.path.exists(cand + ".xsi"):
                return cand + ".xsi"
    return None


class _XsiEntry:
    is_xsi = True

    def __init__(self, var_path: str, xsi_path: str):
        self.accessor = Accessor(xsi_path)
        self.reader = BcfReader(var_path)
        self.samples = self.accessor.get_sample_list()

    def __iter__(self):
        for rec in self.reader:
            yield rec, self.accessor.get_genotypes(rec)

    def get_genotypes(self, rec) -> np.ndarray:
        return self.accessor.get_genotypes(rec)

    def get_internal_access(self, rec):
        bm = self.accessor.position_from_bm_entry(rec)
        return self.accessor.get_internal_access(bm, rec.n_allele)

    def close(self):
        self.reader.close()


class _PlainEntry:
    is_xsi = False

    def __init__(self, path: str):
        self.input = GtInput(path)
        self.samples = self.input.samples

    def __iter__(self):
        for rec in self.input:
            yield rec, rec.gt

    def get_genotypes(self, rec) -> np.ndarray:
        return rec.gt

    def close(self):
        self.input.close()


class Xcf:
    """Multi-reader facade over any mix of XSI variant files and plain
    VCF/BCF (reference: Xcf class + c_api.cpp wrappers)."""

    def __init__(self):
        self.entries: list[_XsiEntry | _PlainEntry] = []

    def add_reader(self, path: str) -> int:
        """Register a file; returns its reader index.  A BCF whose header
        carries ##XSI= (or that sits next to its container under the
        <f>.xsi_var.bcf convention) reads through the Accessor."""
        entry = None
        try:
            head = open(path, "rb").read(4)
        except OSError:
            raise FileNotFoundError(path)
        if path.endswith(".xsi"):
            entry = _XsiEntry(Accessor(path).variant_filename(), path)
        elif head[:2] == b"\x1f\x8b" or head[:3] == b"BCF":
            reader = BcfReader(path)
            xsi = xsi_path_from_variant_header(path, reader.header)
            if xsi is None and path.endswith("_var.bcf"):
                cand = Accessor.xsi_filename_from_variant(path)
                if os.path.exists(cand):
                    xsi = cand
            reader.close()
            if xsi is not None:
                entry = _XsiEntry(path, xsi)
        if entry is None:
            entry = _PlainEntry(path)
        self.entries.append(entry)
        return len(self.entries) - 1

    def sample_names(self, idx: int) -> list[str]:
        return list(self.entries[idx].samples)

    def n_samples(self, idx: int) -> int:
        return len(self.entries[idx].samples)

    def __getitem__(self, idx: int):
        return self.entries[idx]

    def close(self):
        for e in self.entries:
            e.close()
