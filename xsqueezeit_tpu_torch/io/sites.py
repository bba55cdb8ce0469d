"""Site-level record conversions: VCF text columns <-> BCF shared blocks.

The compression pipeline is BCF-centric: whatever the input format, each
record's site data (CHROM..INFO) is held as a raw BCF "shared" block, which
the variant-file writer and the decompressor reuse directly (patching only
the n_fmt/n_sample word).  VCF text inputs are encoded here; VCF text outputs
are rendered here.
"""
from __future__ import annotations

import struct

import numpy as np

from ..format.constants import INT32_VECTOR_END
from .bcf import (
    BcfHeader,
    BcfRecord,
    FLOAT_MISSING_BITS,
    INT8_EOV,
    INT16_EOV,
    INT32_EOV,
    T_FLOAT,
    T_INT8,
    T_INT16,
    T_INT32,
    T_MISSING,
    pack_type_descriptor,
    pack_typed_int,
    pack_typed_int_vector,
    pack_typed_float_vector,
    pack_typed_string,
)


def _fmt_float(v: float) -> str:
    return f"{v:g}"


# ---------------------------------------------------------------------------
# VCF text -> shared block
# ---------------------------------------------------------------------------
def _encode_info_value(header: BcfHeader, key: str, val: str | None) -> bytes:
    number, typ = header.info_meta.get(key, (".", "String"))
    if typ == "Flag" or val is None:
        return bytes([T_MISSING])
    if typ == "Integer":
        parsed = [None if x in (".", "") else int(x) for x in val.split(",")]
        if any(p is None for p in parsed):
            # mixed missing: encode as int32 with MISSING sentinel
            out = pack_type_descriptor(T_INT32, len(parsed))
            for p in parsed:
                out += struct.pack("<i", -2147483648 if p is None else p)
            return out
        return pack_typed_int_vector([int(x) for x in parsed])
    if typ == "Float":
        parsed = [None if x in (".", "") else float(x) for x in val.split(",")]
        return pack_typed_float_vector(parsed)
    # String / Character
    return pack_typed_string(val)


def encode_shared_from_vcf_cols(header: BcfHeader, cols: list[str],
                                n_fmt: int, n_sample: int) -> bytes:
    """Encode the 8 fixed VCF columns into a BCF shared block."""
    chrom, pos, vid, ref, alt, qual, filt, info = cols[:8]
    rid = header.ensure_contig(chrom)
    pos0 = int(pos) - 1
    alleles = [ref] + ([] if alt in (".", "") else alt.split(","))
    rlen = len(ref)

    info_parts = []
    n_info = 0
    if info not in (".", ""):
        for item in info.split(";"):
            if not item:
                continue
            if "=" in item:
                k, v = item.split("=", 1)
            else:
                k, v = item, None
            key_idx = header.ensure_string(
                k, f'##INFO=<ID={k},Number=.,Type=String,Description="auto">')
            if k == "END" and v is not None:
                rlen = int(v) - pos0
            info_parts.append(pack_typed_int(key_idx)
                              + _encode_info_value(header, k, v))
            n_info += 1

    if filt in (".", ""):
        filter_bytes = bytes([T_MISSING])
    else:
        idxs = [header.ensure_string(f, f'##FILTER=<ID={f},Description="auto">')
                for f in filt.split(";")]
        filter_bytes = pack_typed_int_vector(idxs)

    qual_bytes = (struct.pack("<I", FLOAT_MISSING_BITS) if qual in (".", "")
                  else struct.pack("<f", float(qual)))

    out = bytearray()
    out += struct.pack("<iii", rid, pos0, rlen)
    out += qual_bytes
    out += struct.pack("<I", (len(alleles) << 16) | n_info)
    out += struct.pack("<I", (n_fmt << 24) | n_sample)
    out += pack_typed_string("" if vid == "." else vid)
    for a in alleles:
        out += pack_typed_string(a)
    out += filter_bytes
    for p in info_parts:
        out += p
    return bytes(out)


# ---------------------------------------------------------------------------
# shared block -> VCF text columns
# ---------------------------------------------------------------------------
def _render_typed_values(t: int, vals) -> str:
    if t == T_MISSING:
        return ""
    if isinstance(vals, str):
        return vals
    if t == T_FLOAT:
        parts = []
        for v in np.asarray(vals):
            bits = struct.unpack("<I", struct.pack("<f", float(v)))[0]
            parts.append("." if bits == FLOAT_MISSING_BITS else _fmt_float(float(v)))
        return ",".join(parts)
    eov = {T_INT8: INT8_EOV, T_INT16: INT16_EOV, T_INT32: INT32_EOV}.get(t)
    miss = {T_INT8: -128, T_INT16: -32768, T_INT32: -2147483648}.get(t)
    parts = []
    for v in np.asarray(vals):
        v = int(v)
        if v == eov:
            continue
        parts.append("." if v == miss else str(v))
    return ",".join(parts)


def render_vcf_cols(header: BcfHeader, rec: BcfRecord) -> list[str]:
    chrom = header.dict_contigs[rec.rid] if rec.rid < len(header.dict_contigs) \
        else str(rec.rid)
    alleles = rec.alleles
    alt = ",".join(alleles[1:]) if len(alleles) > 1 else "."
    qual = "." if rec.qual is None else _fmt_float(rec.qual)
    filt_idx = rec.filters()
    filt = ";".join(header.dict_strings[i] for i in filt_idx) if filt_idx else "."
    info_items = []
    for key, t, vals in rec.info_fields():
        name = header.dict_strings[key]
        if t == T_MISSING:
            info_items.append(name)
        else:
            info_items.append(f"{name}={_render_typed_values(t, vals)}")
    info = ";".join(info_items) if info_items else "."
    return [chrom, str(rec.pos + 1), rec.id, alleles[0], alt, qual, filt, info]


# ---------------------------------------------------------------------------
# GT indiv blocks
# ---------------------------------------------------------------------------
def encode_gt_indiv(header: BcfHeader, gt: np.ndarray, ploidy: int,
                    n_samples: int) -> bytes:
    """Encode FORMAT/GT values as an indiv block (single field)."""
    key = header.ensure_string(
        "GT", '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    gt = np.asarray(gt, np.int32)
    maxv = int(gt.max(initial=0))
    eov32 = np.int32(INT32_VECTOR_END)
    if maxv < 127:
        vals = gt.astype(np.int8)
        vals[gt == eov32] = INT8_EOV
        t = T_INT8
    elif maxv < 32767:
        vals = gt.astype(np.int16)
        vals[gt == eov32] = INT16_EOV
        t = T_INT16
    else:
        vals = gt.astype(np.int32)
        t = T_INT32
    return (pack_typed_int(key) + pack_type_descriptor(t, ploidy)
            + vals.tobytes())


def encode_bm_indiv(header: BcfHeader, bm_value: int) -> bytes:
    """FORMAT/BM for the single BIN_MATRIX_POS pseudo-sample."""
    key = header.ensure_string(
        "BM", '##FORMAT=<ID=BM,Number=1,Type=Integer,Description='
              '"Position in GT Binary Matrix">')
    return (pack_typed_int(key) + pack_type_descriptor(T_INT32, 1)
            + struct.pack("<i", bm_value))
