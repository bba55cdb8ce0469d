"""The 256-byte XSI file header.

Layout mirrors the packed C struct of the reference format
(the xSqueezeIt reference's include/compression.hpp:40-104) field for field so that
headers are binary-interchangeable.  All fields little-endian.
"""
from __future__ import annotations

import dataclasses
import struct

from .constants import ENDIANNESS, HEADER_SIZE, MAGIC

# struct layout, little endian (see compression.hpp):
#  0  u32 endianness
#  4  u32 first_magic
#  8  u32 version
# 12  u8  ploidy
# 13  u8  ind_bytes
# 14  u8  aet_bytes
# 15  u8  wah_bytes
# 16  u8  special_bitset   (bit0 has_missing, bit1 non_uniform_phasing, bit2 default_phased)
# 17  u8  specific_bitset  (bit0 iota_ppa, bit1 no_sort, bit2 zstd)
# 18  2x u8 rsvd
# 20  3x u32 rsvd
# 32  u64 hap_samples
# 40  u64 num_variants
# 48  u32 block_size (deprecated)
# 52  u32 number_of_blocks (deprecated)
# 56  u32 ss_rate
# 60  u32 number_of_ssas
# 64  u64 wahs_offset
# 72  u64 indices_offset
# 80  u64 samples_offset
# 88  u32 rearrangement_track_offset
# 92  u32 sparse_offset
# 96  u32 rare_threshold
# 100 u64 xcf_entries
# 108 u32 phase_info_offset
# 112 u64 num_samples
# 120 104x u8 rsvd
# 224 3x u32 rsvd
# 236 u32 sample_name_chksum
# 240 u32 bcf_file_chksum
# 244 u32 data_chksum
# 248 u32 header_chksum
# 252 u32 last_magic
_FMT = "<IIIBBBBBB2s3I QQ IIII QQQ II I Q I Q 104s 3I IIII I"
assert struct.calcsize(_FMT) == HEADER_SIZE, struct.calcsize(_FMT)


@dataclasses.dataclass
class XsiHeader:
    version: int = 5
    ploidy: int = 2
    ind_bytes: int = 4
    aet_bytes: int = 4
    wah_bytes: int = 2
    # special bitset
    has_missing: bool = False
    non_uniform_phasing: bool = False
    default_phased: bool = False
    # specific bitset
    iota_ppa: bool = True
    no_sort: bool = False
    zstd: bool = False

    hap_samples: int = 0
    num_variants: int = 0
    block_size: int = 0
    number_of_blocks: int = 1
    ss_rate: int = 8192
    number_of_ssas: int = 0
    wahs_offset: int = 0
    indices_offset: int = 0
    samples_offset: int = 0
    rearrangement_track_offset: int = 0xFFFFFFFF
    sparse_offset: int = 0xFFFFFFFF
    rare_threshold: int = 0
    xcf_entries: int = 0
    phase_info_offset: int = 0
    num_samples: int = 0

    def pack(self) -> bytes:
        special = (
            (1 if self.has_missing else 0)
            | ((1 if self.non_uniform_phasing else 0) << 1)
            | ((1 if self.default_phased else 0) << 2)
        )
        specific = (
            (1 if self.iota_ppa else 0)
            | ((1 if self.no_sort else 0) << 1)
            | ((1 if self.zstd else 0) << 2)
        )
        return struct.pack(
            _FMT,
            ENDIANNESS, MAGIC, self.version,
            self.ploidy & 0xFF, self.ind_bytes, self.aet_bytes, self.wah_bytes,
            special, specific, b"\0\0", 0, 0, 0,
            self.hap_samples & 0xFFFFFFFFFFFFFFFF,
            self.num_variants & 0xFFFFFFFFFFFFFFFF,
            self.block_size, self.number_of_blocks,
            self.ss_rate, self.number_of_ssas & 0xFFFFFFFF,
            self.wahs_offset & 0xFFFFFFFFFFFFFFFF,
            self.indices_offset & 0xFFFFFFFFFFFFFFFF,
            self.samples_offset & 0xFFFFFFFFFFFFFFFF,
            self.rearrangement_track_offset & 0xFFFFFFFF,
            self.sparse_offset & 0xFFFFFFFF,
            self.rare_threshold & 0xFFFFFFFF,
            self.xcf_entries,
            self.phase_info_offset,
            self.num_samples,
            b"\0" * 104, 0, 0, 0,
            0, 0, 0, 0,
            MAGIC,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "XsiHeader":
        if len(data) < HEADER_SIZE:
            raise ValueError("XSI header truncated")
        f = struct.unpack(_FMT, data[:HEADER_SIZE])
        (endianness, first_magic, version, ploidy, ind_bytes, aet_bytes,
         wah_bytes, special, specific, _rsvd0, _r1, _r2, _r3,
         hap_samples, num_variants, block_size, number_of_blocks, ss_rate,
         number_of_ssas, wahs_offset, indices_offset, samples_offset,
         rearrangement_track_offset, sparse_offset, rare_threshold,
         xcf_entries, phase_info_offset, num_samples, _rsvd3,
         _r4, _r5, _r6, _chk1, _chk2, _chk3, _chk4, last_magic) = f
        if endianness != ENDIANNESS:
            raise ValueError("XSI header: bad endianness marker")
        if first_magic != MAGIC or last_magic != MAGIC:
            raise ValueError("XSI header: bad magic")
        return cls(
            version=version,
            ploidy=ploidy,
            ind_bytes=ind_bytes,
            aet_bytes=aet_bytes,
            wah_bytes=wah_bytes,
            has_missing=bool(special & 1),
            non_uniform_phasing=bool(special & 2),
            default_phased=bool(special & 4),
            iota_ppa=bool(specific & 1),
            no_sort=bool(specific & 2),
            zstd=bool(specific & 4),
            hap_samples=hap_samples,
            num_variants=num_variants,
            block_size=block_size,
            number_of_blocks=number_of_blocks,
            ss_rate=ss_rate,
            number_of_ssas=number_of_ssas,
            wahs_offset=wahs_offset,
            indices_offset=indices_offset,
            samples_offset=samples_offset,
            rearrangement_track_offset=rearrangement_track_offset,
            sparse_offset=sparse_offset,
            rare_threshold=rare_threshold,
            xcf_entries=xcf_entries,
            phase_info_offset=phase_info_offset,
            num_samples=num_samples,
        )

    def info_string(self) -> str:
        """Human-readable header dump (CLI `-i/--info`)."""
        lines = [
            f"Version : {self.version}",
            f"Ploidy : {self.ploidy}",
            f"Indice bytes : {self.ind_bytes}",
            f"Sample id bytes : {self.aet_bytes}",
            f"WAH bytes : {self.wah_bytes}",
            "--",
            f"Has a zstd compression layer : {'yes' if self.zstd else 'no'}",
            "--",
            f"Haplotype samples  : {self.hap_samples}",
            f"Number of samples  : {self.num_samples}",
            f"Number of variants : {self.num_variants}",
            "--",
            f"VCF records : {self.xcf_entries}",
            f"GT Data WAH encoded : {self.samples_offset - self.wahs_offset} bytes",
        ]
        return "\n".join(lines)
