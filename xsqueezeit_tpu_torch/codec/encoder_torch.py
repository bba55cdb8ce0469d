"""Block encoder on PyTorch tensors: the CUDA fast path.

Port of xsqueezeit_tpu/codec/encoder_jax.py (encode_block_core_compact,
the carrier extraction, the exception-track encode, the mixed-ploidy core
and DeviceBlockEncoder's serialize).  One block encodes as

    WAH rows --(PBWT chunk chains)--> arrangement-ordered bits
             --(WAH2 RLE kernel, bits packed inside)--> words[Lw, W]
    sparse rows --(rank by cumsum + scatter)--> carrier indices[Ls, cap]
    missing/EOV rows of the same matrix --> track grids (same kernels)

and the host assembles the byte-exact GT block payload through
encoder_base, exactly as for the JAX and NumPy encoders.  Line classes are
host-known (per-record carrier counts taken at ingest), so the chain runs
only over the WAH rows and the extraction only over the sparse rows.
The encode chain takes every width the format allows (a cluster of 8
CTAs above 57,856 haplotypes, 16 above 428,032); blocks wider than 65,535
haplotypes
have 32-bit sparse and track streams.
Mixed-ploidy blocks take the same chains with the parity payload
(encode_block_core_mixed).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..format.constants import WeirdnessStrategy
from ..ops import pbwt_torch, wah_kernels, wah_torch
from .encoder_base import EOV_CODE, MISSING_CODE, BlockEncoderBase

def carrier_indices(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Front-packed ascending carrier indices per row: int32[R, cap],
    zeros past each row's count (rows must hold at most `cap` carriers).

    Rank by cumsum plus one scatter; the same output as the JAX package's
    sparse_idx_packed_reduction / sparse_idx_by_search.
    """
    R, H = mask.shape
    rank = torch.cumsum(mask, 1, dtype=torch.int64) - 1
    rows = torch.arange(R, device=mask.device)[:, None] * cap
    dest = torch.where(mask & (rank < cap), rows + rank, R * cap)
    cols = torch.arange(H, dtype=torch.int32, device=mask.device)
    out = torch.zeros(R * cap + 1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dest.reshape(-1), cols.expand(R, H).reshape(-1))
    return out[:R * cap].reshape(R, cap)


def _wah_rows(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The WAH2 RLE of bit rows, packed inside the kernel (strided rows
    need no copy): (uint16[R, W], int32[R])."""
    return wah_kernels.wah_compress_bits(bits)


def encode_block_core_compact(alleles, alts, wah_rows, sorts_w, sparse_rows,
                              negated_s, sparse_cap: int) -> dict:
    """Encode body over host-classified lines (all tensors on one device).

    alleles: int8/int16[L, H]; alts: int32[L]; wah_rows: int64[Lw] lines
    that take PBWT + WAH (padding rows may repeat a line with its sort flag
    off); sorts_w: bool[Lw]; sparse_rows: int64[Ls]; negated_s: bool[Ls]
    whether a sparse line stores its REF carriers.

    Returns wah_words uint16[Lw, W], wah_len int32[Lw], sparse_idx
    int32[Ls, sparse_cap], sparse_len int64[Ls], rows in the order given.
    """
    aw = alleles.index_select(0, wah_rows)
    ys, _ = pbwt_torch.pbwt_encode_chunked(aw, alts.index_select(0, wah_rows),
                                           sorts_w)
    wah_words, wah_len = _wah_rows(ys)

    sp = alleles.index_select(0, sparse_rows)
    sp_alts = alts.index_select(0, sparse_rows)
    sp_allele = torch.where(negated_s, 0, sp_alts)
    mask = sp.to(torch.int32) == sp_allele[:, None]
    return {
        "wah_words": wah_words,
        "wah_len": wah_len,
        "sparse_idx": carrier_indices(mask, sparse_cap),
        "sparse_len": mask.sum(1),
    }


def track_encode_body(bits: torch.Tensor, cap: int, want_wah: bool = True
                      ) -> tuple[torch.Tensor, ...]:
    """WAH and sparse encode of exception-track bit rows
    (encoder_jax._track_encode_body).

    bits: uint8/bool[R, H], one row per flagged (record, track) pair.
    Returns (wah_words uint16[R, W] front-packed, wah_len int32[R],
    sparse_idx int32[R, cap], sparse_len int64[R]), each row
    byte-identical to wah_np.wah_encode / sparse_np.sparse_encode.
    want_wah False (WS_SPARSE missing/EOV rows) skips the WAH grids, cap 0
    (WS_WAH rows) the carrier extraction: their outputs are empty.
    """
    R = bits.shape[0]
    dev = bits.device
    if want_wah:
        wah_words, wah_len = _wah_rows(bits)
    else:
        wah_words = torch.zeros((R, 0), dtype=torch.uint16, device=dev)
        wah_len = torch.zeros(R, dtype=torch.int32, device=dev)
    if cap == 0:
        return (wah_words, wah_len,
                torch.zeros((R, 0), dtype=torch.int32, device=dev),
                torch.zeros(R, dtype=torch.int64, device=dev))
    mask = bits != 0
    return wah_words, wah_len, carrier_indices(mask, cap), mask.sum(1)


def encode_tracks_packed(packed: torch.Tensor, h: int, cap: int
                         ) -> tuple[torch.Tensor, ...]:
    """track_encode_body of rows packed on the host with np.packbits(...,
    bitorder="little") (element 8j+i of a row is bit i of byte j): the
    transfer is 8x smaller than bool rows
    (encoder_jax._encode_tracks_device_packed).  packed: uint8[R, ceil(h/8)].
    """
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return track_encode_body(bits.reshape(packed.shape[0], -1)[:, :h], cap)


def encode_block_core_compact_tracks(alleles, alts, wah_rows, sorts_w,
                                     sparse_rows, negated_s, trk_rows,
                                     trk_is_eov, sparse_cap: int,
                                     trk_cap: int) -> dict:
    """encode_block_core_compact plus the missing/EOV track encode, from
    the alleles matrix already on the device
    (encoder_jax._encode_block_device_compact_tracks).

    trk_rows: int64[R] first binary line of each flagged record (every line
    of a record repeats its codes); trk_is_eov: bool[R], missing rows
    first.  trk_cap > 0 means WS_SPARSE (sparse indices only), 0 WS_WAH
    (WAH grids only).  Adds trk_wah_words, trk_wah_len, trk_sparse_idx and
    trk_sparse_len to the dict.
    """
    out = encode_block_core_compact(alleles, alts, wah_rows, sorts_w,
                                    sparse_rows, negated_s, sparse_cap)
    code = torch.where(trk_is_eov, EOV_CODE, MISSING_CODE)
    bits = alleles.index_select(0, trk_rows).to(torch.int32) == code[:, None]
    tw, tl, si, sl = track_encode_body(bits, trk_cap, want_wah=trk_cap == 0)
    out.update(trk_wah_words=tw, trk_wah_len=tl, trk_sparse_idx=si,
               trk_sparse_len=sl)
    return out


def even_slot_rows(ys: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """The bits of each row at its even-parity positions (par == 0), in
    order, front-packed: uint8[R, H // 2] from ys, par uint8[R, H] (a
    haploid line's stored bits; encoder_jax computes them with a sort).
    Each even position's rank among the evens is a cumsum, and one
    scatter places the bits (the odd ones land past the row)."""
    N = ys.shape[1] // 2
    even = (par == 0).to(torch.int64)
    dest = torch.where(even != 0, torch.cumsum(even, 1) - 1, N)
    return torch.zeros((ys.shape[0], N + 1), dtype=torch.uint8,
                       device=ys.device).scatter_(1, dest, ys)[:, :N]


def encode_block_core_mixed(alleles, alts, wah_rows, dip_w, hap_w,
                            sparse_rows, negated_s, hap_s,
                            sparse_cap: int) -> dict:
    """Encode body of a mixed-ploidy block (haploid and diploid records
    interleaved, as at a chrX PAR boundary); encoder_jax
    .encode_block_core_mixed over host-classified lines.

    alleles: int8/int16[L, 2N] with haploid lines slot-duplicated (each
    sample's allele in both its slots), so one arrangement chain serves
    both ploidies; alts: int32[L].  wah_rows: int64[Lw] the WAH lines, in
    line order; dip_w / hap_w: int64 positions among them of the diploid
    and the haploid ones.  sparse_rows: int64[Ls]; negated_s, hap_s:
    bool[Ls].

    A diploid WAH line emits its 2N arrangement-ordered bits; a haploid
    one the N bits of its even-parity positions (the encode chains carry
    each position's slot parity, pbwt_encode_chunked(..., parity=True);
    even_slot_rows takes the subsequence).  Haploid sparse lines keep
    even-slot carriers, halved to sample indices.  Returns wah_words
    uint16[len(dip_w), W(2N)], wah_len, hap_wah_words uint16[len(hap_w),
    W(N)], hap_wah_len, sparse_idx int32[Ls, sparse_cap] and sparse_len
    int64[Ls].
    """
    H = alleles.shape[1]
    dev = alleles.device
    aw = alleles.index_select(0, wah_rows)
    sorts = torch.ones(aw.shape[0], dtype=torch.bool, device=dev)
    ys, par, _ = pbwt_torch.pbwt_encode_chunked(
        aw, alts.index_select(0, wah_rows), sorts, parity=True)
    wah_words, wah_len = _wah_rows(ys.index_select(0, dip_w))
    hap_words, hap_len = _wah_rows(even_slot_rows(
        ys.index_select(0, hap_w), par.index_select(0, hap_w)))

    sp = alleles.index_select(0, sparse_rows)
    sp_allele = torch.where(negated_s, 0, alts.index_select(0, sparse_rows))
    odd = (torch.arange(H, device=dev) & 1) != 0
    mask = (sp.to(torch.int32) == sp_allele[:, None]) \
        & ~(hap_s[:, None] & odd[None, :])
    idx = carrier_indices(mask, sparse_cap)
    return {
        "wah_words": wah_words,
        "wah_len": wah_len,
        "hap_wah_words": hap_words,
        "hap_wah_len": hap_len,
        "sparse_idx": torch.where(hap_s[:, None], idx >> 1, idx),
        "sparse_len": mask.sum(1),
    }


def _line_classes(prep: dict) -> dict:
    return {"is_wah": prep["is_wah"], "negated": prep["negated"],
            "wah_compact": True, "sparse_compact": True}


def host_outputs(outd: dict, prep: dict) -> dict:
    """The outputs of encode_block_core_compact(_tracks) fetched to the
    host as the dict encoder_base.assemble takes: the grids cut to the
    block's WAH and sparse lines, the track grids (if any) under "trk"."""
    n_wah, n_sparse = prep["n_wah"], prep["n_sparse"]
    out = {**_line_classes(prep),
           "wah_words": outd["wah_words"][:n_wah].cpu().numpy(),
           "wah_len": outd["wah_len"][:n_wah].cpu().numpy(),
           "sparse_idx": outd["sparse_idx"][:n_sparse].cpu().numpy(),
           "sparse_len": outd["sparse_len"][:n_sparse].cpu().numpy()}
    if "trk_wah_words" in outd:
        out["trk"] = {k: outd[f"trk_{k}"].cpu().numpy() for k in
                      ("wah_words", "wah_len", "sparse_idx", "sparse_len")}
    return out


class TorchBlockEncoder(BlockEncoderBase):
    """Block encoder running the core on a torch device; the host
    assembles the payload (encoder_base).  device="cuda" launches the
    kernels, device="cpu" runs their plain versions."""

    use_device_tracks = True

    def __init__(self, *args, device: str | torch.device = "cuda", **kw):
        super().__init__(*args, **kw)
        self.device = torch.device(device)

    def serialize(self) -> bytes:
        prep = self.prepare()
        return self.assemble(self.encode_prepared(prep), prep)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype=dtype)

    def encode_prepared(self, prep: dict) -> dict:
        """The device part of serialize: the core run on prepare()'s
        output, fetched to the host as the dict `assemble` takes."""
        if prep["L"] == 0:
            # zero-ALT records only: no binary line, nothing to encode
            return {**_line_classes(prep),
                    "wah_words": np.zeros((0, 1), np.uint16),
                    "wah_len": np.zeros(0, np.int32),
                    "sparse_idx": np.zeros((0, 1), np.int32),
                    "sparse_len": np.zeros(0, np.int64)}
        sparse_cap = max(int(self.mac_threshold), 1)
        if prep["mixed"]:
            return {**_line_classes(prep),
                    **self._mixed_core(prep, sparse_cap)}

        args = [self._dev(prep["alleles_p"]), self._dev(prep["alts_p"]),
                self._dev(prep["wah_rows_p"], torch.int64),
                self._dev(prep["sorts_w"]),
                self._dev(prep["sparse_rows_p"], torch.int64),
                self._dev(prep["negated_s"])]
        flag_m, flag_e = prep["flag_m"], prep["flag_e"]
        nm, ne = len(flag_m), len(flag_e)
        fuse = nm + ne >= int(os.environ.get("XSI_TRACKS_DEVICE_MIN", "8"))
        if fuse:
            # missing/EOV tracks encode from the alleles matrix already on
            # the device.  A flagged zero-ALT record owns no line (assemble
            # refuses it); its row is clamped to stay inside the matrix.
            wah_weird = self.weirdness_strategy in (
                WeirdnessStrategy.WS_WAH, WeirdnessStrategy.WS_PBWT_WAH)
            rows = np.minimum(prep["first_lines"][
                np.concatenate([flag_m, flag_e])], prep["L"] - 1)
            kind = np.arange(nm + ne) >= nm
            outd = encode_block_core_compact_tracks(
                *args, self._dev(rows, torch.int64), self._dev(kind),
                sparse_cap, self.track_cap(prep, wah_weird))
        else:
            outd = encode_block_core_compact(*args, sparse_cap)
        return host_outputs(outd, prep)

    def _mixed_core(self, prep: dict, sparse_cap: int) -> dict:
        """encode_block_core_mixed on the device; the two WAH grids are
        stitched back into one compacted grid in line order."""
        is_wah, hap = prep["is_wah"], prep["hap_line"]
        wah_rows = np.flatnonzero(is_wah)
        sparse_rows = np.flatnonzero(~is_wah)
        hap_w = hap[wah_rows]
        dip_i, hap_i = np.flatnonzero(~hap_w), np.flatnonzero(hap_w)
        i64 = torch.int64
        outd = encode_block_core_mixed(
            self._dev(prep["alleles_p"]), self._dev(prep["alts_p"]),
            self._dev(wah_rows, i64), self._dev(dip_i, i64),
            self._dev(hap_i, i64), self._dev(sparse_rows, i64),
            self._dev(prep["negated"][sparse_rows]),
            self._dev(hap[sparse_rows]), sparse_cap)
        dw = outd["wah_words"].cpu().numpy()
        hw = outd["hap_wah_words"].cpu().numpy()
        words = np.zeros((len(wah_rows), wah_torch.n_words_for(prep["H"])),
                         np.uint16)
        lens = np.zeros(len(wah_rows), np.int32)
        words[dip_i, :dw.shape[1]] = dw
        words[hap_i, :hw.shape[1]] = hw
        lens[dip_i] = outd["wah_len"].cpu().numpy()
        lens[hap_i] = outd["hap_wah_len"].cpu().numpy()
        return {"wah_words": words, "wah_len": lens,
                "sparse_idx": outd["sparse_idx"].cpu().numpy(),
                "sparse_len": outd["sparse_len"].cpu().numpy()}

    def _device_track_rows(self, bits: np.ndarray, cap: int):
        """Track rows encoded on the device (called by encoder_base
        ._encode_tracks): the rows cross packed, 8x smaller than bool
        rows."""
        packed = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
        return tuple(x.cpu().numpy() for x in encode_tracks_packed(
            self._dev(packed), bits.shape[1], int(cap)))
