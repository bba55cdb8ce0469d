"""Block encoder on PyTorch tensors: the CUDA fast path.

Port of xsqueezeit_tpu/codec/encoder_jax.py (encode_block_core_compact,
the carrier extraction and DeviceBlockEncoder's serialize).  One block
encodes as

    WAH rows --(PBWT chunk chains)--> arrangement-ordered bits
             --(pack_bits + WAH2 RLE kernel)--> words[Lw, W]
    sparse rows --(rank by cumsum + scatter)--> carrier indices[Ls, cap]

and the host assembles the byte-exact GT block payload through
encoder_base, exactly as for the JAX and NumPy encoders.  Line classes are
host-known (per-record carrier counts taken at ingest), so the chain runs
only over the WAH rows and the extraction only over the sparse rows.
Exception tracks (missing / end-of-vector / phase) encode with numpy in
encoder_base.
"""
from __future__ import annotations

import numpy as np
import torch

from xsqueezeit_tpu.codec.encoder_base import BlockEncoderBase

from ..ops import pbwt_kernels, pbwt_torch, wah_kernels, wah_torch

#: Later PR of the port that brings the cases this slice refuses.
LATER = "not ported to the CUDA path yet (a later PR of the port)"
#: Why blocks above the chunked PBWT's 16-bit slot field are refused.
TOO_WIDE = (f"blocks wider than {pbwt_kernels.MAX_H} haplotypes need the "
            f"pbwt_encode_scan / pbwt_decode_blocked fallbacks, which are "
            f"{LATER} (ROADMAP.md: wider than HRC)")


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
    wah_words, wah_len = wah_kernels.wah_compress(wah_torch.pack_bits(ys))

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


class TorchBlockEncoder(BlockEncoderBase):
    """Block encoder running the core on a torch device; the host
    assembles the payload (encoder_base).  device="cuda" launches the
    kernels, device="cpu" runs their plain versions."""

    use_device_tracks = False

    def __init__(self, *args, device: str | torch.device = "cuda", **kw):
        super().__init__(*args, **kw)
        self.device = torch.device(device)

    def serialize(self) -> bytes:
        # no bucket padding: torch has no per-shape compile to amortize
        return self.serialize_prepared(self.prepare(pad=False))

    def serialize_prepared(self, prep: dict) -> bytes:
        if prep["mixed"]:
            raise NotImplementedError(f"mixed-ploidy blocks are {LATER}")
        if prep["H"] > pbwt_kernels.MAX_H:
            raise NotImplementedError(f"{TOO_WIDE} (got {prep['H']})")

        def dev(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(self.device, dtype=dtype)

        n_wah, n_sparse = prep["n_wah"], prep["n_sparse"]
        outd = encode_block_core_compact(
            dev(prep["alleles_p"]), dev(prep["alts_p"]),
            dev(prep["wah_rows_p"], torch.int64), dev(prep["sorts_w"]),
            dev(prep["sparse_rows_p"], torch.int64), dev(prep["negated_s"]),
            max(int(self.mac_threshold), 1))
        out = {
            "is_wah": prep["is_wah"],
            "negated": prep["negated"],
            "wah_compact": True,
            "sparse_compact": True,
            "wah_words": outd["wah_words"][:n_wah].cpu().numpy(),
            "wah_len": outd["wah_len"][:n_wah].cpu().numpy(),
            "sparse_idx": outd["sparse_idx"][:n_sparse].cpu().numpy(),
            "sparse_len": outd["sparse_len"][:n_sparse].cpu().numpy(),
        }
        return self.assemble(out, prep)
