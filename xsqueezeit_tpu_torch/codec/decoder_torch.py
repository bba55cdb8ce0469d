"""Block decoder on PyTorch tensors: the CUDA fast path.

Port of xsqueezeit_tpu/codec/decoder_jax.py.  One block decodes as

    WAH stream --(expand kernel, bits unpacked inside)-->
    arrangement-ordered bits --(PBWT chunk chains + composition)-->
    natural-order bits of the WAH lines; sparse carriers scatter into the
    other lines, negated lines flip; then per-ALT overlays on the host.

Uniformly diploid and uniformly haploid blocks take this path (haploid
ones at H = n_samples); above 65,535 haplotypes the chains keep wider
states in chunks of fewer lines (pbwt_kernels.decode_chunk) and the
sparse and track streams are 32-bit.  A whole mixed-ploidy block expands at
per-line widths (wah_expand_varw_bits) and runs the parity-reconstructing
scan run by run of one ploidy (_decode_block_mixed).  Anything else -- a
record subset of a mixed block, or a LINE_SORT track that differs from
LINE_SELECT -- decodes with the NumPy GtBlockDecoder, as the JAX decoder's
random-access fallback does.  Missing/EOV tracks overlay on the host in decode_block_records;
_decode_block_full_gt_tracks is the same decode with the overlays fused on
the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..format.constants import (
    INT32_VECTOR_END,
    GTDict,
    WeirdnessStrategy,
)
from ..format.dictionary import read_dictionary
from ..ops import pbwt_np, pbwt_torch, sparse_kernels, wah_kernels, wah_np
from ..ops import wah_torch
from ..ops.sparse_np import msb as _msb, sparse_line_offsets
from ..utils import trace
from .gt_block_decoder import GtBlockDecoder


def _decode_wah_and_scan(stream, sorts, h: int, w: int, out=None,
                         line_of=None) -> torch.Tensor:
    """Decode a block's WAH lines (compacted: WAH lines only) to
    natural-order bits uint8[Lw, h], or into the block's plane `out` with
    WAH row k at out[line_of[k]].  stream: uint16[N] the lines' words back
    to back; sorts: bool[Lw].  The expand writes into whole chunks of the
    decode's rows (pbwt_torch.chunk_rows), the trailing ones zeroed, so
    the decode pads nothing."""
    Lw = sorts.shape[0]
    ys = torch.empty((pbwt_torch.chunk_rows(Lw, h), h), dtype=torch.uint8,
                     device=stream.device)
    if ys.shape[0] > Lw:
        ys[Lw:].zero_()
    wah_kernels.wah_expand_bits(stream, Lw, w, h, out=ys[:Lw])
    vals, _ = pbwt_torch.pbwt_decode_chunked(ys, sorts, out, line_of)
    return vals


def _wah_line_map(rank, is_wah, n_wah: int) -> torch.Tensor:
    """int64[n_wah]: the block line of each WAH row, on the device with no
    host sync: arange(L) scattered at each WAH line's rank, every sparse
    line into a sink slot n_wah that is dropped."""
    L = is_wah.shape[0]
    slots = torch.empty(n_wah + 1, dtype=torch.int64, device=is_wah.device)
    slots.scatter_(0, torch.where(is_wah, rank, n_wah),
                   torch.arange(L, device=is_wah.device))
    return slots[:n_wah]


def _sparse_lines(vals, is_wah, neg, car_line, car_idx, n_wah: int) -> None:
    """The sparse lines of the plane vals (sparse_kernels.sparse_lines),
    counted in decode.sparse_lines; none to write, no launch."""
    n_sparse = is_wah.shape[0] - n_wah
    if n_sparse:
        trace.count("decode.sparse_lines", n_sparse)
        sparse_kernels.sparse_lines(vals, is_wah, neg, car_line, car_idx)


def _decode_block_vals(stream, sorts, rank, is_wah, neg, car_line, car_idx,
                       h: int, w: int) -> torch.Tensor:
    """Decode a whole block (WAH + sparse lines) to natural-order bits.

    stream: uint16[N]; sorts: bool[Lw] per WAH line; rank: int64[L] WAH
    row of each line (read only where is_wah); is_wah: bool[L]; neg:
    uint8[L] 1 for negated sparse lines; car_line/car_idx: int64[Nc] the
    sparse carriers (no padding pairs).  Returns uint8[L, h].

    Every line of the one plane is written once: the run flush stores each
    WAH row at its line (through _wah_line_map), the sparse-line kernel
    fills each other line with its negation byte and sets its carriers to
    1 ^ neg (the stored indices of a negated line are its REF positions).
    """
    L = is_wah.shape[0]
    n_wah = sorts.shape[0]
    vals = torch.empty((L, h), dtype=torch.uint8, device=is_wah.device)
    if n_wah:
        _decode_wah_and_scan(stream, sorts, h, w, vals,
                             _wah_line_map(rank, is_wah, n_wah))
    _sparse_lines(vals, is_wah, neg, car_line, car_idx, n_wah)
    return vals


def _fold_biallelic_impl(vals: torch.Tensor,
                         default_phasing: int) -> torch.Tensor:
    """htslib gt codes for biallelic records: ((allele+1) << 1) | phase."""
    h = vals.shape[1]
    phase = (torch.arange(h, dtype=torch.int32, device=vals.device) & 1) \
        * int(default_phasing)
    return ((vals.to(torch.int32) + 1) << 1) | phase[None, :]


def _fold_tracks_impl(vals: torch.Tensor, default_phasing: int, mrec, midx,
                      erec, eidx) -> torch.Tensor:
    """gt codes with the missing / end-of-vector overlays
    (decoder_jax._fold_tracks_impl; it is also the standalone fold of
    decoded bits, the JAX package's _fold_biallelic_tracks).

    (mrec, midx) / (erec, eidx): int64 (record, haplotype) carrier pairs of
    the block's WS_SPARSE missing / EOV tracks, every record < L (no
    padding pairs).  A uint8 plane takes 1 at missing slots, then 2 at EOV
    slots (EOV overwrites missing, as in the record loop); two selects put
    the bare phase bit and INT32_VECTOR_END into the gt codes.
    """
    h = vals.shape[1]
    phase = (torch.arange(h, dtype=torch.int32, device=vals.device) & 1) \
        * int(default_phasing)
    gt = ((vals.to(torch.int32) + 1) << 1) | phase[None, :]
    ov = torch.zeros(gt.shape, dtype=torch.uint8, device=vals.device)
    ov[mrec, midx] = 1
    ov[erec, eidx] = 2
    gt = torch.where(ov == 1, phase[None, :], gt)
    return torch.where(ov == 2, INT32_VECTOR_END, gt)


def _decode_block_full_gt(stream, sorts, rank, is_wah, neg, car_line,
                          car_idx, default_phasing: int, h: int,
                          w: int) -> torch.Tensor:
    """Payload streams to htslib int32 gt codes int32[L, h] in one go."""
    vals = _decode_block_vals(stream, sorts, rank, is_wah, neg, car_line,
                              car_idx, h, w)
    return _fold_biallelic_impl(vals, default_phasing)


def _decode_block_full_gt_tracks(stream, sorts, rank, is_wah, neg, car_line,
                                 car_idx, default_phasing: int, mrec, midx,
                                 erec, eidx, h: int, w: int) -> torch.Tensor:
    """Payload streams to gt codes with missing/EOV overlays in one go
    (decoder_jax._decode_block_full_gt_tracks)."""
    vals = _decode_block_vals(stream, sorts, rank, is_wah, neg, car_line,
                              car_idx, h, w)
    return _fold_tracks_impl(vals, default_phasing, mrec, midx, erec, eidx)


def _decode_block_mixed(stream, group_off, sorts, hap_w, rank, is_wah, neg,
                        car_line, car_idx, hap_host, h: int,
                        w_max: int) -> torch.Tensor:
    """_decode_block_vals of a mixed-ploidy block
    (decoder_jax._decode_block_mixed): the WAH stream expands at per-line
    widths (haploid lines span n_words_for(N) groups) and the mixed scan
    rebuilds each haploid line's slot-duplicated bits from its stored
    even-parity bits, run by run (pbwt_torch.pbwt_decode_scan_mixed).
    group_off: int64[Lw + 1]; hap_w: bool[Lw]; hap_host: hap_w on the host
    (NumPy), which cuts the runs without a device sync.  Haploid rows come
    back slot-duplicated in natural order and are copied to their lines;
    the sparse lines are written as in _decode_block_vals, the carriers of
    haploid sparse lines mapped to even slots (host_inputs_mixed).  The
    scan's final arrangement is not needed, so it is not computed.
    """
    L = is_wah.shape[0]
    n_wah = sorts.shape[0]
    vals = torch.empty((L, h), dtype=torch.uint8, device=is_wah.device)
    if n_wah:
        ys = wah_kernels.wah_expand_varw_bits(stream, group_off, w_max, h)
        vals_w, _ = pbwt_torch.pbwt_decode_scan_mixed(
            ys, sorts, hap_w, hap_host, keep_final=False)
        vals.index_copy_(0, _wah_line_map(rank, is_wah, n_wah), vals_w)
    _sparse_lines(vals, is_wah, neg, car_line, car_idx, n_wah)
    return vals


def host_decoder(payload, n_samples: int, n_haps: int,
                 aet_dtype) -> GtBlockDecoder:
    """GtBlockDecoder of a GT block: its dictionary and line tracks parsed
    by the JAX package's host decoder, copied.  Where the copy raises
    KeyError (a dictionary without its line counts) or IndexError (a line
    track that runs past its stream) on a corrupt block, this raises
    ValueError, in the native accessor's words where it has them."""
    d, _ = read_dictionary(memoryview(payload), 0)
    if GTDict.KEY_BCF_LINES not in d or GTDict.KEY_BINARY_LINES not in d:
        raise ValueError("block dictionary missing line counts")
    try:
        return GtBlockDecoder(payload, n_samples, n_haps, aet_dtype)
    except IndexError as exc:
        raise ValueError(f"corrupt line track ({exc})") from exc


def line_offsets(stream: np.ndarray, n_lines: int, what: str) -> np.ndarray:
    """sparse_line_offsets (each line's head in a sparse stream, and the
    stream's end); head counts that run past the stream raise the native
    accessor's ValueError ("<what> count exceeds stream") where the host
    copy raises IndexError or returns an end past the stream."""
    try:
        offs = sparse_line_offsets(stream, n_lines)
    except IndexError:
        offs = None
    if offs is None or int(offs[-1]) > stream.shape[0]:
        raise ValueError(f"{what} count exceeds stream")
    return offs


def check_indices(line: np.ndarray, idx: np.ndarray, widths: np.ndarray,
                  what: str) -> None:
    """Raise the native accessor's ValueError ("<what> index out of
    range") unless every stored index idx (any integer type, as stored)
    is below widths[line], the width of its line (n_samples for a
    haploid line, n_haps else); every line < len(widths).  One max over
    the stored values, no device sync; each index's own width is read
    only where one reaches the narrowest line's width."""
    if idx.size and int(idx.max()) >= int(widths.min()) and bool(
            (idx >= widths[line]).any()):
        raise ValueError(f"{what} index out of range")


def track_carriers(stream: np.ndarray, flagged_lines: np.ndarray,
                   aet_dtype, widths: np.ndarray,
                   what: str = "track") -> tuple[np.ndarray, np.ndarray]:
    """Flat (line, haplotype) carrier pairs of a WS_SPARSE exception-track
    stream (rows in flagged-line order, heads [count] with no negation).
    widths: int64[L] each line's width (TorchBlockDecoder.line_width); a
    pair outside the block raises ValueError("<what> index out of
    range")."""
    msb = _msb(np.dtype(aet_dtype))
    flagged_lines = np.asarray(flagged_lines, np.int64)
    if flagged_lines.size and int(flagged_lines.max()) >= widths.shape[0]:
        raise ValueError(f"{what} index out of range")
    offs = line_offsets(stream, len(flagged_lines), what)
    heads = stream[offs[:-1]].astype(np.int64)
    counts = heads & (msb - 1)
    car_line = np.repeat(flagged_lines, counts)
    take = np.ones(int(offs[-1]), bool)
    take[offs[:-1]] = False
    stored = stream[:offs[-1]][take]
    check_indices(car_line, stored, widths, what)
    return car_line, stored.astype(np.int64)


class TorchBlockDecoder:
    """Decodes a whole GT block into per-record allele matrices.

    A corrupt block raises ValueError on every device, before any tensor
    is built from it: a line track that does not cover the block's lines,
    or a stored index (sparse carrier, missing or EOV track) past its
    line's width, in the native accessor's words ("sparse index out of
    range").  The JAX package's device route drops such an index instead
    and its NumPy route raises IndexError."""

    def __init__(self, payload: memoryview | bytes, n_samples: int,
                 n_haps: int, aet_dtype=np.uint32,
                 device: str | torch.device = "cuda"):
        self.n_samples = n_samples
        self.n_haps = n_haps
        self.aet_dtype = np.dtype(aet_dtype)
        self.device = torch.device(device)
        # header/metadata parsing and the random-access fallback
        self.meta = m = host_decoder(payload, n_samples, n_haps, aet_dtype)
        if m.line_is_wah is None:
            raise ValueError("block missing line-select track")
        if any(v is not None and v.shape[0] != m.binary_lines
               for v in (m.line_is_wah, m.line_is_sorting, m.haploid_line,
                         m.line_has_missing, m.line_has_eov,
                         m.line_has_nup)):
            raise ValueError("corrupt block payload: a line track is "
                             "shorter than the block's lines")
        #: each binary line's width: n_samples for a haploid line
        self.line_width = np.where(m.haploid_line.astype(bool), n_samples,
                                   n_haps).astype(np.int64)
        self._tracks: dict = {}                # track_pairs, parsed once
        self._vals: np.ndarray | None = None   # natural-order bits
        self._neg: np.ndarray | None = None
        # Uniformly-haploid blocks are an N-element PBWT over samples: the
        # same kernels decode them with H = n_samples.
        self.uniform_haploid = (self.meta.binary_lines > 0
                                and bool(self.meta.haploid_line.all()))
        self.n_eff = n_samples if self.uniform_haploid else n_haps

    @property
    def eligible(self) -> bool:
        """Uniformly diploid or uniformly haploid, and sort == select (the
        chunk chains partition after every WAH line)."""
        return ((self.uniform_haploid
                 or not bool(self.meta.haploid_line.any()))
                and self.meta.binary_lines > 0
                and bool(np.array_equal(self.meta.line_is_sorting,
                                        self.meta.line_is_wah)))

    def track_pairs(self, what: str) -> tuple[np.ndarray, np.ndarray]:
        """The (line, haplotype) carrier pairs of the block's WS_SPARSE
        "missing" or "EOV" track (track_carriers: each index checked
        against its line's width), parsed once."""
        if what not in self._tracks:
            m = self.meta
            flags, stream = ((m.line_has_missing, m.missing_sparse)
                             if what == "missing"
                             else (m.line_has_eov, m.eov_sparse))
            if stream is None:
                raise ValueError(f"{what} track absent")
            self._tracks[what] = track_carriers(
                stream, np.flatnonzero(flags), self.aet_dtype,
                self.line_width, what)
        return self._tracks[what]

    def host_inputs(self) -> tuple:
        """Parse the payload streams into the decode inputs (numpy):
        (stream u16[N], sorts bool[Lw], rank i64[L], is_wah bool[L],
        neg u8[L], car_line i64[Nc], car_idx i64[Nc], H, W, L, n_wah).
        Nothing is padded: the carriers are exactly the stored ones
        (sparse_carriers), counted in decode.carriers."""
        m = self.meta
        H = self.n_eff
        W = wah_torch.n_words_for(H)
        L = m.binary_lines
        is_wah = m.line_is_wah.astype(bool)
        stream = (m.wah_stream if m.wah_stream is not None
                  else np.zeros(0, np.uint16))
        n_wah = int(is_wah.sum())
        sorts = np.ones(n_wah, bool)
        rank = np.clip(np.cumsum(is_wah) - 1, 0, None).astype(np.int64)
        neg, car_line, car_idx = self.sparse_carriers()
        trace.count("decode.carriers", len(car_idx))
        return (np.array(stream), sorts, rank, is_wah, neg,
                car_line, car_idx, H, W, L, n_wah)

    def sparse_carriers(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The block's sparse lines: (neg u8[L] 1 for a negated line,
        car_line i64[Nc], car_idx i64[Nc] every stored index that is not
        a head, with its line), each index checked against its line's
        width."""
        m = self.meta
        is_wah = m.line_is_wah.astype(bool)
        neg = np.zeros(m.binary_lines, np.uint8)
        car_line = np.zeros(0, np.int64)
        car_idx = np.zeros(0, np.int64)
        if (~is_wah).any():
            sp = m.sparse_stream
            if sp is None:
                raise ValueError("sparse stream truncated")
            msb = _msb(self.aet_dtype)
            sparse_lines = np.flatnonzero(~is_wah)
            offs = line_offsets(sp, len(sparse_lines), "sparse")
            heads = sp[offs[:-1]].astype(np.int64)
            counts = heads & (msb - 1)
            neg[sparse_lines] = (heads & msb) != 0
            if int(counts.sum()):
                # every sparse element that is not a head, with its line
                car_line = np.repeat(sparse_lines, counts).astype(np.int64)
                take = np.ones(int(offs[-1]), bool)
                take[offs[:-1]] = False
                stored = sp[:offs[-1]][take]
                check_indices(car_line, stored, self.line_width, "sparse")
                car_idx = stored.astype(np.int64)
        return neg, car_line, car_idx

    def device_inputs(self) -> tuple:
        """host_inputs moved to the decoder's device, plus (H, W, L)."""
        (stream, sorts, rank, is_wah, neg, car_line, car_idx,
         H, W, L, _n_wah) = self.host_inputs()
        t = [torch.from_numpy(x).to(self.device)
             for x in (stream, sorts, rank, is_wah, neg, car_line, car_idx)]
        return (*t, H, W, L)


    @property
    def mixed_device_ok(self) -> bool:
        """Mixed-ploidy blocks (haploid and diploid lines interleaved) take
        the parity-reconstruction path (_decode_block_mixed) under the
        constraints of `eligible`; WS_PBWT_WAH tracks replay on the host."""
        m = self.meta
        return (m.binary_lines > 0
                and bool(m.haploid_line.any())
                and not self.uniform_haploid
                and bool(np.array_equal(m.line_is_sorting, m.line_is_wah))
                and not (m.has_weirdness and m.weirdness_strat
                         == WeirdnessStrategy.WS_PBWT_WAH))

    def host_inputs_mixed(self) -> tuple:
        """host_inputs of a mixed-ploidy block (numpy, nothing padded):
        (stream u16[N], group_off i64[Lw + 1] per-WAH-line group offsets,
        sorts bool[Lw], hap_w bool[Lw], rank i64[L], is_wah bool[L], neg
        u8[L], car_line i64[Nc], car_idx i64[Nc], H, w_max, L).  Haploid
        sparse lines store sample indices s, which map to slot 2s of the
        slot-duplicated row."""
        (stream, _, rank, is_wah, neg, car_line, car_idx,
         _, _, L, n_wah) = self.host_inputs()
        H, N = self.n_haps, self.n_samples
        hap = self.meta.haploid_line.astype(bool)
        hap_w = hap[is_wah]
        w_dip, w_hap = wah_torch.n_words_for(H), wah_torch.n_words_for(N)
        group_off = np.zeros(n_wah + 1, np.int64)
        np.cumsum(np.where(hap_w, w_hap, w_dip), out=group_off[1:])
        car_idx = np.where(hap[car_line], car_idx * 2, car_idx)
        # a corrupt header's n_haps may be below 2 * n_samples
        check_indices(car_line, car_idx, np.full(L, H, np.int64), "sparse")
        return (stream, group_off, np.ones(n_wah, bool), hap_w, rank,
                is_wah, neg, car_line, car_idx, H, max(w_dip, w_hap), L)

    def decode_bits(self) -> tuple[torch.Tensor, str]:
        """Decode the whole block on the decoder's device; returns its
        carrier bits, a uint8 tensor [L, H] in natural haplotype order left
        on the device, and the route taken: "device" for an eligible block
        (H = n_eff), "mixed" for a mixed-ploidy one (H = n_haps, haploid
        lines slot-duplicated: fold the even slots).  Any other block
        decodes record by record on the host (GtBlockDecoder).  The
        decode.parse span carries aet_bits, the width of the block's sparse
        and track values (16 up to 65,535 haplotypes, else 32); the
        decode.device span sparse_lines, the lines the sparse-line kernel
        writes (counted in decode.sparse_lines), and the counter
        decode.haploid_lines the haploid lines it decodes.  A mixed block's
        decode.device holds decode.mixed around _decode_block_mixed, with
        the shapes its byte bound reads: haps, w_max, lines, wah_lines,
        haploid_lines, stream_words and sparse_values (the stored sparse
        heads and indices)."""
        aet_bits = 8 * self.aet_dtype.itemsize
        if self.eligible:
            with trace.span("decode.parse", aet_bits=aet_bits):
                *arrays, H, W, L, n_wah = self.host_inputs()
            neg = arrays[4]
            t = self._upload(arrays)
            with trace.span("decode.device", sparse_lines=L - n_wah):
                if self.uniform_haploid:
                    trace.count("decode.haploid_lines", L)
                vals, route = _decode_block_vals(*t, H, W), "device"
        elif self.mixed_device_ok:
            with trace.span("decode.parse", aet_bits=aet_bits):
                *arrays, H, w_max, L = self.host_inputs_mixed()
            neg = arrays[6]
            n_wah = arrays[2].shape[0]
            n_hap = int(np.count_nonzero(self.meta.haploid_line))
            t = self._upload(arrays)
            with trace.span("decode.device", sparse_lines=L - n_wah):
                trace.count("decode.haploid_lines", n_hap)
                with trace.span("decode.mixed", haps=H, w_max=w_max,
                                lines=L, wah_lines=n_wah, haploid_lines=n_hap,
                                stream_words=arrays[0].shape[0],
                                sparse_values=arrays[8].shape[0] + L - n_wah):
                    vals = _decode_block_mixed(*t, arrays[3], H, w_max)
            route = "mixed"
        else:
            raise ValueError("the block takes no device route: decode it "
                             "record by record on the host")
        self._neg = neg.astype(bool)
        return vals, route

    def _upload(self, arrays: list) -> list:
        """The decode's host arrays copied to the decoder's device."""
        with trace.span("decode.upload",
                        bytes=sum(x.nbytes for x in arrays)):
            return [torch.from_numpy(x).to(self.device) for x in arrays]

    def decode_all(self) -> np.ndarray:
        """decode_bits copied to the host (cached; record_alleles folds
        records)."""
        self._vals = self.decode_bits()[0].cpu().numpy()
        return self._vals


    def record_alleles(self, first_line: int, n_alleles: int) -> np.ndarray:
        """Fold a record's binary lines into allele codes [H].

        Overlay order of GtBlockDecoder.fill_genotype_array_advance: later
        ALT lines overwrite, and a negated sparse line (whose stored bits
        are the complement {allele != 0}) marks all currently-REF slots as
        this ALT and then restores the stored (REF) indices."""
        vals = self._vals
        neg = self._neg
        if n_alleles <= 1:
            return np.zeros(self.n_eff, np.int16)
        out = vals[first_line].astype(np.int16)
        for j in range(1, n_alleles - 1):
            row = vals[first_line + j].astype(bool)
            alt = j + 1
            if neg[first_line + j]:
                out = np.where(out == 0, alt, out).astype(np.int16)
                out = np.where(~row & (out == alt), 0, out).astype(np.int16)
            else:
                out = np.where(row, alt, out).astype(np.int16)
        return out


def _mixed_records(dev: TorchBlockDecoder, n_alleles_per_record: list[int],
                   n_haps: int, aet_dtype) -> list[np.ndarray]:
    """decode_block_records of a whole mixed-ploidy block (the mixed
    branch of decoder_jax.decode_block_records): the block's bits decode
    on the device, haploid records fold their even slots, and the
    exception tracks overlay record by record on the host, width-aware
    (haploid lines store sample indices and n_samples-wide WAH rows), as
    GtBlockDecoder.fill_genotype_array_advance does."""
    m = dev.meta
    if dev._vals is None:
        dev.decode_all()
    H, N = dev.n_haps, dev.n_samples
    idx = np.arange(H)
    phase = ((idx & 1) & m.default_phasing).astype(np.int32)
    phase_hap = np.zeros(N, np.int32)
    zero_alt_gt = (np.int32(1 << 1)
                   | ((np.arange(n_haps) & 1)
                      & m.default_phasing)).astype(np.int32)
    wah_weird = m.weirdness_strat in (WeirdnessStrategy.WS_WAH,
                                      WeirdnessStrategy.WS_PBWT_WAH)
    msb = 1 << (np.dtype(aet_dtype).itemsize * 8 - 1)
    # haploid WS_WAH tracks index the arrangement derived from the iota
    hap_weird = pbwt_np.haploid_rearrangement_from_diploid(idx)
    miss_pos = eov_pos = phs_pos = 0

    def targets(sparse, pos, wah, n, haploid):
        if wah_weird:
            y, _ = wah_np.wah_decode(wah[pos:], n)
            sel = y[:n].astype(bool)
            return hap_weird[sel] if haploid else idx[sel]
        cnt = int(sparse[pos]) & (msb - 1)
        return sparse[pos + 1:pos + 1 + cnt].astype(np.int64)

    def advance(sparse, pos, wah, n):
        if wah_weird:
            return pos + wah_np.wah_words_consumed(wah[pos:], n)
        return pos + 1 + (int(sparse[pos]) & (msb - 1))

    out = []
    first = 0
    for na in n_alleles_per_record:
        if na <= 1:
            out.append(zero_alt_gt.copy())
            continue
        haploid = bool(m.haploid_line[first])
        alleles = dev.record_alleles(first, na)
        if haploid:
            gt = (alleles[::2].astype(np.int32) + 1) << 1
            pterm = phase_hap
        else:
            gt = ((alleles.astype(np.int32) + 1) << 1) | phase
            pterm = phase
        n = gt.shape[0]
        if m.line_has_missing is not None and m.line_has_missing[first]:
            tgt = targets(m.missing_sparse, miss_pos, m.missing_wah, n,
                          haploid)
            gt[tgt] = pterm[tgt]
        if m.line_has_eov is not None and m.line_has_eov[first]:
            tgt = targets(m.eov_sparse, eov_pos, m.eov_wah, n, haploid)
            gt[tgt] = np.int32(INT32_VECTOR_END)
        if m.line_has_nup is not None and m.line_has_nup[first]:
            y, _ = wah_np.wah_decode(m.phase_wah[phs_pos:], n)
            sel = y[:n].astype(bool) & (gt != np.int32(INT32_VECTOR_END))
            gt[sel] ^= (np.arange(n)[sel] & 1).astype(np.int32)

        # advance the exception cursors over this record's binary lines
        for p in range(first, first + na - 1):
            n_line = N if m.haploid_line[p] else H
            if m.line_has_missing is not None and m.line_has_missing[p]:
                miss_pos = advance(m.missing_sparse, miss_pos, m.missing_wah,
                                   n_line)
            if m.line_has_eov is not None and m.line_has_eov[p]:
                eov_pos = advance(m.eov_sparse, eov_pos, m.eov_wah, n_line)
            if m.line_has_nup is not None and m.line_has_nup[p]:
                phs_pos += wah_np.wah_words_consumed(m.phase_wah[phs_pos:],
                                                     n_line)
        out.append(gt.astype(np.int32))
        first += na - 1
    return out


def mesh_decode_all(decoders: list[TorchBlockDecoder], devices: list
                    ) -> None:
    """decode_all of several blocks over a device pool (data parallelism
    on the block axis, the decode-side counterpart of
    parallel/shard.MeshBlockEncoder): block i decodes on devices[i % n],
    one worker thread per device.  Fills each decoder's cached bits
    exactly as its own decode_all() would (it is decode_all, on the
    block's pool device), so downstream record folding and overlays are
    unchanged.  Each block decodes alone at its own shapes: nothing is
    padded, so no padding carrier needs masking.  Every decoder must be
    eligible or mixed_device_ok."""
    from ..parallel.shard import map_blocks

    parent = trace.current()

    def decode(dec, device):
        with trace.span("decode.block", parent=parent, device=str(device)):
            dec.device = torch.device(device)
            dec.decode_all()

    map_blocks(decode, decoders, devices)


def decode_block_records(payload, n_samples, n_haps, aet_dtype,
                         n_alleles_per_record: list[int],
                         offsets: list[int] | None = None,
                         predecoded: TorchBlockDecoder | None = None,
                         device: str | torch.device = "cuda"
                         ) -> list[np.ndarray]:
    """Decode records of a block to htslib gt arrays (device decode of the
    block's bits, host overlays).  Blocks that are not eligible decode with
    the NumPy GtBlockDecoder.

    `offsets` gives each record's first binary line (BM & 0x7FFF) for
    region/target-filtered runs where the records are a non-contiguous
    subset of the block; omitted, records are consecutive from line 0.
    `predecoded` supplies a decoder whose bits were already produced.
    Every stored index of the block is checked against its line's width
    before any route reads it (sparse_carriers, track_pairs): a corrupt
    block raises ValueError in the native accessor's words."""
    contiguous = True
    if offsets is not None:
        pos = 0
        for off, na in zip(offsets, n_alleles_per_record):
            if off != pos:
                contiguous = False
                break
            pos += max(na - 1, 0)

    dev = predecoded or TorchBlockDecoder(payload, n_samples, n_haps,
                                          aet_dtype, device=device)
    m = dev.meta
    if m.weirdness_strat == WeirdnessStrategy.WS_SPARSE:
        for flags, what in ((m.line_has_missing, "missing"),
                            (m.line_has_eov, "EOV")):
            if flags is not None and flags.any():
                dev.track_pairs(what)

    def numpy_random_access():
        dev.sparse_carriers()       # its checks: GtBlockDecoder has none
        out = []
        pos = 0
        for i, na in enumerate(n_alleles_per_record):
            m.seek(offsets[i] if offsets is not None else pos)
            out.append(m.fill_genotype_array_advance(na))
            pos += max(na - 1, 0)
        return out

    if not dev.eligible:
        # mixed-ploidy blocks decode on the device only for a whole block
        # (the CLI passes offsets, so it takes GtBlockDecoder, as the JAX
        # package's does)
        if dev.mixed_device_ok and contiguous and offsets is None:
            return _mixed_records(dev, n_alleles_per_record, n_haps,
                                  aet_dtype)
        return numpy_random_access()

    # Haploid records carry one slot per sample and no phase bit.
    dp = 0 if dev.uniform_haploid else m.default_phasing
    H = dev.n_eff
    idx = np.arange(H)
    phase_term = ((idx & 1) & dp).astype(np.int32)
    # Zero-ALT records own no binary line; the NumPy decoder emits them at
    # full diploid width with default phasing regardless of block ploidy.
    zero_alt_gt = (np.int32(1 << 1)
                   | ((np.arange(n_haps) & 1)
                      & m.default_phasing)).astype(np.int32)

    no_weird = ((m.line_has_missing is None or not m.line_has_missing.any())
                and (m.line_has_eov is None or not m.line_has_eov.any())
                and (m.line_has_nup is None or not m.line_has_nup.any()))
    if not no_weird and not contiguous:
        # exception-track cursors only replay sequentially; filtered subsets
        # of weird blocks use the random-access NumPy decoder
        return numpy_random_access()

    if dev._vals is None:
        dev.decode_all()

    # All-biallelic, no exception tracks: one elementwise pass.
    if no_weird and all(na == 2 for na in n_alleles_per_record):
        rows = (np.asarray(offsets) if offsets is not None
                else np.arange(len(n_alleles_per_record)))
        gt_all = ((dev._vals[rows].astype(np.int32) + 1) << 1) \
            | phase_term[None, :]
        return list(gt_all)

    # All-biallelic, WS_SPARSE tracks, no phase exceptions: the missing/EOV
    # streams parse in one vectorized walk and overlay with two scatters
    # (missing takes the bare phase bit, then EOV overwrites).  Contiguous
    # was checked above, so record i sits at line i.
    if (m.weirdness_strat == WeirdnessStrategy.WS_SPARSE
            and (m.line_has_nup is None or not m.line_has_nup.any())
            and all(na == 2 for na in n_alleles_per_record)):
        n = len(n_alleles_per_record)
        gt_all = ((dev._vals[:n].astype(np.int32) + 1) << 1) \
            | phase_term[None, :]
        if m.line_has_missing is not None and m.line_has_missing.any():
            car_rec, car_idx = dev.track_pairs("missing")
            keep = car_rec < n
            gt_all[car_rec[keep], car_idx[keep]] = \
                phase_term[car_idx[keep]]
        if m.line_has_eov is not None and m.line_has_eov.any():
            car_rec, car_idx = dev.track_pairs("EOV")
            keep = car_rec < n
            gt_all[car_rec[keep], car_idx[keep]] = np.int32(INT32_VECTOR_END)
        return list(gt_all)

    if not contiguous:
        # no exception tracks: fold each selected record's lines directly
        out = []
        for off, na in zip(offsets, n_alleles_per_record):
            if na <= 1:
                out.append(zero_alt_gt.copy())
                continue
            alleles = dev.record_alleles(off, na)
            out.append((((alleles.astype(np.int32) + 1) << 1)
                        | phase_term).astype(np.int32))
        return out

    # host-side exception streams, replayed record by record
    ws = m.weirdness_strat
    wah_weird = ws in (WeirdnessStrategy.WS_WAH, WeirdnessStrategy.WS_PBWT_WAH)
    miss_pos = eov_pos = phs_pos = 0
    a_weird = np.arange(H)
    msb = 1 << (np.dtype(aet_dtype).itemsize * 8 - 1)
    # a WS_PBWT_WAH (v4) block chains a_weird by each weird line's own
    # bits; uniform-haploid blocks never sort it
    chain = ws == WeirdnessStrategy.WS_PBWT_WAH and not dev.uniform_haploid

    out = []
    first_line = 0
    for na in n_alleles_per_record:
        if na <= 1:
            # zero-ALT record: no binary line, all-REF with default phasing
            # (first_line belongs to the NEXT record: no overlays apply)
            out.append(zero_alt_gt.copy())
            continue
        alleles = dev.record_alleles(first_line, na)
        gt = ((alleles.astype(np.int32) + 1) << 1) | phase_term

        if m.line_has_missing is not None and m.line_has_missing[first_line]:
            if wah_weird:
                y, _ = wah_np.wah_decode(m.missing_wah[miss_pos:], H)
                tgt = a_weird[y.astype(bool)]
            else:
                cnt = int(m.missing_sparse[miss_pos]) & (msb - 1)
                tgt = m.missing_sparse[
                    miss_pos + 1:miss_pos + 1 + cnt].astype(np.int64)
            gt[tgt] = phase_term[tgt]
        if m.line_has_eov is not None and m.line_has_eov[first_line]:
            if wah_weird:
                y, _ = wah_np.wah_decode(m.eov_wah[eov_pos:], H)
                tgt = a_weird[y.astype(bool)]
            else:
                cnt = int(m.eov_sparse[eov_pos]) & (msb - 1)
                tgt = m.eov_sparse[
                    eov_pos + 1:eov_pos + 1 + cnt].astype(np.int64)
            gt[tgt] = np.int32(INT32_VECTOR_END)
        if m.line_has_nup is not None and m.line_has_nup[first_line]:
            y, _ = wah_np.wah_decode(m.phase_wah[phs_pos:], H)
            sel = y.astype(bool) & (gt != np.int32(INT32_VECTOR_END))
            gt[sel] ^= (idx[sel] & 1).astype(np.int32)

        # advance the exception cursors over this record's binary lines
        for j in range(na - 1):
            p = first_line + j
            y_m = y_e = None
            if m.line_has_missing is not None and m.line_has_missing[p]:
                if not wah_weird:
                    miss_pos += 1 + (int(m.missing_sparse[miss_pos])
                                     & (msb - 1))
                elif chain:
                    y_m, used = wah_np.wah_decode(m.missing_wah[miss_pos:], H)
                    miss_pos += used
                else:
                    miss_pos += wah_np.wah_words_consumed(
                        m.missing_wah[miss_pos:], H)
            if m.line_has_eov is not None and m.line_has_eov[p]:
                if not wah_weird:
                    eov_pos += 1 + (int(m.eov_sparse[eov_pos]) & (msb - 1))
                elif chain:
                    y_e, used = wah_np.wah_decode(m.eov_wah[eov_pos:], H)
                    eov_pos += used
                else:
                    eov_pos += wah_np.wah_words_consumed(
                        m.eov_wah[eov_pos:], H)
            if y_m is not None and y_e is not None:
                a_weird = pbwt_np.pbwt_sort_two_bool(a_weird, y_m[:H],
                                                     y_e[:H])
            elif y_m is not None:
                a_weird = pbwt_np.pbwt_sort_bool(a_weird, y_m[:H])
            elif y_e is not None:
                a_weird = pbwt_np.pbwt_sort_bool(a_weird, y_e[:H])
            if m.line_has_nup is not None and m.line_has_nup[p]:
                phs_pos += wah_np.wah_words_consumed(m.phase_wah[phs_pos:], H)

        out.append(gt.astype(np.int32))
        first_line += na - 1
    return out
