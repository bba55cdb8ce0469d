"""Decompression driver on the torch codec: .xsi + _var.bcf -> VCF/BCF/XSI.

Port of xsqueezeit_tpu/codec/decompressor.py.  The JAX package's
Decompressor (jax-free at import) keeps the variant walk, region/target
filters, sample subsetting and the writers; this subclass decodes whole
blocks with decoder_torch on the chosen device, and re-encodes (-O x) with
TorchBlockEncoder on it.  device="numpy" keeps the host codec.
"""
from __future__ import annotations

import os
import struct
import tempfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from itertools import chain

import numpy as np

# before the container: it imports zstandard, which may be missing
from ..format import zstd_shim  # noqa: F401  isort: skip
from xsqueezeit_tpu.codec import decompressor as _base
from xsqueezeit_tpu.codec.compressor import make_variant_header
from xsqueezeit_tpu.format.constants import (
    BM_BLOCK_BITS,
    XSI_BCF_VAR_EXTENSION,
    WeirdnessStrategy,
)
from xsqueezeit_tpu.format.container import XsiWriter
from xsqueezeit_tpu.format.header import XsiHeader
from xsqueezeit_tpu.io.bcf import BcfWriter, patch_shared_sample_counts
from xsqueezeit_tpu.io.csi import CsiBuilder, depth_for_max_len
from xsqueezeit_tpu.io.sites import encode_bm_indiv

from ..utils.devprobe import torch_device
from .compressor import CompressorOptions, TorchEncodeDispatcher, \
    compress_file
from .decoder_torch import decode_block_records

_OFFSET_MASK = (1 << BM_BLOCK_BITS) - 1


@dataclass
class DecompressorOptions(_base.DecompressorOptions):
    device: str = "cuda"  # "cuda" | "cpu" | "numpy"


def _block_of(bm: int) -> int:
    return (bm & 0xFFFFFFFF) >> BM_BLOCK_BITS


class Decompressor(_base.Decompressor):
    def __init__(self, xsi_path: str,
                 opts: DecompressorOptions | None = None):
        opts = opts or DecompressorOptions()
        # resolve the device before any work: "cuda" without a card fails
        self.torch_device = torch_device(opts.device)
        super().__init__(xsi_path, opts)

    def _use_device(self) -> bool:
        return self.torch_device is not None

    def _local_mesh(self):
        return None   # one device; multi-GPU is a later PR of the port

    def _recompress_options(self) -> CompressorOptions:
        """The source's rare/common split and block length (the base
        class's options), encoded on this decompressor's device."""
        base = super()._recompress_options()
        return CompressorOptions(maf=base.maf, zstd=base.zstd,
                                 block_length=base.block_length,
                                 device=self.opts.device)

    def _decompress_to_xsi_via_bcf(self, output_path: str) -> dict:
        """Decode to an intermediate BCF, then compress it with the port's
        compress_file (XSI_FUSED_RECOMPRESS=0, and empty selections)."""
        with tempfile.TemporaryDirectory() as td:
            tmp = os.path.join(td, "recompress.bcf")
            self._decompress_to_bcf(tmp)
            return compress_file(tmp, output_path, self._recompress_options())

    def _decompress_to_xsi(self, output_path: str) -> dict:
        """Re-compress the (possibly subset or filtered) records into a
        fresh XSI with the BM rewrite inside the decode loop
        (decompressor.py:686-851 of the JAX package, its device encoder
        replaced by TorchEncodeDispatcher).  Bytes equal the detour's and
        every device's; XSI_FUSED_RECOMPRESS=0 takes the detour."""
        if os.environ.get("XSI_FUSED_RECOMPRESS", "1") in ("0", "off", "no"):
            return self._decompress_to_xsi_via_bcf(output_path)
        opts = self._recompress_options()
        n_out = len(self.output_samples)
        n_haps_out = n_out * 2    # A_T selection assumes diploid (ref parity)
        mac_threshold = int(n_haps_out * opts.maf)
        aet_dtype = np.uint16 if n_haps_out <= 0xFFFF else np.uint32

        # The lead records give phasedness and first-entry ploidy, as
        # compress_file's sniffers would on the intermediate BCF.
        stream = self.iter_decoded_records()
        lead = []
        for item in stream:
            lead.append(item)
            if len(lead) >= 3:
                break
        if not lead:
            # empty selection: raise as compressing an empty BCF would
            return self._decompress_to_xsi_via_bcf(output_path)

        def out_ploidy(gt):
            return self._line_ploidy(gt.shape[0])

        counts = [0, 0]
        default_phased = None
        for _, gt in lead:
            p = out_ploidy(gt)
            if p == 1:
                default_phased = 0
                break
            second = self._subset_gt(gt, p).reshape(-1, p)[:, 1]
            phased = int((second & 1).sum())
            counts[1] += phased
            counts[0] += second.shape[0] - phased
        if default_phased is None:
            default_phased = 1 if counts[1] >= counts[0] else 0
        max_ploidy = out_ploidy(lead[0][1])

        header = XsiHeader(
            version=5, ind_bytes=4,
            aet_bytes=np.dtype(aet_dtype).itemsize, wah_bytes=2,
            iota_ppa=True, no_sort=False,
            default_phased=bool(default_phased),
            ss_rate=opts.block_length, rare_threshold=mac_threshold)
        xsi = XsiWriter(output_path, header, self.output_samples,
                        zstd_on=opts.zstd, zstd_level=opts.zstd_level)
        var_path = output_path + XSI_BCF_VAR_EXTENSION
        out_hdr = self.output_header()
        self._declare_subset_tags(out_hdr)   # before the header hits disk
        var_header = make_variant_header(out_hdr,
                                         os.path.basename(output_path))
        var_writer = BcfWriter(var_path, var_header)
        csi = CsiBuilder(depth=depth_for_max_len(
            max(var_header.contig_lengths.values(), default=0)))
        block = TorchEncodeDispatcher(
            n_out, opts.block_length, mac_threshold,
            default_phasing=default_phased, aet_dtype=aet_dtype,
            weirdness_strategy=WeirdnessStrategy.WS_SPARSE,
            device=self.torch_device)
        entry_counter = variant_counter = 0
        bm_block = bm_offset = 0
        pending: deque = deque()
        try:
            for rec, gt in chain(lead, stream):
                ploidy = out_ploidy(gt)
                max_ploidy = max(max_ploidy, ploidy)
                gt = self._subset_gt(gt, ploidy)
                if entry_counter and entry_counter % opts.block_length == 0:
                    bm_block += 1
                    bm_offset = 0
                if bm_offset >> BM_BLOCK_BITS:
                    raise ValueError(f"BM offset cannot be represented on "
                                     f"{BM_BLOCK_BITS} bits")
                bm = (bm_block << BM_BLOCK_BITS) | bm_offset
                shared = patch_shared_sample_counts(rec.shared, 1, n_out)
                if self._select is not None:
                    shared = self._patch_shared_ac_an(shared, gt,
                                                      rec.n_allele,
                                                      var_header)
                shared = patch_shared_sample_counts(shared, 1, 1)
                vbeg, vend = var_writer.write_raw(
                    shared, encode_bm_indiv(var_header, bm))
                rid, pos0, rlen = struct.unpack_from("<iii", shared, 0)
                csi.add(rid, pos0, pos0 + max(rlen, 1), vbeg, vend)

                if block.full:
                    pending.append(block.submit())
                    while pending and pending[0].done():
                        xsi.write_block(pending.popleft().result())
                    while len(pending) > block.inflight_target:
                        xsi.write_block(pending.popleft().result())
                block.encode_record(gt, rec.n_allele)

                bm_offset += rec.n_allele - 1
                variant_counter += rec.n_allele - 1
                entry_counter += 1

            while pending:
                xsi.write_block(pending.popleft().result())
            if block.bcf_lines:
                xsi.write_block(block.serialize())
            xsi.finalize(num_variants=variant_counter,
                         xcf_entries=entry_counter, max_ploidy=max_ploidy)
            var_writer.close()
            csi.write(var_path + ".csi",
                      n_ref=len(var_header.dict_contigs))
        except BaseException:
            block.shutdown()
            for f in (getattr(xsi, "f", None),
                      getattr(var_writer, "_f", None)):
                try:
                    if f is not None and not f.closed:
                        f.close()
                except OSError:
                    pass      # the exception in flight is the one to raise
            for path in (output_path, var_path, var_path + ".csi"):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            raise
        finally:
            block.shutdown()
        return {
            "entries": entry_counter,
            "variants": variant_counter,
            "n_samples": n_out,
            "xsi_bytes": os.path.getsize(output_path),
            "variant_bytes": os.path.getsize(var_path),
        }

    def iter_decoded_records(self):
        """Yields (variant_rec, gt) in file order, decoding whole blocks on
        the device.  Block k decodes on a worker thread while block k-1's
        records are emitted (one worker keeps the order)."""
        if not self._use_device():
            yield from super().iter_decoded_records()
            return

        def decode(block_id, recs):
            payload = self.xsi.gt_block_payload(block_id)
            return decode_block_records(
                payload, self.n_samples, self.n_haps, self.xsi.aet_dtype,
                [r.n_allele for r, _ in recs], [off for _, off in recs],
                device=self.torch_device)

        with ThreadPoolExecutor(max_workers=1) as executor:
            in_flight = None      # (records, Future[list[gt]])
            pending: list = []    # (rec, offset) of the current block
            pending_block = -1

            def flush():
                nonlocal in_flight, pending
                prev = in_flight
                in_flight = (pending, executor.submit(decode, pending_block,
                                                      pending))
                pending = []
                return prev

            for rec, bm in self.iter_variant_records():
                block_id = _block_of(bm)
                if block_id != pending_block:
                    if pending:
                        prev = flush()
                        if prev is not None:
                            yield from zip((r for r, _ in prev[0]),
                                           prev[1].result())
                    pending_block = block_id
                pending.append((rec, bm & _OFFSET_MASK))
            if pending:
                prev = flush()
                if prev is not None:
                    yield from zip((r for r, _ in prev[0]), prev[1].result())
            if in_flight is not None:
                yield from zip((r for r, _ in in_flight[0]),
                               in_flight[1].result())
