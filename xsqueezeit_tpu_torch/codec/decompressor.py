"""Decompression driver on the torch codec: .xsi + _var.bcf -> VCF/BCF.

Port of xsqueezeit_tpu/codec/decompressor.py.  The JAX package's
Decompressor (jax-free at import) keeps the variant walk, region/target
filters, sample subsetting and the writers; this subclass decodes whole
blocks with decoder_torch on the chosen device.  device="numpy" keeps the
host decoder.  Re-encoding to XSI (-O x) runs only with device="numpy" in
this slice.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

# before the container: it imports zstandard, which may be missing
from ..format import zstd_shim  # noqa: F401  isort: skip
from xsqueezeit_tpu.codec import decompressor as _base
from xsqueezeit_tpu.format.constants import BM_BLOCK_BITS

from ..utils.devprobe import torch_device
from .decoder_torch import LATER, decode_block_records

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

    def _recompress_options(self):
        opts = super()._recompress_options()
        opts.device = "numpy"   # the host encoder re-encodes (-O x)
        return opts

    def _decompress_to_xsi(self, output_path: str) -> dict:
        if self._use_device():
            raise NotImplementedError(
                f"-O x re-encoding on --device {self.opts.device} is "
                f"{LATER}; use --device numpy")
        return super()._decompress_to_xsi(output_path)

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
