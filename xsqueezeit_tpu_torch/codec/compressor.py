"""Streaming compression driver on the torch codec: VCF/BCF -> .xsi +
_var.bcf.

The port's copy of xsqueezeit_tpu/codec/compressor.py: the same record
loop, variant file, CSI index and container, so the files are byte-
identical to the JAX package's.  Each input record contributes (1) its
site columns + FORMAT/BM pointer to the variant BCF and (2) its genotype
matrix rows to the current GT block, flushed to the container every
`block_length` records.  Blocks encode with TorchBlockEncoder on the
chosen device; device="numpy" keeps the host encoder.  With more than one
device of that kind in the process (or a device list given in
`CompressorOptions.devices`), blocks batch over the pool
(parallel/shard.MeshBlockEncoder), as the JAX package's mesh batching
does.  The JAX package's native routes (batched BCF parse, native variant
pass, native block encoder) are not copied: the port's host code is
NumPy.

One deliberate fix over the reference, kept from the JAX package: the
sparse/arrangement index width (A_T) is keyed on N_HAPS everywhere.
"""
from __future__ import annotations

import functools
import os
import struct
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..format.constants import (
    BM_BLOCK_BITS,
    DEFAULT_BLOCK_LENGTH,
    DEFAULT_MAF,
    DEFAULT_ZSTD_LEVEL,
    PSEUDO_SAMPLE_NAME,
    XSI_BCF_VAR_EXTENSION,
    WeirdnessStrategy,
)
from ..format.container import XsiWriter
from ..format.header import XsiHeader
from ..io.bcf import BcfHeader, BcfWriter, patch_shared_sample_counts
from ..io.csi import CsiBuilder, depth_for_max_len
from ..io.sites import encode_bm_indiv
from ..io.unified import (
    GtInput,
    sniff_default_phased,
    sniff_max_ploidy_first_entry,
)
from ..utils.devprobe import torch_device
from .encoder_torch import TorchBlockEncoder
from .gt_block import GtBlockEncoder


@dataclass
class CompressorOptions:
    maf: float = DEFAULT_MAF
    block_length: int = DEFAULT_BLOCK_LENGTH
    zstd: bool = False
    zstd_level: int = DEFAULT_ZSTD_LEVEL
    wah_encode_missing: bool = False  # WS_WAH weirdness strategy
    verbose: bool = False
    device: str = "cuda"  # "cuda" | "cpu" | "numpy"
    #: The block pool: torch devices blocks spread over; None takes every
    #: local device of `device`'s kind (parallel/shard.local_mesh), or
    #: `device` alone.
    devices: tuple | None = None

    def __post_init__(self):
        if self.block_length < 1:
            raise ValueError(
                f"block_length must be >= 1, got {self.block_length}")


class BlockEncodeDispatcher:
    """Buffers one block of records and encodes it at flush time with
    `device_cls` (uniform and mixed-ploidy blocks) or the host
    GtBlockEncoder (no device class, or rows of other lengths).

    Device blocks batch through parallel/shard.MeshBlockEncoder over the
    device pool (_pool_devices), `batch_target` = one block per pool
    device at a time: single-process multi-device data parallelism, the
    generalised form of the reference's 2-thread split
    (xsqueezeit.cpp:120-148).  One device is a pool of one (batches of
    one block).  Payload bytes are the same whatever the pool; only
    wall-clock changes."""

    def __init__(self, n_samples, block_length, mac_threshold,
                 default_phasing, aet_dtype, weirdness_strategy, device_cls):
        self._kw = dict(
            n_samples=n_samples, block_bcf_lines=block_length,
            mac_threshold=mac_threshold, default_phasing=default_phasing,
            aet_dtype=aet_dtype, weirdness_strategy=weirdness_strategy)
        self.n_haps = n_samples * 2
        self.block_length = block_length
        self.device_cls = device_cls
        self.pending: list[tuple[np.ndarray, int]] = []
        self._executor = None
        self._mesh = None           # lazy: probed on the first device block
        self._mesh_encoder = None
        self._batch: list = []      # [(device encoder, Future)]
        self.batch_target = 1
        # Host-path block encodes run on a small worker pool (order is
        # preserved by the caller's future deque, not by worker count).
        # Device paths keep one worker (device dispatch serializes anyway).
        # Each in-flight block holds its records (~L x H x 4 B), so the
        # pool stays small.
        if device_cls is not None:
            self.encode_workers = 1
        else:
            self.encode_workers = max(1, int(os.environ.get(
                "XSI_ENCODE_THREADS", min(4, os.cpu_count() or 1))))

    @property
    def inflight_target(self) -> int:
        """Blocks allowed in flight before the driver blocks on the head
        future (bounds memory: one block's records is L x H x 4 bytes)."""
        return max(2 * self.batch_target, self.encode_workers + 1)

    @property
    def full(self) -> bool:
        return self.bcf_lines >= self.block_length

    @property
    def bcf_lines(self) -> int:
        return len(self.pending)

    def encode_record(self, gt: np.ndarray, n_alleles: int) -> None:
        self.pending.append((gt, n_alleles))

    def _device_eligible(self, records) -> bool:
        """Uniform blocks and mixed-ploidy blocks (haploid + diploid
        interleaved) take the device; anything else (ploidy > 2 is
        guarded upstream) stays on the NumPy encoder."""
        n_samples = self.n_haps // 2
        lengths = {g.shape[0] for g, _ in records}
        return (self.device_cls is not None and bool(lengths)
                and lengths <= {self.n_haps, n_samples})

    def _fill(self, cls, records):
        enc = cls(**self._kw)
        for gt, na in records:
            enc.encode_record(gt, na)
        return enc

    def _encode(self, records) -> bytes:
        cls = (self.device_cls if self._device_eligible(records)
               else GtBlockEncoder)
        return self._fill(cls, records).serialize()

    def serialize(self) -> bytes:
        records, self.pending = self.pending, []
        return self._encode(records)

    # ------------------------------------------------------- mesh batching
    def _pool_devices(self) -> list:
        """The device pool device blocks batch over (one device or more)."""
        raise NotImplementedError

    def _probe_mesh(self) -> list:
        """Resolve the device pool once, on the first device block."""
        if self._mesh is None:
            self._mesh = self._pool_devices()
            self.batch_target = len(self._mesh)
        return self._mesh

    def _dispatch_batch(self) -> None:
        batch, self._batch = self._batch, []
        if not batch:
            return

        def run():
            try:
                if self._mesh_encoder is None:
                    from ..parallel.shard import MeshBlockEncoder
                    self._mesh_encoder = MeshBlockEncoder(
                        self._mesh, self._kw["mac_threshold"])
                payloads = self._mesh_encoder.encode_batch(
                    [e for e, _ in batch])
                for (_, fut), p in zip(batch, payloads):
                    fut.set_result(p)
            except BaseException as exc:   # handed to the block futures
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)

        self._executor.submit(run)

    def flush(self) -> None:
        """Dispatch any partially-filled mesh batch (call before waiting
        on a pending future, or the tail blocks never resolve)."""
        self._dispatch_batch()

    def submit(self):
        """Encode the buffered block on a worker thread, so the caller can
        keep parsing input while the device works.  Returns a
        Future[bytes]; the caller's future deque preserves block order.
        Device blocks gather into batches of `batch_target` that encode
        over the device pool; host blocks encode on their own."""
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self.encode_workers)
        records, self.pending = self.pending, []
        if self._device_eligible(records):
            self._probe_mesh()
            fut = Future()
            # ingest here, beside the parse; the pool does the rest
            self._batch.append((self._fill(self.device_cls, records), fut))
            if len(self._batch) >= self.batch_target:
                self._dispatch_batch()
            return fut
        return self._executor.submit(self._encode, records)

    def shutdown(self) -> None:
        for _, fut in self._batch:
            if not fut.done():
                fut.cancel()
        self._batch = []
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None


class TorchEncodeDispatcher(BlockEncodeDispatcher):
    """BlockEncodeDispatcher whose device encoder is TorchBlockEncoder on
    `device` (None: the host encoder).  The device was chosen explicitly,
    so every block of ploidy 1 or 2, mixed ploidy included, takes it (no
    size threshold, no reachability probe).  `devices` is the block pool
    (None: every local device of `device`'s kind, or `device` alone)."""

    def __init__(self, n_samples, block_length, mac_threshold,
                 default_phasing, aet_dtype, weirdness_strategy,
                 device: torch.device | None, devices=None):
        super().__init__(
            n_samples, block_length, mac_threshold, default_phasing,
            aet_dtype, weirdness_strategy,
            device_cls=(None if device is None else
                        functools.partial(TorchBlockEncoder, device=device)))
        self.device = device
        self.devices = devices

    def _pool_devices(self) -> list:
        from ..parallel.shard import device_pool
        return device_pool(self.devices, self.device)


def make_variant_header(src: BcfHeader, xsi_basename: str) -> BcfHeader:
    """Header for the `_var.bcf` variant file: pseudo-sample + BM + ##XSI.

    The clone *shares* the source header's dictionaries so that shared blocks
    encoded against the source keep valid indices (records passed through
    verbatim reference the input header's FILTER/INFO/contig ids).
    """
    src.ensure_string("BM", '##FORMAT=<ID=BM,Number=1,Type=Integer,Description='
                            '"Position in GT Binary Matrix">')
    h = BcfHeader.from_text(src.to_text())
    h.samples = [PSEUDO_SAMPLE_NAME]
    h.lines.append(f"##XSI={xsi_basename}")
    # Share dictionary objects: any string auto-registered while encoding
    # records stays consistent between the two headers.
    h.dict_strings = src.dict_strings
    h.str2idx = src.str2idx
    h.dict_contigs = src.dict_contigs
    h.contig2idx = src.contig2idx
    return h


def compress_file(input_path: str, output_path: str,
                  opts: CompressorOptions | None = None) -> dict:
    """Compress `input_path` into `output_path` (+ `_var.bcf` + `.csi`).

    Returns summary stats.  The container is byte-identical to the JAX
    package's for the same options, whichever device encodes."""
    opts = opts or CompressorOptions()
    device = torch_device(opts.device)    # fails before any file is opened
    inp = GtInput(input_path)
    samples = inp.samples
    if not samples:
        raise ValueError(f"File {input_path} has no samples")
    n_samples = len(samples)

    default_phased = sniff_default_phased(input_path)
    max_ploidy = sniff_max_ploidy_first_entry(input_path)
    if max_ploidy == 0:
        raise ValueError(f"File {input_path} has no GT entries")

    n_haps = n_samples * 2  # A_T selection always assumes diploid
    aet_dtype = np.uint16 if n_haps <= 0xFFFF else np.uint32
    mac_threshold = int(n_haps * opts.maf)
    ws = (WeirdnessStrategy.WS_WAH if opts.wah_encode_missing
          else WeirdnessStrategy.WS_SPARSE)

    header = XsiHeader(
        version=5, ind_bytes=4, aet_bytes=np.dtype(aet_dtype).itemsize,
        wah_bytes=2, iota_ppa=True, no_sort=False,
        default_phased=bool(default_phased), ss_rate=opts.block_length,
        rare_threshold=mac_threshold)
    xsi = XsiWriter(output_path, header, samples,
                    zstd_on=opts.zstd, zstd_level=opts.zstd_level)
    var_path = output_path + XSI_BCF_VAR_EXTENSION
    var_header = make_variant_header(inp.header, os.path.basename(output_path))
    var_writer = BcfWriter(var_path, var_header)
    # reference parity: create_index_file, xcf.cpp:39-57; depth grows with
    # the longest declared contig so >537 Mbp coordinates stay addressable
    csi = CsiBuilder(depth=depth_for_max_len(
        max(var_header.contig_lengths.values(), default=0)))
    block = TorchEncodeDispatcher(
        n_samples, opts.block_length, mac_threshold,
        default_phasing=default_phased, aet_dtype=aet_dtype,
        weirdness_strategy=ws, device=device, devices=opts.devices)
    try:
        return _compress_loop(inp, opts, xsi, var_writer, var_header, csi,
                              block, var_path, output_path, max_ploidy)
    except BaseException:
        # A failed compression must not leak the encode worker thread or
        # leave half-written output behind.
        block.shutdown()
        for f in (getattr(xsi, "f", None), getattr(var_writer, "_f", None)):
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
        block.shutdown()  # successful runs must also release the worker
        inp.close()


def _compress_loop(inp, opts, xsi, var_writer, var_header, csi, block,
                   var_path, output_path, max_ploidy) -> dict:
    entry_counter = 0
    variant_counter = 0
    bm_block = 0
    bm_offset = 0
    seen_max_ploidy = max_ploidy
    pending_blocks: deque = deque()

    for rec in inp:
        if rec.gt is None:
            raise ValueError("Record without GT data cannot be compressed")
        if rec.ploidy > 2:
            raise ValueError("Ploidy higher than 2 is not yet supported")
        seen_max_ploidy = max(seen_max_ploidy, rec.ploidy)

        # variant file entry (BM = block << 15 | offset)
        if entry_counter and entry_counter % opts.block_length == 0:
            bm_block += 1
            bm_offset = 0
        if bm_offset >> BM_BLOCK_BITS:
            raise ValueError(
                f"BM offset cannot be represented on {BM_BLOCK_BITS} bits")
        bm = (bm_block << BM_BLOCK_BITS) | bm_offset
        shared = patch_shared_sample_counts(rec.shared, n_fmt=1, n_sample=1)
        vbeg, vend = var_writer.write_raw(shared, encode_bm_indiv(var_header, bm))
        rid, pos0, rlen = struct.unpack_from("<iii", shared, 0)
        csi.add(rid, pos0, pos0 + max(rlen, 1), vbeg, vend)

        # genotype block entry (pipelined: earlier blocks encode on a
        # worker thread while this loop parses the next block's records;
        # a device pool keeps up to one batch in flight on top)
        if block.full:
            pending_blocks.append(block.submit())
            while pending_blocks and pending_blocks[0].done():
                xsi.write_block(pending_blocks.popleft().result())
            # Bound in-flight memory.  Before a blocking wait, dispatch any
            # partially-filled batch: the head future could otherwise sit
            # in a batch that never fills.
            while len(pending_blocks) > block.inflight_target:
                if not pending_blocks[0].done():
                    block.flush()
                xsi.write_block(pending_blocks.popleft().result())
        block.encode_record(rec.gt, rec.n_alleles)

        n_alts = rec.n_alleles - 1
        bm_offset += n_alts
        variant_counter += n_alts
        entry_counter += 1
        if opts.verbose and entry_counter % 1000 == 0:
            print(f"Handled {entry_counter} VCF entries (lines)")

    if block.bcf_lines:          # the tail block joins the last batch
        pending_blocks.append(block.submit())
    block.flush()
    while pending_blocks:
        xsi.write_block(pending_blocks.popleft().result())
    xsi.finalize(num_variants=variant_counter, xcf_entries=entry_counter,
                 max_ploidy=seen_max_ploidy)
    if opts.verbose:
        sb = xsi.section_bytes
        print(f"Sections: header {sb['header']} B, blocks {sb['blocks']} B "
              f"({len(xsi.indices)} blocks), indices {sb['indices']} B, "
              f"samples {sb['samples']} B, total {sb['total']} B",
              file=__import__('sys').stderr)
    var_writer.close()
    csi.write(var_path + ".csi", n_ref=len(var_header.dict_contigs))

    return {
        "entries": entry_counter,
        "variants": variant_counter,
        "n_samples": len(inp.samples),
        "xsi_bytes": os.path.getsize(output_path),
        "variant_bytes": os.path.getsize(var_path),
    }
