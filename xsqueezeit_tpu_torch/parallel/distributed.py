"""Several processes over torch.distributed: multi-host compression and
extraction.

The port's counterpart of xsqueezeit_tpu/parallel/distributed.py.  The
reference is a single-process tool; here scale-out is first-class:
variant blocks are independent (the PBWT arrangement re-seeds to identity
at every block boundary), so

  * the input is partitioned into contiguous block ranges, one per worker
    (a process of a torch.distributed job, or a local emulated worker),
  * every worker encodes only its blocks (the torch codec on its device),
  * per-block compressed payloads gather to worker 0 IN ORIGINAL BLOCK
    ORDER, which assembles a container byte-identical to the
    single-process output, while the variant BCF + CSI are written from
    one streaming pass (or, for a BCF input, from per-rank segments).

Two drivers share the plan:

  * `compress_file_distributed`: N emulated workers in-process (threads);
    fast to test, validates partition/gather/assembly byte-identity.
  * `compress_file_multihost`: real separate processes (launch one per
    host or device with the same CLI arguments plus --distributed /
    --dist-nproc / --dist-procid, or call `init_distributed` yourself).
    The per-block payload bytes ride `gather_round_to_host0` (three
    all_gathers: counts, lengths, bytes padded to the global maximum;
    metadata first so every process pads to the same shape) and process 0
    assembles the container.

The JAX package's jax.distributed + multihost_utils.process_allgather
becomes torch.distributed with the gloo backend on CPU tensors: what
crosses between ranks is host bytes (serialized payloads, variant-file
segments, counts), and gloo, unlike NCCL, lets several ranks share one
card.  The host stages take the port's native library as the JAX
package's do: each rank parses its window in batches, the variant pass
(whole or per-rank segment) is native for a BCF input, and the host codec
(device="numpy") extracts its segment with the native extract loop.
XSI_NATIVE=0 takes the Python routes (`_var_segment` then renders its
window with BcfWriter, and the extract segment is
Decompressor._decompress_to_bcf over a block range).
"""
from __future__ import annotations

import contextlib
import io
import itertools
import os
import queue
import struct
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..codec.compressor import (
    CompressorOptions,
    TorchEncodeDispatcher,
    _gt_loop_batched,
    _native_var_pass_eligible,
    make_variant_header,
    variant_pass_native,
)
from ..format.constants import (
    BM_BLOCK_BITS,
    XSI_BCF_VAR_EXTENSION,
    WeirdnessStrategy,
)
from ..format.container import XsiWriter
from ..format.header import XsiHeader
from ..interop import native
from ..io.bcf import BcfWriter, patch_shared_sample_counts
from ..io.bgzf import BGZF_EOF
from ..io.csi import CsiBuilder, depth_for_max_len
from ..io.sites import encode_bm_indiv
from ..io.unified import (
    GtInput,
    count_entries_offsets,
    sniff_default_phased,
    sniff_max_ploidy_first_entry,
)
from ..utils.devprobe import torch_device

#: The overlapped gather of compress_file_multihost streams each rank's
#: payloads to rank 0 in at most this many rounds.
_GATHER_ROUNDS = 4


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the gloo process group at `coordinator` (HOST:PORT, rank 0's
    listening address) as rank `process_id` of `num_processes`; returns
    (rank, world size).  Without a coordinator: the group already
    joined, or (0, 1) when there is none.  A failed join raises."""
    import torch.distributed as dist

    if coordinator is None:
        return _world()
    if num_processes is None or process_id is None:
        raise ValueError("--distributed needs --dist-nproc and "
                         "--dist-procid")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--dist-procid {process_id} is outside "
                         f"0..{num_processes - 1}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes)
    return dist.get_rank(), dist.get_world_size()


@contextlib.contextmanager
def _process_group(coordinator, num_processes, process_id):
    """init_distributed for one driver call; the group it joined is
    destroyed on every way out."""
    import torch.distributed as dist

    joined = coordinator is not None
    try:
        yield init_distributed(coordinator, num_processes, process_id)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_layout(n_blocks: int, process_index: int | None = None,
                   process_count: int | None = None) -> tuple[int, int]:
    """Contiguous block range [start, end) owned by this process under the
    balanced plan (same plan the emulated path tests)."""
    rank, world = _world()
    if process_index is None:
        process_index = rank
    if process_count is None:
        process_count = world
    return plan_block_ranges(n_blocks, process_count)[process_index]


def _all_gather(arr: np.ndarray) -> np.ndarray:
    """all_gather of a 1-D host array of the same shape on every rank:
    [world, n]."""
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def gather_blocks_to_host0(payloads: list[bytes]) -> list[bytes] | None:
    """Ordered gather of per-block payload bytes onto process 0.

    Returns the global payload list in original block order on process 0
    (block ranges are contiguous and ascending by process), None
    elsewhere.  Single-process: identity."""
    if _world()[1] == 1:
        return list(payloads)
    parts = gather_round_to_host0(payloads)
    if parts is None:
        return None
    return [p for plist in parts for p in plist]


def gather_round_to_host0(payloads: list[bytes],
                          known_counts: "np.ndarray | None" = None
                          ) -> list[list[bytes]] | None:
    """One collective gather round: each process contributes its payload
    list; process 0 receives them grouped PER PROCESS (the overlapped
    round-wise gather needs the grouping to reassemble global block order
    across rounds), None elsewhere.

    Up to three all_gathers: (1) per-process block counts, SKIPPED when
    the caller passes `known_counts` (the overlapped gather's round
    structure is deterministic from the block plan), (2) per-block
    lengths padded to the global max count, (3) the concatenated payload
    bytes padded to the global max total, as uint8: metadata first
    because all_gather needs identical shapes on every process.
    """
    rank, world = _world()
    lens = np.asarray([len(p) for p in payloads], np.int64)
    if known_counts is not None:
        counts = np.asarray(known_counts, np.int64).reshape(-1)
        if counts[rank] != len(payloads):
            raise ValueError(f"rank {rank} holds {len(payloads)} payloads, "
                             f"the plan says {int(counts[rank])}")
    else:
        counts = _all_gather(np.asarray([len(payloads)], np.int64)
                             ).reshape(-1)
    # Pad to >= 1 so all_gather never sees a zero-sized tensor (a round
    # where every process contributes nothing would otherwise gather (0,)).
    cmax = max(int(counts.max()), 1)
    lens_pad = np.zeros(cmax, np.int64)
    lens_pad[:lens.shape[0]] = lens
    lens_all = _all_gather(lens_pad).reshape(world, cmax)
    tmax = max(int(lens_all.sum(axis=1).max()), 1)

    buf = np.zeros(tmax, np.uint8)
    if lens.size:
        local = np.frombuffer(b"".join(payloads), np.uint8)
        buf[:local.shape[0]] = local
    bufs = _all_gather(buf)

    if rank != 0:
        return None
    out: list[list[bytes]] = []
    for p in range(world):
        pos = 0
        plist: list[bytes] = []
        for b in range(int(counts[p])):
            n = int(lens_all[p, b])
            plist.append(bufs[p, pos:pos + n].tobytes())
            pos += n
        out.append(plist)
    return out


def plan_block_ranges(n_blocks: int, n_parts: int) -> list[tuple[int, int]]:
    """Contiguous block ranges [start, end) per worker, balanced to within
    one block.  Contiguity keeps each worker's input scan a single window."""
    base = n_blocks // n_parts
    extra = n_blocks % n_parts
    out = []
    start = 0
    for p in range(n_parts):
        size = base + (1 if p < extra else 0)
        out.append((start, start + size))
        start += size
    return out


def _encode_block_range(input_path: str, block_range: tuple[int, int],
                        n_samples: int, opts: CompressorOptions,
                        mac_threshold: int, default_phased: int,
                        aet_dtype, weirdness_strategy,
                        block_voffs=None, on_payload=None) -> list[bytes]:
    """Worker body: encode the records of blocks [start, end) of the input
    on opts.device.

    Streams the input, skipping records outside the window (block i covers
    records [i*block_length, (i+1)*block_length)).  With `block_voffs`
    (per-block virtual offsets from the count scan) the stream SEEKS to
    the window instead of reading the prefix.  `on_payload` is called
    with each block's payload as it completes, in block order (the
    overlapped gather feeds its rounds from this).
    """
    start_blk, end_blk = block_range
    if start_blk >= end_blk:
        return []
    lo = start_blk * opts.block_length
    hi = end_blk * opts.block_length
    disp = TorchEncodeDispatcher(
        n_samples, opts.block_length, mac_threshold,
        default_phasing=default_phased, aet_dtype=aet_dtype,
        weirdness_strategy=weirdness_strategy,
        device=torch_device(opts.device))
    payloads: list[bytes] = []

    def emit():
        p = disp.serialize()
        payloads.append(p)
        if on_payload is not None:
            on_payload(p)

    inp = GtInput(input_path)
    try:
        if block_voffs is not None and start_blk < len(block_voffs):
            inp.seek_fast(lo, int(block_voffs[start_blk]))
        else:
            inp.skip_records(lo)   # lazy: a window beyond EOF iterates empty
        batches = inp.iter_gt_batches(limit=hi - lo)
        if batches is not None:
            # the single-process batch loop with this worker's record
            # window (same segments and encoders: byte-identical)
            _gt_loop_batched(batches, disp, emit, max_records=hi - lo)
        else:
            for i, rec in enumerate(inp, start=lo):
                if i >= hi:
                    break
                if rec.gt is None:
                    raise ValueError("Record without GT data cannot be "
                                     "compressed")
                if disp.full:
                    emit()
                disp.encode_record(rec.gt, rec.n_alleles)
    finally:
        inp.close()
    if disp.bcf_lines:
        emit()
    return payloads


def _setup(input_path: str, opts: CompressorOptions):
    """Deterministic per-process setup (every process computes the same)."""
    inp = GtInput(input_path)
    samples = inp.samples
    if not samples:
        inp.close()
        raise ValueError(f"File {input_path} has no samples")
    n_samples = len(samples)
    default_phased = sniff_default_phased(input_path)
    sniffed_ploidy = sniff_max_ploidy_first_entry(input_path)
    if sniffed_ploidy == 0:
        inp.close()
        raise ValueError(f"File {input_path} has no GT entries")
    n_haps = n_samples * 2
    aet_dtype = np.uint16 if n_haps <= 0xFFFF else np.uint32
    mac_threshold = int(n_haps * opts.maf)
    ws = (WeirdnessStrategy.WS_WAH if opts.wah_encode_missing
          else WeirdnessStrategy.WS_SPARSE)
    return (inp, samples, n_samples, default_phased, sniffed_ploidy,
            aet_dtype, mac_threshold, ws)


def _xsi_writer(output_path, opts, samples, default_phased, aet_dtype,
                mac_threshold) -> XsiWriter:
    header = XsiHeader(
        version=5, ind_bytes=4, aet_bytes=np.dtype(aet_dtype).itemsize,
        wah_bytes=2, iota_ppa=True, no_sort=False,
        default_phased=bool(default_phased), ss_rate=opts.block_length,
        rare_threshold=mac_threshold)
    return XsiWriter(output_path, header, samples,
                     zstd_on=opts.zstd, zstd_level=opts.zstd_level)


def _write_var_records(records, writer, var_header, block_length: int,
                       first_entry: int, on_offsets) -> tuple[int, int, int]:
    """The variant-file body of `records` (iter_sites items) from global
    entry `first_entry` (a block boundary): BM = block << 15 | the ALT
    offset in its block, n_fmt/n_sample patched to the pseudo-sample.
    Calls on_offsets(rid, pos0, rlen, vbeg, vend) per record; returns
    (entries, variants, max ploidy)."""
    entries = variants = max_ploidy = 0
    bm_alt_offset = 0
    for rec in records:
        if rec.ploidy > 2:
            raise ValueError("Ploidy higher than 2 is not yet supported")
        bm_block, in_block = divmod(first_entry + entries, block_length)
        if in_block == 0:
            bm_alt_offset = 0
        if bm_alt_offset >> BM_BLOCK_BITS:
            raise ValueError(
                f"BM offset cannot be represented on {BM_BLOCK_BITS} bits")
        bm = (bm_block << BM_BLOCK_BITS) | bm_alt_offset
        shared = patch_shared_sample_counts(rec.shared, n_fmt=1, n_sample=1)
        vbeg, vend = writer.write_raw(shared,
                                      encode_bm_indiv(var_header, bm))
        rid, pos0, rlen = struct.unpack_from("<iii", shared, 0)
        on_offsets(rid, pos0, rlen, vbeg, vend)
        n_alts = rec.n_alleles - 1
        bm_alt_offset += n_alts
        variants += n_alts
        entries += 1
        max_ploidy = max(max_ploidy, rec.ploidy)
    return entries, variants, max_ploidy


def _var_segment(input_path: str, output_path: str, opts,
                 start_blk: int, end_blk: int, block_voffs,
                 write_header: bool):
    """One worker's window of the DISTRIBUTED variant pass: seek to the
    window's virtual offset and render its records into a BGZF body
    segment (rank 0 carries the header).  Returns (segment_bytes,
    (rid, pos, rlen, vbeg, vend, n_variants, max_ploidy), var_header),
    or None for VCF text (no offsets to seek to: the serial pass runs).
    BGZF members are self-contained, so segments concatenate into a
    valid BCF; vbeg/vend are segment-local and shift at assembly.  The
    window renders natively (var_pass.cpp xsi_var_pass_segment) unless
    XSI_NATIVE=0."""
    inp = GtInput(input_path)
    try:
        if inp.format != "bcf":
            return None
        var_header = make_variant_header(inp.header,
                                         os.path.basename(output_path))
        empty = ((np.zeros(0, np.int32),) * 3
                 + (np.zeros(0, np.uint64),) * 2 + (0, 0))
        if start_blk >= end_blk or start_blk >= len(block_voffs):
            return b"", empty, var_header
        if _native_var_pass_eligible(inp):
            return _native_var_segment(
                input_path, opts, start_blk, end_blk, block_voffs,
                write_header, var_header, 9 + inp._bcf.header_text_len)
        lo = start_blk * opts.block_length
        hi = end_blk * opts.block_length
        inp.seek_fast(lo, int(block_voffs[start_blk]))
        cols: list[tuple] = []
        buf = io.BytesIO()
        writer = BcfWriter(buf, var_header, write_header=write_header)
        _, nv, mp = _write_var_records(
            itertools.islice(inp.iter_sites(), hi - lo), writer,
            var_header, opts.block_length, lo, lambda *c: cols.append(c))
        writer.close(write_eof=False)
    finally:
        inp.close()
    arr = np.asarray(cols, np.int64).reshape(-1, 5)
    tup = (arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32),
           arr[:, 2].astype(np.int32), arr[:, 3].astype(np.uint64),
           arr[:, 4].astype(np.uint64), nv, mp)
    return buf.getvalue(), tup, var_header


def _native_var_segment(input_path, opts, start_blk, end_blk, block_voffs,
                        write_header, var_header, header_skip):
    """_var_segment's window through native_var_pass_segment."""
    text = var_header.to_text().encode() + b"\0"
    bm_prefix = encode_bm_indiv(var_header, 0)[:-4]
    gt_key = var_header.str2idx.get("GT", -1)
    max_recs = (end_blk - start_blk) * opts.block_length
    fd, seg = tempfile.mkstemp(suffix=".varseg")
    os.close(fd)
    try:
        rid, pos, rlen, _bm, vbeg, vend, nv, mp = \
            native.native_var_pass_segment(
                input_path, seg, text, 6, bm_prefix, opts.block_length,
                gt_key, 0 if start_blk == 0 else int(block_voffs[start_blk]),
                start_blk * opts.block_length, max_recs, write_header,
                header_skip=header_skip, cap_hint=max_recs + 1)
        with open(seg, "rb") as f:
            data = f.read()
    finally:
        os.remove(seg)
    return data, (rid, pos, rlen, vbeg, vend, nv, mp), var_header


def _assemble_var_segments(output_path: str, var_header, parts) -> tuple:
    """Process-0 assembly of the distributed variant pass: concatenate
    segment bytes (rank order = record order), append the BGZF EOF,
    shift each segment's voffsets by the bytes before it and build one
    CSI.  Returns (entries, variants, max_ploidy)."""
    var_path = output_path + XSI_BCF_VAR_EXTENSION
    base = 0
    cols: list = []
    entries = variants = 0
    max_ploidy = 0
    with open(var_path, "wb") as f:
        for data, tup in parts:
            f.write(data)
            rid, pos, rlen, vbeg, vend, nv, mp = tup
            shift = np.uint64(base) << np.uint64(16)
            cols.append((rid, pos, rlen, vbeg + shift, vend + shift))
            entries += rid.shape[0]
            variants += int(nv)
            max_ploidy = max(max_ploidy, int(mp))
            base += len(data)
        f.write(BGZF_EOF)
    rid = np.concatenate([c[0] for c in cols])
    pos = np.concatenate([c[1] for c in cols])
    rlen = np.concatenate([c[2] for c in cols])
    vbeg = np.concatenate([c[3] for c in cols])
    vend = np.concatenate([c[4] for c in cols])
    csi = CsiBuilder(depth=depth_for_max_len(
        max(var_header.contig_lengths.values(), default=0)))
    csi.add_many(rid, pos, pos.astype(np.int64) + np.maximum(rlen, 1),
                 vbeg, vend)
    csi.write(var_path + ".csi", n_ref=len(var_header.dict_contigs))
    return entries, variants, max_ploidy


def _pack_var_tuples(tup) -> bytes:
    rid, pos, rlen, vbeg, vend, nv, mp = tup
    buf = io.BytesIO()
    np.savez(buf, rid=rid, pos=pos, rlen=rlen, vbeg=vbeg, vend=vend,
             nv=nv, mp=mp)
    return buf.getvalue()


def _unpack_var_tuples(data: bytes):
    with np.load(io.BytesIO(data)) as z:
        return (z["rid"], z["pos"], z["rlen"], z["vbeg"], z["vend"],
                int(z["nv"]), int(z["mp"]))


def _variant_pass(inp, opts, output_path, sniffed_ploidy):
    """Streaming pass over the input: writes the `_var.bcf` + CSI and
    counts entries/variants (the worker-0 half of the pipeline).  The
    same gate, records, BM values and BGZF framing as compress_file's
    loop, so single- and multi-process variant files are byte-identical."""
    if _native_var_pass_eligible(inp):
        return variant_pass_native(inp, opts, output_path, sniffed_ploidy)
    var_path = output_path + XSI_BCF_VAR_EXTENSION
    var_header = make_variant_header(inp.header, os.path.basename(output_path))
    var_writer = BcfWriter(var_path, var_header)
    csi = CsiBuilder(depth=depth_for_max_len(
        max(var_header.contig_lengths.values(), default=0)))
    try:
        entries, variants, max_ploidy = _write_var_records(
            inp.iter_sites(), var_writer, var_header, opts.block_length, 0,
            lambda rid, pos0, rlen, vbeg, vend: csi.add(
                rid, pos0, pos0 + max(rlen, 1), vbeg, vend))
    finally:
        var_writer.close()
    csi.write(var_path + ".csi", n_ref=len(var_header.dict_contigs))
    return entries, variants, max(sniffed_ploidy, max_ploidy)


def compress_file_distributed(input_path: str, output_path: str,
                              opts: CompressorOptions | None = None,
                              n_parts: int = 4) -> dict:
    """Data-parallel compression over `n_parts` emulated workers.

    Produces output byte-identical to codec.compressor.compress_file: the
    block partition/ordered-gather/assembly logic is exactly the multi-host
    plan, with workers run on a thread pool instead of separate hosts.
    """
    opts = opts or CompressorOptions()
    torch_device(opts.device)          # fails before any file is opened
    (inp, samples, n_samples, default_phased, sniffed_ploidy,
     aet_dtype, mac_threshold, ws) = _setup(input_path, opts)
    try:
        xsi = _xsi_writer(output_path, opts, samples, default_phased,
                          aet_dtype, mac_threshold)
        entry_counter, variant_counter, max_ploidy = _variant_pass(
            inp, opts, output_path, sniffed_ploidy)
    finally:
        inp.close()

    # --- partition blocks, encode on workers, ordered gather --------------
    n_blocks = -(-entry_counter // opts.block_length)
    ranges = plan_block_ranges(n_blocks, n_parts)
    with ThreadPoolExecutor(max_workers=n_parts) as pool:
        futures = [
            pool.submit(_encode_block_range, input_path, r, n_samples, opts,
                        mac_threshold, default_phased, aet_dtype, ws)
            for r in ranges
        ]
        gathered = [f.result() for f in futures]

    for payloads in gathered:            # original block order
        for payload in payloads:
            xsi.write_block(payload)
    xsi.finalize(num_variants=variant_counter, xcf_entries=entry_counter,
                 max_ploidy=max_ploidy)

    return {
        "entries": entry_counter,
        "variants": variant_counter,
        "n_blocks": n_blocks,
        "n_parts": n_parts,
        "xsi_bytes": os.path.getsize(output_path),
    }


def kernel_launches() -> dict:
    """This process's kernel launches so far, by route (the wrappers'
    counters; the routes that launched)."""
    from ..ops import pbwt_kernels, wah_kernels
    return {k: v for c in (pbwt_kernels.launches, wah_kernels.launches)
            for k, v in c.items() if v}


def compress_file_multihost(input_path: str, output_path: str,
                            opts: CompressorOptions | None = None,
                            coordinator: str | None = None,
                            num_processes: int | None = None,
                            process_id: int | None = None,
                            perf: dict | None = None) -> dict | None:
    """Real multi-process data-parallel compression (torch.distributed,
    gloo).

    Every process must see `input_path`; only process 0 writes output.
    Launch one process per host (or device) with the same arguments plus
    the coordinator address and process id, e.g. via the CLI's
    --distributed flags.

    Plan:
      1. every process runs the same deterministic setup (phasing sniff,
         A_T selection, MAC threshold);
      2. every process takes the frame-walk entry count with per-block
         virtual offsets; the count is all-gathered and cross-checked
         (every process must have seen the same input);
      3. the variant file: for a BCF input with more than one process,
         each process renders its own record window into a BGZF segment
         on a thread and process 0 concatenates them (records equal to
         the serial pass, BGZF framing differing at the joins;
         XSI_DIST_VARPASS=0 restores the serial pass); otherwise process
         0 runs the serial pass on a thread, byte-identical to
         compress_file's;
      4. each process encodes its contiguous block range (process_layout)
         on opts.device while a thread gathers its finished payloads to
         process 0 in rounds;
      5. process 0 assembles the container in original block order,
         byte-identical to the single-process output.

    `perf`, when given, receives this process's seconds (setup, scan,
    encode, gather, assemble), payload sizes, gather rounds and its
    kernel launches.  Returns the summary dict on process 0, None on
    other processes.  A process that fails raises; its peers' collectives
    then fail too.
    """
    t0 = time.perf_counter()
    c0 = time.process_time()
    opts = opts or CompressorOptions()
    torch_device(opts.device)          # fails before the group is joined
    with _process_group(coordinator, num_processes, process_id) as (
            pidx, pcount):
        return _compress_multihost(input_path, output_path, opts, pidx,
                                   pcount, perf, t0, c0)


def _compress_multihost(input_path, output_path, opts, pidx, pcount, perf,
                        t0, c0):
    """compress_file_multihost's body, as rank `pidx` of `pcount`."""
    (inp, samples, n_samples, default_phased, sniffed_ploidy,
     aet_dtype, mac_threshold, ws) = _setup(input_path, opts)
    if perf is not None:
        perf["setup_s"] = time.perf_counter() - t0
        perf["setup_cpu_s"] = time.process_time() - c0

    xsi = None
    var_state: dict = {}
    var_thread = None
    gthread = None
    try:
        # Every process (including 0) takes the cheap frame-walk entry
        # count; process 0's variant pass runs on a background thread
        # overlapped with its encode share below.  Its results are only
        # needed at assembly.
        t0 = time.perf_counter()
        c0 = time.process_time()
        entry_counter, block_voffs = count_entries_offsets(
            input_path, opts.block_length)
        inp.close()
        if perf is not None:
            perf["scan_s"] = time.perf_counter() - t0
            perf["scan_cpu_s"] = time.process_time() - c0

        dist_var = (pcount > 1 and block_voffs is not None
                    and os.environ.get("XSI_DIST_VARPASS", "1")
                    not in ("0", "off", "no"))
        if pidx == 0:
            xsi = _xsi_writer(output_path, opts, samples, default_phased,
                              aet_dtype, mac_threshold)

        if pidx == 0 and not dist_var:
            def _run_variant_pass():
                tt0 = time.thread_time()
                vin = GtInput(input_path)
                try:
                    var_state["result"] = _variant_pass(
                        vin, opts, output_path, sniffed_ploidy)
                except BaseException as exc:   # surfaced at join below
                    var_state["error"] = exc
                finally:
                    vin.close()
                    var_state["cpu_s"] = time.thread_time() - tt0

            var_thread = threading.Thread(target=_run_variant_pass,
                                          name="xsi-variant-pass")
            var_thread.start()

        if pcount > 1:
            counts = _all_gather(np.asarray([entry_counter], np.int64)
                                 ).reshape(-1)
            if not (counts == counts[0]).all():
                raise RuntimeError(
                    "processes disagree on input entry count: "
                    f"{counts.tolist()}: every process must read the same "
                    "input file")

        t0 = time.perf_counter()
        c0 = time.thread_time()      # main thread only: variant-pass CPU
        n_blocks = -(-entry_counter // opts.block_length)   # is overlapped
        ranges = plan_block_ranges(n_blocks, pcount)
        start_blk, end_blk = ranges[pidx]

        if dist_var:
            def _run_var_segment():
                tt0 = time.thread_time()
                try:
                    var_state["segment"] = _var_segment(
                        input_path, output_path, opts, start_blk, end_blk,
                        block_voffs, write_header=(pidx == 0))
                except BaseException as exc:   # surfaced at join below
                    var_state["error"] = exc
                finally:
                    var_state["cpu_s"] = time.thread_time() - tt0

            var_thread = threading.Thread(target=_run_var_segment,
                                          name="xsi-var-segment")
            var_thread.start()

        # Overlapped gather: payload bytes stream to process 0 in bounded
        # ROUNDS on a separate thread while encode proceeds, so only the
        # tail round's communication sits on the critical path.  The round
        # count is agreed up front from the deterministic block plan:
        # every process issues the same collective sequence, rounds pacing
        # themselves by each process's own completed chunks: at most
        # _GATHER_ROUNDS rounds of `chunk` blocks.
        max_local = max(e - s for s, e in ranges)
        chunk = max(1, -(-max_local // _GATHER_ROUNDS))
        rounds = -(-max_local // chunk) if pcount > 1 else 0
        local_blocks = end_blk - start_blk
        gather_exc: list[BaseException] = []
        parts: list[list[bytes]] = [[] for _ in range(pcount)]
        payload_q: "queue.Queue[bytes]" = queue.Queue()
        gather_wait = [0.0]

        def gather_loop():
            try:
                for r in range(rounds):
                    need = max(min(chunk, local_blocks - r * chunk), 0)
                    batch = [payload_q.get() for _ in range(need)]
                    # per-round per-process counts are deterministic from
                    # the plan: skip that collective (one less round-trip)
                    kc = np.asarray(
                        [max(min(chunk, (e - s) - r * chunk), 0)
                         for s, e in ranges], np.int64)
                    tg = time.perf_counter()
                    res = gather_round_to_host0(batch, known_counts=kc)
                    gather_wait[0] += time.perf_counter() - tg
                    if pidx == 0:
                        for p in range(pcount):
                            parts[p].extend(res[p])
            except BaseException as exc:   # surfaced at join below
                gather_exc.append(exc)

        if rounds:
            # daemon: an encode failure starves the queue; the way out
            # must not block on a collective that can never complete
            gthread = threading.Thread(target=gather_loop, daemon=True,
                                       name="xsi-gather")
            gthread.start()
        payloads = _encode_block_range(
            input_path, (start_blk, end_blk), n_samples, opts,
            mac_threshold, default_phased, aet_dtype, ws,
            block_voffs=block_voffs,
            on_payload=(payload_q.put if rounds else None))
        if perf is not None:
            perf["encode_s"] = time.perf_counter() - t0
            perf["encode_cpu_s"] = time.thread_time() - c0
            perf["payload_bytes"] = sum(len(p) for p in payloads)
            perf["payload_lens"] = [len(p) for p in payloads]
            perf["n_local_blocks"] = len(payloads)
            perf["launches"] = kernel_launches()

        t0 = time.perf_counter()
        if gthread is not None:
            gthread.join()
            if gather_exc:
                raise RuntimeError(
                    "overlapped gather failed") from gather_exc[0]
            gathered = ([p for plist in parts for p in plist]
                        if pidx == 0 else None)
        else:
            gathered = gather_blocks_to_host0(payloads)
        if perf is not None:
            # gather_s: the RESIDUAL communication on the critical path
            # (time from local encode completion to gather completion);
            # gather_collective_s: total time inside collectives, mostly
            # hidden behind encode
            perf["gather_s"] = time.perf_counter() - t0
            perf["gather_rounds"] = rounds
            perf["gather_chunk"] = chunk
            perf["gather_collective_s"] = gather_wait[0]
        if dist_var:
            # one extra collective round carries the var segments + CSI
            # tuples (every process participates before rank gating)
            var_thread.join()
            if "error" in var_state:
                raise RuntimeError(
                    "variant pass failed") from var_state["error"]
            data, tup, var_header_l = var_state["segment"]
            res = gather_round_to_host0([data, _pack_var_tuples(tup)])
            if pidx == 0:
                vparts = [(plist[0], _unpack_var_tuples(plist[1]))
                          for plist in res]
                e_, v_, mp_ = _assemble_var_segments(
                    output_path, var_header_l, vparts)
                var_state["result"] = (e_, v_, max(mp_, sniffed_ploidy))
        if pidx != 0:
            return None

        if not dist_var:
            var_thread.join()
        if "error" in var_state:
            raise RuntimeError("variant pass failed") from var_state["error"]
        ventries, variant_counter, max_ploidy = var_state["result"]
        if ventries != entry_counter:
            raise RuntimeError(
                f"variant pass saw {ventries} entries, count saw "
                f"{entry_counter}: input changed mid-run?")
        if perf is not None:
            perf["varpass_cpu_s"] = var_state["cpu_s"]

        t0 = time.perf_counter()
        c0 = time.process_time()
        for payload in gathered:                 # original block order
            xsi.write_block(payload)
        xsi.finalize(num_variants=variant_counter, xcf_entries=entry_counter,
                     max_ploidy=max_ploidy)
        if perf is not None:
            perf["assemble_s"] = time.perf_counter() - t0
            perf["assemble_cpu_s"] = time.process_time() - c0
    except BaseException:
        # don't leave a truncated container/variant file behind on
        # process 0 (mirrors compress_file's failure cleanup)
        if pidx == 0:
            if var_thread is not None:
                var_thread.join()      # let it finish before unlinking
            if xsi is not None and not xsi.f.closed:
                xsi.f.close()
            var_path = output_path + XSI_BCF_VAR_EXTENSION
            for path in (output_path, var_path, var_path + ".csi"):
                with contextlib.suppress(OSError):
                    os.unlink(path)
        raise
    return {
        "entries": entry_counter,
        "variants": variant_counter,
        "n_samples": n_samples,
        "n_blocks": n_blocks,
        "n_processes": pcount,
        "xsi_bytes": os.path.getsize(output_path),
        "variant_bytes": os.path.getsize(
            output_path + XSI_BCF_VAR_EXTENSION),
    }


def _native_segment_bytes(d, start_blk: int, end_blk: int,
                          pidx: int) -> tuple[bytes, int] | None:
    """This worker's BCF body segment through the native extract loop
    (xsi_extract_segment: decode + frame + BGZF deflate in C), or None
    when the route is off (a torch device, a sample subset, filters,
    XSI_NATIVE=0): the Python driver then runs."""
    o = d.opts
    if (d.torch_device is not None or d._select is not None or o.regions
            or o.targets or not native.enabled()):
        return None
    header = d.output_header()
    gt_key = header.ensure_string(
        "GT", '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    text = header.to_text().encode() + b"\0"
    # seek straight to this worker's var.bcf window: one cheap native
    # frame walk captures per-block virtual offsets (the compress side's
    # trick), so workers skip zero prefix records
    chunks = None
    _, voffs = count_entries_offsets(d.var_path, d.xsi.header.ss_rate)
    if voffs is not None and start_blk < len(voffs):
        end_v = int(voffs[end_blk]) if end_blk < len(voffs) else 1 << 62
        chunks = [(int(voffs[start_blk]), end_v)]
    fd, seg_path = tempfile.mkstemp(suffix=".bcfseg")
    os.close(fd)
    try:
        n = native.native_extract_segment(
            d.xsi_path, seg_path, text, gt_key, 6, start_blk, end_blk,
            write_header=(pidx == 0), write_eof=False, chunks=chunks)
        with open(seg_path, "rb") as f:
            return f.read(), n
    finally:
        os.remove(seg_path)


def decompress_file_multihost(xsi_path: str, output_path: str,
                              opts=None,
                              coordinator: str | None = None,
                              num_processes: int | None = None,
                              process_id: int | None = None,
                              perf: dict | None = None) -> dict | None:
    """Multi-process decompression to BCF.

    Blocks are independently decodable, so each process decodes its
    contiguous block range on opts.device and emits a records-only BGZF
    body segment; BGZF members concatenate cleanly, so process 0 writes
    [header segment][body 0]...[body N-1][EOF]: a valid BCF with the
    records in original order.  Output equals the single-process
    extraction record for record (BGZF block boundaries differ at segment
    joins, so bytes are not identical; contents are).  The host codec
    (device="numpy") extracts its segment with the native extract loop
    (_native_segment_bytes) unless XSI_NATIVE=0.

    Only -O b output is supported multi-host.  `perf`, when given,
    receives this process's decode and gather seconds, its segment size
    and its kernel launches.  Returns the summary dict on process 0, None
    elsewhere.
    """
    from ..codec.decompressor import Decompressor, DecompressorOptions

    opts = opts or DecompressorOptions()
    if opts.output_type not in ("b",):
        raise ValueError("multi-host decompression supports -O b output")
    with _process_group(coordinator, num_processes, process_id) as (
            pidx, pcount):
        t0 = time.perf_counter()
        d = Decompressor(xsi_path, opts)
        n_blocks = d.xsi.n_blocks()
        start_blk, end_blk = process_layout(max(n_blocks, 1), pidx, pcount)
        d.opts.block_range = (start_blk, end_blk)
        native_seg = _native_segment_bytes(d, start_blk, end_blk, pidx)
        if native_seg is not None:
            data, n_rec = native_seg
            stats = d._emit_stats(n_rec)
        else:
            body = io.BytesIO()
            stats = d._decompress_to_bcf(body, write_header=(pidx == 0),
                                         write_eof=False)
            data = body.getvalue()
            del body
        if perf is not None:
            perf["decode_s"] = time.perf_counter() - t0
            perf["segment_bytes"] = len(data)
            perf["n_local_blocks"] = end_blk - start_blk
            perf["launches"] = kernel_launches()
        t0 = time.perf_counter()
        # Gather in bounded ROUNDS: one 256 MB piece per process per round
        # (piece k of every process), streamed straight to per-process
        # spill files on process 0 and concatenated in process order:
        # peak memory stays at P x 256 MB however large the bodies are.
        chunk = 1 << 28
        n_pieces = max(-(-len(data) // chunk), 1)
        rounds = (int(_all_gather(np.asarray([n_pieces], np.int64)).max())
                  if pcount > 1 else n_pieces)
        spool = []
        try:
            if pidx == 0:
                spool = [tempfile.TemporaryFile() for _ in range(pcount)]
            for k in range(rounds):
                piece = data[k * chunk:(k + 1) * chunk]
                segs = gather_blocks_to_host0([piece])
                if pidx == 0:
                    for p, seg in enumerate(segs):
                        spool[p].write(seg)
            # total record count across processes (stats above covers
            # only this process's block range)
            totals = (_all_gather(np.asarray([stats["records"]], np.int64))
                      .reshape(-1) if pcount > 1
                      else np.asarray([stats["records"]]))
            if perf is not None:
                perf["gather_s"] = time.perf_counter() - t0
                perf["gather_rounds"] = rounds
            if pidx != 0:
                return None
            with open(output_path, "wb") as f:
                for p in range(pcount):
                    spool[p].seek(0)
                    while True:
                        buf = spool[p].read(1 << 24)
                        if not buf:
                            break
                        f.write(buf)
                f.write(BGZF_EOF)
        finally:
            for s in spool:
                s.close()
    stats["records"] = int(totals.sum())
    stats["n_blocks"] = n_blocks
    stats["n_processes"] = pcount
    return stats
