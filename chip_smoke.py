#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (xsqueezeit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths through their entry points and checks every result
exactly:

1. machine facts (card, power limit, torch/CUDA/nvcc versions);
2. builds the kernels from xsqueezeit_tpu_torch/csrc with nvcc (one
   process per source, side by side);
3. each kernel route against its plain PyTorch version on the card,
   bit-exact, with both times and the bound (the bytes each must move
   over the card's memory rate): the one-CTA chains and the WAH kernels at
   1KGP3 shapes, the cluster chains at HRC width (H = 64,976; the encode
   in shared memory, the decode with its rows in device memory) and
   forced at H = 5008 (also against the one-CTA route), both chains on 16
   CTAs at the format's widest panel (491,505 haplotypes; the decode with
   its wide state (slot << 13) | beta), the encode with the parity
   payload (chunks of 15 lines, bit 15 the slot parity) on one CTA at the
   chrX PAR block's chunks, on 8 CTAs at H = 97,256 and on 16 at 491,504,
   the decode at one CTA's widest
   row (28,928) on one CTA and on 16, the WAH kernels at HRC
   width (w = 4332), the per-line-width expand at the widths of a chrX
   PAR block (w = 165 and 83, lines alternating in runs), the WAH routes
   above the chains' 16-bit slot field, a CTA per line, at TOPMed width
   (w = 12,968) and at the format's widest line (w = 32,767); every WAH
   route twice, as the int32-group contract of the TPU kernels and as the bits
   route the codec calls (unpack_bits / pack_bits fused in), and the
   expands with a warp and with a CTA per line; after the 1KGP3, HRC and
   chrX PAR blocks below, the chains and the WAH routes again at the
   block's own shapes,
   registers, sort flags, bit grids and streams (1KGP3: 301 chunks; HRC:
   325 chunks, on the default and the other cluster sizes); the PBWT device
   scans against their plain versions: the rank chain (csrc/rank_chain.cu,
   also against its log-depth form rank_chain_levels_plain, timed as a
   yardstick) at 1KGP3 (301 chunks x 5008, 16-bit totals), the chrX PAR
   mixed encode's (305 x 2466, 15-bit), H = 1, 2 and 16,384 (rows in
   shared memory), and H = 16,385, HRC (325 x 64,976), 65,536 and TOPMed
   (395 x 194,512, 13-bit; rows through device memory, 32-bit ranks above
   65,535), and the mixed decode scan (csrc/pbwt_scan.cu): its stepping
   kernel from a permuted start arrangement, and its run route
   (pbwt_torch.pbwt_decode_scan_mixed) against the stepping plain version
   and timed beside the stepping kernel forced over the same lines, at
   chrX PAR width (4573 lines in runs of 64 of each ploidy and in the PAR
   layout, diploid lines then haploid ones; 1024 alternating, all
   haploid, all diploid), at HRC width (512 lines, the stepping state
   in device memory) and at TOPMed width (512 lines in runs, both
   ploidies above 65,535 slots: the wide state and the run flush on a
   cluster a chunk), the run flush at the PAR layout's, HRC's and
   TOPMed's runs,
   and a sweep of run lengths with every run on the chains against the
   stepping kernel (the crossover behind pbwt_torch.MIN_RUN_LINES); after
   each block the rank chain again at the block's own totals, and after
   each mixed block the parity encode chain, the run route and the run
   flush at its own registers and lines (and at chrX PAR the stepping
   kernel);
4. the 1KGP3 block (2504 samples = 5008 haplotypes x 8192 lines, MAF
   threshold 10, the rare-heavy mix of bench.py), the HRC block (32,488
   samples = 64,976 haplotypes x 8192 lines, MAF threshold 64, the same
   mix) and the TOPMed block (97,256 samples = 194,512 haplotypes, MAF
   threshold 194, the same mix; 32-bit sparse and track streams, the
   encode chain on 8 CTAs, the decode chain on 16 with its rows in device
   memory, its state (slot << 14) | beta in chunks of 14 lines, the run
   flush on a cluster of 8 CTAs a chunk; each PBWT route also timed
   alone): TorchBlockEncoder's payload must be byte-equal to the host
   GtBlockEncoder's and decode_block_records bit-exact on every
   line;
   every launch counter is set to 0 just before each block's run and read
   just after, and each kernel route of that path must have launched
   (and no other); while it runs, wah_torch's plain pack_bits,
   unpack_bits and wah_word_offsets, pbwt_kernels' plain rank chain,
   stepping scan, chain decode and run flush, and the plain sparse-line
   fill raise (every block, TOPMed's included).  The decode's
   run flush as the path calls it (each WAH row at its line of the
   block's plane) and the sparse-line kernel are held against their plain
   versions at each block's own inputs and timed.
   Prints ms/block and
   GB/s in bench.py's unit (L * H * 4 logical gt bytes), the compression
   ratio, the device part of the decode alone, and the peak device memory
   of encode and decode;
5. the exception-track and mixed-ploidy blocks, checked the same way:
   1KGP3-missing (the 1KGP3 block with 1 % of entries missing, as
   bench.py's missing regime: every record carries a missing track),
   1KGP3-chrX (the 1233 male samples hold end-of-vector in their second
   slot on every record), chrX-males-PAR (the 1233 males only, 4096
   diploid PAR lines then 4096 haploid ones: a mixed-ploidy block, encoded
   on the chain with the parity payload and decoded without offsets; its
   two runs of WAH lines on the chains and the run flush, no stepping
   launch) and TOPMed-males-PAR (the same layout at 48,628 males, H =
   97,256, MAF 0.001, 32-bit streams: the parity encode on 8 CTAs, both
   runs on the decode's rows route, the diploid run's flush on a cluster
   a chunk).  The track blocks also hold the fused decode
   (_decode_block_full_gt_tracks) against the input;
6. the file level: a synthetic 1KGP3-width BCF of two blocks through
   `cli -c --device cuda` and `--device numpy` (byte-identical .xsi) and
   `cli -x --device cuda` back to BCF (the input's genotypes on every
   record); then the same with 1 % of entries missing, plus `cli -x -O x`
   on `cuda` and `numpy` (byte-identical re-encoded .xsi); then the
   latter at TOPMed width (97,256 samples x 512 records, one block);
7. the random-access API and the tool suite (tools_phase): the 1KGP3-width
   file through the Accessor (48 records in a random order), Xcf,
   loading_time, af_stats, lockstep and dot_prod on the host, and dot_prod
   on the card (whole blocks decoded by wah_expand_bits and chain_decode,
   one product per block, held per variant against the host walk), also
   on a uniformly haploid chrX file;
8. scale-out (scale_phase) on the file phase's 1KGP3-width BCF, its
   single-process `-c --device cuda` and `-x` outputs the reference:
   compress_file and the extract in this process over the device pool
   [cuda:0, cuda:0] (two worker threads sharing the card), on [cuda:0]
   alone and over the pool of two devices [cuda:0, cpu] (.xsi byte-equal,
   records equal, launches counted); two ranks of `cli -c --distributed`
   (gloo on localhost, both on the card: .xsi byte-equal, _var.bcf
   records equal) and of `cli -x -O b --distributed` (records equal),
   each rank's perf and kernel launches read from its -v line; and
   `python -m xsqueezeit_tpu_torch.bench scaling --procs 1,2` at a small
   size, its line printed;
9. the port's headline benchmark, `python -m
   xsqueezeit_tpu_torch.bench.headline` in its own process (bench.py's
   workload and keys, its own bit-exact checks): exit 0 and its JSON
   line required, the line printed;
10. the native host library (native_build_phase after the kernels' build,
   native_phase after the file phases): g++'s version, whether zlib.h,
   zstd.h and libdeflate.h and libz.so.1 are there, both libraries built
   from xsqueezeit_tpu_torch/native (forced) and their seconds; then on
   the file phase's input `cli -c --device cuda` with the native routes,
   with XSI_NATIVE=0 and on `--device numpy` (.xsi, _var.bcf, .csi
   byte-equal; chain_encode and wah_compress_bits once per block on both
   cuda runs), `cli -x` on cuda to VCF and on numpy to BCF (the input's
   genotypes), a block's host ingest and the 1KGP3-chrX block's host
   parse with the native routes and without (carriers and records equal),
   c_api_test and c_xcf_test built with gcc against the port's libraries
   (their genotypes the Accessor's), and `loading_time --native`;
11. corrupt containers (corrupt_phase, after the native phase): 42 corrupt
   copies of containers written on the card (a stored index past its
   line's width in the sparse, missing, EOV and haploid streams, WAH
   streams cut short or with a counter past its line, byte flips, and the
   file-wide phase's TOPMed-width container) through `cli -x --device
   cuda` in this process, each exit 0 or 1 with one error line and a good
   container extracted bit-exact after each (the CUDA context alive);
   the decode kernels on corrupt streams against their plain versions;
   and the native library built with ASan and UBSan on this machine,
   its fuzz_accessor clean over those containers, 20 truncations and 20
   flips.

Any failure exits non-zero; the last line of standard output is the result
JSON, the line before it the card's name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from xsqueezeit_tpu_torch.bench.synth import synth_bcf
from xsqueezeit_tpu_torch.codec import decoder_torch, encoder_torch
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.format.constants import INT32_VECTOR_END
from xsqueezeit_tpu_torch.io.bcf import BcfHeader, BcfWriter
from xsqueezeit_tpu_torch.io.sites import (
    encode_gt_indiv,
    encode_shared_from_vcf_cols,
)
from xsqueezeit_tpu_torch.io.unified import GtInput
from xsqueezeit_tpu_torch.ops import _build, pbwt_kernels, pbwt_torch
from xsqueezeit_tpu_torch.ops import (product_kernels, sparse_kernels,
                                      wah_kernels, wah_torch)

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
L = 8192                              # lines per block, the XSI default
SEED = 20
#: (name, samples, seed of the block); MAF 0.001 sets the MAC threshold.
#: TOPMed: the TOPMed r2 imputation reference panel's 97,256 samples,
#: above the chunk chains' 16-bit slot field (65,535 haplotypes).
BLOCKS = (("1KGP3", 2504, SEED), ("HRC", 32488, SEED + 1),
          ("TOPMed", 97256, SEED + 3))
HRC_H = 2 * 32488
TOPMED_SAMPLES = 97256
#: Male samples of the 1KGP3 panel: haploid on chrX outside the PARs.
MALES = 1233
#: Male samples of a TOPMed-size panel (half of its 97,256).
TOPMED_MALES = TOPMED_SAMPLES // 2
#: Exception-track blocks at 1KGP3 width (the 1KGP3 block's alleles).
TRACK_BLOCKS = ("1KGP3-missing", "1KGP3-chrX")
TRACK_PAYLOADS: dict = {}  # name -> (payload, samples): track_block_phase
MIXED_BLOCK = "chrX-males-PAR"
WIDE_MIXED_BLOCK = "TOPMed-males-PAR"
#: The mixed-ploidy blocks: (name, male samples, seed of the block).
MIXED_BLOCKS = ((MIXED_BLOCK, MALES, SEED + 2),
                (WIDE_MIXED_BLOCK, TOPMED_MALES, SEED + 4))
ONE_CTA = ("chain_encode", "chain_decode", "wah_expand_bits",
           "wah_compress_bits", "rank_chain", "decode_run_flush",
           "sparse_lines")
#: Kernel routes each block's path must launch (the others must not: the
#: int32-group WAH routes are the TPU kernels' contract, held and timed
#: against their plain versions, but the codec calls the bits routes).
PATH_KERNELS = {
    "1KGP3": ONE_CTA,
    # the encode on 8 CTAs' shared memory, the decode on 16 CTAs with its
    # rows in device memory
    "HRC": ("chain_encode_cluster", "chain_decode_rows",
            "wah_expand_bits", "wah_compress_bits", "rank_chain",
            "decode_run_flush", "sparse_lines"),
    # above 65,535 haplotypes: the same chains, the decode's wide state,
    # the run flush on a cluster a chunk
    "TOPMed": ("chain_encode_cluster", "chain_decode_rows",
               "decode_run_flush_cluster", "wah_expand_bits",
               "wah_compress_bits", "rank_chain", "sparse_lines"),
    "1KGP3-missing": ONE_CTA,
    "1KGP3-chrX": ONE_CTA,
    # the encode on the chain with the parity payload; the mixed scan's
    # run route: both runs on the chains and the run flush, no stepping
    # launch (the decode keeps no final arrangement, so the haploid run's
    # rank chain is skipped: the encode launches it)
    MIXED_BLOCK: ("chain_encode_parity", "wah_compress_bits",
                  "wah_expand_varw_bits", "rank_chain", "chain_decode",
                  "decode_run_flush", "sparse_lines"),
    # the same at 97,256 haplotypes: the parity encode on 8 CTAs, both
    # runs (97,256 and 48,628 slots) on the decode's rows route, the
    # diploid run's flush on a cluster a chunk, the haploid one's on one
    # CTA
    WIDE_MIXED_BLOCK: ("chain_encode_parity_cluster", "rank_chain",
                       "wah_compress_bits", "wah_expand_varw_bits",
                       "chain_decode_rows", "decode_run_flush_cluster",
                       "decode_run_flush", "sparse_lines"),
}
#: Plain passes that must not run on a block's card path (they are
#: replaced by functions that raise while it runs), by module: the mixed
#: scan's run route on the CPU is its pieces' plain versions (the chains,
#: the run flush, the rank chain, the stepping scan).
PLAIN_PASSES = ((wah_torch, ("pack_bits", "unpack_bits", "wah_word_offsets")),
                (pbwt_kernels, ("rank_chain_plain", "decode_scan_mixed_plain",
                                "chain_decode_plain",
                                "decode_run_flush_plain")),
                (sparse_kernels, ("sparse_lines_plain",)),
                (product_kernels, ("dot_rows_plain",)))
#: The plain passes a block's path takes by design: none (the rank chain
#: and the chains run their kernels at every width).
PLAIN_ROUTES: dict = {}
#: Kernel-check shapes: 1KGP3 and HRC widths.
KERNEL_SHAPES = dict(H=5008, C=16, n_ch=256, n_lines=4096)
HRC_SHAPES = dict(H=HRC_H, C=16, n_ch=64, n_lines=4096)
#: Chain checks at the edges of the routes: (kernel, width, chunks, lines
#: a chunk, CTAs or None for the default): both chains on 16 CTAs at the
#: format's widest panel (the decode with its wide state's shift), and the
#: decode at one CTA's widest row on one CTA and on its cluster route
#: (rows in device memory), the two routes side by side where one hands
#: over to the other.
WIDE_CHAINS = (("chain_encode", pbwt_kernels.MAX_RANK_H, 32, 16, None),
               ("chain_decode", pbwt_kernels.MAX_RANK_H, 32,
                pbwt_kernels.decode_chunk(pbwt_kernels.MAX_RANK_H), None),
               ("chain_decode", pbwt_kernels.MAX_H_DECODE, 64, 16, None),
               ("chain_decode", pbwt_kernels.MAX_H_DECODE, 64, 16,
                pbwt_kernels.MAX_CLUSTER))
#: The chain routes the HRC-width kernel checks hold (the rest at 1KGP3).
CLUSTER_ROUTES = ("chain_encode_cluster", "chain_decode_rows")
#: The encode with the parity payload (chunks of 15 lines, bit 15 of the
#: registers set at random) on each route: (label, width, chunks, CTAs or
#: None for the default): one CTA at the chrX PAR block's chunks, 8 CTAs
#: at the TOPMed males' width, 16 at the widest even width.
PARITY_CHAINS = (("chrX-PAR chunks", 2 * MALES, 305, None),
                 ("TOPMed-males width", 2 * TOPMED_MALES, 64, None),
                 ("H=491504", 491504, 32, None))
#: WAH kernel checks above the 16-bit slot field, where only a CTA per line
#: fits: TOPMed width (w = 12,968) and the format's widest line (w =
#: 32,767 groups).
WIDE_WAH = (("TOPMed", dict(H=2 * TOPMED_SAMPLES, n_lines=384)),
            ("widest", dict(H=15 * 32767, n_lines=256)))
#: The file-level phases: 1KGP3 width, two blocks; TOPMed width, one.
FILE_SAMPLES, FILE_RECORDS = 2504, 2 * L
WIDE_FILE_RECORDS = 512

SRC = "xsqueezeit_tpu_torch/csrc/"
PALLAS = "xsqueezeit_tpu/ops/"
ROUTES = {  # name -> (source, TPU kernel it replaces)
    "chain_encode": ("pbwt_chain.cu", "pbwt_pallas.py:133"),
    "chain_decode": ("pbwt_chain.cu", "pbwt_pallas.py:76"),
    "wah_expand": ("wah.cu", "wah_pallas.py:51"),
    "wah_compress": ("wah.cu", "wah_pallas.py:112"),
    "chain_encode_cluster": ("pbwt_chain.cu", "pbwt_pallas.py:133"),
    "chain_decode_rows": ("pbwt_chain.cu", "pbwt_pallas.py:76"),
    # the encode chain with the parity payload: the mixed encode's route in
    # place of the XLA parity scan (its packed keys' row sort)
    "chain_encode_parity": ("pbwt_chain.cu", "pbwt_jax.py:80"),
    "chain_encode_parity_cluster": ("pbwt_chain.cu", "pbwt_jax.py:80"),
    # an XLA function in the JAX package (no Pallas kernel there)
    "wah_expand_varw": ("wah.cu", "wah_jax.py:227"),
    # the same kernels with unpack_bits / pack_bits fused in
    "wah_expand_bits": ("wah.cu", "wah_pallas.py:51"),
    "wah_compress_bits": ("wah.cu", "wah_pallas.py:112"),
    "wah_expand_varw_bits": ("wah.cu", "wah_jax.py:227"),
    # XLA scans of the JAX package, Python-stepped loops before this port
    "rank_chain": ("rank_chain.cu", "pbwt_jax.py:213"),
    "decode_scan_mixed": ("pbwt_scan.cu", "pbwt_jax.py:564"),
    # the mixed scan's run route's own kernel (with chain_decode and the
    # rank chain in the route)
    "decode_run_flush": ("pbwt_scan.cu", "pbwt_jax.py:564"),
    # the same above 65,535 slots, a cluster a chunk: the uniform decode's
    # flush there takes the blocked decode's place (pbwt_jax.py:456)
    "decode_run_flush_cluster": ("pbwt_scan.cu", "pbwt_jax.py:456"),
    # XLA glue of the JAX decoder (a zeros plane, the carriers' scatter, a
    # where and an XOR over the block's plane), not a Pallas kernel
    "sparse_lines": ("sparse_lines.cu",
                     "xsqueezeit_tpu/codec/decoder_jax.py:58"),
    # the dot_prod tool's product, jitted XLA in the JAX package (no Pallas
    # kernel there)
    "dot_rows": ("dot_rows.cu", "xsqueezeit_tpu/bench/tools.py:171"),
}


#: Memory rate of an H100 SXM (NVIDIA's data sheet), bytes per second.  No
#: kernel here does tensor-core or float work: each one's bound is the
#: bytes it must move (each input read once, each output written once).
HBM_BYTES_PER_S = 3.35e12


def _expand_kernels(varw: bool, bits: bool) -> tuple:
    v, b = ("true" if varw else "false"), ("true" if bits else "false")
    return (("wah_span_scan_kernel",),
            (f"wah_expand_kernel<{v}, {b}",
             f"wah_expand_kernelILb{int(varw)}ELb{int(bits)}E"))


#: The CUDA kernels each route launches once per call, as the profiler
#: names them (demangled or not), to find their device time among the
#: profiler's events.  An expand route is the span scan plus the expand
#: (and a memset of the scan's tile flags, not counted).
KERNEL_NAMES = {
    "chain_encode": (("chain_kernel<false, false, false>",
                      "chain_kernelILb0ELb0ELb0E"),),
    "chain_decode": (("chain_kernel<true, false, false>",
                      "chain_kernelILb1ELb0ELb0E"),),
    "chain_encode_cluster": (("chain_kernel<false, true, false>",
                              "chain_kernelILb0ELb1ELb0E"),),
    "chain_decode_rows": (("chain_kernel<true, true, false>",
                           "chain_kernelILb1ELb1ELb0E"),),
    "chain_encode_parity": (("chain_kernel<false, false, true>",
                             "chain_kernelILb0ELb0ELb1E"),),
    "chain_encode_parity_cluster": (("chain_kernel<false, true, true>",
                                     "chain_kernelILb0ELb1ELb1E"),),
    "wah_expand": _expand_kernels(False, False),
    "wah_expand_varw": _expand_kernels(True, False),
    "wah_expand_bits": _expand_kernels(False, True),
    "wah_expand_varw_bits": _expand_kernels(True, True),
    "wah_compress": (("wah_compress_kernel<false>",
                      "wah_compress_kernelILb0E"),),
    "wah_compress_bits": (("wah_compress_kernel<true>",
                           "wah_compress_kernelILb1E"),),
    # the rank chain's kernels (csrc/rank_chain.cu): several launches a
    # call, their count following the chunks and the route (MULTI_LAUNCH)
    "rank_chain": (("rank_",),),
    "decode_scan_mixed": (("decode_scan_mixed_kernel",),),
    # the run flush's composition levels and the flush itself: several
    # launches a call, their count following the chunks (MULTI_LAUNCH)
    "decode_run_flush": (("compose_level_kernel", "decode_run_flush_kernel"),),
    "decode_run_flush_cluster": (("compose_level_kernel",
                                  "decode_run_flush_cluster_kernel"),),
    # the sparse lines' fill, then their carriers: two launches a call
    "sparse_lines": (("sparse_line_fill_kernel", "sparse_carrier_kernel"),),
    # the partial sums, then (more than one tile a row) their sum; each
    # timed by the launches the profiler recorded, as it misses some
    "dot_rows": (("dot_rows_kernel",), ("dot_rows_sum_kernel",)),
}


#: Routes whose call launches its kernels several times (KERNEL_NAMES then
#: names their common prefix): their device time is summed over a call and
#: their launches per call printed.
MULTI_LAUNCH = {"rank_chain", "decode_run_flush", "decode_run_flush_cluster",
                "sparse_lines"}


def kernel_device_ms(route: str, fn, iters: int = 10) -> float | None:
    """Device milliseconds per call of the route's own kernels alone (no
    wrapper, no host launch cost, none of the wrapper's torch ops), from
    torch.profiler's CUDA events; None where the profiler records none of
    a kernel's launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    parts = []
    for names in KERNEL_NAMES[route]:
        events = [e for e in averages if any(n in e.key for n in names)]
        count = sum(e.count for e in events)
        total_us = sum(e.device_time_total for e in events)
        if route in MULTI_LAUNCH:
            by_kernel = ", ".join(
                f"{re.search(r'rank_\w+|\w+_kernel', e.key).group(0)} "
                f"{e.device_time_total / iters / 1e3:.3f} ms "
                f"({e.count / iters:g}x)"
                for e in sorted(events, key=lambda e: -e.device_time_total))
            print(f"{route}: {count / iters:g} kernel launches a call: "
                  f"{by_kernel}")
            if not count or total_us <= 0:
                return None
            parts.append(total_us / iters / 1e3)
            continue
        if count != iters:
            print(f"{route}: the profiler recorded {count} of {iters} "
                  f"launches of {names[0]}")
        if not count or total_us <= 0:
            return None
        parts.append(total_us / count / 1e3)
    if len(parts) > 1:
        print(f"{route}: " + " + ".join(
            f"{names[0]} {ms:.4f} ms"
            for names, ms in zip(KERNEL_NAMES[route], parts)))
    return sum(parts)


def host_ms(fn, iters: int = 10) -> float:
    """Host milliseconds per call to enqueue fn (no synchronize inside):
    where it is near the CUDA-event time, the call is bound by the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def chain_bytes(name: str, args) -> int:
    """Bytes a chain call must move: encode reads q0 (int32) and the sort
    flags and writes one byte per line and slot; decode reads the line
    bytes and flags and writes one 32-bit state per slot."""
    if name.startswith("chain_encode"):
        q0, ss = args
        return q0.nbytes + ss.nbytes + q0.shape[0] * ss.shape[1] * q0.shape[1]
    yc, ss = args
    return yc.nbytes + ss.nbytes + yc.shape[0] * yc.shape[2] * 4


def rank_bytes(T) -> int:
    """Bytes a rank chain must move: T read (as the kernel reads it, int32)
    and r0, r_starts (int64) and r_final written."""
    n_ch, H = T.shape
    return n_ch * H * 4 + 8 * H + n_ch * H * 8 + 8 * H


def rank_floor(T) -> dict:
    """The rank chain's sequential floor on these totals: its levels, each
    a set of independent row sorts (level 0, ceil(log2 n_ch) doubling
    levels and the final one), and its route."""
    n_ch, H = T.shape
    route, rank_bytes_ = pbwt_kernels.rank_route(H)
    return {"chunks": n_ch, "levels": max(n_ch - 1, 0).bit_length() + 2,
            "route": route, "rank_bytes": rank_bytes_}


def first_bad_level(got, want) -> str:
    """Where a rank chain's output first differs from the plain one: the
    first wrong row r_t and the level that completes its prefix rank P_t
    (level 0 for t = 1, the doubling level of stride 2^(k-1) for t <=
    2^k; row 0 is r0 itself), the final level being the last to touch
    every row."""
    rows = torch.cat([got[1], got[0][None]]).cpu()
    ref = torch.cat([want[1], want[0][None]]).cpu()
    bad = (rows != ref).any(1).nonzero()
    if not len(bad):
        return "none"
    t = int(bad[0])
    level = ("r0 copied" if t == 0 else "level 0" if t == 1 else
             f"doubling level {(t - 1).bit_length()} (stride "
             f"{1 << ((t - 1).bit_length() - 1)})")
    return (f"row t = {t} (its prefix complete after {level}; or the "
            f"final level)")


def mixed_bytes(ys, hap) -> int:
    """Bytes the mixed scan must move: the stored lines read (a haploid
    line only its ceil(H / 2) front-packed bits, a diploid one H) and two
    flags per line, vals and a_final (int64) written."""
    Lw, H = ys.shape
    n_hap = int(hap.sum())
    read = n_hap * ((H + 1) // 2) + (Lw - n_hap) * H
    return read + Lw * H + 2 * Lw + 8 * H


def mixed_floor(sorts, hap) -> dict:
    """The mixed scan's sequential floor: every line is one step over the
    row, a haploid line one block scan more, a sorting line one more."""
    return {"lines": int(sorts.shape[0]), "sorting_lines": int(sorts.sum()),
            "haploid_lines": int(hap.sum())}


def rank_totals(rng, n_ch: int, H: int, bits: int):
    """int32[n_ch, H] chunk history totals below 2^bits: bit k a sorting
    line, set with a density drawn per chunk and line from the blocks'
    allele-frequency mix."""
    T = np.zeros((n_ch, H), np.int32)
    for k in range(bits):
        p = rng.choice([0.0005, 0.01, 0.05, 0.3, 0.7], (n_ch, 1))
        T |= (rng.random((n_ch, H)) < p).astype(np.int32) << k
    return T


def mixed_lines(rng, n_lines: int, H: int, kind, dev):
    """Stored lines of a mixed-ploidy block's WAH lines: haploid lines hold
    their H / 2 front-packed bits, zero past them; kind "runs" (each
    ploidy in runs of 64 lines), "par" (diploid lines, then haploid ones:
    the chrX PAR layout), "alternating" (single lines), "haploid",
    "diploid", or the haploid flags themselves.  Every line sorts (as the
    codec's WAH lines do).  Returns (ys, sorts, hap) on dev and hap on the
    host (the run route cuts its runs from it)."""
    hap = kind if isinstance(kind, np.ndarray) else {
        "runs": np.repeat(rng.random(-(-n_lines // 64)) < 0.5,
                          64)[:n_lines],
        "par": np.arange(n_lines) >= n_lines // 2,
        "alternating": np.arange(n_lines) % 2 == 1,
        "haploid": np.ones(n_lines, bool),
        "diploid": np.zeros(n_lines, bool)}[kind]
    dens = rng.choice([0.002, 0.05, 0.3, 0.7, 0.99], n_lines)
    ys = bernoulli_rows(rng, dens, H)
    ys[hap, H // 2:] = 0
    return (torch.from_numpy(ys).to(dev),
            torch.ones(n_lines, dtype=torch.bool, device=dev),
            torch.from_numpy(hap).to(dev), hap)


def make_block(rng, H: int):
    """bench.py's workload: a rare-heavy MAF mix approximating 1KGP3 chr20
    (plus a near-fixed tail that encodes as negated sparse lines)."""
    kind = rng.random(L)
    freqs = np.where(
        kind < 0.53, rng.uniform(0.0, 0.0015, L),
        np.where(kind < 0.78, rng.uniform(0.0015, 0.05, L),
                 np.where(kind < 0.98, rng.uniform(0.05, 0.95, L),
                          rng.uniform(0.999, 1.0, L))))
    return bernoulli_rows(rng, freqs, H).view(np.int8)


def bernoulli_rows(rng, dens, H: int, slice_lines: int = 512):
    """uint8[len(dens), H] bits, row i set with probability dens[i];
    drawn in slices of rows, the draws are those of one [rows, H] call."""
    out = np.empty((len(dens), H), np.uint8)
    for a in range(0, len(dens), slice_lines):
        b = min(len(dens), a + slice_lines)
        out[a:b] = rng.random((b - a, H)) < np.asarray(dens[a:b])[:, None]
    return out


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def importable(name: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(name) is not None


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean host-clock milliseconds per call, each call synchronized."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def diff(a, b) -> int:
    """Largest absolute difference of two integer tensors (0 = equal)."""
    if isinstance(a, tuple):          # wah_compress: (words, counts)
        return max(diff(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise SystemExit(f"chip_smoke: FAIL: shapes {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def counters() -> tuple[dict, ...]:
    return (pbwt_kernels.launches, wah_kernels.launches,
            sparse_kernels.launches, product_kernels.launches)


def reset_counts() -> None:
    for c in counters():
        for k in c:
            c[k] = 0


def read_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def machine_facts() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([_build.nvcc(), "--version"]).splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print(f"nvcc: {nvcc}")
    print(f"triton importable: {importable('triton')}; "
          f"zstandard importable: {importable('zstandard')}")
    return card


def build_kernels() -> None:
    _build.build(force=True)
    _build.library()
    print(f"build: {len(_build.sources())} x nvcc "
          f"{' '.join(_build.NVCC_FLAGS)} -c, side by side, + link -> "
          f"{_build.LIB_PATH} in {_build.last_build_seconds:.2f} s")


def wah_rows(bits):
    """Concatenated WAH stream of bit rows (the port's plain encoder)."""
    words, n = wah_torch.wah_compress_words(wah_torch.pack_bits(bits))
    keep = torch.arange(words.shape[1])[None, :] < n[:, None]
    return words[keep]


def chain_inputs(rng, s, dev):
    ss = torch.from_numpy(rng.random((s["n_ch"], s["C"])) < 0.9).to(dev)
    q0 = torch.from_numpy(rng.integers(0, 1 << 16, (s["n_ch"], s["H"]),
                                       dtype=np.int32)).to(dev)
    p = rng.choice([0.002, 0.05, 0.3, 0.7, 0.99], s["n_ch"] * s["C"])
    yc = torch.from_numpy(bernoulli_rows(rng, p, s["H"]).reshape(
        s["n_ch"], s["C"], s["H"])).to(dev)
    return ss, q0, yc


def wah_inputs(rng, s, dev):
    dens = rng.choice([0.0, 0.0005, 0.01, 0.3, 0.9, 0.999, 1.0],
                      s["n_lines"])
    bits = torch.from_numpy(bernoulli_rows(rng, dens, s["H"]))
    words_cpu = wah_torch.pack_bits(bits)
    stream = torch.cat([wah_rows(bits), torch.zeros(64, dtype=torch.uint16)])
    return bits.to(dev), words_cpu, words_cpu.to(dev), stream.to(dev)


def varw_inputs(rng, n_samples: int, n_lines: int, dev):
    """A stream of lines of two widths, haploid (n_samples bits) and
    diploid (2 n_samples), alternating in runs of 64 lines as a chrX PAR
    boundary block's lines would; returns (the packed words, zero past a
    line's width, on the CPU), the stream and the group offsets on dev."""
    hap = np.repeat(rng.random(n_lines // 64) < 0.5, 64)
    dens = rng.choice([0.0, 0.0005, 0.01, 0.3, 0.9, 0.999, 1.0], n_lines)
    grids = [wah_torch.pack_bits(torch.from_numpy(
        bernoulli_rows(rng, dens, w))) for w in (2 * n_samples, n_samples)]
    w_max = grids[0].shape[1]
    words = grids[0].clone()
    hap_t = torch.from_numpy(hap)
    words[hap_t] = 0
    words[hap_t, :grids[1].shape[1]] = grids[1][hap_t]
    # torch's uint16 lacks masked writes on the CPU: stitch in int32
    (dw, dn), (hw, hn) = (wah_torch.wah_compress_words(g) for g in grids)
    comb, hw = dw.to(torch.int32), hw.to(torch.int32)
    comb[hap_t] = 0
    comb[hap_t, :hw.shape[1]] = hw[hap_t]
    n = torch.where(hap_t, hn, dn)
    stream = torch.cat([comb[torch.arange(w_max)[None, :] < n[:, None]],
                        torch.zeros(64, dtype=torch.int32)]).to(torch.uint16)
    widths = np.where(hap, grids[1].shape[1], w_max)
    group_off = torch.from_numpy(np.concatenate([[0], np.cumsum(widths)]))
    return words, stream.to(dev), group_off.to(dev), w_max


def check_kernels(card: str) -> tuple[dict, list[dict]]:
    """Each kernel route vs its plain version on the card, bit-exact; both
    timed by CUDA events.  Returns the JSON rows of the kernels line (by
    route) and every check made."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    cases = []    # (route, width, shape, kernel fn, plain fn, extra check,
    #              bytes moved[, meta])
    for label, s in (("1KGP3", KERNEL_SHAPES), ("HRC", HRC_SHAPES)):
        ss, q0, yc = chain_inputs(rng, s, dev)
        bits, words_cpu, words, stream = wah_inputs(rng, s, dev)
        w = words.shape[1]
        h = s["H"]
        shape = f"H={s['H']} C={s['C']} n_ch={s['n_ch']}"
        wshape = f"n_lines={s['n_lines']} w={w}"
        n = s["n_lines"]
        enc, dec = (pbwt_kernels.chain_route(k, pbwt_kernels.cluster_size(
            k, h)) for k in ("chain_encode", "chain_decode"))
        cases += [
            (enc, label, shape,
             lambda q0=q0, ss=ss: pbwt_kernels.chain_encode(q0, ss),
             lambda q0=q0, ss=ss: pbwt_kernels.chain_encode_plain(q0, ss),
             None, chain_bytes("chain_encode", (q0, ss))),
            (dec, label, shape,
             lambda yc=yc, ss=ss: pbwt_kernels.chain_decode(yc, ss),
             lambda yc=yc, ss=ss: pbwt_kernels.chain_decode_plain(yc, ss),
             None, chain_bytes("chain_decode", (yc, ss))),
            ("wah_compress", label, wshape,
             lambda wd=words: wah_kernels.wah_compress(wd),
             lambda wd=words: wah_kernels.wah_compress_plain(wd), None,
             words.nbytes + n * w * 2 + n * 4),
            ("wah_compress_bits", label, f"{wshape} h={h}",
             lambda b=bits: wah_kernels.wah_compress_bits(b),
             lambda b=bits: wah_kernels.wah_compress_bits_plain(b), None,
             bits.nbytes + n * w * 2 + n * 4),
        ]
        # the expands with each line width route (a warp or a CTA per
        # line); the default route first
        for lt in (None, 32, 256):
            sfx = "" if lt is None else f" line_threads={lt}"
            cases += [
                ("wah_expand", label, wshape + sfx,
                 lambda st=stream, n=n, w=w, lt=lt: wah_kernels.wah_expand(
                     st, n, w, line_threads=lt),
                 lambda st=stream, n=n, w=w: wah_kernels.wah_expand_plain(
                     st, n, w),
                 ("the encoded words", lambda got, wc=words_cpu: diff(
                     got.cpu(), wc)),
                 stream.nbytes + n * w * 4),
                ("wah_expand_bits", label, f"{wshape} h={h}{sfx}",
                 lambda st=stream, n=n, w=w, h=h, lt=lt:
                 wah_kernels.wah_expand_bits(st, n, w, h, line_threads=lt),
                 lambda st=stream, n=n, w=w, h=h:
                 wah_kernels.wah_expand_bits_plain(st, n, w, h),
                 ("the encoded bits", lambda got, b=bits: diff(got, b)),
                 stream.nbytes + n * h),
            ]
        if label == "1KGP3":
            # the cluster route forced at 1KGP3 width, against the plain
            # version and the one-CTA route
            for name, K, args in (("chain_encode", 2, (q0, ss)),
                                  ("chain_decode", 4, (yc, ss))):
                kern = getattr(pbwt_kernels, name)
                plain = getattr(pbwt_kernels, f"{name}_plain")
                cases.append((
                    pbwt_kernels.chain_route(name, K), "1KGP3 forced",
                    f"{shape} K={K}",
                    lambda f=kern, a=args, K=K: f(*a, cluster=K),
                    lambda f=plain, a=args: f(*a),
                    ("the one-CTA route", lambda got, f=kern, a=args:
                     diff(got, f(*a, cluster=1))),
                    chain_bytes(name, args)))

    # the per-line-width expand at a chrX PAR block's widths (its own
    # generator: the draws of the cases above stay as they were)
    vwords, vstream, voff, vw = varw_inputs(np.random.default_rng(2), MALES,
                                            4096, dev)
    vshape = f"n_lines=4096 w={vw}/{wah_torch.n_words_for(MALES)} in runs"
    vh = 2 * MALES
    for lt in (None, 32, 256):
        sfx = "" if lt is None else f" line_threads={lt}"
        cases += [(
            "wah_expand_varw", "chrX-PAR", vshape + sfx,
            lambda lt=lt: wah_kernels.wah_expand_varw(vstream, voff, vw,
                                                      line_threads=lt),
            lambda: wah_kernels.wah_expand_varw_plain(vstream, voff, vw),
            ("the encoded words", lambda got: diff(got.cpu(), vwords)),
            vstream.nbytes + voff.nbytes + (voff.shape[0] - 1) * vw * 4), (
            "wah_expand_varw_bits", "chrX-PAR", f"{vshape} h={vh}{sfx}",
            lambda lt=lt: wah_kernels.wah_expand_varw_bits(
                vstream, voff, vw, vh, line_threads=lt),
            lambda: wah_kernels.wah_expand_varw_bits_plain(vstream, voff, vw,
                                                           vh),
            ("the encoded words", lambda got: diff(
                got.cpu(), wah_torch.unpack_bits(vwords, vh))),
            vstream.nbytes + voff.nbytes + (voff.shape[0] - 1) * vh)]

    # the WAH routes above the 16-bit slot field (their own generator), a
    # CTA per line: the expand's shared memory holds w <= 32,767
    wrng = np.random.default_rng(3)
    for label, s in WIDE_WAH:
        bits, words_cpu, words, stream = wah_inputs(wrng, s, dev)
        n, h, w = s["n_lines"], s["H"], words.shape[1]
        wshape = f"n_lines={n} w={w}"
        cases += [
            ("wah_compress_bits", label, f"{wshape} h={h}",
             lambda b=bits: wah_kernels.wah_compress_bits(b),
             lambda b=bits: wah_kernels.wah_compress_bits_plain(b), None,
             bits.nbytes + n * w * 2 + n * 4),
            ("wah_expand", label, wshape,
             lambda st=stream, n=n, w=w: wah_kernels.wah_expand(st, n, w),
             lambda st=stream, n=n, w=w: wah_kernels.wah_expand_plain(
                 st, n, w),
             ("the encoded words", lambda got, wc=words_cpu: diff(
                 got.cpu(), wc)),
             stream.nbytes + n * w * 4),
            ("wah_expand_bits", label, f"{wshape} h={h}",
             lambda st=stream, n=n, w=w, h=h:
             wah_kernels.wah_expand_bits(st, n, w, h),
             lambda st=stream, n=n, w=w, h=h:
             wah_kernels.wah_expand_bits_plain(st, n, w, h),
             ("the encoded bits", lambda got, b=bits: diff(got, b)),
             stream.nbytes + n * h),
        ]
        del words_cpu

    # the chains at the edges of their routes (their own generator):
    # encode registers of 16 lines, decode lines of the wide state's chunk,
    # against the plain versions
    crng = np.random.default_rng(6)
    for name, H, n_ch, C, K in WIDE_CHAINS:
        shape = f"H={H} C={C} n_ch={n_ch}"
        ss = torch.from_numpy(crng.random((n_ch, C)) < 0.9).to(dev)
        if name == "chain_encode":
            q0 = crng.integers(0, 1 << 16, (n_ch, H), dtype=np.int32)
            args = (torch.from_numpy(q0).to(dev), ss)
        else:
            p = crng.choice([0.002, 0.05, 0.3, 0.7, 0.99], n_ch * C)
            yc = bernoulli_rows(crng, p, H, slice_lines=64)
            args = (torch.from_numpy(yc.reshape(n_ch, C, H)).to(dev), ss)
        K = pbwt_kernels.cluster_size(name, H, K)
        route = pbwt_kernels.chain_route(name, K)
        cases.append((
            route, f"H={H}", f"{shape} K={K}",
            lambda f=getattr(pbwt_kernels, name), a=args, K=K: f(
                *a, cluster=K),
            lambda f=getattr(pbwt_kernels, f"{name}_plain"), a=args: f(*a),
            None, chain_bytes(name, args)))

    # the encode with the parity payload on each route (its own generator):
    # registers of 15 lines and a random bit 15, the slot parity
    prng = np.random.default_rng(7)
    for label, H, n_ch, K in PARITY_CHAINS:
        ss = torch.from_numpy(prng.random((n_ch, 15)) < 0.9).to(dev)
        q0 = torch.from_numpy(prng.integers(0, 1 << 16, (n_ch, H),
                                            dtype=np.int32)).to(dev)
        K = pbwt_kernels.cluster_size("chain_encode", H, K)
        cases.append((
            pbwt_kernels.chain_route("chain_encode_parity", K), label,
            f"H={H} C=15 n_ch={n_ch} K={K}",
            lambda a=(q0, ss), K=K: pbwt_kernels.chain_encode(
                *a, cluster=K, parity=True),
            lambda a=(q0, ss): pbwt_kernels.chain_encode_plain(
                *a, parity=True),
            None, chain_bytes("chain_encode", (q0, ss))))

    # the PBWT device scans (their own generator): the rank chain on both
    # routes at the main path's widths, the chrX PAR mixed encode's, the
    # narrowest, each side of the shared-memory route's bound and of the
    # 16-bit ranks', and TOPMed's; the mixed scan at chrX PAR width and at
    # HRC width (its state in device memory).  Their plain versions step
    # from the host, one chunk or line at a time: timed over fewer calls.
    srng = np.random.default_rng(4)
    for label, n_ch, H, bits in (("1KGP3", 301, 5008, 16),
                                 ("HRC", 325, HRC_H, 16),
                                 ("chrX-PAR parity", 305, 2 * MALES, 15),
                                 ("H=1", 64, 1, 30), ("H=2", 64, 2, 30),
                                 ("H=16384", 301, 16384, 16),
                                 ("H=16385", 301, 16385, 16),
                                 ("H=65536", 40, 65536, 16),
                                 ("TOPMed", 395, 2 * TOPMED_SAMPLES, 13)):
        T = torch.from_numpy(rank_totals(srng, n_ch, H, bits)).to(dev)
        r0 = torch.arange(H, device=dev)
        r_bits = max(16, (H - 1).bit_length())
        route = pbwt_kernels.rank_route(H)[0]
        cases.append((
            "rank_chain", label, f"n_ch={n_ch} H={H} {bits}-bit T {route}",
            lambda T=T, r0=r0: pbwt_kernels.rank_chain(T, r0),
            lambda T=T, r0=r0, b=r_bits: pbwt_kernels.rank_chain_plain(
                T, r0, b),
            ("its log-depth form", lambda got, T=T, r0=r0: diff(
                got, pbwt_kernels.rank_chain_levels_plain(T, r0))),
            rank_bytes(T),
            {"plain_iters": 3, "floor": rank_floor(T),
             "yardstick": lambda T=T, r0=r0:
                 pbwt_kernels.rank_chain_levels_plain(T, r0)}))
    # the stepping kernel from an arrangement other than the identity (as
    # the run route starts a stepping piece); the run route itself on the
    # same lines after the loop
    mixed = []
    for label, n, H, kind in (("chrX-PAR", 4573, 2 * MALES, "runs"),
                              ("chrX-PAR layout", 4573, 2 * MALES, "par"),
                              ("chrX-PAR alternating", 1024, 2 * MALES,
                               "alternating"),
                              ("chrX-PAR haploid", 1024, 2 * MALES,
                               "haploid"),
                              ("chrX-PAR diploid", 1024, 2 * MALES,
                               "diploid"),
                              ("HRC", 512, HRC_H, "runs"),
                              ("TOPMed", 512, 2 * TOPMED_SAMPLES, "runs")):
        ys, so, hp, hnp = mixed_lines(srng, n, H, kind, dev)
        a0 = torch.from_numpy(srng.permutation(H)).to(dev)
        cases.append((
            "decode_scan_mixed", label, f"Lw={n} H={H} {kind}, a0 a "
            f"permutation",
            lambda a=(ys, so, hp), a0=a0: pbwt_kernels.decode_scan_mixed(
                *a, a0=a0),
            lambda a=(ys, so, hp), a0=a0:
            pbwt_kernels.decode_scan_mixed_plain(*a, a0=a0),
            None, mixed_bytes(ys, hp),
            {"plain_iters": 1, "floor": mixed_floor(so, hp)}))
        mixed.append((label, kind, ys, so, hp, hnp))

    rows, checks = {}, []
    wide_labels = ({label for label, _ in WIDE_WAH}
                   | {f"H={H}" for _, H, *_ in WIDE_CHAINS}
                   | {label for label, *_ in PARITY_CHAINS})
    for name, label, shape, kern, plain, extra, nbytes, *meta in cases:
        meta = meta[0] if meta else {}
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = diff(got, want)
        require(err == 0, f"{name} at {shape}: kernel differs from its plain "
                          f"version (max abs err {err})"
                + (f"; first at {first_bad_level(got, want)}"
                   if name == "rank_chain" else ""))
        note = ""
        if extra is not None:
            err2 = extra[1](got)
            require(err2 == 0, f"{name} at {shape}: differs from "
                               f"{extra[0]} (max abs err {err2})")
            note = f" and vs {extra[0]}"
        del got, want
        iters = 20 if label in ("1KGP3", "1KGP3 forced", "chrX-PAR") else 10
        p_iters = meta.get("plain_iters", iters)
        ms = cuda_ms(kern, iters=iters)
        plain_ms = cuda_ms(plain, iters=p_iters, warmup=min(3, p_iters))
        check = timed_check(name, label, shape, err, ms, plain_ms, nbytes,
                            note, card, kernel_device_ms(name, kern),
                            host_ms(kern), meta.get("floor"))
        if "yardstick" in meta:
            check["levels_plain_ms"] = cuda_ms(meta["yardstick"],
                                               iters=p_iters, warmup=1)
            print(f"kernel {name} [{label}]: its log-depth form in torch "
                  f"(rank_chain_levels_plain, a yardstick) "
                  f"{check['levels_plain_ms']:.4f} ms ({card})")
        checks.append(check)
        # the kernels line holds each route at its own path's width: the
        # cluster chains at HRC, the per-line-width expand at chrX PAR
        # widths, the rest at 1KGP3 (the chains are replaced by their
        # blocks' own shapes once the blocks have run), plus the WAH routes
        # at TOPMed width and at the widest line, the chains on 16 CTAs and
        # the parity routes, rows of their own
        if label in wide_labels:
            rows[f"{name}@{label}"] = kernel_row(check)
        elif name not in rows and (name in CLUSTER_ROUTES) == (label == "HRC"):
            rows[name] = kernel_row(check)

    # the mixed scan's run route on each case's lines beside the stepping
    # kernel forced over them; the run flush at the chrX PAR layout's runs
    # and at HRC width; then the crossover sweep behind MIN_RUN_LINES
    for label, kind, ys, so, hp, hnp in mixed:
        route, flushes = mixed_route_checks(
            label, ys, so, hp, hnp, card,
            flush=label in ("chrX-PAR layout", "HRC", "TOPMed"))
        checks.append(route)
        for c in flushes:
            checks.append(c)
            rows.setdefault(c["name"] if label != "TOPMed"
                            else f"{c['name']}@TOPMed mixed", kernel_row(c))
    del mixed
    checks.extend(mixed_crossover(card))
    return rows, checks


def flush_calls(fn) -> list:
    """fn() with the run flush's calls recorded: [(args, kwargs)], the
    tensors copied and the output buffer left out (a line-mapped call's
    kept as its row count, out_rows)."""
    calls = []
    orig = pbwt_kernels.decode_run_flush

    def call(*args, **kw):
        rec = {k: v.clone() if isinstance(v, torch.Tensor) else v
               for k, v in kw.items() if k != "out"}
        if kw.get("line_of") is not None:
            rec["out_rows"] = kw["out"].shape[0]
        calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args), rec))
        return orig(*args, **kw)
    with swapped(pbwt_kernels, {"decode_run_flush": call}):
        fn()
    return calls


def flush_bytes(args, kw) -> int:
    """Bytes a run flush must move: p_fin read (the chains' u32 states, 4
    B a slot), start and the sort flags read, the run's rows (and T) and
    its end map (int64 a slot) written."""
    p_fin, start, ss, H, n, _haploid = args
    T = 4 * p_fin.shape[0] * H if kw.get("want_T") else 0
    line_of = kw.get("line_of")
    return (p_fin.nbytes + 2 * start.nbytes + ss.nbytes + n * H + T
            + (0 if line_of is None else line_of.nbytes))


def flush_check(label: str, args, kw, card: str) -> dict:
    """The run flush at one call's arguments against its plain version
    (rows, the end map, and T if written), timed.  A line-mapped call
    (line_of, out_rows in kw) writes into two zeroed planes of out_rows
    rows, compared whole: the rows at their lines, the others untouched."""
    p_fin, _, _, H, n, haploid = args
    W = p_fin.shape[1]
    route = ("decode_run_flush" if pbwt_kernels.flush_cluster(W) == 1
             else "decode_run_flush_cluster")
    kw = dict(kw)
    out_rows = kw.pop("out_rows", None)
    planes = [None, None]
    if out_rows is not None:
        planes = [torch.zeros((out_rows, H), dtype=torch.uint8,
                              device=p_fin.device) for _ in range(2)]

    def kern():
        return pbwt_kernels.decode_run_flush(*args, **kw, out=planes[0])

    def plain():
        return pbwt_kernels.decode_run_flush_plain(*args, **kw,
                                                   out=planes[1])
    g, w = kern(), plain()
    torch.cuda.synchronize()
    err = max(diff(g[0], w[0]), diff(g[2], w[2]),
              diff(g[1], w[1]) if kw.get("want_T") else 0)
    shape = (f"{'haploid' if haploid else 'diploid'} run of {n} lines, "
             f"W={W} H={H} n_ch={p_fin.shape[0]} C={args[2].shape[1]}"
             + (", T written" if kw.get("want_T") else "")
             + ("" if out_rows is None else
                f", rows at their lines of {out_rows}"))
    require(err == 0, f"{route} at {label} ({shape}): kernel "
                      f"differs from its plain version (max abs err {err})")
    del g, w
    c = timed_check(route, label, shape, err, cuda_ms(kern),
                    cuda_ms(plain, iters=3, warmup=1), flush_bytes(args, kw),
                    "", card, kernel_device_ms(route, kern), host_ms(kern))
    c["haploid"] = haploid
    return c


def sparse_check(label: str, staged, h: int, card: str) -> dict:
    """The sparse-line kernel at a block's own inputs (the decode's staged
    is_wah, neg and carriers) against its plain version, each writing a
    zeroed plane of the block's shape, compared whole (the WAH rows left
    as they were), timed.  Bound: the sparse lines' bytes written once,
    the carriers read (16 B) and written (1 B), the flags read."""
    is_wah, neg, car_line, car_idx = staged[3:7]
    L = is_wah.shape[0]
    planes = [torch.zeros((L, h), dtype=torch.uint8, device=is_wah.device)
              for _ in range(2)]

    def kern():
        return sparse_kernels.sparse_lines(planes[0], is_wah, neg, car_line,
                                           car_idx)

    def plain():
        return sparse_kernels.sparse_lines_plain(planes[1], is_wah, neg,
                                                 car_line, car_idx)
    kern(), plain()
    torch.cuda.synchronize()
    err = diff(planes[0], planes[1])
    n_sparse = int((~is_wah).sum())
    n_car = car_line.shape[0]
    shape = f"{n_sparse} sparse lines of {L}, H={h}, {n_car} carriers"
    require(err == 0, f"sparse_lines at {label} ({shape}): kernel differs "
                      f"from its plain version (max abs err {err})")
    c = timed_check("sparse_lines", label, shape, err, cuda_ms(kern),
                    cuda_ms(plain, iters=3, warmup=1),
                    n_sparse * h + 17 * n_car + 2 * L, "", card,
                    kernel_device_ms("sparse_lines", kern), host_ms(kern))
    del planes
    c["default_route"] = label == "1KGP3"
    if not c["default_route"]:
        c["row"] = f"sparse_lines@{label}"
    return c


#: The product's agreement with float64 dots: the widest gap over
#: max(|dot|, 1), as the benchmark's dot_rel_err.
PRODUCT_RTOL = 1e-6


def product_bytes(K: int, H: int, n_samples: int) -> int:
    """Bytes dot_rows must move for K kept rows of H: the rows read once as
    uint8, keep (8 B) and the dot (4 B) a row, the weights (4 B a
    sample)."""
    return K * H + 12 * K + 4 * n_samples


def product_check(label: str, vals, n_samples: int, card: str) -> dict:
    """The product kernel at a block's own plane, every line kept (K = L,
    as in the cells' phased biallelic blocks), diploid weights from a
    seeded draw: within PRODUCT_RTOL of float64 dots and the same bits on
    two calls; timed beside its plain version and library_ms, the form the
    port used before (index_select, a float32 copy of the rows, cuBLAS's
    gemv), a yardstick the port no longer calls.  Bound: the K x H row
    bytes read once, keep (8 B) and the dot (4 B) a row, the weights (4 B
    a sample)."""
    L, h = vals.shape
    dev = vals.device
    g = torch.Generator(device=dev).manual_seed(L + h)
    y = torch.rand(n_samples, device=dev, generator=g)
    y_dip = y.repeat_interleave(2)
    keep = torch.arange(L, device=dev)

    def kern():
        return product_kernels.dot_rows(vals, keep, y, "diploid")

    def plain():
        return product_kernels.dot_rows_plain(vals, keep, y, "diploid")

    def library():
        return vals.index_select(0, keep).to(torch.float32) @ y_dip

    got, again, ref = kern(), kern(), plain()
    want = torch.cat([vals[k:k + 256].double() @ y_dip.double()
                      for k in range(0, L, 256)])
    rel = float(((got.double() - want).abs()
                 / want.abs().clamp(min=1)).max())
    err = float((got - ref).abs().max())
    shape = f"K={L} of {L} lines, H={h}, diploid"
    require(torch.equal(got, again), f"dot_rows at {label} ({shape}): two "
                                     "calls gave other bits")
    require(rel <= PRODUCT_RTOL, f"dot_rows at {label} ({shape}): relative "
                                 f"error {rel:.3g} against float64")
    c = timed_check("dot_rows", label, shape, err, cuda_ms(kern),
                    cuda_ms(plain, iters=3, warmup=1),
                    product_bytes(L, h, n_samples), "", card,
                    kernel_device_ms("dot_rows", kern), host_ms(kern),
                    agree=f"within relative {rel:.3g} of float64 dots, "
                          f"max abs {err:.3g} from plain, the same bits on "
                          f"two calls")
    c["max_rel_err"] = rel
    c["library_ms"] = cuda_ms(library, iters=5, warmup=1)
    print(f"kernel dot_rows [{label}]: library_ms (index_select + float32 "
          f"copy + gemv) {c['library_ms']:.4f} ms, "
          f"{c['library_ms'] / c['ms']:.2f}x the wrapper ({card})")
    c["default_route"] = label == "1KGP3"
    if not c["default_route"]:
        c["row"] = f"dot_rows@{label}"
    return c


def mixed_route_checks(label: str, ys, so, hp, hnp, card: str,
                       flush: bool = True, step_iters: int = 5
                       ) -> tuple[dict, list[dict]]:
    """The mixed scan's run route (pbwt_torch.pbwt_decode_scan_mixed) on
    these lines: bit-exact against the stepping kernel's plain version
    (vals and a_final), timed as the codec calls it (no final
    arrangement) and with the final arrangement, beside the stepping
    kernel forced over the same lines (timed in turns: stepping, route,
    route, stepping; `step_iters` calls each turn), with its launches a
    call.  With `flush`, the run flush at each of the route's runs against
    its plain version, timed.  Returns (the route's record, the flush
    checks)."""
    Lw, H = ys.shape

    def route(keep=True):
        return pbwt_torch.pbwt_decode_scan_mixed(ys, so, hp, hnp,
                                                 keep_final=keep)

    def step():
        return pbwt_kernels.decode_scan_mixed(ys, so, hp)

    got, want = route(), pbwt_kernels.decode_scan_mixed_plain(ys, so, hp)
    torch.cuda.synchronize()
    err = diff(got, want)
    pieces = pbwt_torch.mixed_runs(hnp, H)
    shape = (f"Lw={Lw} H={H}, pieces "
             + " ".join(f"{r}:{b - a}" for a, b, r in pieces))
    require(err == 0, f"the mixed run route at {label} ({shape}): differs "
                      f"from the stepping plain version (max abs err {err})")
    del got, want
    n0 = read_counts()
    route(False)
    torch.cuda.synchronize()
    ran = {k: v - n0[k] for k, v in read_counts().items() if v != n0[k]}
    step_a = cuda_ms(step, iters=step_iters, warmup=1)
    route_ms = cuda_ms(lambda: route(False), iters=10)
    final_ms = cuda_ms(route, iters=10)
    step_ms = (step_a + cuda_ms(step, iters=step_iters, warmup=1)) / 2
    enqueue = host_ms(lambda: route(False))
    b_ms = bound_ms(mixed_bytes(ys, hp))
    print(f"mixed route [{label}: {shape}]: bit-exact vs plain (vals and "
          f"a_final); {route_ms:.4f} ms as the codec calls it (no final "
          f"arrangement), {final_ms:.4f} ms with it; the stepping kernel "
          f"forced over the same lines {step_ms:.4f} ms (ratio "
          f"{final_ms / step_ms:.3f} with the final arrangement, "
          f"{route_ms / step_ms:.3f} without); bound {b_ms:.5f} ms; "
          f"launches a call {ran}; host enqueue {enqueue:.4f} ms/call "
          f"({card})")
    record = {"name": "mixed_run_route", "width": label, "shape": shape,
              "max_abs_err": err, "ms": route_ms, "ms_with_final": final_ms,
              "stepping_ms": step_ms, "ratio": final_ms / step_ms,
              "bound_ms": b_ms, "host_enqueue_ms": enqueue,
              "launches_a_call": ran}
    checks = [flush_check(label, args, kw, card)
              for args, kw in (flush_calls(route) if flush else [])]
    return record, checks


#: The crossover sweep: (width, lines, run lengths); the lines alternate
#: ploidy in runs of each length.  At chrX PAR width the stepping kernel
#: keeps its state in shared memory, at HRC width in device memory.
CROSSOVER = ((2 * MALES, 3072, (64, 128, 192, 256, 384, 512, 1024)),
             (HRC_H, 256, (4, 8, 16, 64)))


def mixed_crossover(card: str) -> list[dict]:
    """Every run on the chains (MIN_RUN_LINES and MIN_RUN_LINES_WIDE set
    to 1) against the stepping kernel over the same lines, by run length:
    where the chains overtake, which the constants follow (PERF.md §6).
    The two agree bit for bit (the stepping kernel is held against its
    plain version above)."""
    rng = np.random.default_rng(5)
    dev = torch.device(DEVICE)
    out = []
    for H, n_lines, lengths in CROSSOVER:
        for n in lengths:
            hnp = np.arange(n_lines) // n % 2 == 1
            ys, so, hp, _ = mixed_lines(rng, n_lines, H, hnp, dev)

            def chains():
                return pbwt_torch.pbwt_decode_scan_mixed(ys, so, hp, hnp)

            def step():
                return pbwt_kernels.decode_scan_mixed(ys, so, hp)
            with swapped(pbwt_torch, {"MIN_RUN_LINES": 1,
                                      "MIN_RUN_LINES_WIDE": 1}):
                err = diff(chains(), step())
                require(err == 0, f"crossover at H={H}, runs of {n}: the "
                                  f"chains differ from the stepping kernel")
                chains_ms = cuda_ms(chains, iters=5, warmup=1)
            step_ms = cuda_ms(step, iters=3, warmup=1)
            runs = n_lines // n
            print(f"mixed crossover [H={H}, {n_lines} lines in runs of {n}]: "
                  f"every run on the chains {chains_ms:.4f} ms, the stepping "
                  f"kernel {step_ms:.4f} ms; a run {chains_ms / runs:.4f} vs "
                  f"{step_ms / runs:.4f} ms ({card})")
            out.append({"name": "mixed_crossover", "H": H, "lines": n_lines,
                        "run_lines": n, "chains_ms": chains_ms,
                        "stepping_ms": step_ms})
    return out


def timed_check(name, label, shape, err, ms, plain_ms, nbytes, note,
                card, kernel_ms, enqueue_ms, floor=None,
                agree="bit-exact vs plain") -> dict:
    """Print one kernel check and return its record (with the bound).
    ms: the wrapper per call by CUDA events; kernel_ms: the kernel alone
    (profiler; None: not measured); enqueue_ms: the host's time per call;
    floor: a scan's sequential steps on these inputs (rank_floor,
    mixed_floor), printed beside the byte bound; agree: how the kernel's
    output was held against the plain version's."""
    b_ms = bound_ms(nbytes)
    alone = ("not measured" if kernel_ms is None else
             f"{kernel_ms:.4f} ms (share {b_ms / kernel_ms:.4f})")
    seq = "" if floor is None else f"; sequential floor {floor}"
    print(f"kernel {name} [{label}: {shape}]: {agree}{note}; "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms; bound {b_ms:.5f} ms "
          f"({nbytes} B), roofline share {b_ms / ms:.4f}{seq}; the kernel "
          f"alone {alone}; host enqueue {enqueue_ms:.4f} ms/call ({card})")
    return {"name": name, "width": label, "shape": shape, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "kernel_ms": kernel_ms,
            "host_enqueue_ms": enqueue_ms, "bytes": nbytes,
            "bound_ms": b_ms, "sequential_floor": floor}


def kernel_row(check: dict) -> dict:
    """The kernels line's entry of a route, from one of its checks.  No
    single PyTorch call computes a chunk chain of stable partitions, a WAH
    expansion or compression, or a whole rank chain or mixed scan (their
    plain versions take a sort or a dozen ops per chunk or line):
    library_ms is null but for the product (product_check)."""
    src, replaces = ROUTES[check["name"]]
    row = {"name": check["name"], "route": "cuda", "source": SRC + src,
           "replaces": replaces if "/" in replaces else PALLAS + replaces,
           "shape": check["shape"],
           "max_abs_err": check["max_abs_err"], "ms": check["ms"],
           "plain_ms": check["plain_ms"], "kernel_ms": check["kernel_ms"],
           "bound_ms": check["bound_ms"], "bound_by": "bytes",
           "library_ms": check.get("library_ms")}
    if check.get("sequential_floor"):
        row["sequential_floor"] = check["sequential_floor"]
    if check.get("levels_plain_ms") is not None:
        row["levels_plain_ms"] = check["levels_plain_ms"]
    if check.get("max_rel_err") is not None:
        row["max_rel_err"] = check["max_rel_err"]
    return row


#: Wrappers whose first call in a block is recorded (captured_args).
CAPTURED = ((pbwt_kernels, ("chain_encode", "chain_decode", "rank_chain",
                             "decode_run_flush")),
            (pbwt_torch, ("pbwt_decode_scan_mixed",)),
            (wah_kernels, ("wah_compress_bits", "wah_expand_bits",
                           "wah_expand_varw_bits")))


@contextlib.contextmanager
def swapped(module, fns: dict):
    """Module attributes replaced by `fns` (name -> function) inside."""
    orig = {n: getattr(module, n) for n in fns}
    for n, fn in fns.items():
        setattr(module, n, fn)
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(module, n, fn)


def index_checks_ms(parse) -> dict:
    """A block's host parse `parse` timed with the decoder's index checks
    (decoder_torch.check_indices) and with them made a no-op, in turns
    (with, without, without, with; 5 calls each): the checks' cost on
    the decode path, beside its spread."""
    times = {True: [], False: []}
    for checked in (True, False, False, True):
        fns = {} if checked else {"check_indices": lambda *a: None}
        with swapped(decoder_torch, fns):
            times[checked].append(wall_ms(parse, iters=5, warmup=1))
    return {"host_parse_ms": times[True],
            "host_parse_unchecked_ms": times[False]}


@contextlib.contextmanager
def captured_args():
    """Records (a copy of) the arguments of the first call of each chain,
    rank chain, mixed scan and bits WAH wrapper made inside the block, so
    the kernels can be held and timed at the shapes, registers, sort flags,
    lines and streams the block's own path gives them (the encode chain
    with the parity payload as chain_encode_parity)."""
    seen = {}

    def recorder(name, fn):
        def call(*args, **kw):
            key = f"{name}_parity" if kw.get("parity") else name
            seen.setdefault(key, tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return fn(*args, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for mod, names in CAPTURED:
            stack.enter_context(swapped(mod, {
                n: recorder(n, getattr(mod, n)) for n in names}))
        yield seen


def plain_pass_names(allow=()) -> list[str]:
    return [f"{mod.__name__.rsplit('.', 1)[1]}.{n}"
            for mod, names in PLAIN_PASSES for n in names if n not in allow]


@contextlib.contextmanager
def no_plain_passes(allow=()):
    """The PLAIN_PASSES (but `allow`) replaced by functions that raise: no
    plain pass may run on the card path."""
    def refuse(mod, name):
        def call(*args, **kw):
            raise AssertionError(f"{mod.__name__}.{name} ran on the card "
                                 f"path")
        return call
    with contextlib.ExitStack() as stack:
        for mod, names in PLAIN_PASSES:
            stack.enter_context(swapped(mod, {
                n: refuse(mod, n) for n in names if n not in allow}))
        yield


def once_peak_gb(fn) -> float:
    """Peak device memory (GB) of one call of fn, counted from its start
    (tensors already allocated included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def block_chain_checks(label: str, seen: dict, card: str) -> list[dict]:
    """Each chain kernel at its block's own shapes, bit-exact against its
    plain version and timed (the decode's states widened, as chain_decode
    returns them by default); at HRC width also on the other cluster sizes
    (encode K = 2, 4 and 8 in shared memory, decode K = 3, 4 and 8 with
    its rows in device memory), above 65,535 haplotypes on 8 and 16 CTAs;
    the encode with the parity payload (chain_encode_parity) likewise.  A
    wide block's checks fill rows of their own (route@block)."""
    out = []
    for name, args in seen.items():
        if not name.startswith("chain"):
            continue
        base, kw = (("chain_encode", {"parity": True})
                    if name == "chain_encode_parity" else (name, {}))
        plain = getattr(pbwt_kernels, f"{base}_plain")
        kern = getattr(pbwt_kernels, base)
        H = args[0].shape[-1]
        n_ch, C = args[1].shape
        K0 = pbwt_kernels.cluster_size(base, H)
        sizes = [K0]
        if K0 > 1:
            others = ((8, 16) if H > pbwt_kernels.SLOT16_H
                      else (2, 4, 8) if base == "chain_encode"
                      else (3, 4, 8))
            sizes += [k for k in others if k != K0]
        want = plain(*args, **kw)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=10, warmup=2)
        for K in sizes:
            got = kern(*args, cluster=K, **kw)
            torch.cuda.synchronize()
            err = diff(got, want)
            route = pbwt_kernels.chain_route(name, K)
            shape = f"H={H} C={C} n_ch={n_ch} K={K}"
            require(err == 0, f"{route} at {label} block shape {shape}: "
                              f"kernel differs from its plain version "
                              f"(max abs err {err})")
            del got
            def call(K=K):
                return kern(*args, cluster=K, **kw)
            ms = cuda_ms(call, iters=10, warmup=2)
            check = timed_check(route, f"{label} block", shape, err, ms,
                                plain_ms, chain_bytes(base, args), "", card,
                                kernel_device_ms(route, call), host_ms(call))
            check["default_route"] = K == K0 and H <= pbwt_kernels.SLOT16_H
            if K == K0 and H > pbwt_kernels.SLOT16_H:
                check["row"] = f"{route}@{label}"
            out.append(check)
        del want
    return out


#: Each scan: the block whose own inputs fill the kernels line, its bytes,
#: its sequential floor, calls of its plain version timed.  The rank
#: chain's device route also has rows of its own, at the HRC and TOPMed
#: blocks' totals (WIDE_SCAN_ROWS).
SCANS = {"rank_chain": ("1KGP3", lambda a: rank_bytes(a[0]),
                        lambda a: rank_floor(a[0]), 3),
         "decode_scan_mixed": (MIXED_BLOCK,
                               lambda a: mixed_bytes(a[0], a[2]),
                               lambda a: mixed_floor(a[1], a[2]), 2)}


WIDE_SCAN_ROWS = {("rank_chain", "HRC"), ("rank_chain", "TOPMed")}


def scan_block_checks(label: str, seen: dict, card: str) -> list[dict]:
    """The PBWT device scans at the block's own inputs (the first call of
    each its path made: the rank chain's totals, the mixed scan's lines),
    bit-exact against their plain versions and timed, with their
    sequential floor.  Returns the checks by route."""
    out = {}
    for name, (row_block, nbytes, floor, p_iters) in SCANS.items():
        if name not in seen:
            continue
        args = seen[name]
        kern = getattr(pbwt_kernels, name)
        plain = getattr(pbwt_kernels, f"{name}_plain")
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = diff(got, want)
        shape = " x ".join(str(tuple(a.shape)) for a in args
                           if isinstance(a, torch.Tensor))
        where = ""
        if name == "rank_chain":
            shape += f" {pbwt_kernels.rank_route(args[0].shape[1])[0]}"
            where = f"; first at {first_bad_level(got, want)}"
        require(err == 0, f"{name} at {label} block shape {shape}: kernel "
                          f"differs from its plain version (max abs err "
                          f"{err}){where}")
        del got, want

        def call(f=kern, a=args):
            return f(*a)
        c = timed_check(name, f"{label} block", shape, err,
                        cuda_ms(call, iters=10, warmup=2),
                        cuda_ms(lambda: plain(*args), iters=p_iters,
                                warmup=1),
                        nbytes(args), "", card, kernel_device_ms(name, call),
                        host_ms(call), floor=floor(args))
        if name == "rank_chain":
            c["levels_plain_ms"] = cuda_ms(
                lambda: pbwt_kernels.rank_chain_levels_plain(*args[:2]),
                iters=p_iters, warmup=1)
            print(f"kernel rank_chain [{label} block]: its log-depth form in "
                  f"torch (rank_chain_levels_plain, a yardstick) "
                  f"{c['levels_plain_ms']:.4f} ms ({card})")
        c["default_route"] = label == row_block
        if (name, label) in WIDE_SCAN_ROWS:
            c["row"] = f"{name}@{label}"
        out[name] = c
    return out


def wah_block_checks(label: str, seen: dict, card: str) -> list[dict]:
    """Each WAH route at its block's own bit grid or stream (the first
    bits-route calls the block's path made), bit-exact against its plain
    version and timed, the expands on both line widths (a warp and a CTA
    per line).  The checks of
    the 1KGP3 and chrX PAR blocks' default routes fill the kernels line."""
    wk, wt = wah_kernels, wah_torch
    out = []

    def check(route, shape, kern, plain, nbytes, lt=None):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = diff(got, want)
        require(err == 0, f"{route} at {label} block shape {shape}: kernel "
                          f"differs from its plain version (max abs err "
                          f"{err})")
        del got, want
        c = timed_check(route, f"{label} block", shape, err,
                        cuda_ms(kern, iters=10, warmup=2),
                        cuda_ms(plain, iters=3, warmup=1), nbytes, "", card,
                        kernel_device_ms(route, kern), host_ms(kern))
        c["default_route"] = lt is None and label in ("1KGP3", MIXED_BLOCK)
        out.append(c)

    if "wah_compress_bits" in seen:
        (bits,) = seen["wah_compress_bits"]
        R, H = bits.shape
        W = wt.n_words_for(H)
        words = wt.pack_bits(bits)
        shape = f"{R} rows x {H} bits (w={W})"
        check("wah_compress_bits", shape, lambda: wk.wah_compress_bits(bits),
              lambda: wt.wah_encode_lines(bits),
              bits.nbytes + R * W * 2 + R * 4)
        check("wah_compress", shape, lambda: wk.wah_compress(words),
              lambda: wt.wah_compress_words(words),
              words.nbytes + R * W * 2 + R * 4)
        del words
    for route in ("wah_expand_bits", "wah_expand_varw_bits"):
        if route not in seen:
            continue
        varw = route == "wah_expand_varw_bits"
        if varw:
            stream, goff, w, h = seen[route]
            n = goff.shape[0] - 1
            extra = (goff,)
            shape = f"{n} lines, w={w} (per-line widths), h={h}"
        else:
            stream, n, w, h = seen[route]
            extra = ()
            shape = f"{n} lines, w={w}, h={h}"
        shape += f", stream of {stream.shape[0]} words"
        bits_k = wk.wah_expand_varw_bits if varw else wk.wah_expand_bits
        bits_p = (wt.wah_expand_stream_varw_bits if varw
                  else wt.wah_expand_stream_bits)
        int_k = wk.wah_expand_varw if varw else wk.wah_expand
        int_p = wt.wah_expand_stream_varw if varw else wt.wah_expand_stream
        a = (stream, *extra) if varw else (stream, n)
        head = stream.nbytes + sum(x.nbytes for x in extra)
        for lt in (None, 32, 256):
            if lt and wk.expand_smem_bytes(w, lt) > wk.SMEM_LIMIT:
                continue          # four lines of w groups do not fit a CTA
            sfx = "" if lt is None else f" line_threads={lt}"
            check(route, shape + sfx,
                  lambda lt=lt: bits_k(*a, w, h, line_threads=lt),
                  lambda: bits_p(*a, w, h), head + n * h, lt=lt)
            check(route[:-len("_bits")], shape + sfx,
                  lambda lt=lt: int_k(*a, w, line_threads=lt),
                  lambda: int_p(*a, w), head + n * w * 4, lt=lt)
    return out


def host_reference(name: str, kw: dict, rows) -> bytes:
    """The host GtBlockEncoder's payload of the block's records."""
    t0 = time.perf_counter()
    ref = GtBlockEncoder(**kw)
    for row in rows:
        ref.encode_record(row, 2)
    payload = ref.serialize()
    print(f"[{name}] host GtBlockEncoder reference: {len(payload)} B in "
          f"{time.perf_counter() - t0:.1f} s")
    return payload


def ingester(kw: dict, gt_flat: np.ndarray, widths: np.ndarray):
    """A function that ingests the block's biallelic records into a new
    TorchBlockEncoder through the batched entry point."""
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    na = np.full(len(widths), 2, np.int32)

    def ingest():
        enc = encoder_torch.TorchBlockEncoder(device=DEVICE, **kw)
        enc.encode_records(gt_flat, offs, na, 0, len(widths))
        return enc
    return ingest


def run_path(name: str, enc, decode, ref_payload: bytes, rows) -> tuple:
    """The path once -- enc.serialize(), then decode(payload) -- with every
    launch counter at 0 just before and read just after.  Requires the
    payload byte-equal to the host's, every decoded record equal to its
    row, each of the path's kernel routes launched and no other.  Returns
    (payload, launches, peak device GB of the run)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the path, once, with every launch counter at 0 and the plain
    # ---- passes made to raise -----------------------------------------
    allow = PLAIN_ROUTES.get(name, ())
    with no_plain_passes(allow):
        reset_counts()
        payload = enc.serialize()
        recs = decode(payload)
        torch.cuda.synchronize()
        launches = read_counts()
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{name}] path launches: {launches}; ran with "
          f"{', '.join(plain_pass_names(allow))} made to raise"
          + (f" ({', '.join(allow)} is this path's route)" if allow else ""))
    require(payload == ref_payload,
            f"{name}: payload differs from GtBlockEncoder's ({len(payload)} "
            f"vs {len(ref_payload)} B)")
    bad = sum(int(r.shape != g.shape or (r != g).any())
              for r, g in zip(recs, rows))
    require(len(recs) == L and bad == 0,
            f"{name}: {bad} of {L} decoded lines differ from the input")
    for k, n in launches.items():
        if k in PATH_KERNELS[name]:
            require(n > 0, f"{name}: kernel {k} was not launched by the path")
        else:
            require(n == 0, f"{name}: route {k} was launched by the path")
    return payload, launches, peak_gb


def alone(block: str, fn, nbytes: int, label: str, card: str) -> dict:
    """A path's function timed alone (CUDA events), with its byte bound
    and its peak device memory above what is allocated."""
    ms = cuda_ms(fn, iters=3, warmup=1)
    base = torch.cuda.memory_allocated() / 1e9
    extra = once_peak_gb(fn) - base
    print(f"[{block}] {label} alone: {ms:.3f} ms, bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes} B), share "
          f"{bound_ms(nbytes) / ms:.4f}; peak above its inputs "
          f"{extra:.3f} GB ({card})")
    return {"ms": ms, "bound_ms": bound_ms(nbytes), "bytes": nbytes,
            "peak_above_inputs_gb": extra}


def aet_dtype_for(H: int):
    """The sparse and track streams' type, by width, as the compressor
    picks it (codec/compressor.py): 32-bit above 65,535 haplotypes."""
    return np.uint16 if H <= 0xFFFF else np.uint32


def block_phase(name: str, n_samples: int, seed: int, card: str) -> dict:
    """One block through the main path's entry points, checked exactly;
    returns the launch counts of that one run and the timings.  The wide
    blocks' host loops (serialize, decode_block_records) run once, the
    path's own run being their warm-up.  Above 65,535 haplotypes (TOPMed)
    the chains take the decode's wide state and the run flush a cluster a
    chunk, and each PBWT route is timed alone."""
    H = 2 * n_samples
    mac = int(H * 0.001)
    aet = aet_dtype_for(H)
    slots32 = H > pbwt_kernels.SLOT16_H
    t0 = time.perf_counter()
    alleles = make_block(np.random.default_rng(seed), H)
    gt = (alleles.astype(np.int32) + 1) << 1          # unphased biallelic
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=mac,
              default_phasing=0, aet_dtype=aet)
    print(f"[{name}] block of {L} x {H} made in "
          f"{time.perf_counter() - t0:.1f} s")
    ref_payload = host_reference(name, kw, gt)
    ingest = ingester(kw, gt.reshape(-1), np.full(L, H))
    enc = ingest()

    def records(p):
        return decoder_torch.decode_block_records(p, n_samples, H, aet,
                                                  [2] * L, device=DEVICE)

    payload, launches, peak_gb = run_path(name, enc, records, ref_payload,
                                          gt)

    # line classes, as the payload stores them
    ac = alleles.sum(1, dtype=np.int64)
    del alleles
    mac_l = np.minimum(ac, H - ac)
    n_wah = int((mac_l > mac).sum())
    n_neg = int(((mac_l <= mac) & (ac != mac_l)).sum())
    print(f"[{name}] block: {L} lines x {H} haplotypes; {n_wah} WAH lines, "
          f"{L - n_wah} sparse lines ({n_neg} negated); payload "
          f"{len(payload)} B byte-equal to GtBlockEncoder's; decode "
          f"bit-exact on all {L} lines; peak device memory of the run "
          f"{peak_gb:.3f} GB")

    # ---- timing, in bench.py's unit (L * H * 4 logical gt bytes) ------
    wide = H > 2 * 5008
    dev_loop = dict(iters=5, warmup=1) if wide else dict(iters=10, warmup=2)
    # the wide blocks' host loops run once: the path's run warmed them up
    host_loop = dict(iters=1, warmup=0) if wide else dict(iters=3, warmup=1)
    prep = enc.prepare()
    dev = torch.device(DEVICE)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype=dtype)

    staged = (t(prep["alleles_p"]), t(prep["alts_p"]),
              t(prep["wah_rows_p"], torch.int64), t(prep["sorts_w"]),
              t(prep["sparse_rows_p"], torch.int64), t(prep["negated_s"]))
    del prep, enc
    cap = max(mac, 1)

    def encode_core():
        return encoder_torch.encode_block_core_compact(*staged, cap)

    torch.cuda.reset_peak_memory_stats()
    enc_ms = cuda_ms(encode_core, **dev_loop)
    enc_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    enc_core_peak = once_peak_gb(encode_core)
    # the path's own inputs of each kernel (captured after the peaks: the
    # copies are not the path's memory) and the rank chain alone
    with captured_args() as seen:
        encode_core()
    scans = scan_block_checks(name, seen, card)
    parts = {}
    # the rank chain's copied totals are done with: the decode's peaks
    # below are measured without them
    seen.pop("rank_chain", None)
    if slots32:
        aw = staged[0].index_select(0, staged[2])
        at = staged[1].index_select(0, staged[2])
        sw = staged[3]
        # reads the WAH lines' alleles and flags, writes their bits and
        # the final arrangement
        parts["pbwt_encode_chunked"] = alone(
            name, lambda: pbwt_torch.pbwt_encode_chunked(aw, at, sw),
            2 * aw.numel() + at.nbytes + sw.nbytes + 8 * H,
            "pbwt_encode_chunked", card)
        del aw, at, sw
    del staged
    ser_ms = wall_ms(lambda: ingest().serialize(), **host_loop)

    dec = decoder_torch.TorchBlockDecoder(payload, n_samples, H, aet,
                                          device=dev)
    *dstaged, h, w, _ = dec.device_inputs()
    gt_dev = decoder_torch._decode_block_full_gt(*dstaged, 0, h, w)
    require(bool((gt_dev.cpu().numpy() == gt).all()),
            f"{name}: fused decode to gt codes is not bit-exact")
    del gt_dev, gt

    def decode_device():
        return decoder_torch._decode_block_full_gt(*dstaged, 0, h, w)

    dec_dev_ms = cuda_ms(decode_device, **dev_loop)
    dec_dev_peak = once_peak_gb(decode_device)

    def decode_once():
        dec.host_inputs()                 # the per-block host parse
        return decoder_torch._decode_block_full_gt(*dstaged, 0, h, w)

    torch.cuda.reset_peak_memory_stats()
    dec_ms = wall_ms(decode_once, **(dict(iters=1, warmup=1) if slots32
                                     else dev_loop))
    dec_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the path's own inputs of each decode kernel (captured after the
    # decode's peaks: the copies are not the path's memory); the run flush
    # as the path calls it (its rows at their lines of the block's plane)
    # and the sparse-line kernel, each against its plain version
    with captured_args() as seen_dec:
        decode_device()
    seen.update(seen_dec)
    mapped = [c for c in flush_calls(decode_device)
              if c[1].get("line_of") is not None]
    require(len(mapped) == 1, f"{name}: the decode made {len(mapped)} "
                              f"line-mapped run flush calls, want 1")
    decode_checks = [sparse_check(name, dstaged, h, card)]
    plane = decoder_torch._decode_block_vals(*dstaged, h, w)
    decode_checks.append(product_check(name, plane, n_samples, card))
    del plane
    fm = flush_check(f"{name} block", *mapped[0], card)
    fm["default_route"] = False
    fm["row"] = f"{fm['name']}@{name} line map"
    decode_checks.append(fm)
    del mapped
    if slots32:
        ys = wah_kernels.wah_expand_bits(*seen["wah_expand_bits"])
        sorts = dstaged[1]
        parts["pbwt_decode_chunked"] = alone(
            name, lambda: pbwt_torch.pbwt_decode_chunked(ys, sorts),
            2 * ys.numel() + sorts.nbytes + 8 * H, "pbwt_decode_chunked",
            card)
        del ys, sorts
    del dstaged
    rec_ms = wall_ms(lambda: records(payload), **host_loop)
    gt_bytes = L * H * 4
    ratio = gt_bytes / len(payload)
    rc = scans["rank_chain"]
    print(f"[{name}] encode core: {enc_ms:.3f} ms/block = "
          f"{gt_bytes / enc_ms / 1e6:.2f} GB/s (peak {enc_peak_gb:.3f} GB) "
          f"| decode to gt codes (host parse + device): {dec_ms:.3f} "
          f"ms/block = {gt_bytes / dec_ms / 1e6:.2f} GB/s (peak "
          f"{dec_peak_gb:.3f} GB) | serialize (ingest + prepare + device + "
          f"assemble): {ser_ms:.1f} ms | decode_block_records: {rec_ms:.1f} "
          f"ms | compression {ratio:.2f}x ({card})")
    print(f"[{name}] device alone: encode core {enc_ms:.3f} ms, of which "
          f"the rank chain {rc['ms']:.3f} ms (its plain version "
          f"{rc['plain_ms']:.3f} ms), peak {enc_core_peak:.3f} GB | decode "
          f"{dec_dev_ms:.3f} ms, peak {dec_dev_peak:.3f} GB ({card})")
    checks = (block_chain_checks(name, seen, card)
              + wah_block_checks(name, seen, card) + list(scans.values())
              + decode_checks)
    if "decode_run_flush" in seen:      # the uniform decode's flush
        fc = flush_check(f"{name} block", seen["decode_run_flush"], {}, card)
        fc["default_route"] = False
        fc["row"] = f"{fc['name']}@{name}"
        checks.append(fc)
    return {"launches": launches, "H": H, "aet_dtype": np.dtype(aet).name,
            "encode_ms": enc_ms, "block_checks": checks,
            "rank_chain_ms": rc["ms"], "rank_chain_plain_ms": rc["plain_ms"],
            "decode_device_ms": dec_dev_ms,
            "wide_path_alone": parts,
            "decode_ms": dec_ms, "serialize_ms": ser_ms,
            "index_checks": index_checks_ms(dec.host_inputs),
            "decode_records_ms": rec_ms, "compression_ratio": ratio,
            "payload_bytes": len(payload), "wah_lines": n_wah,
            "sparse_lines": L - n_wah, "negated_lines": n_neg,
            "peak_device_gb": {"path": peak_gb, "encode_core": enc_peak_gb,
                               "decode": dec_peak_gb,
                               "encode_core_once": enc_core_peak,
                               "decode_device_once": dec_dev_peak}}


def to_device(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
            for a in arrays]


def track_block_phase(name: str, card: str) -> dict:
    """An exception-track block at 1KGP3 width (the 1KGP3 block's alleles):
    1KGP3-missing sets 1 % of entries missing (bench.py's missing regime),
    1KGP3-chrX gives the 1233 male samples end-of-vector in their second
    slot on every record.  Every record carries a track, so serialize()
    encodes them inside the block's own device run; the fused decode
    (_decode_block_full_gt_tracks) is held against the input too."""
    n_samples = 2504
    H = 2 * n_samples
    mac = int(H * 0.001)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    gt = (make_block(rng, H).astype(np.int32) + 1) << 1
    if name == "1KGP3-missing":
        for a in range(0, L, 512):          # bench.py:233-234, in slices
            part = gt[a:a + 512]
            part[rng.random(part.shape) < 0.01] = 0
    else:
        males = np.random.default_rng(SEED + 3).choice(n_samples, MALES,
                                                       replace=False)
        gt[:, 2 * np.sort(males) + 1] = INT32_VECTOR_END
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=mac,
              default_phasing=0, aet_dtype=np.uint16)
    print(f"[{name}] block of {L} x {H} made in "
          f"{time.perf_counter() - t0:.1f} s")
    ref_payload = host_reference(name, kw, gt)
    ingest = ingester(kw, gt.reshape(-1), np.full(L, H))
    enc = ingest()
    payload, launches, peak_gb = run_path(
        name, enc, lambda p: decoder_torch.decode_block_records(
            p, n_samples, H, np.uint16, [2] * L, device=DEVICE),
        ref_payload, gt)
    TRACK_PAYLOADS[name] = (payload, n_samples)    # for the native phase

    # ---- the fused decode, and the timings (bench.py's unit) ----------
    dec = decoder_torch.TorchBlockDecoder(payload, n_samples, H, np.uint16,
                                          device=DEVICE)
    m = dec.meta

    def carrier_pairs():
        out = []
        for stream, flags in ((m.missing_sparse, m.line_has_missing),
                              (m.eov_sparse, m.line_has_eov)):
            out += (decoder_torch.track_carriers(
                stream, np.flatnonzero(flags), np.uint16, dec.line_width)
                if flags is not None else [np.zeros(0, np.int64)] * 2)
        return out

    pairs = carrier_pairs()
    n_carriers = (len(pairs[0]), len(pairs[2]))
    *dstaged, h, w, _ = dec.device_inputs()
    pairs_dev = to_device(*pairs)
    gt_dev = decoder_torch._decode_block_full_gt_tracks(*dstaged, 0,
                                                        *pairs_dev, h, w)
    require(bool((gt_dev.cpu().numpy() == gt).all()),
            f"{name}: fused decode with track overlays is not bit-exact")
    del gt_dev

    def decode_once():
        dec.host_inputs()                 # the per-block host parse
        carrier_pairs()
        return decoder_torch._decode_block_full_gt_tracks(
            *dstaged, 0, *pairs_dev, h, w)

    torch.cuda.reset_peak_memory_stats()
    dec_ms = wall_ms(decode_once, iters=5, warmup=1)
    dec_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # its parts: the host's walk of the track streams, and the device
    walk_ms = wall_ms(carrier_pairs, iters=3, warmup=1)
    def decode_device():
        return decoder_torch._decode_block_full_gt_tracks(
            *dstaged, 0, *pairs_dev, h, w)

    dev_ms = cuda_ms(decode_device, iters=10, warmup=2)
    del dstaged, pairs_dev

    prep = enc.prepare()
    nm = len(prep["flag_m"])
    rows = prep["first_lines"][np.concatenate([prep["flag_m"],
                                               prep["flag_e"]])]
    trk_cap = enc.track_cap(prep, False)
    core = to_device(prep["alleles_p"], prep["alts_p"],
                     prep["wah_rows_p"].astype(np.int64), prep["sorts_w"],
                     prep["sparse_rows_p"].astype(np.int64),
                     prep["negated_s"], rows.astype(np.int64),
                     np.arange(len(rows)) >= nm)
    n_wah = prep["n_wah"]
    del prep, enc
    def encode_core():
        return encoder_torch.encode_block_core_compact_tracks(
            *core, max(mac, 1), trk_cap)

    torch.cuda.reset_peak_memory_stats()
    enc_ms = cuda_ms(encode_core, iters=10, warmup=2)
    enc_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with captured_args() as seen:
        encode_core()
    scans = scan_block_checks(name, seen, card)
    rc = scans["rank_chain"]
    del core, seen
    ser_ms = wall_ms(lambda: ingest().serialize(), iters=3, warmup=1)
    rec_ms = wall_ms(lambda: decoder_torch.decode_block_records(
        payload, n_samples, H, np.uint16, [2] * L, device=DEVICE),
        iters=3, warmup=1)
    gt_bytes = L * H * 4
    ratio = gt_bytes / len(payload)
    print(f"[{name}] block: {L} lines x {H} haplotypes; {n_wah} WAH lines; "
          f"track rows {len(rows)} (missing carriers {n_carriers[0]}, EOV "
          f"carriers {n_carriers[1]}, track cap {trk_cap}); payload "
          f"{len(payload)} B byte-equal to GtBlockEncoder's; decode "
          f"bit-exact on all {L} lines (decode_block_records and the fused "
          f"decode); peak device memory of the run {peak_gb:.3f} GB")
    print(f"[{name}] encode core with tracks: {enc_ms:.3f} ms/block = "
          f"{gt_bytes / enc_ms / 1e6:.2f} GB/s (peak {enc_peak_gb:.3f} GB), "
          f"of which the rank chain {rc['ms']:.3f} ms (its plain version "
          f"{rc['plain_ms']:.3f} ms) | fused decode with overlays (host "
          f"parse + device): "
          f"{dec_ms:.3f} ms/block = {gt_bytes / dec_ms / 1e6:.2f} GB/s (peak "
          f"{dec_peak_gb:.3f} GB), of which the host's track walk "
          f"{walk_ms:.1f} ms and the device {dev_ms:.3f} ms | serialize: "
          f"{ser_ms:.1f} ms | "
          f"decode_block_records: {rec_ms:.1f} ms | compression "
          f"{ratio:.2f}x ({card})")
    return {"launches": launches, "H": H, "encode_ms": enc_ms,
            "block_checks": list(scans.values()),
            "rank_chain_ms": rc["ms"], "rank_chain_plain_ms": rc["plain_ms"],
            "decode_ms": dec_ms, "decode_track_walk_ms": walk_ms,
            "index_checks": index_checks_ms(
                lambda: (dec.host_inputs(), carrier_pairs())),
            "decode_device_ms": dev_ms, "serialize_ms": ser_ms,
            "decode_records_ms": rec_ms, "compression_ratio": ratio,
            "payload_bytes": len(payload), "wah_lines": n_wah,
            "track_rows": len(rows), "track_cap": trk_cap,
            "missing_carriers": n_carriers[0],
            "eov_carriers": n_carriers[1],
            "peak_device_gb": {"path": peak_gb, "encode_core": enc_peak_gb,
                               "decode": dec_peak_gb}}


def mixed_block_phase(name: str, N: int, seed: int, card: str) -> dict:
    """A mixed-ploidy block of N male samples (2N haplotypes): lines 0-4095
    diploid (PAR1) and 4096-8191 haploid (non-PAR), bench.py's allele mix,
    MAF 0.001.  chrX-males-PAR has the 1233 males of 1KGP3,
    TOPMed-males-PAR the 48,628 of a TOPMed-size panel (32-bit streams).
    The mixed-ploidy encode (the encode chain with the parity payload, two
    WAH grids) and decode (per-line-width expand, the mixed scan's run
    route) run through TorchBlockEncoder.serialize and
    decode_block_records without offsets; their steps are timed one by
    one: the encode core, the parity route and the even-slot compaction
    alone, with their peaks, and the decode beside the same decode with
    the stepping kernel forced over all its lines.  At the wide block the
    host loops run once and the stepping kernel, which its path does not
    run, is timed over fewer calls and its plain version not at all."""
    H = 2 * N
    mac = int(H * 0.001)
    aet = aet_dtype_for(H)
    wide = H > 2 * 5008
    t0 = time.perf_counter()
    alleles = make_block(np.random.default_rng(seed), H)
    hap = np.arange(L) >= L // 2
    rows = [((alleles[i, :N] if hap[i] else alleles[i]).astype(np.int32)
             + 1) << 1 for i in range(L)]
    del alleles
    kw = dict(n_samples=N, block_bcf_lines=L, mac_threshold=mac,
              default_phasing=0, aet_dtype=aet)
    print(f"[{name}] block of {L} lines ({int(hap.sum())} haploid) x {H} "
          f"haplotypes made in {time.perf_counter() - t0:.1f} s")
    ref_payload = host_reference(name, kw, rows)
    ingest = ingester(kw, np.concatenate(rows), np.where(hap, N, H))
    enc = ingest()

    def records(p):
        return decoder_torch.decode_block_records(p, N, H, aet, [2] * L,
                                                  device=DEVICE)

    payload, launches, peak_gb = run_path(name, enc, records, ref_payload,
                                          rows)
    del rows

    # ---- timings, step by step (bench.py's unit) ----------------------
    loop = dict(iters=3, warmup=1) if wide else dict(iters=5, warmup=1)
    host_loop = dict(iters=1, warmup=0) if wide else dict(iters=3, warmup=1)
    prep = enc.prepare()
    is_wah, hap_l = prep["is_wah"], prep["hap_line"]
    wah_rows = np.flatnonzero(is_wah)
    sparse_rows = np.flatnonzero(~is_wah)
    hap_w = hap_l[wah_rows]
    args = to_device(prep["alleles_p"], prep["alts_p"], wah_rows,
                     np.flatnonzero(~hap_w), np.flatnonzero(hap_w),
                     sparse_rows, prep["negated"][sparse_rows],
                     hap_l[sparse_rows])
    n_wah, n_hap_wah = len(wah_rows), int(hap_w.sum())
    del prep, enc

    def encode_core():
        return encoder_torch.encode_block_core_mixed(*args, max(mac, 1))

    torch.cuda.reset_peak_memory_stats()
    enc_ms = cuda_ms(encode_core, **loop)
    enc_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    enc_core_peak = once_peak_gb(encode_core)
    aw, at = args[0].index_select(0, args[2]), args[1].index_select(0, args[2])
    ones = torch.ones(n_wah, dtype=torch.bool, device=DEVICE)

    def parity_route():
        return pbwt_torch.pbwt_encode_chunked(aw, at, ones, parity=True)

    # reads the WAH lines' alleles and flags and writes their bits, their
    # parities and the final arrangement
    nbytes = 3 * aw.numel() + at.nbytes + ones.nbytes + 8 * H
    parts = {"pbwt_encode_chunked(parity=True)": alone(
                 name, parity_route, nbytes,
                 "pbwt_encode_chunked(parity=True)", card)}
    ys, par, _ = parity_route()
    hy, hpar = ys.index_select(0, args[4]), par.index_select(0, args[4])
    del ys, par
    # reads the haploid lines' bits and parities, writes their even bits
    parts["even_slot_rows"] = alone(
        name, lambda: encoder_torch.even_slot_rows(hy, hpar),
        2 * hy.numel() + hy.shape[0] * N, "even_slot_rows", card)
    del hy, hpar
    # the path's own inputs of each kernel (captured after the peaks: the
    # copies are not the path's memory), checked before the decode's peaks
    with captured_args() as seen:
        encode_core()
    pchain = scan_block_checks(name, seen, card)["rank_chain"]
    seen.pop("rank_chain")
    checks = block_chain_checks(
        name, {"chain_encode_parity": seen.pop("chain_encode_parity")}, card)
    del args, aw, at
    ser_ms = wall_ms(lambda: ingest().serialize(), **host_loop)

    dec = decoder_torch.TorchBlockDecoder(payload, N, H, aet, device=DEVICE)
    *arrays, h, w_max, _ = dec.host_inputs_mixed()
    dargs = to_device(*arrays)
    hap_host = arrays[3]

    def decode_once():
        dec.host_inputs_mixed()           # the per-block host parse
        return decoder_torch._decode_block_mixed(*dargs, hap_host, h, w_max)

    def decode_device():
        return decoder_torch._decode_block_mixed(*dargs, hap_host, h, w_max)

    torch.cuda.reset_peak_memory_stats()
    dec_ms = wall_ms(decode_once, iters=host_loop["iters"], warmup=1)
    dec_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dec_dev_ms = cuda_ms(decode_device, iters=5 if wide else 10, warmup=2)
    dec_dev_peak = once_peak_gb(decode_device)
    # the device decode with the stepping kernel, the route of short runs,
    # forced over all the block's lines
    def stepping(ys, so, hp, _host, keep_final=True):
        return pbwt_kernels.decode_scan_mixed(ys, so, hp)
    with swapped(pbwt_torch, {"pbwt_decode_scan_mixed": stepping}):
        dec_dev_step_ms = cuda_ms(decode_device, iters=2 if wide else 10,
                                  warmup=1 if wide else 2)
        dec_dev_peak_step = once_peak_gb(decode_device)
    with captured_args() as seen_dec:
        decode_device()
    seen.update(seen_dec)
    stream, group_off, sorts, hap_wd = dargs[:4]
    seen["wah_expand_varw_bits"] = (stream, group_off, w_max, h)
    exp_ms = cuda_ms(lambda: wah_kernels.wah_expand_varw_bits(
        stream, group_off, w_max, h))
    # the scan at the block's own lines: the run route (and the run flush
    # at its runs), and the stepping kernel forced over the same lines
    ys_b, so_b, hp_b, host_b = seen["pbwt_decode_scan_mixed"][:4]
    droute, dflush = mixed_route_checks(name, ys_b, so_b, hp_b, host_b, card,
                                        step_iters=1 if wide else 5)
    droute["width"] = f"{name} block"
    for c in dflush:
        c["width"] = f"{name} block"
        c["default_route"] = not (c["haploid"] or wide)
        if wide:
            c["row"] = (f"{c['name']}@{name}"
                        + (" haploid" if c["haploid"] else ""))
        elif c["haploid"]:
            c["row"] = "decode_run_flush@haploid"
    dscan = None
    if not wide:
        seen["decode_scan_mixed"] = (ys_b, so_b, hp_b)
        dscan = scan_block_checks(name, seen, card)["decode_scan_mixed"]
    checks += (wah_block_checks(name, seen, card) + [pchain]
               + ([dscan] if dscan else []) + dflush + [droute])
    droute["default_route"] = False
    del dargs, seen, ys_b, so_b, hp_b
    rec_ms = wall_ms(lambda: records(payload), iters=1, warmup=0)
    gt_bytes = L * H * 4
    ratio = gt_bytes / len(payload)
    pc = next(c for c in checks if c["name"].startswith("chain_encode_par"))
    print(f"[{name}] block: {L} lines x {H} haplotypes; {n_wah} WAH lines "
          f"({n_hap_wah} haploid), {L - n_wah} sparse; payload "
          f"{len(payload)} B byte-equal to GtBlockEncoder's; decode without "
          f"offsets bit-exact on all {L} records; peak device memory of the "
          f"run {peak_gb:.3f} GB")
    print(f"[{name}] encode core (mixed): {enc_ms:.3f} ms/block = "
          f"{gt_bytes / enc_ms / 1e6:.2f} GB/s (peak {enc_peak_gb:.3f} GB) "
          f"| the parity route "
          f"{parts['pbwt_encode_chunked(parity=True)']['ms']:.3f} ms, of "
          f"which the rank chain {pchain['ms']:.3f} ms and {pc['name']} "
          f"{pc['ms']:.4f} ms | decode (host parse + device): "
          f"{dec_ms:.3f} ms/block = {gt_bytes / dec_ms / 1e6:.2f} GB/s (peak "
          f"{dec_peak_gb:.3f} GB), of which wah_expand_varw_bits "
          f"{exp_ms:.4f} ms and the mixed scan (run route, no final "
          f"arrangement) {droute['ms']:.3f} ms | "
          f"serialize: {ser_ms:.1f} ms | decode_block_records: {rec_ms:.1f} "
          f"ms | compression {ratio:.2f}x ({card})")
    plain_scan = ("" if dscan is None else
                  f", the stepping scan {dscan['plain_ms']:.3f} ms")
    print(f"[{name}] the plain versions alone: the rank chain "
          f"{pchain['plain_ms']:.3f} ms{plain_scan} ({card})")
    step_scan = ("" if dscan is None else
                 f"the scan {dscan['ms']:.3f} ms, ")
    print(f"[{name}] device alone: encode core peak {enc_core_peak:.3f} GB "
          f"| decode {dec_dev_ms:.3f} ms, peak {dec_dev_peak:.3f} GB; with "
          f"the stepping kernel forced over the block's lines: {step_scan}"
          f"the decode {dec_dev_step_ms:.3f} ms, peak "
          f"{dec_dev_peak_step:.3f} GB ({card})")
    return {"launches": launches, "H": H, "aet_dtype": np.dtype(aet).name,
            "encode_ms": enc_ms, "block_checks": checks,
            "parity_path_alone": parts,
            "decode_device_ms": dec_dev_ms,
            "decode_device_stepping_ms": dec_dev_step_ms,
            "encode_parity_route_ms":
                parts["pbwt_encode_chunked(parity=True)"]["ms"],
            "rank_chain_ms": pchain["ms"],
            "rank_chain_plain_ms": pchain["plain_ms"], "decode_ms": dec_ms,
            "index_checks": index_checks_ms(dec.host_inputs_mixed),
            "decode_expand_ms": exp_ms, "decode_scan_ms": droute["ms"],
            "decode_scan_with_final_ms": droute["ms_with_final"],
            "decode_scan_stepping_ms": droute["stepping_ms"],
            "decode_scan_plain_ms": dscan and dscan["plain_ms"],
            "serialize_ms": ser_ms, "decode_records_ms": rec_ms,
            "compression_ratio": ratio, "payload_bytes": len(payload),
            "wah_lines": n_wah, "haploid_wah_lines": n_hap_wah,
            "peak_device_gb": {"path": peak_gb, "encode_core": enc_peak_gb,
                               "decode": dec_peak_gb,
                               "encode_core_once": enc_core_peak,
                               "decode_device_once": dec_dev_peak,
                               "decode_device_once_stepping":
                                   dec_dev_peak_step}}


def file_phase(card: str, label: str = "file", missing_frac: float = 0.0,
               recompress: bool = False, samples: int = FILE_SAMPLES,
               records: int = FILE_RECORDS, keep: str | None = None) -> dict:
    """The CLI on files: -c on the card and on the host codec give the same
    .xsi bytes; -x on the card gives the input's genotypes back; with
    `recompress`, -x -O x re-encodes the .xsi on the card and on the host
    codec to the same bytes.  missing_frac of the entries are missing.
    `keep`: a directory the input, the card's .xsi (with its variant file
    and index) and its -x output are moved into, for the scale phase."""
    work = os.path.join(REPO, ".bench_work", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    secs = {}

    def path(f):
        return os.path.join(work, f)

    def cli(key, *args):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "xsqueezeit_tpu_torch.cli",
                        *args], cwd=REPO, check=True)
        secs[key] = time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        synth_bcf(path("in.bcf"), records, samples, seed=SEED,
                  missing_frac=missing_frac)
        secs["synth_bcf"] = time.perf_counter() - t0
        block = ["--variant-block-length", str(L)]
        cli("compress_cuda", "-c", "-f", path("in.bcf"), "-o",
            path("cuda.xsi"), "--device", DEVICE, *block)
        cli("compress_numpy", "-c", "-f", path("in.bcf"), "-o",
            path("numpy.xsi"), "--device", "numpy", *block)
        with open(path("cuda.xsi"), "rb") as a, \
                open(path("numpy.xsi"), "rb") as b:
            xsi_a, xsi_b = a.read(), b.read()
        require(xsi_a == xsi_b, f".xsi of --device {DEVICE} "
                                f"({len(xsi_a)} B) differs from --device "
                                f"numpy's ({len(xsi_b)} B)")
        cli("extract_cuda", "-x", "-f", path("cuda.xsi"), "-o",
            path("out.bcf"), "--device", DEVICE)
        t0 = time.perf_counter()
        src, out = GtInput(path("in.bcf")), GtInput(path("out.bcf"))
        n = bad = 0
        for a, b in zip(src, out):
            n += 1
            bad += int(a.n_alleles != b.n_alleles
                       or not np.array_equal(a.gt, b.gt))
        n_out = n + sum(1 for _ in out)
        src.close()
        out.close()
        secs["compare"] = time.perf_counter() - t0
        require(n == records and n_out == n and bad == 0,
                f"-x --device {DEVICE}: {bad} of {n} records differ "
                f"({n_out} records read back, {records} written)")
        same_as_source = None
        if recompress:
            outs = {}
            for device in (DEVICE, "numpy"):
                # one file name in two directories: the name is in the
                # variant file's header
                os.makedirs(path(device))
                cli(f"recompress_{device}", "-x", "-f", path("cuda.xsi"),
                    "-o", path(f"{device}/re.xsi"), "-O", "x", "--device",
                    device)
                with open(path(f"{device}/re.xsi"), "rb") as f:
                    outs[device] = f.read()
            require(outs[DEVICE] == outs["numpy"],
                    f"-x -O x: .xsi of --device {DEVICE} "
                    f"({len(outs[DEVICE])} B) differs from --device numpy's "
                    f"({len(outs['numpy'])} B)")
            same_as_source = outs[DEVICE] == xsi_a
        if keep is not None:
            shutil.rmtree(keep, ignore_errors=True)
            os.makedirs(keep)
            for f in ("in.bcf", "cuda.xsi", "cuda.xsi_var.bcf",
                      "cuda.xsi_var.bcf.csi", "out.bcf"):
                shutil.move(path(f), os.path.join(keep, f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    recomp = ("" if not recompress else
              f", -x -O x .xsi byte-identical across --device {DEVICE} / "
              f"numpy (equal to the source .xsi: {same_as_source})")
    print(f"[{label}] {records} records x {samples} samples "
          f"(missing fraction {missing_frac}), {len(xsi_a)} B .xsi "
          f"byte-identical across --device {DEVICE} / numpy, -x genotypes "
          f"equal on every record{recomp}; seconds: "
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})} ({card})")
    return {"xsi_bytes": len(xsi_a), "records": records,
            "samples": samples, "missing_frac": missing_frac,
            "recompressed_equals_source": same_as_source, "seconds": secs}


def write_haploid_bcf(path: str, n_samples: int, n_records: int,
                      seed: int) -> None:
    """A uniformly haploid BCF (one allele per sample on every record, no
    phase bit), written with the port's own BcfWriter and GT encoder, at
    synth_bcf's rare-heavy site-frequency mix."""
    rng = np.random.default_rng(seed)
    h = BcfHeader.from_text(
        "##fileformat=VCFv4.2\n"
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "##contig=<ID=X,length=155270560>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(f"M{i}" for i in range(n_samples)))
    kind = rng.random(n_records)
    freqs = np.where(kind < 0.55, rng.uniform(0.0, 0.0015, n_records),
                     np.where(kind < 0.80,
                              rng.uniform(0.0015, 0.05, n_records),
                              rng.uniform(0.05, 0.95, n_records)))
    gt = (bernoulli_rows(rng, freqs, n_samples).astype(np.int32) + 1) << 1
    w = BcfWriter(path, h)
    for i in range(n_records):
        shared = encode_shared_from_vcf_cols(
            h, ["X", str(2_800_000 + 29 * i), f"x{i}", "G", "A", ".",
                "PASS", "."], n_fmt=1, n_sample=n_samples)
        w.write_raw(shared, encode_gt_indiv(h, gt[i], 1, n_samples))
    w.close()


#: The tools phase: records Accessor.get_genotypes reads in a seeded
#: random order across both blocks, backward seeks included
#: (BASELINE.json config 4's random access).
TOOLS_ACCESSES = 48
#: dot_prod on the card against the host walk, per variant: relative
#: 1e-6 (float32 products of at most 5008 terms in [0, 1); one flipped
#: carrier moves a dot by its y, about 2e-4 of the largest); the checksum
#: within relative 1e-7.  The host walks over the .xsi and over the BCF
#: sum the same float64 terms in another order: 1e-12 per variant.
DOT_RTOL, CHECKSUM_RTOL, HOST_RTOL = 1e-6, 1e-7, 1e-12


def tools_phase(card: str) -> dict:
    """The random-access API and the tool suite on files (BASELINE.json
    config 4): the file phase's 1KGP3-width BCF (2504 samples x 16,384
    records, two 8192-record blocks) through `cli -c --device cuda`, then
    Accessor.get_genotypes on TOOLS_ACCESSES records in a seeded random
    order across both blocks (each equal to the input record), Xcf over
    the variant file and over the input in lockstep, loading_time, af_stats
    and dot_prod --device host on the .xsi and on the BCF, lockstep of the
    two, and dot_prod on the card (its default device) on the .xsi; then a
    uniformly haploid file (1233 samples x 8192 records, one block: 1KGP3's
    chrX males outside the PARs) through dot_prod on the card and on the
    host.  Every variant's dot on the card must be within relative
    DOT_RTOL of the host walk's and the checksum within CHECKSUM_RTOL; the
    host walks over the .xsi and the BCF agree per variant within HOST_RTOL
    and in the checksum to 1e-6 (one unit of its sixth decimal); every
    launch counter is set to 0 just before each dot_prod on the card and
    read just after: wah_expand_bits, chain_decode and the run flush once
    per block, the sparse-line kernel at most once (a block may hold no
    sparse line), the product kernel once per block, nothing else.  The counts are the tools' own: they stay out of the
    kernels line, which reads the block paths."""
    from xsqueezeit_tpu_torch.accessor import Accessor
    from xsqueezeit_tpu_torch.bench import tools
    from xsqueezeit_tpu_torch.cli import main as cli_main
    from xsqueezeit_tpu_torch.io.bcf import BcfReader
    from xsqueezeit_tpu_torch.mixed import Xcf

    work = os.path.join(REPO, ".bench_work", "chip_smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    secs = {}
    out = {}

    def path(f):
        return os.path.join(work, f)

    def timed(key, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        secs[key] = time.perf_counter() - t0
        return res

    def compress(src, dst):
        rc = cli_main(["-c", "-f", src, "-o", dst, "--device", DEVICE,
                       "--variant-block-length", str(L)])
        require(rc == 0, f"cli -c --device {DEVICE} of {src} exited {rc}")

    def max_rel(got, want):
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), np.finfo(float).tiny)))

    def dots(label, src, xsi, n_blocks, haploid):
        """dot_prod of the source and of the .xsi on the host, and of the
        .xsi on the card; the checks of the docstring."""
        plain = timed(f"{label}_dot_prod_source", tools.dot_prod, src,
                      device="host")
        host = timed(f"{label}_dot_prod_xsi", tools.dot_prod, xsi,
                     device="host")
        torch.cuda.synchronize()
        with no_plain_passes():
            reset_counts()
            card_res = timed(f"{label}_dot_prod_cuda", tools.dot_prod, xsi)
            torch.cuda.synchronize()
            launches = read_counts()
        sparse = launches.pop("sparse_lines")
        require(sparse <= n_blocks, f"{label}: {sparse} sparse-line "
                                    f"launches for {n_blocks} blocks")
        products = launches.pop("dot_rows")
        require(products == n_blocks, f"{label}: {products} product "
                                      f"launches for {n_blocks} blocks")
        ran = {k: v for k, v in launches.items() if v}
        want = {"wah_expand_bits": n_blocks, "chain_decode": n_blocks,
                "decode_run_flush": n_blocks}
        require(ran == want, f"{label}: dot_prod --device {DEVICE} "
                             f"launched {ran}, want {want}")
        require(plain["variants"] == host["variants"] == card_res["variants"]
                > 0, f"{label}: variant counts {plain['variants']} / "
                     f"{host['variants']} / {card_res['variants']}")
        require(card_res["device"] == DEVICE,
                f"{label}: dot_prod ran on {card_res['device']}")
        host_rel = max_rel(host["dots"], plain["dots"])
        require(host_rel <= HOST_RTOL
                and abs(host["checksum"] - plain["checksum"]) <= 1e-6 + 1e-8,
                f"{label}: host walks, .xsi vs source: per variant relative "
                f"{host_rel:.3g}, checksums {host['checksum']} vs "
                f"{plain['checksum']}")
        dot_rel = max_rel(card_res["dots"], host["dots"])
        rel = (abs(card_res["checksum"] - host["checksum"])
               / abs(host["checksum"]))
        require(dot_rel <= DOT_RTOL and rel <= CHECKSUM_RTOL,
                f"{label}: card vs host walk: per variant relative "
                f"{dot_rel:.3g} (limit {DOT_RTOL}), checksum "
                f"{card_res['checksum']} vs {host['checksum']} (relative "
                f"{rel:.3g}, limit {CHECKSUM_RTOL})")
        routes = {k: card_res[k] for k in ("device_blocks", "haploid_blocks",
                                           "mixed_blocks", "host_blocks")}
        want_routes = {"device_blocks": n_blocks,
                       "haploid_blocks": n_blocks if haploid else 0,
                       "mixed_blocks": 0, "host_blocks": 0}
        require(routes == want_routes,
                f"{label}: routes {routes}, want {want_routes}")
        print(f"[tools] {label}: dot_prod of {host['variants']} variants: "
              f"checksum source {plain['checksum']}, .xsi host "
              f"{host['checksum']}, .xsi --device {DEVICE} "
              f"{card_res['checksum']} (relative {rel:.3g}; per variant "
              f"max relative {dot_rel:.3g}, host walks {host_rel:.3g}); "
              f"seconds "
              f"{plain['seconds']:.3f} / {host['seconds']:.3f} / "
              f"{card_res['seconds']:.3f}; routes {routes}; launches {ran}")
        return {"variants": host["variants"], "checksum_source":
                plain["checksum"], "checksum_host": host["checksum"],
                "checksum_card": card_res["checksum"], "relative": rel,
                "dot_max_relative": dot_rel, "host_max_relative": host_rel,
                "launches": ran, **routes}

    try:
        src, xsi = path("in.bcf"), path("o.xsi")
        timed("synth_bcf", synth_bcf, src, FILE_RECORDS, FILE_SAMPLES,
              seed=SEED)
        timed("compress_cuda", compress, src, xsi)

        # random access: the sampled input records, then the Accessor
        rng = np.random.default_rng(SEED)
        order = rng.choice(FILE_RECORDS, TOOLS_ACCESSES, replace=False)
        wanted = set(order.tolist())
        inp = GtInput(src)
        want = {i: r.gt for i, r in enumerate(inp) if i in wanted}
        inp.close()
        reader = BcfReader(xsi + "_var.bcf")
        recs = list(reader)
        reader.close()
        acc = Accessor(xsi)
        block_of = [acc.split_bm(acc.position_from_bm_entry(recs[i]))[0]
                    for i in order]
        blocks_hit = set(block_of)
        backward = sum(int(b0 == b1 and i1 < i0) for i0, i1, b0, b1 in
                       zip(order, order[1:], block_of, block_of[1:]))
        t0 = time.perf_counter()
        bad = sum(int(not np.array_equal(acc.get_genotypes(recs[i]),
                                         want[i])) for i in order)
        secs["accessor_random"] = time.perf_counter() - t0
        require(bad == 0 and blocks_hit == {0, 1} and backward > 0,
                f"Accessor: {bad} of {TOOLS_ACCESSES} records differ "
                f"(blocks {sorted(blocks_hit)}, {backward} backward seeks)")
        out["accessor"] = {"records": TOOLS_ACCESSES,
                           "backward_seeks": backward,
                           "ms_per_record": secs["accessor_random"] * 1e3
                           / TOOLS_ACCESSES}

        # Xcf: the variant file (Accessor route) and the input, in lockstep
        t0 = time.perf_counter()
        x = Xcf()
        i_var, i_src = x.add_reader(xsi + "_var.bcf"), x.add_reader(src)
        require(x[i_var].is_xsi and not x[i_src].is_xsi,
                "Xcf: routes of the variant file and the input")
        n = bad = 0
        for (_, a), (_, b) in zip(x[i_var], x[i_src]):
            n += 1
            bad += int(not np.array_equal(a, b))
        x.close()
        secs["xcf_lockstep"] = time.perf_counter() - t0
        require(n == FILE_RECORDS and bad == 0,
                f"Xcf: {bad} of {n} records differ")

        lt = {k: timed(f"loading_time_{k}", tools.loading_time, p)
              for k, p in (("xsi", xsi), ("bcf", src))}
        require(lt["xsi"]["records"] == lt["bcf"]["records"] == FILE_RECORDS
                and lt["xsi"]["gt_entries"] == lt["bcf"]["gt_entries"],
                f"loading_time: {lt}")
        af = {k: timed(f"af_stats_{k}", tools.af_stats, p)
              for k, p in (("xsi", xsi), ("bcf", src))}
        require(af["xsi"]["stats"] == af["bcf"]["stats"],
                "af_stats: the .xsi's counts differ from the BCF's")
        lock = timed("lockstep", tools.lockstep_load, src, xsi)
        require(lock["identical"] and lock["records"] == FILE_RECORDS,
                f"lockstep: {lock}")
        out["loading_time"] = {k: {"gt_per_second": v["gt_per_second"],
                                   "seconds": v["seconds"]}
                               for k, v in lt.items()}
        out["af_stats"] = {k: {"logical_gb_s": v["logical_gb_s"],
                               "seconds": v["seconds"]}
                           for k, v in af.items()}
        out["lockstep_seconds"] = lock["seconds"]
        print(f"[tools] 1KGP3 file ({FILE_SAMPLES} samples x {FILE_RECORDS} "
              f"records, 2 blocks): Accessor {TOOLS_ACCESSES} records in "
              f"random order equal; Xcf lockstep equal; loading_time "
              f"gt_per_second .xsi {lt['xsi']['gt_per_second']:.4g}, BCF "
              f"{lt['bcf']['gt_per_second']:.4g}; af_stats equal, "
              f"logical_gb_s .xsi {af['xsi']['logical_gb_s']}, BCF "
              f"{af['bcf']['logical_gb_s']}; lockstep identical")
        out["1KGP3"] = dots("1KGP3", src, xsi, 2, False)

        hsrc, hxsi = path("males.bcf"), path("males.xsi")
        timed("synth_haploid", write_haploid_bcf, hsrc, MALES, L, SEED + 7)
        timed("compress_haploid_cuda", compress, hsrc, hxsi)
        out["haploid"] = dots("chrX-males", hsrc, hxsi, 1, True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {
        "accessor_ms_per_record": out["accessor"]["ms_per_record"],
        "gt_per_second": {k: v["gt_per_second"]
                          for k, v in out["loading_time"].items()},
        "logical_gb_s": {k: v["logical_gb_s"]
                         for k, v in out["af_stats"].items()},
        "dot_prod_seconds": {k: v for k, v in secs.items()
                             if "dot_prod" in k},
        "dot_prod_launches": {k: out[k]["launches"]
                              for k in ("1KGP3", "haploid")},
        "seconds": secs}
    print(f"[tools] {json.dumps(summary)} ({card})")
    return {**out, "seconds": secs}


#: The scale phase: the file phase's outputs are kept here.
SCALE_WORK = os.path.join(REPO, ".bench_work", "chip_smoke_scale")
#: Ranks of the multi-process runs, all on the one card.
SCALE_RANKS = 2
#: The scaling tool's size: 1KGP3 width, four 1024-record blocks.
SCALING_ARGS = ("--records", "4096", "--samples", str(FILE_SAMPLES),
                "--block-length", "1024", "--procs", "1,2")
#: Seconds a rank, or the scaling tool, may take before it is killed.
RANK_TIMEOUT, SCALING_TIMEOUT = 600, 900
ENCODE_ROUTES = ("chain_encode", "wah_compress_bits", "rank_chain")
DECODE_ROUTES = ("wah_expand_bits", "chain_decode", "decode_run_flush")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args: list[str], label: str) -> tuple[float, list[dict]]:
    """SCALE_RANKS processes of `cli ARGS --distributed` side by side (gloo
    on localhost, every rank on the card), each with -v; returns the wall
    seconds and each rank's perf line.  A rank that fails or outlives
    RANK_TIMEOUT fails the phase; every rank is ended before returning."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "xsqueezeit_tpu_torch.cli", *args, "-v",
         "--device", DEVICE, "--distributed", f"127.0.0.1:{port}",
         "--dist-nproc", str(SCALE_RANKS), "--dist-procid", str(i)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(SCALE_RANKS)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                raise SystemExit(f"chip_smoke: FAIL: {label}: a rank ran "
                                 f"over {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    perfs = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"{label}: rank {i} exited "
                                   f"{p.returncode}:\n{out[-3000:]}")
        tag = f"xsqueezeit: rank {i}/{SCALE_RANKS} perf "
        lines = [l for l in out.splitlines() if l.startswith(tag)]
        require(len(lines) == 1, f"{label}: rank {i} printed no perf line")
        perfs.append(json.loads(lines[0][len(tag):]))
    return wall, perfs


def rank_launches(label: str, perfs: list[dict], routes) -> list[dict]:
    """Each rank's kernel launches; every one of `routes` must have run in
    every rank."""
    got = [p["launches"] for p in perfs]
    for i, ran in enumerate(got):
        missing = [r for r in routes if not ran.get(r)]
        require(not missing, f"{label}: rank {i} launched {ran}, never "
                             f"{missing}")
    return got


def same_records(a: str, b: str, label: str, genotypes: bool) -> int:
    """Record-by-record equality of two BCFs: genotypes and allele counts
    (an extract), or the raw shared and indiv blocks (a variant file)."""
    from xsqueezeit_tpu_torch.io.bcf import BcfReader
    if genotypes:
        ra, rb = GtInput(a), GtInput(b)
        key = (lambda r: (r.n_alleles, r.gt.tobytes()))
    else:
        ra, rb = BcfReader(a), BcfReader(b)
        key = (lambda r: (r.shared, r.indiv))
    try:
        ka, kb = [key(r) for r in ra], [key(r) for r in rb]
    finally:
        ra.close()
        rb.close()
    bad = sum(int(x != y) for x, y in zip(ka, kb))
    require(len(ka) == len(kb) == FILE_RECORDS and bad == 0,
            f"{label}: {bad} records differ ({len(ka)} vs {len(kb)})")
    return len(ka)


def scale_phase(card: str) -> dict:
    """Scale-out on the file phase's input (2504 samples x 16,384 phased
    records, two 8192-record blocks), the file phase's single-process
    `cli -c --device cuda` .xsi and its `cli -x` BCF the reference:
    (a) compress_file and Decompressor in this process with the device
        pool [cuda:0, cuda:0] (parallel/shard: a worker thread per pool
        entry, both on the card) and, in turns with it, on [cuda:0] alone
        (one, pool, pool, one; one device is a pool of one, batches of
        one block), then once over the pool of two devices [cuda:0, cpu]
        (block 0 on the card, block 1 through the plain versions on the
        host): .xsi byte-equal, records equal; every launch counter is
        set to 0 just before each run and read just after (chain_encode
        and wah_compress_bits, then wah_expand_bits, chain_decode and
        the run flush, must have launched);
    (b) SCALE_RANKS processes of `cli -c --distributed` (torch.distributed,
        gloo, both ranks on the card): .xsi byte-equal, _var.bcf records
        equal (its BGZF framing differs at the rank join);
    (c) SCALE_RANKS processes of `cli -x -O b --distributed`: records
        equal to the single-process -x;
    (d) `python -m xsqueezeit_tpu_torch.bench scaling --device cuda` at
        SCALING_ARGS (its own byte-identity check at every process
        count), its line printed.
    Each rank's perf (seconds of scan, encode, gather, assembly) and
    kernel launches are printed: every rank must have launched the
    encode routes (b) or the decode routes (c).  These counts are the
    phase's own and stay out of the kernels line."""
    from xsqueezeit_tpu_torch.codec.compressor import (
        CompressorOptions,
        compress_file,
    )
    from xsqueezeit_tpu_torch.codec.decompressor import (
        Decompressor,
        DecompressorOptions,
    )

    pool = (f"{DEVICE}:0",) * SCALE_RANKS
    mixed = (f"{DEVICE}:0", "cpu")
    secs, out = {}, {}

    def path(f):
        return os.path.join(SCALE_WORK, f)

    try:
        with open(path("cuda.xsi"), "rb") as f:
            ref_xsi = f.read()
        os.makedirs(path("pool"))

        def compress(devices):
            compress_file(path("in.bcf"), path("pool/o.xsi"),
                          CompressorOptions(block_length=L, device=DEVICE,
                                            devices=devices))

        def compressed(devices):
            with open(path("pool/o.xsi"), "rb") as f:
                require(f.read() == ref_xsi, "(a) compress_file over "
                                             f"{devices}: .xsi differs")

        def extract(devices):
            Decompressor(path("cuda.xsi"), DecompressorOptions(
                device=DEVICE, devices=devices)).decompress(path("pool.bcf"))

        def extracted(devices):
            same_records(path("pool.bcf"), path("out.bcf"),
                         f"(a) extract over {devices}", True)

        launched = {}

        def turn(key, fn, check, routes, devices, kind, suffix=""):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            fn(devices)
            torch.cuda.synchronize()
            secs[f"a_{key}_{kind}{suffix}"] = time.perf_counter() - t0
            ran = {k: v for k, v in read_counts().items() if v}
            check(devices)
            missing = [r for r in routes if not ran.get(r)]
            require(not missing, f"(a) {key} over {list(devices)} launched "
                                 f"{ran}, never {missing}")
            launched[f"{key}_{kind}"] = ran

        steps = (("compress", compress, compressed, ENCODE_ROUTES),
                 ("extract", extract, extracted, DECODE_ROUTES))
        with no_plain_passes():
            for step in steps:
                for k, devices in enumerate((pool[:1], pool, pool,
                                             pool[:1])):
                    turn(*step, devices,
                         "pool" if len(devices) > 1 else "one", f"_{k}")
        # the host half of the mixed pool runs the plain versions
        for step in steps:
            turn(*step, mixed, "mixed")
        enc, dec = launched["compress_pool"], launched["extract_pool"]
        out["pool"] = {"devices": list(pool), "compress_launches": enc,
                       "extract_launches": dec, "mixed_devices": list(mixed),
                       "mixed_compress_launches": launched["compress_mixed"],
                       "mixed_extract_launches": launched["extract_mixed"]}

        os.makedirs(path("ranks"))
        block = ["--variant-block-length", str(L)]
        secs["b_compress_ranks"], perf_c = run_ranks(
            ["-c", "-f", path("in.bcf"), "-o", path("ranks/o.xsi"),
             *block], "(b) cli -c --distributed")
        with open(path("ranks/o.xsi"), "rb") as f:
            require(f.read() == ref_xsi,
                    "(b) cli -c --distributed: .xsi differs")
        same_records(path("ranks/o.xsi_var.bcf"),
                     path("cuda.xsi_var.bcf"), "(b) _var.bcf", False)
        out["compress_ranks"] = {"perf": perf_c, "launches": rank_launches(
            "(b) cli -c --distributed", perf_c, ENCODE_ROUTES)}

        secs["c_extract_ranks"], perf_x = run_ranks(
            ["-x", "-f", path("cuda.xsi"), "-o", path("ranks.bcf"),
             "-O", "b"], "(c) cli -x -O b --distributed")
        same_records(path("ranks.bcf"), path("out.bcf"),
                     "(c) cli -x -O b --distributed", True)
        out["extract_ranks"] = {"perf": perf_x, "launches": rank_launches(
            "(c) cli -x --distributed", perf_x, DECODE_ROUTES)}

        t0 = time.perf_counter()
        # its own session: a timeout ends the tool and its workers
        proc = subprocess.Popen(
            [sys.executable, "-m", "xsqueezeit_tpu_torch.bench", "scaling",
             *SCALING_ARGS, "--device", DEVICE, "--dir", path("scaling")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=SCALING_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise SystemExit(f"chip_smoke: FAIL: (d) bench scaling ran over "
                             f"{SCALING_TIMEOUT} s")
        secs["d_scaling"] = time.perf_counter() - t0
        require(proc.returncode == 0, f"(d) bench scaling exited "
                                      f"{proc.returncode}: "
                                      f"{stderr.strip()[-2000:]}")
        line = (stdout.strip().splitlines() or [""])[-1]
        scaling = json.loads(line)
        require(scaling["byte_identical"] is True
                and [r["procs"] for r in scaling["curve"]] == [1, 2],
                f"(d) bench scaling: {line[:500]}")
        for r in scaling["curve"]:
            rank_launches(f"(d) scaling at {r['procs']} processes",
                          [{"launches": x} for x in r["launches"]],
                          ENCODE_ROUTES)
        print(f"[scale] (d) {line}")
        out["scaling"] = scaling
    finally:
        shutil.rmtree(SCALE_WORK, ignore_errors=True)
    print(f"[scale] (a) pool {list(pool)}: .xsi byte-equal, -x records "
          f"equal; launches compress {enc}, extract {dec}")
    print(f"[scale] (a) pool {list(mixed)}: .xsi byte-equal, -x records "
          f"equal; launches compress {out['pool']['mixed_compress_launches']}"
          f", extract {out['pool']['mixed_extract_launches']}")
    for label, key in (("(b) -c", "compress_ranks"),
                       ("(c) -x -O b", "extract_ranks")):
        for i, perf in enumerate(out[key]["perf"]):
            print(f"[scale] {label} rank {i}/{SCALE_RANKS} perf "
                  f"{json.dumps(perf)}")
    print(f"[scale] seconds {json.dumps(secs)} ({card})")
    return {**out, "seconds": secs}


#: The keys of root bench.py's JSON line (bench.py:407-427), which the
#: port's headline benchmark keeps.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "encode_gbps",
              "decode_gbps", "missing_encode_gbps", "missing_decode_gbps",
              "missing_records_ms", "missing_prepare_ms",
              "missing_assemble_ms", "compression_ratio")


def bench_phase(card: str) -> dict:
    """The port's headline benchmark as a user runs it, in a process of its
    own (python -m xsqueezeit_tpu_torch.bench.headline, bench.py's
    workload, its own bit-exact checks): exit 0 and a JSON line with
    bench.py's keys are required; the line is printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "xsqueezeit_tpu_torch.bench.headline"],
        cwd=REPO, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"bench.headline exited {proc.returncode}: "
            f"{proc.stderr.strip()[-2000:]}")
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        result = json.loads(line)
    except json.JSONDecodeError:
        raise SystemExit(f"chip_smoke: FAIL: bench.headline printed no JSON "
                         f"line (last line {line[:200]!r})")
    missing = [k for k in BENCH_KEYS if k not in result]
    require(not missing, f"bench.headline's line lacks {missing}")
    print(f"[bench] {line}")
    print(f"[bench] python -m xsqueezeit_tpu_torch.bench.headline: exit 0 in "
          f"{secs:.1f} s ({card})")
    return result


NATIVE_WORK = os.path.join(REPO, ".bench_work", "chip_smoke_native")
#: the 1KGP3-chrX block's decode with the lifting walk, PERF.md section 5
RUN_D_CHRX_DECODE_MS = 1203.0


@contextlib.contextmanager
def environ(**kw):
    """os.environ with `kw` set (None: unset) for the block's duration."""
    old = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def native_build_phase() -> dict:
    """The port's native host library, built from
    xsqueezeit_tpu_torch/native with g++ (its own copy of native/): the
    machine's compiler and headers, then both libraries, forced."""
    from xsqueezeit_tpu_torch.interop import native

    gxx = run([native.CXX, "--version"]).splitlines()[0]
    headers = {h: native._compiles((), f"#include <{h}>\nint main()"
                                       "{return 0;}\n")
               for h in ("zlib.h", "zstd.h", "libdeflate.h")}
    import ctypes.util
    libz = ctypes.util.find_library("z")
    flags, libs = native.build_flags()
    secs = {}
    for name, fn in (("libxsqueezeit_tpu", native.build_native),
                     ("libxsqueezeit", native.build_c_api)):
        fn(force=True)
        secs[name] = native.last_build_seconds
    native.load_library()
    print(f"[native] {gxx}; headers {json.dumps(headers)}; libz: {libz}; "
          f"flags {' '.join(flags)} {' '.join(libs)}; build seconds "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    require(headers["zlib.h"] and libz is not None,
            "zlib.h or libz.so.1 missing: the native library cannot build")
    return {"gxx": gxx, "headers": headers, "libz": libz,
            "flags": flags + libs, "build_seconds": secs}


def native_phase(card: str) -> dict:
    """The native host library on the file phase's input (2504 samples x
    16,384 phased records, two 8192-record blocks, kept in SCALE_WORK):
    `cli -c --device cuda` with the native routes on, with XSI_NATIVE=0,
    and `--device numpy` (the native block encoder) in this process:
    .xsi, _var.bcf and .csi byte-equal across the three, chain_encode and
    wah_compress_bits launched once per block on both cuda runs (every
    counter set to 0 just before each run and read just after); `cli -x
    --device cuda` to VCF (native offsets walk and GT formatter) and `cli
    -x --device numpy` to BCF (the native extract loop), each with the
    input's records and genotypes; the host ingest of the first block
    (TorchBlockEncoder.encode_records) with the native ingest and with
    NumPy's; the 1KGP3-chrX block's host parse (TorchBlockDecoder's
    host inputs and the track walk) with the native offsets walk and with
    the lifting walk, carriers equal; c_api_test and c_xcf_test built with
    gcc against the port's libraries and run on the .xsi, their genotypes
    the Accessor's; and `bench loading_time --native` on it.  Wall times
    are printed beside the card."""
    from xsqueezeit_tpu_torch import cli
    from xsqueezeit_tpu_torch.accessor import Accessor
    from xsqueezeit_tpu_torch.bench import tools
    from xsqueezeit_tpu_torch.interop import native
    from xsqueezeit_tpu_torch.io.bcf import BcfReader

    src = os.path.join(SCALE_WORK, "in.bcf")
    shutil.rmtree(NATIVE_WORK, ignore_errors=True)
    os.makedirs(NATIVE_WORK)
    secs, launches = {}, {}
    flags, _ = native.build_flags()
    # the emitter's bytes are zlib's (the Python writer's) unless the
    # build found libdeflate; then its zlib mode is asked for
    zlib_mode = "1" if "-DUSE_LIBDEFLATE" in flags else None

    def path(*f):
        return os.path.join(NATIVE_WORK, *f)

    def run_cli(key, args, **env):
        reset_counts()
        t0 = time.perf_counter()
        with environ(XSI_EMIT_ZLIB=zlib_mode, **env):
            rc = cli.main(args)
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        launches[key] = {k: v for k, v in read_counts().items() if v}
        require(rc == 0, f"[native] cli {' '.join(args)}: exit {rc}")

    def read(f):
        with open(f, "rb") as fh:
            return fh.read()

    try:
        n_blocks = -(-FILE_RECORDS // L)
        runs = (("native", DEVICE, {}), ("off", DEVICE, {"XSI_NATIVE": "0"}),
                ("numpy", "numpy", {}))
        for key, device, env in runs:
            os.makedirs(path(key))
            run_cli(f"compress_{key}", ["-c", "-f", src, "-o",
                                        path(key, "o.xsi"), "--device",
                                        device, "--variant-block-length",
                                        str(L)], **env)
        for sfx in ("", "_var.bcf", "_var.bcf.csi"):
            a = read(path("native", "o.xsi" + sfx))
            for key in ("off", "numpy"):
                require(read(path(key, "o.xsi" + sfx)) == a,
                        f"[native] o.xsi{sfx}: -c {key} differs from -c "
                        "with the native routes")
        for key in ("compress_native", "compress_off"):
            for route in ENCODE_ROUTES:
                require(launches[key].get(route) == n_blocks,
                        f"[native] {key}: {route} launched "
                        f"{launches[key].get(route)} times, not once per "
                        f"block ({n_blocks})")
        xsi = path("native", "o.xsi")
        run_cli("extract_cuda_vcf", ["-x", "-f", xsi, "-o",
                                     path("out.vcf"), "--device", DEVICE])
        run_cli("extract_numpy_bcf", ["-x", "-f", xsi, "-o",
                                      path("out.bcf"), "--device", "numpy"])
        t0 = time.perf_counter()
        for out in ("out.vcf", "out.bcf"):
            a_in, b_in = GtInput(src), GtInput(path(out))
            n = bad = 0
            for a, b in zip(a_in, b_in):
                n += 1
                bad += int(a.n_alleles != b.n_alleles
                           or not np.array_equal(a.gt, b.gt))
            n += sum(1 for _ in b_in)
            a_in.close()
            b_in.close()
            require(n == FILE_RECORDS and bad == 0,
                    f"[native] -x to {out}: {bad} records differ, {n} read")
        secs["compare_extracts"] = time.perf_counter() - t0

        # ---- the host ingest of one block, native and NumPy ----------
        inp = GtInput(src)
        gt_all, offs, na, _, n = next(inp.iter_gt_batches())
        inp.close()
        n_samples = FILE_SAMPLES
        kw = dict(n_samples=n_samples, block_bcf_lines=L,
                  mac_threshold=int(2 * n_samples * 0.001),
                  default_phasing=1, aet_dtype=np.uint16)

        def ingest():
            enc = encoder_torch.TorchBlockEncoder(device=DEVICE, **kw)
            enc.encode_records(gt_all, offs, na, 0, min(n, L))
            return enc

        ingest_ms = {}
        for key, env in (("native", {}), ("numpy", {"XSI_NATIVE": "0"})):
            with environ(**env):
                ingest_ms[key] = wall_ms(ingest, iters=3, warmup=1)
        with environ(XSI_NATIVE="0"):
            want = ingest().serialize()
        require(ingest().serialize() == want,
                "[native] payload of the native ingest differs from NumPy's")

        # ---- the chrX block's host parse, native and lifting ---------
        payload, n_chrx = TRACK_PAYLOADS["1KGP3-chrX"]
        H = 2 * n_chrx
        dec = decoder_torch.TorchBlockDecoder(payload, n_chrx, H, np.uint16,
                                              device=DEVICE)
        m = dec.meta

        def parse():
            dec.host_inputs()
            return [decoder_torch.track_carriers(s, np.flatnonzero(f),
                                                 np.uint16, dec.line_width)
                    for s, f in ((m.missing_sparse, m.line_has_missing),
                                 (m.eov_sparse, m.line_has_eov))
                    if f is not None]

        parse_ms, carriers = {}, {}
        for key, env in (("native", {}), ("lifting", {"XSI_NATIVE": "0"})):
            with environ(**env):
                carriers[key] = parse()
                parse_ms[key] = wall_ms(parse, iters=3, warmup=1)
        require(len(carriers["native"]) == len(carriers["lifting"]) and all(
            np.array_equal(x, y) for a, b in zip(carriers["native"],
                                                 carriers["lifting"])
            for x, y in zip(a, b)),
            "[native] chrX carriers of the native walk differ from the "
            "lifting walk's")
        with environ(XSI_NATIVE="0"):
            want = decoder_torch.decode_block_records(
                payload, n_chrx, H, np.uint16, [2] * L, device=DEVICE)
        t0 = time.perf_counter()
        got = decoder_torch.decode_block_records(
            payload, n_chrx, H, np.uint16, [2] * L, device=DEVICE)
        secs["chrx_decode_records_native"] = time.perf_counter() - t0
        require(all(np.array_equal(a, b) for a, b in zip(got, want))
                and len(got) == len(want) == L,
                "[native] chrX decode_block_records differs between walks")
        del got, want

        # ---- the C API programs ---------------------------------------
        t0 = time.perf_counter()
        progs = native.build_c_api_tests(NATIVE_WORK)
        secs["build_c_api_tests"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_api = run([progs["c_api_test"], xsi])
        out_xcf = run([progs["c_xcf_test"], xsi + "_var.bcf"])
        secs["c_programs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc = Accessor(xsi)
        reader = BcfReader(acc.variant_filename())
        chk, total = [], 0
        for rec in reader:
            g = acc.get_genotypes(rec).astype(np.int64)
            total += int(g.sum())
            chk.append(int((g * np.arange(1, g.shape[0] + 1)).sum()))
        reader.close()
        secs["accessor_walk"] = time.perf_counter() - t0
        got = [int(line.split()[-1]) for line in out_xcf.splitlines()
               if line.startswith("record ")]
        require(f"records_read={FILE_RECORDS} gt_checksum={total}"
                in out_api, f"[native] c_api_test: {out_api.strip()[-200:]}")
        require(got == chk, f"[native] c_xcf_test: {len(got)} checksums, "
                            f"{sum(a != b for a, b in zip(got, chk))} "
                            "differ from the Accessor's")

        lt = tools.loading_time(xsi, native=True)
        require(lt["records"] == FILE_RECORDS,
                f"[native] loading_time --native read {lt['records']}")
    finally:
        shutil.rmtree(NATIVE_WORK, ignore_errors=True)
    print(f"[native] {FILE_RECORDS} records x {FILE_SAMPLES} samples: -c "
          f"--device {DEVICE} native / XSI_NATIVE=0 / --device numpy "
          f".xsi, _var.bcf, .csi byte-equal (XSI_EMIT_ZLIB={zlib_mode}); "
          f"launches {json.dumps({k: launches[k] for k in launches})}; -x "
          f"--device {DEVICE} to VCF and --device numpy to BCF: the input's "
          "genotypes on every record; c_api_test and c_xcf_test equal to "
          "the Accessor on every record")
    print(f"[native] seconds: "
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    print(f"[native] host ingest of one {L}-record block "
          f"(encode_records): native {ingest_ms['native']:.1f} ms, NumPy "
          f"{ingest_ms['numpy']:.1f} ms | 1KGP3-chrX host parse (host "
          f"inputs + track walk): native {parse_ms['native']:.1f} ms, "
          f"lifting {parse_ms['lifting']:.1f} ms (run D's whole decode: "
          f"{RUN_D_CHRX_DECODE_MS} ms) | loading_time --native "
          f"{json.dumps(lt)} ({card})")
    return {"seconds": secs, "launches": launches, "ingest_ms": ingest_ms,
            "chrx_parse_ms": parse_ms, "loading_time_native": lt,
            "emit_zlib": zlib_mode}


#: The corrupt phase: the file-wide phase's TOPMed-width outputs are kept
#: here, and the phase's containers written here.
WIDE_WORK = os.path.join(REPO, ".bench_work", "chip_smoke_wide")
CORRUPT_WORK = os.path.join(REPO, ".bench_work", "chip_smoke_corrupt")
#: Samples and records of the corrupt phase's containers (H = 512, blocks
#: of 32 records).
CORRUPT_SAMPLES, CORRUPT_RECORDS, CORRUPT_BLOCK = 256, 96, 32


def cli_in_process(args: list[str]) -> tuple[int, list[str]]:
    """`cli.main(args)` in this process: its exit code and the non-empty
    lines it wrote to standard error."""
    import io

    from xsqueezeit_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, [l for l in err.getvalue().splitlines() if l.strip()]


def corrupt_stream_checks() -> dict:
    """The decode kernels on corrupt streams (bench/corrupt.wah_streams:
    random u16 words, a well-formed stream cut short, counters of 16,383
    groups past their line), against their plain versions on the CPU,
    bit-exact: wah_expand_bits (a warp per line at H = 512, a CTA per line
    at TOPMed's 194,512) and wah_expand_varw_bits (lines of 256 and 512
    bits), then chain_decode and the run flush (pbwt_decode_chunked) on
    each expansion."""
    from xsqueezeit_tpu_torch.bench import corrupt

    rng = np.random.default_rng(SEED + 15)
    cases = 0
    for n_lines, h in ((64, 512), (4, 2 * TOPMED_SAMPLES)):
        w = wah_torch.n_words_for(h)
        for kind, s in corrupt.wah_streams(rng, n_lines, w).items():
            st = torch.from_numpy(s.astype(np.int32)).to(torch.uint16)
            want = wah_torch.wah_expand_stream_bits(st, n_lines, w, h)
            got = wah_kernels.wah_expand_bits(st.to(DEVICE), n_lines, w, h)
            require(diff(got.cpu(), want) == 0,
                    f"[corrupt] wah_expand_bits on a {kind} stream "
                    f"({n_lines} x {h}) differs from its plain version")
            sorts = torch.ones(n_lines, dtype=torch.bool)
            dv, _ = pbwt_torch.pbwt_decode_chunked(got, sorts.to(DEVICE))
            pv, _ = pbwt_torch.pbwt_decode_chunked(want, sorts)
            require(diff(dv.cpu(), pv) == 0,
                    f"[corrupt] chain_decode on a {kind} stream's "
                    f"expansion ({n_lines} x {h}) differs from its plain "
                    "version")
            cases += 1
            if h != 512:
                continue
            hap = np.arange(n_lines) % 3 == 2
            goff = np.zeros(n_lines + 1, np.int64)
            np.cumsum(np.where(hap, wah_torch.n_words_for(h // 2), w),
                      out=goff[1:])
            go = torch.from_numpy(goff)
            want = wah_torch.wah_expand_stream_varw_bits(st, go, w, h)
            got = wah_kernels.wah_expand_varw_bits(st.to(DEVICE),
                                                   go.to(DEVICE), w, h)
            require(diff(got.cpu(), want) == 0,
                    f"[corrupt] wah_expand_varw_bits on a {kind} stream "
                    "differs from its plain version")
            cases += 1
    torch.cuda.synchronize()
    return {"stream_cases": cases}


def corrupt_phase(card: str) -> dict:
    """Corrupt containers on the card (bench/corrupt.py).

    (a) Containers of 256 samples (H = 512) written with `cli -c --device
    cuda`: uniformly diploid ("wah", the default MAF; "diploid", --maf
    0.4: most lines sparse), with tracks ("tracks": 40 haploid males, 1 %
    missing) and mixed ploidy ("mixed", every third record haploid).  In
    this process `cli -x --device cuda` runs on each corrupt copy: a
    stored index at its line's width + 3 (sparse, missing and EOV tracks,
    a haploid line's sample), the WAH stream 1 / 5 / 37 words late and
    with a counter of 16,383 groups at word 0 / 3 / 40, 20 random flips,
    and the file-wide phase's TOPMed-width container (32-bit streams)
    with a sparse index past its line.  Each exits 0 or 1 with one
    `xsqueezeit: error:` line; the index cases exit 1 with the native
    accessor's words.  After each, the same process extracts the "wah"
    container on cuda:0 to the VCF bytes of --device numpy (the CUDA
    context is alive).  The mixed copies also go through the mixed device
    route (decode_block_records of the whole block), and the TOPMed
    container's block with a counter past its line through decode_bits
    (the CTA-per-line expand, the rows chains, the cluster flush).
    (b) The decode kernels on corrupt streams against their plain
    versions (corrupt_stream_checks).  No compute-sanitizer memcheck: it
    reports the card as not supported where this script runs (PERF.md).
    (c) The port's native library with ASan and UBSan, built on the
    card's host (no zstd, no libdeflate as there), and fuzz_accessor over
    part (a)'s containers:
    each walked to its end, 20 truncations and 20 flips; a sanitizer
    report or a signal fails.  The build starts with the phase."""
    import concurrent.futures

    from xsqueezeit_tpu_torch.bench import corrupt
    from xsqueezeit_tpu_torch.format.container import XsiReader
    from xsqueezeit_tpu_torch.interop import native

    shutil.rmtree(CORRUPT_WORK, ignore_errors=True)
    os.makedirs(CORRUPT_WORK)
    secs = {}
    t_phase = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    asan = pool.submit(native.build_sanitized, "asan",
                       os.path.join(CORRUPT_WORK), zstd=False,
                       libdeflate=False)

    def path(f):
        return os.path.join(CORRUPT_WORK, f)

    try:
        t0 = time.perf_counter()
        synth_bcf(path("diploid.bcf"), CORRUPT_RECORDS, CORRUPT_SAMPLES,
                  seed=SEED)
        corrupt.write_vcf(path("tracks.vcf"), CORRUPT_SAMPLES,
                          CORRUPT_RECORDS, seed=SEED, males=40,
                          missing_frac=0.01)
        corrupt.write_vcf(path("mixed.vcf"), CORRUPT_SAMPLES,
                          CORRUPT_RECORDS, seed=SEED + 1, males=40,
                          haploid_every=3, missing_frac=0.01)
        good = {}
        for name, src, maf in (("wah", "diploid.bcf", "0.01"),
                               ("diploid", "diploid.bcf", "0.4"),
                               ("tracks", "tracks.vcf", "0.01"),
                               ("mixed", "mixed.vcf", "0.4")):
            good[name] = path(f"{name}.xsi")
            rc, err = cli_in_process(
                ["-c", "-f", path(src), "-o", good[name], "--maf", maf,
                 "--variant-block-length", str(CORRUPT_BLOCK), "--device",
                 DEVICE])
            require(rc == 0, f"[corrupt] -c {name}: exit {rc} {err}")
        rc, err = cli_in_process(["-x", "-f", good["wah"], "-o",
                                  path("want.vcf"), "-O", "v", "--device",
                                  "numpy"])
        require(rc == 0, f"[corrupt] -x --device numpy: exit {rc} {err}")
        with open(path("want.vcf"), "rb") as f:
            want = f.read()
        secs["containers"] = time.perf_counter() - t0

        def alive(after: str) -> None:
            rc, err = cli_in_process(["-x", "-f", good["wah"], "-o",
                                      path("good.vcf"), "-O", "v",
                                      "--device", DEVICE])
            with open(path("good.vcf"), "rb") as f:
                same = f.read() == want
            require(rc == 0 and same,
                    f"[corrupt] after {after}: -x --device {DEVICE} of a "
                    f"good container exit {rc}, VCF equal: {same} {err}")

        outcomes = {}

        def case(label: str, p: str, words: str | None = None) -> None:
            rc, err = cli_in_process(["-x", "-f", p, "-o", path("bad.vcf"),
                                      "-O", "v", "--device", DEVICE])
            one = (rc == 0 and not err) or (
                rc == 1 and len(err) == 1
                and err[0].startswith("xsqueezeit: error:"))
            require(one, f"[corrupt] {label}: exit {rc}, stderr {err}")
            if words is not None:
                require(rc == 1 and err == [f"xsqueezeit: error: {words}"],
                        f"[corrupt] {label}: exit {rc}, stderr {err}, not "
                        f"'{words}'")
            outcomes[label] = err[0][len("xsqueezeit: error: "):] \
                if rc else "decoded"
            alive(label)

        t0 = time.perf_counter()
        reset_counts()
        for kind, name, stream, haploid, words, blocks in (
                ("sparse", "diploid", "sparse", None,
                 "sparse index out of range", (0, 1, 2)),
                ("missing", "tracks", "missing", None,
                 "missing index out of range", (0, 1)),
                ("eov", "tracks", "eov", None, "EOV index out of range",
                 (0, 1)),
                ("haploid", "mixed", "sparse", True,
                 "sparse index out of range", (0, 1))):
            for b in blocks:
                p = corrupt.index_past_width(
                    good[name], path(f"{kind}{b}.xsi"), stream, b, haploid)
                case(f"{kind} index past its line, block {b}", p, words)
                if kind == "haploid":
                    rd = XsiReader(p)
                    try:
                        decoder_torch.decode_block_records(
                            rd.gt_block_payload(b), rd.n_samples, rd.n_haps,
                            rd.aet_dtype, [2] * CORRUPT_BLOCK,
                            device=DEVICE)
                        raised = None
                    except ValueError as exc:
                        raised = str(exc)
                    require(raised == words,
                            f"[corrupt] the mixed device route on block "
                            f"{b}: {raised!r}, not {words!r}")
        for name in ("wah", "tracks"):
            for k in (1, 5, 37):
                case(f"{name}: WAH stream {k} words late",
                     corrupt.wah_dropped_words(good[name],
                                               path(f"drop{k}.xsi"), k))
        for name in ("wah", "mixed"):
            for k in (0, 3, 40):
                p = corrupt.wah_long_counter(good[name], path(f"long{k}.xsi"),
                                             k)
                case(f"{name}: counter past its line at word {k}", p)
                if name == "mixed":
                    rd = XsiReader(p)
                    decoder_torch.decode_block_records(
                        rd.gt_block_payload(0), rd.n_samples, rd.n_haps,
                        rd.aet_dtype, [2] * CORRUPT_BLOCK, device=DEVICE)
        rng = np.random.default_rng(SEED + 16)
        for t in range(20):
            name = ("wah", "diploid", "tracks", "mixed")[t % 4]
            case(f"{name}: flips, trial {t}",
                 corrupt.flip_bytes(good[name], path(f"flip{t}.xsi"), rng,
                                    int(rng.integers(1, 4))))
        wide = os.path.join(WIDE_WORK, "cuda.xsi")
        case("TOPMed width: sparse index past its line",
             corrupt.index_past_width(wide, path("wide.xsi"), "sparse"),
             "sparse index out of range")
        p = corrupt.wah_long_counter(wide, path("wide_long.xsi"), 3)
        rd = XsiReader(p)
        dec = decoder_torch.TorchBlockDecoder(
            rd.gt_block_payload(0), rd.n_samples, rd.n_haps, rd.aet_dtype,
            device=DEVICE)
        dec.decode_bits()
        torch.cuda.synchronize()
        alive("TOPMed width: counter past its line, decode_bits")
        launches = {k: v for k, v in read_counts().items() if v}
        for route in DECODE_ROUTES:
            require(launches.get(route, 0) > 0,
                    f"[corrupt] {route} was not launched by part (a)")
        secs["containers_on_card"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        streams = corrupt_stream_checks()
        secs["kernels_on_corrupt_streams"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        prog = asan.result()["fuzz_accessor"]
        secs["asan_build_wait"] = time.perf_counter() - t0
        env = {**os.environ, "ASAN_OPTIONS": "exitcode=99:abort_on_error=0",
               "UBSAN_OPTIONS": "exitcode=99:print_stacktrace=1"}
        runs = [(f"{name} walked to its end", good[name], name)
                for name in ("wah", "diploid", "tracks", "mixed")]
        data = open(good["tracks"], "rb").read()
        for t, cut in enumerate(np.linspace(0, len(data) - 1, 20)
                                .astype(int)):
            runs.append((f"truncated at {cut}", corrupt.copy_container(
                good["tracks"], path(f"cut{t}.xsi"), data[:cut]), None))
        for t in range(20):
            runs.append((f"flips, trial {t}", corrupt.flip_bytes(
                good["diploid"], path(f"aflip{t}.xsi"), rng,
                int(rng.integers(1, 4))), None))
        with concurrent.futures.ThreadPoolExecutor(4) as fz:
            results = list(fz.map(lambda r: subprocess.run(
                [prog, r[1]], env=env, capture_output=True, text=True,
                timeout=120), runs))
        for (label, _, name), r in zip(runs, results):
            blob = r.stdout + r.stderr
            require(r.returncode >= 0 and r.returncode != 99
                    and "AddressSanitizer" not in blob
                    and "runtime error" not in blob,
                    f"[corrupt] fuzz_accessor, {label}: exit "
                    f"{r.returncode}\n{blob[-2000:]}")
            if name is not None:
                n = CORRUPT_RECORDS
                require(r.returncode == 0 and f"done records={n}" in r.stdout,
                        f"[corrupt] fuzz_accessor, {label}: {r.stdout}")
        secs["asan_fuzz_accessor"] = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True)
        shutil.rmtree(CORRUPT_WORK, ignore_errors=True)
        shutil.rmtree(WIDE_WORK, ignore_errors=True)
    secs["phase"] = time.perf_counter() - t_phase
    errors = sorted(set(outcomes.values()))
    print(f"[corrupt] {len(outcomes)} corrupt containers through -x "
          f"--device {DEVICE}, each exit 0 or 1 with one line, a good "
          f"container bit-exact after each; outcomes {json.dumps(errors)}; "
          f"{streams['stream_cases']} corrupt streams through the decode "
          f"kernels equal to their plain versions; fuzz_accessor (ASan, "
          f"UBSan) clean on {len(runs)} containers; launches "
          f"{json.dumps(launches)}; seconds "
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})} "
          f"({card})")
    return {"cases": len(outcomes), "outcomes": outcomes,
            "launches": launches, "asan_runs": len(runs), **streams,
            "asan_build_seconds": native.last_build_seconds,
            "seconds": secs}


def main() -> int:
    phases = {}

    def phase(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phases[key] = time.perf_counter() - t0
        print(f"phase {key}: {phases[key]:.1f} s", flush=True)
        return out

    card = phase("machine", machine_facts)
    phase("build", build_kernels)
    native_build = phase("native_build", native_build_phase)
    rows, checks = phase("kernels", check_kernels, card)
    blocks = {name: phase(f"block_{name}", block_phase, name, n, seed, card)
              for name, n, seed in BLOCKS}
    for name in TRACK_BLOCKS:
        blocks[name] = phase(f"block_{name}", track_block_phase, name, card)
    for name, n, seed in MIXED_BLOCKS:
        blocks[name] = phase(f"block_{name}", mixed_block_phase, name, n,
                             seed, card)
    files = {"file": phase("file", file_phase, card, keep=SCALE_WORK),
             "file-missing": phase("file-missing", file_phase, card,
                                   "file-missing", 0.01, True),
             "file-wide": phase("file-wide", file_phase, card, "file-wide",
                                0.01, True, TOPMED_SAMPLES,
                                WIDE_FILE_RECORDS, WIDE_WORK)}
    nat = phase("native", native_phase, card)
    bad = phase("corrupt", corrupt_phase, card)
    tools = phase("tools", tools_phase, card)
    scale = phase("scale", scale_phase, card)
    bench = phase("bench", bench_phase, card)

    for b in blocks.values():
        for c in b.pop("block_checks", []):
            checks.append(c)
            if c["default_route"]:
                rows[c["name"]] = kernel_row(c)   # the block's own shapes
            elif c.get("row"):
                rows[c["row"]] = kernel_row(c)
    for r in rows.values():
        r["launches"] = sum(b["launches"][r["name"]] for b in blocks.values())
        r["launches_by_block"] = {k: b["launches"][r["name"]]
                                  for k, b in blocks.items()
                                  if b["launches"][r["name"]]}
    print(json.dumps({"kernel_checks": checks, "card": card}))
    print(json.dumps({"blocks": {k: {x: v for x, v in b.items()
                                     if x != "launches"}
                                 for k, b in blocks.items()},
                      "files": files, "native": nat,
                      "native_build": native_build, "corrupt": bad,
                      "tools": tools, "scale": scale,
                      "bench": bench,
                      "phase_seconds": phases,
                      "card": card}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
