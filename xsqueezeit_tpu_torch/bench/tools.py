"""Benchmark & validation tools — counterparts of the reference's L8 apps.

The port's copy of xsqueezeit_tpu/bench/tools.py:

  loading_time    load every record's genotype array (BCF or XSI path)
  dot_prod        GWAS-style dot product; on the card (device="cuda", or
                  "cpu" tensors) whole blocks decode on the torch device
                  and one product per block runs there; device="host"
                  walks the compressed WAH/sparse forms ("compressive
                  acceleration"), or a BCF/VCF's gt arrays
  af_stats        recompute AC/AN for every record from allele counts only
  lockstep_load   walk two files (any mix of BCF/XSI) and assert identical
                  genotypes record by record -- the scalable bit-exactness
                  checker (reference: lockstep_loader/gt_lockstep_loader.hpp)
  hrc_scale       HRC-width file round trip with a streamed lockstep
  warmup          build the kernels, then one encode and decode per shape
  scaling_curve   compress_file_multihost at 1, 2, 4 ... processes
                  (torch.distributed, gloo on localhost), with the
                  modelled dedicated-host wall clock broken out

`loading_time --native` reads an XSI through the port's native accessor,
and af_stats and dot_prod on a torch device walk its variant file natively
(interop/native.py; XSI_NATIVE=0 takes the Python record reader; a native
failure raises).  A haploid line stores sample indices and is n_samples
bits wide: dot_prod maps its carriers to samples one to one (the JAX
package's XSI walk halves them), and the device product takes y itself on
a uniformly haploid block.
"""
from __future__ import annotations

import time

import numpy as np

from ..accessor import Accessor
from ..format.constants import BM_BLOCK_BITS
from ..io.bcf import BcfReader
from ..io.unified import GtInput
from ..ops import pbwt_np, wah_np
from ..utils import trace


def _is_xsi(path: str) -> bool:
    if path.endswith(".xsi"):
        return True
    try:
        with open(path, "rb") as f:
            head = f.read(8)
            return len(head) == 8 and head[4:8] == bytes.fromhex("6717edfe")
    except OSError:
        return False


def iter_genotypes(path: str):
    """Yields (n_alleles, gt int32 array) for a BCF/VCF or XSI file."""
    if _is_xsi(path):
        acc = Accessor(path)
        reader = BcfReader(acc.variant_filename())
        for rec in reader:
            yield rec.n_allele, acc.get_genotypes(rec)
        reader.close()
    else:
        inp = GtInput(path)
        for rec in inp:
            yield rec.n_alleles, rec.gt
        inp.close()


def loading_time(path: str, native: bool = False) -> dict:
    """Load every record's gt array; returns timing stats.

    `native=True` reads an XSI file through the C++ accessor library
    (the integration path, reference: loading_time/ NewLoader)."""
    t0 = time.perf_counter()
    n_records = 0
    n_gt = 0
    if native:
        from ..interop.native import NativeAccessor
        acc = NativeAccessor(path)
        try:
            for n_alleles, gt in acc:
                n_records += 1
                n_gt += gt.shape[0]
        finally:
            acc.close()
    else:
        for n_alleles, gt in iter_genotypes(path):
            n_records += 1
            if gt is not None:
                n_gt += gt.shape[0]
    elapsed = time.perf_counter() - t0
    return {"records": n_records, "gt_entries": n_gt, "seconds": elapsed,
            "gt_per_second": n_gt / elapsed if elapsed else 0.0}


def _carriers(gt: np.ndarray) -> np.ndarray:
    """Slots holding the first ALT allele of an htslib gt array."""
    return np.flatnonzero(((gt >> 1) - 1) == 1)


def _xsi_line_sum(acc: Accessor, bm: int, n_alleles: int,
                  y: np.ndarray) -> float:
    """Sum of y over the samples carrying the first ALT of one record,
    off its compressed forms: sparse lines sum y at the stored indices; WAH
    lines decode their words and map the set bits through the arrangement.
    A diploid line's slot h belongs to sample h >> 1, a haploid line's
    slot s to sample s."""
    ia = acc.get_internal_access(bm, n_alleles)
    shift = 0 if ia.haploid else 1
    if ia.sparse[0]:
        stream = ia.pointers[0]
        msb = 1 << (stream.dtype.itemsize * 8 - 1)
        head = int(stream[0])
        cnt = head & (msb - 1)
        if head & msb:
            # negated sparse: full decode fallback (ref parity:
            # dot_prod/main.cpp treats negated lines the same way)
            carriers = _carriers(acc.fill_genotype_array(bm, n_alleles))
        else:
            carriers = stream[1:1 + cnt].astype(np.int64)
    else:
        if ia.haploid:
            width = acc.n_samples
            a = pbwt_np.haploid_rearrangement_from_diploid(ia.a)
        else:
            width, a = acc.n_haps, ia.a
        bits, _ = wah_np.wah_decode(ia.pointers[0], width)
        carriers = a[np.flatnonzero(bits[:width])]
    return y[carriers >> shift].sum()


#: dot_prod's devices: the torch devices a whole block decodes on, and
#: the host walk over the compressed forms.
DOT_PROD_DEVICES = ("cuda", "cpu", "host")


def dot_prod(path: str, seed: int = 42, device: str = "cuda") -> dict:
    """Dot product of each bi-allelic variant's dosage with a random
    phenotype vector: `dots` in record order, float64, and their sum
    `checksum`.  With `device` "cuda" or "cpu", whole blocks of an XSI file
    decode on that torch device and the products run there
    (_dot_prod_device); "host" walks the records on the host, over the
    compressed forms of an XSI file (_xsi_line_sum) or the gt arrays of a
    BCF/VCF, which only "host" reads."""
    if device not in DOT_PROD_DEVICES:
        raise ValueError(f"dot_prod takes a device of {DOT_PROD_DEVICES}, "
                         f"not {device!r}")
    xsi = _is_xsi(path)
    if device != "host":
        if not xsi:
            raise ValueError(f"dot_prod --device {device} reads .xsi input; "
                             "a BCF or VCF takes --device host")
        return _dot_prod_device(path, seed, device)
    t0 = time.perf_counter()
    checksum = 0.0
    dots = []
    if xsi:
        acc = Accessor(path)
        n_samples = len(acc.get_sample_list())
        rng = np.random.default_rng(seed)
        y = rng.random(n_samples)
        reader = BcfReader(acc.variant_filename())
        for rec in reader:
            if rec.n_allele != 2:
                continue
            dots.append(_xsi_line_sum(acc, acc.position_from_bm_entry(rec),
                                      rec.n_allele, y))
            checksum += dots[-1]
        reader.close()
    else:
        inp = GtInput(path)
        n_samples = len(inp.samples)
        rng = np.random.default_rng(seed)
        y = rng.random(n_samples)
        for rec in inp:
            if rec.n_alleles != 2 or rec.gt is None:
                continue
            dots.append(y[_carriers(rec.gt) // rec.ploidy].sum())
            checksum += dots[-1]
        inp.close()
    return {"variants": len(dots), "checksum": round(float(checksum), 6),
            "seconds": time.perf_counter() - t0,
            "dots": np.asarray(dots, np.float64)}


def _scan_records(acc: Accessor) -> tuple[np.ndarray, np.ndarray, str]:
    """Every record's BM entry and n_allele off an XSI's variant file, as
    int32 arrays in file order, and the walk that read them: "native", one
    xsi_scan_records crossing on a fresh native accessor, closed after it
    (a native error raises), or with XSI_NATIVE=0 "python", the BcfReader
    pass."""
    nat = acc._native()
    if nat is not None:
        try:
            bms, nas = nat.scan_records()
        finally:
            acc.close()
        return bms, nas, "native"
    reader = BcfReader(acc.variant_filename())
    try:
        recs = list(reader)
    finally:
        reader.close()
    bms = np.fromiter((acc.position_from_bm_entry(r) for r in recs),
                      np.int32, len(recs))
    nas = np.fromiter((r.n_allele for r in recs), np.int32, len(recs))
    return bms, nas, "python"


def _group_by_block(bms: np.ndarray, nas: np.ndarray):
    """The records of each block, blocks in order of first appearance:
    (block id, the block's records' n_allele in file order, each of its
    bi-allelic records' index among the file's variants), and the number
    of variants."""
    blk = bms.view(np.uint32) >> BM_BLOCK_BITS      # Accessor.split_bm
    is_var = nas == 2
    variant = np.cumsum(is_var, dtype=np.int32) - 1
    order = np.argsort(blk, kind="stable")
    ids = blk[order]
    if not len(ids):
        return [], 0
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    ends = np.r_[starts[1:], len(ids)]
    groups = []
    for k in np.argsort(order[starts], kind="stable"):
        idx = order[starts[k]:ends[k]]
        groups.append((int(ids[starts[k]]), nas[idx],
                       variant[idx][is_var[idx]]))
    return groups, int(np.count_nonzero(is_var))


def _dot_prod_device(path: str, seed: int, device: str) -> dict:
    """dot_prod of an XSI file with whole blocks decoded on a torch device.

    The variant file's records are scanned in one native crossing
    (_scan_records) and grouped by block in numpy.  A block
    TorchBlockDecoder.decode_bits takes decodes on the device (on "cuda":
    wah_expand_bits, then chain_decode and the run flush; a mixed-ploidy
    block through wah_expand_varw_bits and the mixed scan);
    its bi-allelic records' lines are multiplied there in float32 with the
    phenotype weights, one product_kernels.dot_rows call per block (a hand
    kernel that reads each kept row once on "cuda"): y[h >> 1] on a
    diploid block, y on a uniformly haploid one (n_samples wide), and on a
    mixed block y at the even slots for its haploid lines (they come back
    slot-duplicated).  Only the per-variant dots leave the device.  Other
    blocks (sort != select) take the per-record host walk.  Checksum-
    compatible with the host walk."""
    import torch

    from ..codec.decoder_torch import TorchBlockDecoder
    from ..ops import product_kernels
    from ..utils.devprobe import torch_device

    dev = torch_device(device)
    t0 = time.perf_counter()
    with trace.span("dot_prod", device=str(dev)):
        with trace.span("dot_prod.open"):
            acc = Accessor(path)
            n_samples = acc.n_samples
            rng = np.random.default_rng(seed)
            y = rng.random(n_samples)
            y32 = torch.from_numpy(y.astype(np.float32)).to(dev)

        # per block: each record's n_allele, and each bi-allelic record's
        # index among the file's variants
        with trace.span("dot_prod.walk") as span:
            bms, nas, walk = _scan_records(acc)
            span.set(route=walk)
            trace.count("dot_prod.records", len(bms))
            blocks, n = _group_by_block(bms, nas)

        dots = np.zeros(n, np.float64)
        checksum = 0.0
        # haploid_blocks: the device blocks that are uniformly haploid
        routes = {"device_blocks": 0, "haploid_blocks": 0, "mixed_blocks": 0,
                  "host_blocks": 0}
        for blk, n_alleles, variants in blocks:
            if not len(variants):
                continue
            with trace.span("dot_prod.block", block=blk) as span:
                # binary line of each bi-allelic record (one line each)
                lines = np.maximum(n_alleles.astype(np.int64) - 1, 0)
                keep = (np.cumsum(lines) - lines)[n_alleles == 2]
                with trace.span("decode.parse"):
                    dec = TorchBlockDecoder(acc.xsi.gt_block_payload(blk),
                                            n_samples, acc.n_haps,
                                            acc.xsi.aet_dtype, device=dev)
                m = dec.meta
                if not (dec.eligible or dec.mixed_device_ok):
                    span.set(route="host")
                    routes["host_blocks"] += 1
                    with trace.span("dot_prod.host_block"):
                        for v, first in zip(variants.tolist(),
                                            keep.tolist()):
                            m.seek(first)
                            gt = m.fill_genotype_array_advance(2)
                            shift = 0 if m.haploid_line[first] else 1
                            dots[v] = y[_carriers(gt) >> shift].sum()
                            checksum += float(dots[v])
                    continue
                vals, route = dec.decode_bits()
                span.set(route=route)
                if route == "mixed":
                    routes["mixed_blocks"] += 1
                    mode = "mixed"
                else:
                    routes["device_blocks"] += 1
                    routes["haploid_blocks"] += int(dec.uniform_haploid)
                    mode = "haploid" if dec.uniform_haploid else "diploid"
                with trace.span("dot_prod.product", rows=len(keep),
                                width=vals.shape[1], mode=mode,
                                samples=n_samples,
                                loads=product_kernels.load_width(vals)):
                    hap = None
                    if mode == "mixed":
                        hap = torch.from_numpy(
                            m.haploid_line[keep].astype(bool)).to(dev)
                    block_dots = product_kernels.dot_rows(
                        vals, torch.from_numpy(keep).to(dev), y32, mode, hap)
                with trace.span("dot_prod.readback"):
                    got = block_dots.cpu().numpy().astype(np.float64)
                dots[variants] = got
                checksum += float(got.sum())
    return {"variants": n, "checksum": round(float(checksum), 6),
            "seconds": time.perf_counter() - t0, "device": str(dev),
            "walk": walk, "dots": dots, **routes}


def af_stats(path: str, annotate_out: str | None = None) -> dict:
    """Recompute AC/AN per record using allele counts only (no gt arrays).

    With `annotate_out`, also writes the variant BCF with AC/AN patched
    into INFO (reference: af_stats/ Annotator writes an annotated variant
    file)."""
    t0 = time.perf_counter()
    out = []
    n_haps = 0
    if _is_xsi(path):
        from ..io.bcf import BcfWriter
        from ..io.sites import encode_shared_from_vcf_cols, render_vcf_cols

        acc = Accessor(path)
        n_haps = acc.n_haps
        nat = acc._native()
        if nat is not None and not annotate_out:
            # fully native walk: ONE crossing scans every (BM, n_allele)
            # off the variant file, ONE crossing counts every record off
            # the compressed streams — no Python record objects at all.
            # A native error raises (and the accessor is closed).
            try:
                bms, nas = nat.scan_records()
                flat = nat.count_alleles_range(bms, nas)
            finally:
                acc.close()
            offs = np.zeros(len(nas) + 1, np.int64)
            np.cumsum(nas, out=offs[1:])
            for i in range(len(nas)):
                counts = flat[offs[i]:offs[i + 1]]
                out.append((int(counts.sum()), [int(c) for c in counts[1:]]))
            return _af_result(out, n_haps, time.perf_counter() - t0)
        reader = BcfReader(acc.variant_filename())
        writer = None
        hdr = reader.header
        if annotate_out:
            hdr.ensure_string(
                "AC", '##INFO=<ID=AC,Number=A,Type=Integer,Description='
                      '"Allele count in genotypes">')
            hdr.ensure_string(
                "AN", '##INFO=<ID=AN,Number=1,Type=Integer,Description='
                      '"Total number of alleles in called genotypes">')
            writer = BcfWriter(annotate_out, hdr)
        recs = list(reader)
        nas = np.fromiter((r.n_allele for r in recs), np.int32, len(recs))
        bms = np.fromiter((acc.position_from_bm_entry(r) for r in recs),
                          np.int32, len(recs))
        flat = acc.fill_allele_counts_range(bms, nas)
        offs = np.zeros(len(recs) + 1, np.int64)
        np.cumsum(nas, out=offs[1:])
        for i, rec in enumerate(recs):
            counts = flat[offs[i]:offs[i + 1]]
            an = int(counts.sum())
            acs = [int(c) for c in counts[1:]]
            out.append((an, acs))
            if writer is not None:
                cols = render_vcf_cols(hdr, rec)
                info = [kv for kv in cols[7].split(";")
                        if kv and not kv.startswith(("AC=", "AN="))
                        and kv != "."]
                info.append("AC=" + ",".join(str(c) for c in acs))
                info.append(f"AN={an}")
                cols[7] = ";".join(info)
                shared = encode_shared_from_vcf_cols(
                    hdr, cols, rec.n_fmt, rec.n_sample)
                writer.write_raw(shared, rec.indiv)
        if writer is not None:
            writer.close()
        reader.close()
    else:
        for n_alleles, gt in iter_genotypes(path):
            alleles = (gt >> 1) - 1
            valid = (alleles >= 0) & (gt != np.int32(-0x7FFFFFFF))
            counts = np.bincount(alleles[valid], minlength=n_alleles)
            out.append((int(valid.sum()), [int(c) for c in counts[1:n_alleles]]))
    return _af_result(out, n_haps, time.perf_counter() - t0)


def _af_result(out: list, n_haps: int, seconds: float) -> dict:
    # throughput over the logical htslib gt bytes the counts stand in for
    # (the reference's "compressive genomics" pitch: AC/AN without gt
    # materialization, af_stats/main.cpp)
    logical = len(out) * n_haps * 4
    return {"records": len(out), "stats": out, "seconds": seconds,
            "records_per_s": round(len(out) / seconds, 1) if seconds else 0,
            "logical_gb_s": (round(logical / seconds / 1e9, 3)
                             if seconds and logical else None)}


def lockstep_load(path_a: str, path_b: str) -> dict:
    """Walk two files in lockstep asserting identical genotypes."""
    t0 = time.perf_counter()
    n_records = 0
    n_entries = 0
    it_a = iter_genotypes(path_a)
    it_b = iter_genotypes(path_b)
    import itertools
    for (na, ga), (nb, gb) in itertools.zip_longest(
            it_a, it_b, fillvalue=(None, None)):
        if na is None or nb is None:
            raise AssertionError(
                f"files differ in record count at record {n_records}")
        if na != nb:
            raise AssertionError(
                f"record {n_records}: n_allele {na} != {nb}")
        if (ga is None) != (gb is None):
            raise AssertionError(f"record {n_records}: GT presence differs")
        if ga is not None and not np.array_equal(ga, gb):
            raise AssertionError(f"record {n_records}: genotypes differ")
        n_records += 1
        n_entries += 0 if ga is None else ga.shape[0]
    return {"records": n_records, "gt_entries": n_entries,
            "identical": True, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# HRC-scale file-level validation (reference README.md:404-408 claims a
# 17.4B-entry chrX bit-exact round trip at 64976 haplotypes)
# ---------------------------------------------------------------------------
def hrc_scale(n_records: int = 16384, n_samples: int = 32488,
              block_length: int = 4096, workdir: str | None = None,
              device: str = "cuda", keep: bool = False) -> dict:
    """Synthesize an HRC-width (2*n_samples = 64976 haplotypes) multi-block
    BCF, compress it and extract it back to BCF on `device` ("cuda",
    "cpu" or "numpy"), and stream a chunked lockstep compare of every
    genotype (bounded memory: one record in flight per side).  Defaults
    give ~1.06e9 GT entries -- within 20x of the reference's 17.4B chrX
    claim -- with peak RSS reported."""
    import os
    import resource
    import tempfile

    from ..utils.devprobe import torch_device
    torch_device(device)           # "cuda" without a card fails here

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="xsi_hrc_")
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "hrc.bcf")
    xsi = os.path.join(workdir, "hrc.xsi")
    out = os.path.join(workdir, "hrc.out.bcf")

    from .synth import synth_bcf
    t0 = time.perf_counter()
    synth_bcf(inp, n_records, n_samples)
    t_synth = time.perf_counter() - t0

    from ..codec.compressor import CompressorOptions, compress_file
    t0 = time.perf_counter()
    stats = compress_file(inp, xsi, CompressorOptions(
        block_length=block_length, device=device))
    t_comp = time.perf_counter() - t0

    from ..codec.decompressor import Decompressor, DecompressorOptions
    t0 = time.perf_counter()
    Decompressor(xsi, DecompressorOptions(output_type="b",
                                          device=device)).decompress(out)
    t_ext = time.perf_counter() - t0

    lock = lockstep_load(inp, out)
    if lock["records"] != n_records:
        raise AssertionError(f"{lock['records']} records read back, "
                             f"{n_records} written")

    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    result = {
        "n_records": n_records,
        "n_haplotypes": n_samples * 2,
        "device": device,
        "gt_entries": lock["gt_entries"],
        "identical": True,
        "input_bcf_mb": round(os.path.getsize(inp) / 1e6, 1),
        "xsi_mb": round(os.path.getsize(xsi) / 1e6, 1),
        "logical_gb": round(n_records * n_samples * 2 * 4 / 1e9, 2),
        "synth_s": round(t_synth, 1),
        "compress_s": round(t_comp, 1),
        "extract_s": round(t_ext, 1),
        "lockstep_s": round(lock["seconds"], 1),
        "n_blocks": -(-n_records // block_length),
        "entries": stats["entries"],
        "peak_rss_gb": round(peak_rss_gb, 2),
    }
    if own and not keep:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return result


def warmup(n_samples: int, block_length: int = 8192,
           mac_threshold: int | None = None,
           fracs: tuple = (1.0, 0.7, 0.45, 0.2),
           device: str = "cuda") -> dict:
    """Build the kernels, then encode and decode one synthetic block per
    `frac` at a production geometry.

    On "cuda" the kernels compile with nvcc first (ops/_build.build(); the
    JAX package precompiled XLA executables here); every later call of the
    process loads the built library.  Each `frac` makes a block whose first
    frac of the lines are a balanced common row (WAH) and the rest a
    single-carrier rare row (sparse), encodes it with TorchBlockEncoder and
    decodes the payload back with TorchBlockDecoder on `device`, checking
    the bits.  Reports the build seconds (None on "cpu") and each shape's
    encode and decode seconds."""
    import torch

    from ..codec.decoder_torch import TorchBlockDecoder
    from ..codec.encoder_torch import TorchBlockEncoder
    from ..ops import _build
    from ..utils.devprobe import torch_device

    dev = torch_device(device)
    if dev is None:
        raise ValueError("warmup takes cuda or cpu")
    build_s = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _build.build()
        _build.library()
        build_s = round(time.perf_counter() - t0, 2)

    H = 2 * n_samples
    thr = (max(int(H * 0.001), 1) if mac_threshold is None
           else int(mac_threshold))
    aet = np.uint16 if H <= 0xFFFF else np.uint32

    # Two template records: a balanced common row (mac = H/2 -> WAH) and a
    # single-carrier rare row (-> sparse).
    common = np.full(H, 2, np.int32)
    common[0::2] = 4
    rare = np.full(H, 2, np.int32)
    rare[0] = 4
    want_common = (np.arange(H) % 2 == 0).astype(np.uint8)
    want_rare = (np.arange(H) == 0).astype(np.uint8)

    shapes = []
    for frac in fracs:
        n_wah = max(min(int(block_length * frac), block_length), 1)
        enc = TorchBlockEncoder(n_samples, block_length, thr,
                                default_phasing=0, aet_dtype=aet,
                                device=dev)
        for i in range(block_length):
            enc.encode_record(common if i < n_wah else rare, 2)
        t0 = time.perf_counter()
        payload = enc.serialize()
        t_enc = time.perf_counter() - t0

        dec = TorchBlockDecoder(payload, n_samples, H, aet, device=dev)
        t0 = time.perf_counter()
        out = dec.decode_all()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        if not (np.array_equal(out[:n_wah], np.broadcast_to(
                want_common, (n_wah, H)))
                and np.array_equal(out[n_wah:], np.broadcast_to(
                    want_rare, (block_length - n_wah, H)))):
            raise AssertionError(f"warmup frac={frac}: decoded bits differ "
                                 "from the encoded block")
        shapes.append({"frac": frac, "n_wah": n_wah,
                       "encode_s": round(t_enc, 2),
                       "decode_s": round(t_dec, 2)})
        print(f"warmup frac={frac}: {n_wah} WAH lines, "
              f"encode {t_enc:.2f}s decode {t_dec:.2f}s", flush=True)
    return {"n_samples": n_samples, "n_haps": H, "block_length": block_length,
            "mac_threshold": thr, "device": str(dev), "build_s": build_s,
            "shapes": shapes}


# ---------------------------------------------------------------------------
# Multi-process scaling curve (BASELINE.md: >=80% efficiency at 4 hosts)
# ---------------------------------------------------------------------------
def _scaling_worker(cfg_json: str) -> None:
    """Entry point of one scaling-bench OS process (see scaling_curve)."""
    import json

    from ..codec.compressor import CompressorOptions
    from ..parallel.distributed import compress_file_multihost

    cfg = json.loads(cfg_json)
    perf: dict = {}
    stats = compress_file_multihost(
        cfg["input"], cfg["output"],
        CompressorOptions(block_length=cfg["block_length"],
                          device=cfg["device"]),
        coordinator=cfg["coordinator"],
        num_processes=cfg["nproc"], process_id=cfg["procid"],
        perf=perf)
    perf["procid"] = cfg["procid"]
    if stats is not None:
        perf["xsi_bytes"] = stats["xsi_bytes"]
    with open(cfg["perf_out"], "w") as f:
        json.dump(perf, f)


def _gather_only_worker(cfg_json: str) -> None:
    """Replay ONLY the overlapped gather's collective rounds (same round
    structure and byte sizes as the real run, synthetic payloads, no
    encode): the pure-communication cost sample for the scaling model.
    The contended run's measured gather_s is dominated by straggler WAIT
    (a fast process blocks in the collective until the slowest finishes
    its chunk: barrier skew, not bytes), so the dedicated-host model
    needs this isolated number."""
    import json

    from ..parallel.distributed import _process_group, gather_round_to_host0

    cfg = json.loads(cfg_json)
    with _process_group(cfg["coordinator"], cfg["nproc"], cfg["procid"]):
        lens = cfg["payload_lens"]
        chunk = max(1, int(cfg.get("chunk", 8)))
        rounds = cfg["rounds"]
        payloads = [b"\xAB" * n for n in lens]
        all_n = cfg["all_counts"]
        # warmup round (backend/socket setup is not per-byte cost)
        gather_round_to_host0([b"x"])
        t0 = time.perf_counter()
        for r in range(rounds):
            batch = payloads[r * chunk:(r + 1) * chunk]
            kc = np.asarray([max(min(chunk, n_i - r * chunk), 0)
                             for n_i in all_n], np.int64)
            gather_round_to_host0(batch, known_counts=kc)
        wall = time.perf_counter() - t0
    with open(cfg["perf_out"], "w") as f:
        json.dump({"procid": cfg["procid"], "comm_s": wall,
                   "rounds": rounds}, f)


def _scaling_solo_worker(cfg_json: str) -> None:
    """One worker's COMPUTE slice run alone (no peers, no contention):
    the dedicated-host wall-clock sample for the scaling model."""
    import json
    import os

    from ..codec.compressor import CompressorOptions
    from ..io.unified import count_entries_offsets
    from ..parallel.distributed import (
        _encode_block_range,
        _setup,
        _var_segment,
        _variant_pass,
        plan_block_ranges,
    )

    cfg = json.loads(cfg_json)
    opts = CompressorOptions(block_length=cfg["block_length"],
                             device=cfg["device"])
    (s_inp, _samples, n_samples, default_phased, max_ploidy, aet_dtype,
     mac_threshold, ws) = _setup(cfg["input"], opts)
    s_inp.close()
    perf: dict = {}
    t0 = time.perf_counter()
    n_entries, block_voffs = count_entries_offsets(cfg["input"],
                                                   cfg["block_length"])
    perf["scan_s"] = time.perf_counter() - t0

    n_blocks = -(-n_entries // opts.block_length)
    rng = plan_block_ranges(max(n_blocks, 1), cfg["nproc"])[cfg["procid"]]

    dist_var = (cfg["nproc"] > 1 and block_voffs is not None
                and os.environ.get("XSI_DIST_VARPASS", "1")
                not in ("0", "off", "no"))
    if dist_var:
        # distributed form: THIS worker's var segment (runs on a thread
        # next to encode on a dedicated host; the model takes the max)
        t0 = time.perf_counter()
        _var_segment(cfg["input"], cfg["output"], opts, rng[0], rng[1],
                     block_voffs, write_header=(cfg["procid"] == 0))
        perf["varpass_s"] = time.perf_counter() - t0
    elif cfg["procid"] == 0:
        vin = GtInput(cfg["input"])
        try:
            t0 = time.perf_counter()
            _variant_pass(vin, opts, cfg["output"], max_ploidy)
            perf["varpass_s"] = time.perf_counter() - t0
        finally:
            vin.close()

    t0 = time.perf_counter()
    payloads = _encode_block_range(
        cfg["input"], rng, n_samples, opts, mac_threshold, default_phased,
        aet_dtype, ws, block_voffs=block_voffs)
    perf["encode_s"] = time.perf_counter() - t0
    perf["payload_bytes"] = sum(len(p) for p in payloads)
    with open(cfg["perf_out"], "w") as f:
        json.dump(perf, f)


def _spawn(entry: str, cfg: dict, log):
    """One worker process running bench.tools.<entry>(json(cfg)), in this
    process's environment and working directory."""
    import json
    import subprocess
    import sys
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from xsqueezeit_tpu_torch.bench.tools import "
         f"{entry}; {entry}(sys.argv[1])", json.dumps(cfg)],
        stdout=log, stderr=log)


def scaling_curve(n_records: int = 20000, n_samples: int = 500,
                  procs: tuple = (1, 2, 4), block_length: int = 1024,
                  workdir: str | None = None, device: str = "cuda") -> dict:
    """Wall-clock scaling of `compress_file_multihost` at 1/2/4 OS
    processes on a synthetic input (real torch.distributed with the gloo
    backend and a localhost coordinator), each process encoding on
    `device`, with the gather overhead broken out.

    On one card every process shares it (their kernels queue on the same
    device), and the processes share the host's cores, so the measured
    wall clock cannot show speedup: it validates overhead, not
    parallelism.  Models stand in for a pool where each process has a
    host and a device of its own, Efficiency_N = T1 / (N * T_N) over each:
      * solo_*: every process's slice re-run alone in a fresh process
        (wall times: scan + the busiest encode + the gather residual +
        assembly);
      * modeled_* / compute_* (device="numpy" only): the same sum over
        the contended run's CPU times, which equal wall time on a
        dedicated host only when all the work is on the host.  With a
        torch device the encode waits on the device, and that wait is not
        CPU time, so these are None there.
    Outputs are verified byte-identical to single-process compress_file
    at every process count.  Each row also carries every process's
    kernel launches.
    """
    import json
    import os
    import shutil
    import socket
    import tempfile

    from ..utils.devprobe import torch_device
    # fails before any work; None: the host codec, the CPU-time model holds
    host_model = torch_device(device) is None
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="xsi_scaling_")
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "in.bcf")
    from .synth import synth_bcf
    synth_bcf(inp, n_records, n_samples)
    if os.environ.get("XSI_SCAN_CACHE", "0") not in ("0", "off", "no"):
        # warm-index mode: prime the sidecar once so every point (incl.
        # the 1-process baseline) reads the same warm scan: the steady
        # state for repeated compressions of a static input
        from ..io.unified import count_entries_offsets
        count_entries_offsets(inp, block_length)

    # single-process reference bytes
    from ..codec.compressor import CompressorOptions, compress_file
    ref = os.path.join(workdir, "ref.xsi")
    t0 = time.perf_counter()
    compress_file(inp, ref, CompressorOptions(block_length=block_length,
                                              device=device))
    t_single = time.perf_counter() - t0
    with open(ref, "rb") as f:
        ref_bytes = f.read()

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def load(path):
        with open(path) as f:
            return json.load(f)

    results = []
    for n in procs:
        out = os.path.join(workdir, f"out_{n}.xsi")
        coord = f"127.0.0.1:{free_port()}"
        cfgs = [dict(input=inp, output=out, block_length=block_length,
                     device=device, coordinator=coord, nproc=n, procid=i,
                     perf_out=os.path.join(workdir, f"perf_{n}_{i}.json"))
                for i in range(n)]
        with open(os.path.join(workdir, f"workers_{n}.log"), "wb") as logf:
            t0 = time.perf_counter()
            children = [_spawn("_scaling_worker", cfg, logf)
                        for cfg in cfgs]
            rcs = [c.wait() for c in children]
            wall = time.perf_counter() - t0
            if any(rcs):
                raise RuntimeError(f"scaling worker failed: rcs={rcs}")
            with open(out, "rb") as f:
                if f.read() != ref_bytes:
                    raise RuntimeError(f"{n}-process output differs from "
                                       "single-process bytes")

            perfs = [load(c["perf_out"]) for c in cfgs]
            perfs_by_id = {p["procid"]: p for p in perfs}
            p0 = perfs_by_id[0]
            # CPU times are contention-immune: on dedicated hosts (one
            # busy process each, the host codec) they equal wall time, so
            # the model below is the wall clock of a real N-host run (kept
            # for device="numpy" only).  Process 0 runs the
            # variant pass on a thread overlapped with its encode, so its
            # span is max(varpass, encode0).  Gather is communication:
            # keep its measured wall (localhost gloo under contention, a
            # pessimistic bound) and report efficiency both with and
            # without it.
            scan_max = max(p["scan_cpu_s"] for p in perfs)
            var0 = p0.get("varpass_cpu_s", 0.0)
            enc0 = p0["encode_cpu_s"]
            enc_others = max([p["encode_cpu_s"] for p in perfs
                              if p["procid"] != 0], default=0.0)
            span = max(var0, enc0, enc_others)
            gather_max = max(p.get("gather_s", 0.0) for p in perfs)
            assemble = p0.get("assemble_cpu_s", 0.0)
            gather_bytes = sum(p.get("payload_bytes", 0)
                               for p in perfs if p["procid"] != 0)
            modeled = scan_max + span + gather_max + assemble

            # SOLO pass: each worker's compute slice re-run alone (fresh
            # process, no contention): with N processes sharing the host
            # even CPU times inflate (cache thrash), so the dedicated-host
            # model samples each slice uncontended.  p0's span is
            # max(varpass, encode): on a real host they run on separate
            # threads and cores.
            solo_perfs = []
            for i in range(n):
                solo_cfg = dict(
                    input=inp,
                    output=os.path.join(workdir, f"solo_{n}_{i}.xsi"),
                    block_length=block_length, device=device, nproc=n,
                    procid=i,
                    perf_out=os.path.join(workdir, f"solo_{n}_{i}.json"))
                best: dict = {}
                for _rep in range(2):   # min-of-2: stray host contention
                    child = _spawn("_scaling_solo_worker", solo_cfg, logf)
                    if child.wait() != 0:
                        raise RuntimeError(
                            f"solo worker failed: see {logf.name}")
                    for k, v in load(solo_cfg["perf_out"]).items():
                        best[k] = min(best[k], v) if k in best else v
                solo_perfs.append(best)
            solo_scan = max(p["scan_s"] for p in solo_perfs)
            solo_var0 = max(p.get("varpass_s", 0.0) for p in solo_perfs)
            # per-host span: encode and the (possibly distributed) variant
            # pass run on threads of the same host: take the busiest host
            solo_span = max(max(p["encode_s"], p.get("varpass_s", 0.0))
                            for p in solo_perfs)

            # Pure-communication sample: replay ONLY the gather rounds
            # (same structure and bytes, synthetic payloads).  With the
            # overlapped gather, communication hides behind encode; the
            # dedicated-host residual is what cannot hide: the tail
            # round, or the spill when comm_total exceeds the encode span.
            comm_total = 0.0
            rounds = max(int(p.get("gather_rounds", 0)) for p in perfs)
            if n > 1 and rounds:
                gcoord = f"127.0.0.1:{free_port()}"
                gcfgs = [dict(
                    coordinator=gcoord, nproc=n, procid=i,
                    payload_lens=perfs_by_id[i].get("payload_lens", []),
                    rounds=rounds,
                    chunk=max(int(p.get("gather_chunk", 8)) for p in perfs),
                    all_counts=[len(perfs_by_id[j].get("payload_lens", []))
                                for j in range(n)],
                    perf_out=os.path.join(workdir, f"go_{n}_{i}.json"))
                    for i in range(n)]
                gchildren = [_spawn("_gather_only_worker", cfg, logf)
                             for cfg in gcfgs]
                grcs = [c.wait() for c in gchildren]
                if any(grcs):
                    raise RuntimeError(f"gather-only worker failed: {grcs}")
                comm_total = max(load(c["perf_out"])["comm_s"]
                                 for c in gcfgs)
        comm_residual = (max(comm_total - solo_span, comm_total / rounds)
                         if rounds else 0.0)
        solo_wall = solo_scan + solo_span + comm_residual + assemble

        results.append(dict(
            procs=n, wall_s=wall, scan_cpu_s=scan_max,
            varpass_cpu_s=var0, encode_max_cpu_s=max(enc0, enc_others),
            gather_s=gather_max, assemble_cpu_s=assemble,
            gather_mb=gather_bytes / 1e6,
            solo_scan_s=solo_scan, solo_varpass_s=solo_var0,
            solo_encode_max_s=max(p["encode_s"] for p in solo_perfs),
            comm_total_s=comm_total, comm_residual_s=comm_residual,
            solo_wall_s=solo_wall,
            solo_compute_wall_s=solo_wall - comm_residual,
            modeled_wall_s=modeled if host_model else None,
            compute_wall_s=modeled - gather_max if host_model else None,
            launches=[perfs_by_id[i].get("launches", {})
                      for i in range(n)]))

    base = results[0]["modeled_wall_s"]
    base_c = results[0]["compute_wall_s"]
    base_s = results[0]["solo_wall_s"]
    base_sc = results[0]["solo_compute_wall_s"]

    def eff(num, den):   # micro workloads can bring a wall close to 0
        return num / max(den, 1e-6)

    for r in results:
        r["modeled_efficiency"] = r["compute_efficiency"] = None
        if host_model:
            r["modeled_efficiency"] = eff(base,
                                          r["procs"] * r["modeled_wall_s"])
            r["compute_efficiency"] = eff(base_c,
                                          r["procs"] * r["compute_wall_s"])
        r["solo_efficiency"] = eff(base_s, r["procs"] * r["solo_wall_s"])
        r["solo_compute_efficiency"] = eff(
            base_sc, r["procs"] * r["solo_compute_wall_s"])
    if own:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"records": n_records, "samples": n_samples,
            "block_length": block_length, "device": device,
            "single_process_compress_s": t_single,
            "byte_identical": True, "curve": results}
