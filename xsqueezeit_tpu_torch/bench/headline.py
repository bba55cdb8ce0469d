"""The port's headline benchmark: encode + decode throughput of a
1KGP3-chr20-like genotype block on one card, every output held bit-exact
in the same run.

    python -m xsqueezeit_tpu_torch.bench.headline [--device cuda|cpu]
        [--repeats N]

The counterpart of the JAX package's root bench.py, with its workload,
unit and JSON keys.  The workload: make_block (seed 20), 2504 samples
(H = 5008 haplotypes, the 1000 Genomes phase 3 panel) x 8192 lines, MAF
threshold 10, every line's ALT 1; and the same block with 1 % of entries
missing (a missing track on every record).  The unit: logical htslib gt
bytes, L * H * 4; `value` is the round-trip rate, 2 * bytes / (encode +
decode).

One iteration of each regime:
- encode: the block's line classes from its per-line carrier counts on
  the host, their transfer, and encoder_torch.encode_block_core_compact
  (missing regime: the track rows too, and
  encode_block_core_compact_tracks) on the allele matrix staged once;
- decode: TorchBlockDecoder.host_inputs (missing regime: and
  track_carriers) from the serialized payload, the transfer, and
  decoder_torch._decode_block_full_gt (_decode_block_full_gt_tracks).
An iteration ends in a synchronize; its host-clock time is the rate's
time, and CUDA events time its device part (transfers included).  A
repeat is the mean of `iters` iterations after two warm-up ones; the
rates are the medians over the repeats, each with its min-max spread.

The checks, in the same run: the timed encode's output, assembled, and
TorchBlockEncoder.serialize() are byte-equal to GtBlockEncoder's payload;
the timed decode gives the input's gt codes on every line; the missing
block's payload also decodes with GtBlockDecoder on records 0, 1, L/2 and
L - 1.  Any mismatch exits non-zero.  On "cpu" the same code runs the
kernels' plain versions (the tests call run() at a small size); "cuda"
without a card is a one-line error, never a CPU run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..codec import decoder_torch, encoder_torch
from ..codec.gt_block import GtBlockEncoder
from ..codec.gt_block_decoder import GtBlockDecoder
from ..utils.devprobe import DeviceUnavailable, torch_device

N_SAMPLES = 2504
N_LINES = 8192
SEED = 20
MISSING_FRAC = 0.01
#: The C++ reference's own loading_time figure (chr20 gt load, 34.8 GB in
#: 15.83 s on its hardware), bench.py's baseline; not a TPU number.
REFERENCE_LOAD_GBPS = 2.2
METRIC = ("encode+decode GB/s on {where} (1KGP3-chr20-like blocks incl. "
          "sparse and negated lines, bit-exact); vs_baseline is against "
          "2.2 GB/s, the C++ reference's own loading_time figure on its "
          "hardware, not a TPU number")


def make_block(rng, n_samples: int, n_lines: int) -> np.ndarray:
    """bench.py's make_block: a rare-heavy MAF mix approximating 1KGP3
    chr20 (plus a near-fixed tail that encodes as negated sparse lines);
    int8[n_lines, 2 * n_samples] allele codes."""
    L, H = n_lines, 2 * n_samples
    kind = rng.random(L)
    freqs = np.where(
        kind < 0.53, rng.uniform(0.0, 0.0015, L),
        np.where(kind < 0.78, rng.uniform(0.0015, 0.05, L),
                 np.where(kind < 0.98, rng.uniform(0.05, 0.95, L),
                          rng.uniform(0.999, 1.0, L))))
    return (rng.random((L, H)) < freqs[:, None]).astype(np.int8)


class _Clock:
    """Times iterations of a host part followed by a device part: the
    host clock over the whole (ending in a synchronize) and, on a card,
    CUDA events over the device part."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def one(self, host, device):
        """One iteration: (output, wall ms, device ms or None)."""
        self.sync()
        t0 = time.perf_counter()
        h = host()
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        out = device(h)
        if self.cuda:
            e1.record()
        self.sync()
        wall = (time.perf_counter() - t0) * 1e3
        return out, wall, (e0.elapsed_time(e1) if self.cuda else None)

    def repeats(self, host, device, repeats: int, iters: int,
                warmup: int = 2):
        """Per repeat the mean wall and device ms of `iters` iterations;
        returns (the last output, [wall ms], [device ms or None])."""
        out = None
        for _ in range(warmup):
            out = self.one(host, device)[0]
        walls, devs = [], []
        for _ in range(repeats):
            w = d = 0.0
            for _ in range(iters):
                out, wi, di = self.one(host, device)
                w += wi
                d = None if di is None else d + di
            walls.append(w / iters)
            devs.append(None if d is None else d / iters)
        return out, walls, devs


def _spread(xs: list[float]) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"headline: FAIL: {msg}")


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _host_payload(kw: dict, gt: np.ndarray) -> bytes:
    ref = GtBlockEncoder(**kw)
    for row in gt:
        ref.encode_record(row, 2)
    return ref.serialize()


def run(n_samples: int = N_SAMPLES, n_lines: int = N_LINES,
        device: str = "cuda", repeats: int = 5, iters: int = 10) -> dict:
    """The benchmark at a block of n_lines x 2 * n_samples; returns the
    result dict (bench.py's keys and more).  Raises DeviceUnavailable for
    "cuda" without a card, SystemExit on a failed check."""
    dev = torch_device(device)
    clock = _Clock(dev)
    L, H = n_lines, 2 * n_samples
    mac = int(H * 0.001)
    sparse_cap = max(mac, 1)
    rng = np.random.default_rng(SEED)
    alleles = make_block(rng, n_samples, n_lines)
    gt = ((alleles.astype(np.int32) + 1) << 1)            # unphased
    gt_missing = np.where(rng.random((L, H)) < MISSING_FRAC, 0,
                          gt).astype(np.int32)
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=mac,
              default_phasing=0, aet_dtype=np.uint16)
    offs = np.arange(L + 1, dtype=np.int64) * H
    na = np.full(L, 2, np.int32)
    gt_bytes = L * H * 4

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype=dtype)

    def ingested(block):
        enc = encoder_torch.TorchBlockEncoder(device=dev, **kw)
        enc.encode_records(block.reshape(-1), offs, na, 0, L)
        return enc

    # ---- encode: host line classes + the core on the staged matrix -----
    def line_classes(ac):
        """WAH and sparse lines from the per-line carrier counts (taken at
        ingest), as prepare() classifies them."""
        m = np.minimum(ac, H - ac)
        is_wah = m > mac
        wah_rows, sparse_rows = np.flatnonzero(is_wah), np.flatnonzero(~is_wah)
        return (wah_rows, np.ones(len(wah_rows), bool), sparse_rows,
                (ac != m)[sparse_rows])

    def classes_to_device(c):
        return (t(c[0], torch.int64), t(c[1]), t(c[2], torch.int64), t(c[3]))

    a_dev, alts_dev = t(alleles), t(np.ones(L, np.int32))
    ac = alleles.sum(1, dtype=np.int64)
    def encode(c):
        return encoder_torch.encode_block_core_compact(
            a_dev, alts_dev, *classes_to_device(c), sparse_cap)

    outd, enc_ms, enc_dev = clock.repeats(lambda: line_classes(ac), encode,
                                          repeats, iters)
    del a_dev
    ref_payload = _host_payload(kw, gt)
    enc = ingested(gt)
    prep = enc.prepare()
    _require(enc.assemble(encoder_torch.host_outputs(outd, prep), prep)
             == ref_payload, "the timed encode's payload differs from "
                             "GtBlockEncoder's")
    payload = enc.serialize()
    _require(payload == ref_payload, "TorchBlockEncoder.serialize() differs "
                                     "from GtBlockEncoder's payload")
    del enc, prep, outd

    # ---- decode: host parse + transfer + the fused gt decode ------------
    dec = decoder_torch.TorchBlockDecoder(payload, n_samples, H, np.uint16,
                                          device=dev)
    _require(dec.eligible, "the block must take the device decode")

    def decode(hi):
        return decoder_torch._decode_block_full_gt(
            *[t(x) for x in hi[:7]], 0, hi[7], hi[8])

    gt_out, dec_ms, dec_dev = clock.repeats(dec.host_inputs, decode,
                                            repeats, iters)
    _require(bool((gt_out.cpu().numpy() == gt).all()),
             "the timed decode is not bit-exact")
    del gt_out, dec

    # ---- the missing regime ---------------------------------------------
    records_ms, prepare_ms, assemble_ms = [], [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        enc_m = ingested(gt_missing)
        t1 = time.perf_counter()
        prep_m = enc_m.prepare()
        t2 = time.perf_counter()
        out_m = enc_m.encode_prepared(prep_m)
        t3 = time.perf_counter()
        payload_m = enc_m.assemble(out_m, prep_m)
        t4 = time.perf_counter()
        records_ms.append((t1 - t0) * 1e3)
        prepare_ms.append((t2 - t1) * 1e3)
        assemble_ms.append((t4 - t3) * 1e3)
    ref_payload_m = _host_payload(kw, gt_missing)
    _require(payload_m == ref_payload_m, "the missing block's payload "
                                         "differs from GtBlockEncoder's")
    n_missing = np.asarray(enc_m._n_missing)
    n_eov = np.asarray(enc_m._n_eov)
    first_lines = prep_m["first_lines"]
    trk_cap = enc_m.track_cap(prep_m, False)
    am_dev = t(prep_m["alleles_p"])
    ac_m = (prep_m["alleles_p"] == 1).sum(1, dtype=np.int64)

    def missing_host():
        c = line_classes(ac_m)
        flag_m = np.flatnonzero(n_missing > 0)
        flag_e = np.flatnonzero(n_eov > 0)
        rows = first_lines[np.concatenate([flag_m, flag_e])]
        return c, rows, np.arange(len(rows)) >= len(flag_m)

    def missing_device(h):
        c, rows, kind = h
        return encoder_torch.encode_block_core_compact_tracks(
            am_dev, alts_dev, *classes_to_device(c), t(rows, torch.int64),
            t(kind), sparse_cap, trk_cap)

    outd_m, menc_ms, menc_dev = clock.repeats(missing_host, missing_device,
                                              repeats, iters)
    _require(enc_m.assemble(encoder_torch.host_outputs(outd_m, prep_m),
                            prep_m) == ref_payload_m,
             "the timed missing encode's payload differs from "
             "GtBlockEncoder's")
    del am_dev, outd_m, enc_m, prep_m

    dec_m = decoder_torch.TorchBlockDecoder(payload_m, n_samples, H,
                                            np.uint16, device=dev)
    _require(dec_m.eligible, "the missing block must take the device decode")
    meta = dec_m.meta
    no_pairs = np.zeros(0, np.int64)

    def missing_decode_host():
        hi = dec_m.host_inputs()
        return hi, decoder_torch.track_carriers(
            meta.missing_sparse, np.flatnonzero(meta.line_has_missing),
            np.uint16, dec_m.line_width, "missing")

    def missing_decode(h):
        hi, (mrec, midx) = h
        return decoder_torch._decode_block_full_gt_tracks(
            *[t(x) for x in hi[:7]], 0, t(mrec), t(midx), t(no_pairs),
            t(no_pairs), hi[7], hi[8])

    gt_out_m, mdec_ms, mdec_dev = clock.repeats(
        missing_decode_host, missing_decode, repeats, iters)
    _require(bool((gt_out_m.cpu().numpy() == gt_missing).all()),
             "the timed missing decode is not bit-exact")
    host = GtBlockDecoder(payload_m, n_samples, H, aet_dtype=np.uint16)
    for r in sorted({0, 1, L // 2, L - 1}):
        host.seek(r)
        _require(bool((host.fill_genotype_array_advance(2)
                       == gt_missing[r]).all()),
                 f"GtBlockDecoder's record {r} of the missing block")
    del gt_out_m, dec_m

    # ---- the result -------------------------------------------------------
    def gbps(ms):
        return gt_bytes / (ms * 1e-3) / 1e9

    per_repeat = {
        "value": [2 * gt_bytes / ((e + d) * 1e-3) / 1e9
                  for e, d in zip(enc_ms, dec_ms)],
        "encode_gbps": [gbps(x) for x in enc_ms],
        "decode_gbps": [gbps(x) for x in dec_ms],
        "missing_encode_gbps": [gbps(x) for x in menc_ms],
        "missing_decode_gbps": [gbps(x) for x in mdec_ms],
    }
    med = {k: statistics.median(v) for k, v in
           (("enc", enc_ms), ("dec", dec_ms), ("menc", menc_ms),
            ("mdec", mdec_ms))}
    value = 2 * gt_bytes / ((med["enc"] + med["dec"]) * 1e-3) / 1e9

    def device_ms(xs):
        return None if xs[0] is None else statistics.median(xs)

    return {
        "metric": METRIC.format(
            where="one CUDA device" if dev.type == "cuda"
            else "the CPU (the kernels' plain versions)"),
        "value": value,
        "unit": "GB/s",
        "vs_baseline": value / REFERENCE_LOAD_GBPS,
        "encode_gbps": gbps(med["enc"]),
        "decode_gbps": gbps(med["dec"]),
        "missing_encode_gbps": gbps(med["menc"]),
        "missing_decode_gbps": gbps(med["mdec"]),
        "missing_records_ms": statistics.median(records_ms),
        "missing_prepare_ms": statistics.median(prepare_ms),
        "missing_assemble_ms": statistics.median(assemble_ms),
        "compression_ratio": gt_bytes / len(payload),
        "spread": {k: _spread(v) for k, v in per_repeat.items()},
        "ms_per_block": {"encode": med["enc"], "decode": med["dec"],
                         "missing_encode": med["menc"],
                         "missing_decode": med["mdec"]},
        "device_ms_per_block": {"encode": device_ms(enc_dev),
                                "decode": device_ms(dec_dev),
                                "missing_encode": device_ms(menc_dev),
                                "missing_decode": device_ms(mdec_dev)},
        "workload": {"samples": n_samples, "haplotypes": H, "lines": L,
                     "mac_threshold": mac, "seed": SEED,
                     "missing_frac": MISSING_FRAC,
                     "payload_bytes": len(payload),
                     "missing_payload_bytes": len(payload_m)},
        "repeats": repeats, "iters": iters,
        "checks": "payloads byte-equal to GtBlockEncoder's; every decoded "
                  "line bit-exact; GtBlockDecoder on records 0, 1, L/2, "
                  "L-1 of the missing block",
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "card": _card() if dev.type == "cuda" else None,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m xsqueezeit_tpu_torch.bench.headline",
        description="Encode + decode throughput of a 1KGP3-chr20-like "
                    "block, bit-exact (the port's bench.py); prints one "
                    "JSON line.")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the CUDA kernels (fails without a card); "
                        "cpu: their plain versions")
    p.add_argument("--repeats", type=int, default=5,
                   help="repeats of each timing (median and spread)")
    args = p.parse_args(argv)
    if args.repeats < 1:
        print("headline: error: --repeats must be >= 1", file=sys.stderr)
        return 1
    from ..utils.malltune import tune_glibc_malloc
    tune_glibc_malloc()
    try:
        result = run(device=args.device, repeats=args.repeats)
    except DeviceUnavailable as exc:
        print(f"headline: error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
