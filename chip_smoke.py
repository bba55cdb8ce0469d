#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (xsqueezeit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path -- the XSI block encoder and decoder at 1KGP3
geometry (2504 samples = 5008 haplotypes x 8192 lines, MAF threshold 10,
the rare-heavy mix of bench.py) -- and checks every result exactly:

1. machine facts (card, power limit, torch/CUDA/nvcc versions);
2. builds the kernels from xsqueezeit_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at main-path
   shapes, bit-exact, with both times;
4. block encode + decode: the payload must be byte-equal to the host
   GtBlockEncoder's and the decode bit-exact on every line; prints ms/block
   and GB/s in bench.py's unit (L * H * 4 logical gt bytes) and the
   compression ratio;
5. every kernel's launch count over the main-path run must be > 0.

The file-level CLI round trip is not part of this script: the container
module imports `zstandard` at module level, and the script has to run
where only torch and numpy are installed (PERF.md, ROADMAP.md).  The CPU
tests cover that path.  Any failure exits non-zero; the last line of
standard output is the result JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from xsqueezeit_tpu_torch.codec import decoder_torch, encoder_torch
from xsqueezeit_tpu_torch.ops import _build, pbwt_kernels, wah_kernels
from xsqueezeit_tpu_torch.ops import wah_torch
from xsqueezeit_tpu_torch.reference import GtBlockEncoder

N_SAMPLES = 2504
H = 2 * N_SAMPLES
L = 8192
MAF_THRESHOLD = int(H * 0.001)        # = 10
SEED = 20
DEVICE = "cuda"

KERNEL_SHAPES = dict(H=H, C=16, n_ch=256, n_lines=4096, w=(H + 14) // 15)


def make_block(rng):
    """bench.py's workload: a rare-heavy MAF mix approximating 1KGP3 chr20
    (plus a near-fixed tail that encodes as negated sparse lines)."""
    kind = rng.random(L)
    freqs = np.where(
        kind < 0.53, rng.uniform(0.0, 0.0015, L),
        np.where(kind < 0.78, rng.uniform(0.0015, 0.05, L),
                 np.where(kind < 0.98, rng.uniform(0.05, 0.95, L),
                          rng.uniform(0.999, 1.0, L))))
    return (rng.random((L, H)) < freqs[:, None]).astype(np.int8)


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
    if a.shape != b.shape:
        raise SystemExit(f"chip_smoke: FAIL: shapes {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


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
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {_build.LIB_PATH} "
          f"in {_build.last_build_seconds:.2f} s")


def wah_rows(bits):
    """Concatenated WAH stream of bit rows (the port's plain encoder)."""
    words, n = wah_torch.wah_compress_words(wah_torch.pack_bits(bits))
    keep = torch.arange(words.shape[1])[None, :] < n[:, None]
    return words[keep]


def check_kernels(card: str) -> list[dict]:
    """Each kernel vs its plain version on the card at main-path shapes,
    bit-exact; both timed by CUDA events."""

    s = KERNEL_SHAPES
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    ss = torch.from_numpy(rng.random((s["n_ch"], s["C"])) < 0.9).to(dev)
    q0 = torch.from_numpy(rng.integers(0, 1 << 16, (s["n_ch"], s["H"]),
                                       dtype=np.int32)).to(dev)
    p = rng.choice([0.002, 0.05, 0.3, 0.7, 0.99], (s["n_ch"], s["C"], 1))
    yc = torch.from_numpy(
        (rng.random((s["n_ch"], s["C"], s["H"])) < p).astype(np.uint8)).to(dev)
    dens = rng.choice([0.0, 0.0005, 0.01, 0.3, 0.9, 0.999, 1.0],
                      (s["n_lines"], 1))
    bits = torch.from_numpy(
        (rng.random((s["n_lines"], s["H"])) < dens).astype(np.uint8))
    words_cpu = wah_torch.pack_bits(bits)
    stream = torch.cat([wah_rows(bits), torch.zeros(64, dtype=torch.uint16)])
    words = words_cpu.to(dev)
    stream = stream.to(dev)

    cases = [
        ("chain_encode", "pbwt_chain.cu", "ops/pbwt_pallas.py:133",
         lambda: pbwt_kernels.chain_encode(q0, ss),
         lambda: pbwt_kernels.chain_encode_plain(q0, ss)),
        ("chain_decode", "pbwt_chain.cu", "ops/pbwt_pallas.py:76",
         lambda: pbwt_kernels.chain_decode(yc, ss),
         lambda: pbwt_kernels.chain_decode_plain(yc, ss)),
        ("wah_expand", "wah.cu", "ops/wah_pallas.py:51",
         lambda: wah_kernels.wah_expand(stream, s["n_lines"], s["w"]),
         lambda: wah_kernels.wah_expand_plain(stream, s["n_lines"], s["w"])),
        ("wah_compress", "wah.cu", "ops/wah_pallas.py:112",
         lambda: wah_kernels.wah_compress(words),
         lambda: wah_kernels.wah_compress_plain(words)),
    ]
    rows = []
    for name, src, replaces, kern, plain in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if isinstance(got, tuple):   # wah_compress: (words, counts)
            err = max(diff(g, w) for g, w in zip(got, want))
        else:
            err = diff(got, want)
        require(err == 0, f"{name}: kernel differs from its plain version "
                          f"(max abs err {err})")
        if name == "wah_expand":     # and from the words that were encoded
            err2 = diff(got.cpu(), words_cpu)
            require(err2 == 0, f"wah_expand: expansion differs from the "
                               f"encoded words (max abs err {err2})")
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        print(f"kernel {name}: bit-exact vs plain; {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms ({card})")
        rows.append({"name": name, "route": "cuda",
                     "source": f"xsqueezeit_tpu_torch/csrc/{src}",
                     "replaces": f"xsqueezeit_tpu/{replaces}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return rows


def block_level(card: str) -> dict:
    """The main path at 1KGP3 geometry; returns the launch counts of its
    one run, then times encode and decode."""

    alleles = make_block(np.random.default_rng(SEED))
    gt = (alleles.astype(np.int32) + 1) << 1          # unphased biallelic
    kw = dict(n_samples=N_SAMPLES, block_bcf_lines=L,
              mac_threshold=MAF_THRESHOLD, default_phasing=0,
              aet_dtype=np.uint16)

    t0 = time.perf_counter()
    ref = GtBlockEncoder(**kw)
    for row in gt:
        ref.encode_record(row, 2)
    ref_payload = ref.serialize()
    print(f"host GtBlockEncoder reference: {len(ref_payload)} B in "
          f"{time.perf_counter() - t0:.1f} s")

    def ingest():
        enc = encoder_torch.TorchBlockEncoder(device=DEVICE, **kw)
        enc.encode_records(gt.reshape(-1),
                           np.arange(L + 1, dtype=np.int64) * H,
                           np.full(L, 2, np.int32), 0, L)
        return enc

    enc = ingest()
    counters = (pbwt_kernels.launches, wah_kernels.launches)
    # ---- the main path, once, with every launch counter at 0 ----------
    for c in counters:
        for k in c:
            c[k] = 0
    payload = enc.serialize()
    recs = decoder_torch.decode_block_records(
        payload, N_SAMPLES, H, np.uint16, [2] * L, device=DEVICE)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items()}
    # --------------------------------------------------------------------
    print(f"main-path launches: {launches}")
    require(payload == ref_payload,
            f"payload differs from GtBlockEncoder's ({len(payload)} vs "
            f"{len(ref_payload)} B)")
    got = np.stack(recs)
    bad = int((got != gt).any(1).sum())
    require(bad == 0, f"{bad} of {L} decoded lines differ from the input")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched by the main path")

    # line classes, as the payload stores them
    ac = alleles.sum(1, dtype=np.int64)
    mac = np.minimum(ac, H - ac)
    n_wah = int((mac > MAF_THRESHOLD).sum())
    n_neg = int(((mac <= MAF_THRESHOLD) & (ac != mac)).sum())
    print(f"block: {L} lines x {H} haplotypes; {n_wah} WAH lines, "
          f"{L - n_wah} sparse lines ({n_neg} negated); payload "
          f"{len(payload)} B byte-equal to GtBlockEncoder's; decode "
          f"bit-exact on all {L} lines")

    # ---- timing, in bench.py's unit (L * H * 4 logical gt bytes) ------
    prep = enc.prepare(pad=False)
    dev = torch.device(DEVICE)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype=dtype)

    staged = (t(prep["alleles_p"]), t(prep["alts_p"]),
              t(prep["wah_rows_p"], torch.int64), t(prep["sorts_w"]),
              t(prep["sparse_rows_p"], torch.int64), t(prep["negated_s"]))
    cap = max(MAF_THRESHOLD, 1)
    enc_ms = cuda_ms(lambda: encoder_torch.encode_block_core_compact(
        *staged, cap), iters=10, warmup=2)
    ser_ms = wall_ms(lambda: ingest().serialize(), iters=3, warmup=1)

    dec = decoder_torch.TorchBlockDecoder(payload, N_SAMPLES, H, np.uint16,
                                          device=dev)
    *dstaged, h, w, _ = dec.device_inputs()
    gt_dev = decoder_torch._decode_block_full_gt(*dstaged, 0, h, w)
    require(bool((gt_dev.cpu().numpy() == gt).all()),
            "fused decode to gt codes is not bit-exact")

    def decode_once():
        dec.host_inputs()                 # the per-block host parse
        return decoder_torch._decode_block_full_gt(*dstaged, 0, h, w)

    dec_ms = wall_ms(decode_once)
    rec_ms = wall_ms(lambda: decoder_torch.decode_block_records(
        payload, N_SAMPLES, H, np.uint16, [2] * L, device=DEVICE),
        iters=3, warmup=1)
    gt_bytes = L * H * 4
    ratio = gt_bytes / len(payload)
    print(f"encode core: {enc_ms:.3f} ms/block = "
          f"{gt_bytes / enc_ms / 1e6:.2f} GB/s | decode to gt codes (host "
          f"parse + device): {dec_ms:.3f} ms/block = "
          f"{gt_bytes / dec_ms / 1e6:.2f} GB/s | serialize (ingest + "
          f"prepare + device + assemble): {ser_ms:.1f} ms | "
          f"decode_block_records: {rec_ms:.1f} ms | compression "
          f"{ratio:.2f}x ({card})")
    return {"launches": launches, "encode_ms": enc_ms, "decode_ms": dec_ms,
            "serialize_ms": ser_ms, "decode_records_ms": rec_ms,
            "compression_ratio": ratio, "payload_bytes": len(payload)}


def main() -> int:
    # The native host library links libzstd; pin the NumPy host paths so
    # the run does not depend on it.
    os.environ.setdefault("XSI_NATIVE", "0")
    os.environ.setdefault("XSI_NATIVE_ENCODE", "0")

    card = machine_facts()
    build_kernels()
    rows = check_kernels(card)
    blk = block_level(card)
    for r in rows:
        r["launches"] = blk["launches"][r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"block": {k: v for k, v in blk.items()
                                if k != "launches"}, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
