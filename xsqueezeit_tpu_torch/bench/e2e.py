"""End-to-end file-level benchmark: CLI wall-clock, file -> file.

The port's copy of xsqueezeit_tpu/bench/e2e.py::run (synth_bcf is
bench/synth.py).  The reference's decompression profile is dominated by
host serialization (>60% bcf_write1, ~15% bcf_update_genotypes,
gt_decompressor_new.hpp:308,315), so kernel GB/s alone overstates
user-visible speed.  This tool measures what a user sees:

    run    — write a chr20-like synthetic BCF (2504 samples, rare-heavy
             site-frequency mix, phased diploid), time `cli -c` (BCF ->
             .xsi) and `cli -x -O b` (.xsi -> BCF) wall-clock with
             `--device cuda|cpu|numpy`, verify the round trip on sampled
             records, and print MB/s over the logical htslib genotype
             bytes.

    python -m xsqueezeit_tpu_torch.bench e2e [--records N] [--samples N]
        [--dir D] [--device cuda|cpu|numpy]
"""
from __future__ import annotations

import os
import time

import numpy as np

from .synth import synth_bcf


def run(n_records: int = 20000, n_samples: int = 2504,
        workdir: str | None = None, device: str = "cuda",
        zstd: bool = False, missing_frac: float = 0.0) -> dict:
    import tempfile

    from ..cli import main as cli_main
    from ..io.unified import GtInput
    from ..utils.devprobe import torch_device

    torch_device(device)           # "cuda" without a card fails here
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="xsi_e2e_")
    os.makedirs(workdir, exist_ok=True)
    inp = os.path.join(workdir, "in.bcf")
    xsi = os.path.join(workdir, "out.xsi")
    back = os.path.join(workdir, "roundtrip.bcf")

    try:
        t0 = time.perf_counter()
        synth_bcf(inp, n_records, n_samples, missing_frac=missing_frac)
        t_synth = time.perf_counter() - t0

        t0 = time.perf_counter()
        rc = cli_main(["-c", "-f", inp, "-o", xsi, "--device", device]
                      + (["--zstd"] if zstd else []))
        t_compress = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli -c --device {device} exited {rc}")

        t0 = time.perf_counter()
        rc = cli_main(["-x", "-f", xsi, "-o", back, "-O", "b",
                       "--device", device])
        t_extract = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli -x --device {device} exited {rc}")

        # verify: sampled lockstep (full lockstep is the bench/lockstep tool)
        a, b = GtInput(inp), GtInput(back)
        step = max(n_records // 64, 1)
        for i, (ra, rb) in enumerate(zip(a, b)):
            if i % step == 0 and not np.array_equal(ra.gt, rb.gt):
                raise AssertionError(f"round-trip mismatch at record {i}")
        a.close()
        b.close()

        logical = n_records * n_samples * 2 * 4
        return {
            "records": n_records,
            "samples": n_samples,
            "device": device,
            "missing_frac": missing_frac,
            "logical_mb": round(logical / 1e6, 1),
            "input_bcf_mb": round(os.path.getsize(inp) / 1e6, 2),
            "xsi_mb": round(os.path.getsize(xsi) / 1e6, 3),
            "synth_s": round(t_synth, 2),
            "compress_s": round(t_compress, 2),
            "extract_s": round(t_extract, 2),
            "compress_mb_s": round(logical / t_compress / 1e6, 1),
            "extract_mb_s": round(logical / t_extract / 1e6, 1),
            "workdir": workdir if not own else "(temp)",
        }
    finally:
        if own:
            import shutil
            shutil.rmtree(workdir, ignore_errors=True)
