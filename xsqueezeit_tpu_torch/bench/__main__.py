"""Tool-suite entry point — counterparts of the reference's standalone
benchmark/validation binaries (loading_time/, dot_prod/, af_stats/,
lockstep_loader/) and the xcf.cpp test-data generators.  The port's copy
of xsqueezeit_tpu/bench/__main__.py.

    python -m xsqueezeit_tpu_torch.bench loading_time  FILE [--native]
    python -m xsqueezeit_tpu_torch.bench dot_prod      FILE [--seed N]
                                                  [--device cuda|cpu|host]
    python -m xsqueezeit_tpu_torch.bench af_stats      FILE [--summary]
                                                       [--annotate OUT]
    python -m xsqueezeit_tpu_torch.bench lockstep      FILE_A FILE_B
    python -m xsqueezeit_tpu_torch.bench unphase       IN OUT [--random]
    python -m xsqueezeit_tpu_torch.bench sprinkle-missing IN OUT [--rate F]
    python -m xsqueezeit_tpu_torch.bench phase-switch-errors TEST REF
    python -m xsqueezeit_tpu_torch.bench phase         IN OUT [--windows]
    python -m xsqueezeit_tpu_torch.bench stats         FILE
    python -m xsqueezeit_tpu_torch.bench e2e   [--device cuda|cpu|numpy]
    python -m xsqueezeit_tpu_torch.bench hrc   [--device cuda|cpu|numpy]
    python -m xsqueezeit_tpu_torch.bench warmup --samples N
                                               [--device cuda|cpu]
    python -m xsqueezeit_tpu_torch.bench scaling [--procs 1,2,4]
                                               [--device cuda|cpu|numpy]

`dot_prod`, `e2e`, `hrc`, `warmup` and `scaling` run on the card unless
--device says otherwise (`scaling`'s processes share it when there is
one); on --device cuda without a card each exits 1 with one
line.  `dot_prod` decodes whole blocks of an .xsi on the torch device;
`--device host` walks the compressed forms on the host, and is the one
that reads a BCF or VCF.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    from ..utils.devprobe import DEVICES, DeviceUnavailable
    from .tools import DOT_PROD_DEVICES, _is_xsi
    from ..utils.malltune import tune_glibc_malloc
    tune_glibc_malloc()

    p = argparse.ArgumentParser(prog="xsqueezeit-tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    torch_devices = [d for d in DEVICES if d != "numpy"]

    s = sub.add_parser("loading_time")
    s.add_argument("file")
    s.add_argument("--native", action="store_true",
                   help="read through the C++ accessor library (XSI only)")
    s = sub.add_parser("dot_prod")
    s.add_argument("file")
    s.add_argument("--seed", type=int, default=42)
    s.add_argument("--device", default="cuda", choices=DOT_PROD_DEVICES,
                   help="cuda / cpu: decode whole blocks of an .xsi on "
                        "this torch device and multiply there; host: walk "
                        "the compressed forms (or a BCF/VCF) on the host")
    s = sub.add_parser("af_stats")
    s.add_argument("file")
    s.add_argument("--summary", action="store_true",
                   help="print only counts, not per-record stats")
    s.add_argument("--annotate", default=None,
                   help="write the variant BCF with AC/AN patched into INFO")
    s = sub.add_parser("lockstep")
    s.add_argument("file_a")
    s.add_argument("file_b")
    s = sub.add_parser("unphase")
    s.add_argument("infile")
    s.add_argument("outfile")
    s.add_argument("--random", action="store_true")
    s.add_argument("--seed", type=int, default=None)
    s = sub.add_parser("sprinkle-missing")
    s.add_argument("infile")
    s.add_argument("outfile")
    s.add_argument("--rate", type=float, default=0.01)
    s.add_argument("--seed", type=int, default=None)
    s = sub.add_parser("phase-switch-errors")
    s.add_argument("test_file")
    s.add_argument("ref_file")
    s = sub.add_parser("phase")
    s.add_argument("infile")
    s.add_argument("outfile")
    s.add_argument("--windows", action="store_true",
                   help="word-window parsimony phaser "
                        "(PhasingMachineryNew) instead of the "
                        "PBWT-neighbour heuristic")
    s.add_argument("--word-bits", type=int, default=64)
    s = sub.add_parser("stats")
    s.add_argument("file")
    s = sub.add_parser("e2e")
    s.add_argument("--records", type=int, default=20000)
    s.add_argument("--samples", type=int, default=2504)
    s.add_argument("--dir", default=None,
                   help="working directory (kept); default: temp")
    s.add_argument("--device", default="cuda", choices=DEVICES)
    s.add_argument("--zstd", action="store_true")
    s.add_argument("--missing", type=float, default=0.0,
                   help="fraction of genotype slots sprinkled missing "
                        "(exception-track stress regime)")

    s = sub.add_parser("hrc", help="HRC-width (64976 hap) file-level "
                                   "round trip + streamed lockstep")
    s.add_argument("--records", type=int, default=16384)
    s.add_argument("--samples", type=int, default=32488)
    s.add_argument("--block-length", type=int, default=4096)
    s.add_argument("--device", default="cuda", choices=DEVICES)
    s.add_argument("--dir", default=None)

    s = sub.add_parser("warmup", help="build the kernels, then encode and "
                                      "decode one block per shape of a "
                                      "geometry")
    s.add_argument("--samples", type=int, required=True)
    s.add_argument("--block-length", type=int, default=8192)
    s.add_argument("--maf-threshold", type=int, default=None)
    s.add_argument("--fracs", default="1.0,0.7,0.45,0.2")
    s.add_argument("--device", default="cuda", choices=torch_devices)

    s = sub.add_parser("scaling", help="multi-process compress scaling "
                                       "curve (torch.distributed, gloo)")
    s.add_argument("--records", type=int, default=20000)
    s.add_argument("--samples", type=int, default=500)
    s.add_argument("--block-length", type=int, default=1024)
    s.add_argument("--procs", default="1,2,4")
    s.add_argument("--dir", default=None)
    s.add_argument("--device", default="cuda", choices=DEVICES)

    args = p.parse_args(argv)
    if args.cmd == "dot_prod" and args.device != "host" and \
            not _is_xsi(args.file):
        p.error(f"dot_prod --device {args.device} reads .xsi input; a BCF "
                "or VCF takes --device host")
    try:
        return _dispatch(args)
    except DeviceUnavailable as exc:
        print(f"xsqueezeit-tools: error: {exc}", file=sys.stderr)
        return 1


def _dispatch(args) -> int:
    if args.cmd == "loading_time":
        from .tools import loading_time
        print(json.dumps(loading_time(args.file, native=args.native)))
    elif args.cmd == "dot_prod":
        from .tools import dot_prod
        out = dot_prod(args.file, seed=args.seed, device=args.device)
        out.pop("dots")
        print(json.dumps(out))
    elif args.cmd == "af_stats":
        from .tools import af_stats
        out = af_stats(args.file, annotate_out=args.annotate)
        if args.summary:
            out = {"records": out["records"], "seconds": out["seconds"]}
        print(json.dumps(out))
    elif args.cmd == "lockstep":
        from .tools import lockstep_load
        try:
            print(json.dumps(lockstep_load(args.file_a, args.file_b)))
        except AssertionError as e:
            print(f"MISMATCH: {e}", file=sys.stderr)
            return 1
    elif args.cmd == "unphase":
        from ..utils.mutate import unphase, unphase_random
        n = (unphase_random(args.infile, args.outfile, seed=args.seed)
             if args.random else unphase(args.infile, args.outfile))
        print(json.dumps({"records": n}))
    elif args.cmd == "sprinkle-missing":
        from ..utils.mutate import sprinkle_missing
        n = sprinkle_missing(args.infile, args.outfile, rate=args.rate,
                             seed=args.seed)
        print(json.dumps({"records": n}))
    elif args.cmd == "phase-switch-errors":
        from ..utils.mutate import compute_phase_switch_errors
        out = compute_phase_switch_errors(args.test_file, args.ref_file)
        out.pop("per_sample")
        print(json.dumps(out))
    elif args.cmd == "phase":
        if args.windows:
            from ..utils.phasing import phase_file_windows
            print(json.dumps(phase_file_windows(
                args.infile, args.outfile, word_bits=args.word_bits)))
        else:
            from ..utils.phasing import phase_file
            print(json.dumps(phase_file(args.infile, args.outfile)))
    elif args.cmd == "stats":
        from ..utils.stats import xsi_block_stats
        print(json.dumps(xsi_block_stats(args.file)))
    elif args.cmd == "e2e":
        from .e2e import run
        print(json.dumps(run(n_records=args.records, n_samples=args.samples,
                             workdir=args.dir, device=args.device,
                             zstd=args.zstd, missing_frac=args.missing)))
    elif args.cmd == "hrc":
        from .tools import hrc_scale
        print(json.dumps(hrc_scale(
            n_records=args.records, n_samples=args.samples,
            block_length=args.block_length, device=args.device,
            workdir=args.dir)))
    elif args.cmd == "warmup":
        from .tools import warmup
        print(json.dumps(warmup(
            args.samples, block_length=args.block_length,
            mac_threshold=args.maf_threshold,
            fracs=tuple(float(f) for f in args.fracs.split(",")),
            device=args.device)))
    elif args.cmd == "scaling":
        from .tools import scaling_curve
        procs = tuple(int(x) for x in args.procs.split(",") if x)
        print(json.dumps(scaling_curve(
            n_records=args.records, n_samples=args.samples,
            procs=procs, block_length=args.block_length,
            workdir=args.dir, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
