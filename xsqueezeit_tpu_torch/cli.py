"""xsqueezeit-compatible command line interface on the torch codec.

Port of xsqueezeit_tpu/cli.py (compress, extract, info):

    python -m xsqueezeit_tpu_torch.cli -c -f in.{vcf,vcf.gz,bcf} -o out.xsi
        [--zstd] [--maf F] [--variant-block-length N] [--zstd-level L]
        [--wah-encode-missing] [-v] [--device cuda|cpu|numpy]
    python -m xsqueezeit_tpu_torch.cli -x -f out.xsi -o out.bcf
        [-O b|u|z|v|x] [-r REGIONS] [-R FILE] [-t TARGETS] [-s SAMPLES]
        [-S FILE] [-H] [-p] [--device cuda|cpu|numpy]
    python -m xsqueezeit_tpu_torch.cli -i -f out.xsi
    python -m xsqueezeit_tpu_torch.cli --count-xcf -f in.{vcf,bcf}

--profile DIR (with any mode) writes a torch.profiler Chrome trace of the
run into DIR, every thread's host activity with the program's spans as
its marks, and the card's activity on --device cuda.
--distributed HOST:PORT --dist-nproc N --dist-procid I (with -c, or -x to
-O b) runs one of N processes of a torch.distributed (gloo) job: launch N
with the same arguments and I = 0..N-1; process 0 listens at HOST:PORT
and writes the output.  Each encodes or decodes its range of blocks on
--device; ranks may share one card.  With -v each rank prints its
timings and kernel launches as one JSON line on stderr.
--device cuda (the default) runs the CUDA kernels and fails when there is
no card; cpu runs their plain versions on CPU tensors; numpy is the
host codec (the port's copy of the JAX package's NumPy codec).  Output
files are byte-identical across devices, and to the JAX package's.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import struct
import sys

from .format.constants import (
    DEFAULT_BLOCK_LENGTH,
    DEFAULT_MAF,
    DEFAULT_ZSTD_LEVEL,
)
from .format.container import ZstdUnavailable
from .utils.devprobe import DEVICES, DeviceUnavailable


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="xsqueezeit",
        description="xSqueezeIt - VCF/BCF Compressor (PyTorch + CUDA)")
    p.add_argument("-f", "--file", default="-", help="Input file name")
    p.add_argument("-o", "--output", default="-", help="Output file name")
    p.add_argument("-O", "--output-type", default="b", choices="buzvx",
                   help="Output type b|u|z|v|x")
    p.add_argument("-p", "--fast-pipe", action="store_true",
                   help="Outputs uncompressed BCF (-Ou) when writing to "
                        "stdout")
    p.add_argument("-c", "--compress", action="store_true", help="Compress")
    p.add_argument("-d", "--decompress", action="store_true",
                   help="Decompress")
    p.add_argument("-x", "--extract", action="store_true",
                   dest="decompress", help="Extract (Decompress)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Verbose, prints progress")
    p.add_argument("--zstd", action="store_true",
                   help="Compress blocks with zstd")
    p.add_argument("--zstd-level", "--zl", type=int,
                   default=DEFAULT_ZSTD_LEVEL, help="zstd compression level")
    p.add_argument("--maf", type=float, default=DEFAULT_MAF,
                   help="Minor Allele Frequency threshold")
    p.add_argument("-i", "--info", action="store_true",
                   help="Get info on file")
    p.add_argument("--variant-block-length", type=int,
                   default=DEFAULT_BLOCK_LENGTH,
                   help="Number of VCF lines to compress together")
    p.add_argument("--wah-encode-missing", action="store_true",
                   help="Encode missing alleles with WAH strategy")
    p.add_argument("-s", "--samples", default="",
                   help='Comma-separated samples to include ("^" to exclude)')
    p.add_argument("-S", "--samples-file", default="",
                   help="File of sample names (one per line)")
    p.add_argument("-r", "--regions", default="",
                   help="chr|chr:pos|chr:beg-end[,...]")
    p.add_argument("-R", "--regions-file", default="", help="Region file")
    p.add_argument("-t", "--targets", default="",
                   help="Targets (POS-only filter, streamed)")
    p.add_argument("-H", "--no-header", action="store_true",
                   help="Suppress the header in VCF output")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="cuda: CUDA kernels (fails without a card); cpu: "
                        "their plain versions on CPU tensors; numpy: the "
                        "host codec")
    p.add_argument("--profile", default="",
                   help="Write a torch.profiler trace of the run to this "
                        "directory (Chrome trace JSON)")
    p.add_argument("--count-xcf", action="store_true",
                   help="Count the variant entries of a VCF/BCF and print "
                        "the elapsed time (reference debug utility)")
    p.add_argument("--distributed", default="", metavar="HOST:PORT",
                   help="Multi-process run: the torch.distributed (gloo) "
                        "address of process 0; launch one identical "
                        "process per rank with --dist-nproc/--dist-procid "
                        "(process 0 writes output)")
    p.add_argument("--dist-nproc", type=int, default=None,
                   help="Total number of processes of the distributed run")
    p.add_argument("--dist-procid", type=int, default=None,
                   help="This process's id (0-based) in the distributed run")
    return p


def main(argv: list[str] | None = None) -> int:
    from .utils.malltune import tune_glibc_malloc
    tune_glibc_malloc()

    args = build_parser().parse_args(argv)
    if args.variant_block_length < 1:
        print("xsqueezeit: error: --variant-block-length must be >= 1",
              file=sys.stderr)
        return 1
    try:
        with _profiler(args):
            return _dispatch(args)
    except BrokenPipeError:
        # downstream closed the pipe: exit quietly like htslib tools
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 141  # 128 + SIGPIPE
    except KeyboardInterrupt:
        return 130
    except (ValueError, OSError, EOFError, NotImplementedError,
            DeviceUnavailable, ZstdUnavailable, struct.error) as exc:
        # one-line diagnostics for user-level failures (XSI_DEBUG=1
        # re-raises for development)
        if os.environ.get("XSI_DEBUG"):
            raise
        msg = str(exc) or exc.__class__.__name__
        print(f"xsqueezeit: error: {msg}", file=sys.stderr)
        return 1


@contextlib.contextmanager
def _profiler(args):
    """torch.profiler over the run when --profile DIR is given (the
    counterpart of the JAX package's jax.profiler.trace): host activity on
    every thread, with the program's spans (utils/trace.py) as its marks,
    plus the card's on --device cuda; the trace is written into DIR when
    the run ends."""
    if not args.profile:
        yield
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    from .utils import trace
    activities = [ProfilerActivity.CPU]
    if args.device == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # the decompressor decodes its batches on a worker thread
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(args.profile),
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)):
        trace.enable()
        try:
            yield
        finally:
            trace.disable()
            trace.collect()


def _read_regions_file(path: str) -> list[str]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or line.startswith("#"):
                continue
            if len(parts) >= 3:
                out.append(f"{parts[0]}:{parts[1]}-{parts[2]}")
            elif len(parts) == 2:
                out.append(f"{parts[0]}:{parts[1]}")
            else:
                out.append(parts[0])
    return out


def _print_rank_perf(args, perf: dict) -> None:
    """One JSON line per rank on stderr: its seconds, sizes and kernel
    launches (parallel/distributed.py's perf)."""
    import json
    perf = {k: v for k, v in perf.items() if k != "payload_lens"}
    print(f"xsqueezeit: rank {args.dist_procid}/{args.dist_nproc} perf "
          f"{json.dumps(perf)}", file=sys.stderr)


def _dispatch(args) -> int:
    if args.info:
        from .format.header import XsiHeader
        with open(args.file, "rb") as f:
            header = XsiHeader.unpack(f.read(256))
        print(header.info_string(), file=sys.stderr)
        return 0

    if args.count_xcf:
        # reference parity: --count-xcf (xsqueezeit.cpp:58-64 ->
        # count_entries, xcf.cpp:318-340)
        import time
        from .io.unified import count_entries
        t0 = time.perf_counter()
        count = count_entries(args.file)
        elapsed = time.perf_counter() - t0
        print(f"INFO : Number of entries is : {count}", file=sys.stderr)
        print(f"Time taken : {elapsed:.6f} s", file=sys.stderr)
        return 0

    if args.compress:
        from .codec.compressor import CompressorOptions, compress_file
        opts = CompressorOptions(
            maf=args.maf, block_length=args.variant_block_length,
            zstd=args.zstd, zstd_level=args.zstd_level,
            wah_encode_missing=args.wah_encode_missing,
            verbose=args.verbose, device=args.device)
        if args.distributed:
            from .parallel.distributed import compress_file_multihost
            perf: dict = {}
            stats = compress_file_multihost(
                args.file, args.output, opts,
                coordinator=args.distributed,
                num_processes=args.dist_nproc,
                process_id=args.dist_procid, perf=perf)
            if args.verbose:
                _print_rank_perf(args, perf)
            if stats is None:      # non-zero process: encode + gather only
                return 0
        else:
            stats = compress_file(args.file, args.output, opts)
        if args.verbose:
            print(f"Compressed {stats['entries']} entries "
                  f"({stats['variants']} variants) of {stats['n_samples']} "
                  f"samples into {stats['xsi_bytes']} + "
                  f"{stats['variant_bytes']} bytes", file=sys.stderr)
        return 0

    if args.decompress:
        from .codec.decompressor import Decompressor, DecompressorOptions
        regions = args.regions
        if args.regions_file:
            regions = ",".join([r for r in [regions] if r]
                               + _read_regions_file(args.regions_file))
        output_type = args.output_type
        out = args.output
        if out == "-" and output_type == "b":
            # text to stdout unless -p, which pipes uncompressed BCF (-Ou)
            output_type = "u" if args.fast_pipe else "v"
        if out.endswith(".vcf"):
            output_type = "v" if output_type in ("b", "u") else output_type
        opts = DecompressorOptions(
            regions=regions, targets=args.targets, samples=args.samples,
            samples_file=args.samples_file, output_type=output_type,
            no_header=args.no_header, verbose=args.verbose,
            device=args.device)
        if args.distributed:
            from .parallel.distributed import decompress_file_multihost
            perf = {}
            decompress_file_multihost(
                args.file, out, opts,
                coordinator=args.distributed,
                num_processes=args.dist_nproc,
                process_id=args.dist_procid, perf=perf)
            if args.verbose:
                _print_rank_perf(args, perf)
            return 0
        Decompressor(args.file, opts).decompress(out)
        return 0

    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
