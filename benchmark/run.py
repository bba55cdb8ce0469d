"""The benchmark of xsqueezeit_tpu_torch on one NVIDIA card: one run of
one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each run is a new process: it loads the port's kernels and native library
from their build directory inside the checkout (only a first run builds
them), makes the cell's inputs from the seed, warms up with one
operation, runs operations back to back for --seconds as one
closed-loop client, then compares what the window produced with the
plain reference (benchmark/reference/) and prints one JSON line as the
last line of standard output.  With --trace 0 its metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from
spans around calls into the port, the port's launch counters and
torch.profiler.  A run without a card, or with fewer cards than the
cell asks for, fails with one line and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark.harness import cells, runner

    try:
        cell = cells.load(args.workload, os.path.join(ROOT, "BENCHMARK.json"))
    except (cells.UnknownCell, OSError) as exc:
        print(f"benchmark: error: {exc}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: error: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {torch.cuda.device_count()} "
              "(no CPU fallback)", file=sys.stderr)
        return 3
    torch.cuda.init()
    workdir = runner.workdir_for()
    try:
        run = runner.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda",
                         workdir=workdir, t_start=T_START)
        result, lines, rc = runner.run_cell(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for line in lines:
        print(line, file=sys.stderr)
    if rc == 0:
        print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
