"""The controls: each cell's comparison run on an output that breaks what
its configuration states, which has to come out as not correct.

- `extract`: the reference in the program's place writes the panel's
  records with the phase bits dropped, which the lossless guarantee
  forbids; read back as the cell reads the program's output.
- `dotprod`: the reference's dots computed in TF32, the precision below
  the program's float32 (weights rounded to 10 mantissa bits, float32
  sums), against the float64 dots.

Run at a cell's own size on the card:

    python3 -m benchmark.harness.control --workload <cell> --seeds a,b,c

which prints one JSON line a seed with the numbers the cell compares.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from ..reference import dots
from ..reference.panel import Panel
from ..reference.readback import bcf_tally
from . import cells, gen


def control_extract(cfg: dict, traffic: dict, seed: int, device,
                    workdir: str) -> dict:
    path = os.path.join(workdir, "control.bcf")
    gen.write_bcf(path, cfg, seed, device, phased=False)
    t = bcf_tally(path, Panel(cfg, seed, device),
                  np.arange(int(cfg["records"])))
    return {"bad_records": t.bad_records, "bad_gt": t.bad_gt}


def control_dotprod(cfg: dict, traffic: dict, seed: int, device,
                    workdir: str) -> dict:
    want = dots.dots(cfg, seed, seed, device)
    got = dots.dots(cfg, seed, seed, device, tf32=True)
    return {"dot_rel_err": dots.rel_err(got, want)}


CONTROLS = {"extract": control_extract, "dotprod": control_dotprod}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.harness.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = os.path.dirname(cells.BENCH_DIR)
    cell = cells.load(args.workload, os.path.join(root, "BENCHMARK.json"))
    fn = CONTROLS[cell.traffic["operation"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="control_")
        try:
            got = fn(cell.config, cell.traffic, seed, args.device, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        limits = cell.traffic["limits"]
        fails = any(v > limits[k] for k, v in got.items() if k in limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got, "fails_a_limit": fails}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
