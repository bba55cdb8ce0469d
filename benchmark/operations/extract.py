"""Extract: `xsqueezeit -x -O b` of the whole container, file to file,
in the client's process (xsqueezeit_tpu_torch.cli.main).

Set-up makes the container with the program's own `-c` from the seed's
panel.  Each operation writes a BCF of every record and sample.  The
check: every output byte-equal to the first, and a sample of them
(traffic `check_sample`, drawn from the seed) read back record by record
against the regenerated panel: every site, genotype and phase bit.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

from benchmark.harness import inputs
from benchmark.harness.runner import Check, Done
from benchmark.reference.panel import Panel
from benchmark.reference.readback import bcf_tally

NAME = "extract"


def setup(run):
    return SimpleNamespace(run=run, xsi=inputs.container(run),
                           out=inputs.outdir(run),
                           nbytes=inputs.logical_bytes(run.cell.config))


def operate(state, k):
    out = os.path.join(state.out, f"{k}.bcf")
    inputs.cli(["-x", "-f", state.xsi, "-o", out, "-O",
                state.run.cell.traffic["output_type"],
                "--device", state.run.device])
    if k < 0 and os.path.exists(out):
        os.unlink(out)
    return Done(state.nbytes, out)


def check(state, run):
    cfg, limits = run.cell.config, run.cell.traffic["limits"]
    done = run.completed()
    if not done:
        return []
    panel = Panel(cfg, run.seed, run.device)
    everything = np.arange(int(cfg["records"]))
    bad_records = bad_gt = 0
    for r in run.sample(int(run.cell.traffic["check_sample"])):
        t = bcf_tally(r.done.output, panel, everything)
        bad_records += t.bad_records
        bad_gt += t.bad_gt
    return [Check("bad_records", bad_records, limits["bad_records"]),
            Check("bad_gt", bad_gt, limits["bad_gt"]),
            Check("outputs_unlike",
                  inputs.unlike(done, lambda r: [r.done.output]),
                  limits["outputs_unlike"])]
