"""Dot products on the card over a mixed-ploidy panel (males on chrX):
`bench.tools.dot_prod(path, seed)` over the whole container, as
`operations/dotprod.py` does over a diploid one.  A block across a PAR's
end decodes on the mixed route and its products weigh its haploid lines
by their even slots; a block of haploid lines decodes at H = n_samples.

Set-up makes the container with the program's own `-c` from the seed's
panel (`harness/gen_ploidy.py`).  An operation's logical bytes are the
panel's htslib gt arrays, n_gt x 4 B a record.  The check: every
operation's dots against the reference's float64 dots of the regenerated
panel (`reference/ploidy_dots.py`), the widest relative gap over all
variants of all operations.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

from benchmark.harness import gen_ploidy, inputs
from benchmark.harness.runner import Check, Done
from benchmark.reference import dots, ploidy_dots

NAME = "dotprod_ploidy"


def container(run) -> str:
    """The panel written as a BCF and compressed by the program (`-c` on
    the run's device), its BCF input removed."""
    src = os.path.join(run.workdir, "panel.bcf")
    gen_ploidy.write_bcf(src, run.cell.config, run.seed, run.device)
    xsi = os.path.join(run.workdir, "panel.xsi")
    inputs.cli(inputs.compress_args(run.cell.config, src, xsi, run.device))
    os.unlink(src)
    return xsi


def setup(run):
    return SimpleNamespace(run=run, xsi=container(run),
                           nbytes=gen_ploidy.logical_bytes(run.cell.config))


def operate(state, k):
    from xsqueezeit_tpu_torch.bench.tools import dot_prod
    out = dot_prod(state.xsi, seed=state.run.seed, device=state.run.device)
    return Done(state.nbytes, out["dots"])


def check(state, run):
    limits = run.cell.traffic["limits"]
    done = run.completed()
    if not done:
        return []
    want = ploidy_dots.dots(run.cell.config, run.seed, run.seed, run.device)
    err = max(dots.rel_err(np.asarray(r.done.output), want) for r in done)
    return [Check("dot_rel_err", err, limits["dot_rel_err"])]
