"""Dot products on the card: `bench.tools.dot_prod(path, seed)` over the
whole container, the compressive computation of the reference's
`dot_prod/` tool.  Each block decodes on the device and its bi-allelic
lines multiply with the phenotype there, in float32; only the
per-variant dots come back.

Set-up makes the container with the program's own `-c` from the seed's
panel; the phenotype is the one `dot_prod` draws from the run's seed.
The check: every operation's dots against the reference's float64 dots
of the regenerated panel (`reference/dots.py`), the widest relative gap
over all variants of all operations.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from benchmark.harness import inputs
from benchmark.harness.runner import Check, Done
from benchmark.reference import dots

NAME = "dotprod"


def setup(run):
    return SimpleNamespace(run=run, xsi=inputs.container(run),
                           nbytes=inputs.logical_bytes(run.cell.config))


def operate(state, k):
    from xsqueezeit_tpu_torch.bench.tools import dot_prod
    out = dot_prod(state.xsi, seed=state.run.seed, device=state.run.device)
    return Done(state.nbytes, out["dots"])


def check(state, run):
    limits = run.cell.traffic["limits"]
    done = run.completed()
    if not done:
        return []
    want = dots.dots(run.cell.config, run.seed, run.seed, run.device)
    err = max(dots.rel_err(np.asarray(r.done.output), want) for r in done)
    return [Check("dot_rel_err", err, limits["dot_rel_err"])]
