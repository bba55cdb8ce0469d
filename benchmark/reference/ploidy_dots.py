"""Per-variant dot products of a mixed-ploidy panel's ALT dosages with a
phenotype, in float64: the reference the card's `dot_prod` is held to on
the chrX cells.

A diploid record's dot is sum_s y[s] (a[2s] + a[2s + 1]), a haploid
record's sum_s y[s] a[s], over the N samples.  The phenotype y is the one
`dot_prod(path, seed)` draws: numpy's default_rng(seed).random(N).
``tf32=True`` computes the same products with y rounded to TF32's 10
mantissa bits and float32 sums, the precision below the program's
float32: the cells' control.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import gen, gen_ploidy
from .dots import phenotype, round_tf32


def dots(cfg: dict, seed: int, phen_seed: int, device,
         tf32: bool = False) -> np.ndarray:
    """float64[records]: each record's sum of its ALT alleles' sample
    weights, in record order."""
    y = torch.from_numpy(phenotype(int(cfg["samples"]), phen_seed)).to(device)
    if tf32:
        y = round_tf32(y)
    y2 = y.repeat_interleave(2)
    draw = gen_ploidy.PloidyDraw(cfg, seed, device)
    out = []
    for c in range(gen.n_chunks(cfg)):
        dip, a2, a1 = draw.alleles(c)
        got = torch.empty(len(dip), dtype=torch.float64)
        at = torch.from_numpy(dip)
        if a2 is not None:
            got[at] = (a2.to(y.dtype) @ y2).to(torch.float64).cpu()
        if a1 is not None:
            got[~at] = (a1.to(y.dtype) @ y).to(torch.float64).cpu()
        out.append(got)
    return torch.cat(out).numpy()
