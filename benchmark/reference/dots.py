"""Per-variant dot products of the panel's ALT dosages with a phenotype,
in float64: the reference the card's `dot_prod` is held to.

The phenotype is the one `dot_prod(path, seed)` documents and draws:
numpy's default_rng(seed).random(n_samples), each sample's weight taken
by both of its haplotypes.  ``tf32=True`` computes the same products in
the nearest precision below the program's float32 (TF32: the weights
rounded to 10 mantissa bits, float32 sums), the control of the dotprod
cell.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import gen


def phenotype(n_samples: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(n_samples)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties
    to even)."""
    bits = x.to(torch.float32).view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def dots(cfg: dict, seed: int, phen_seed: int, device,
         tf32: bool = False) -> np.ndarray:
    """float64[records]: sum over the haplotypes carrying ALT of their
    sample's weight, record by record."""
    y = torch.from_numpy(np.repeat(phenotype(int(cfg["samples"]),
                                             phen_seed), 2)).to(device)
    if tf32:
        y = round_tf32(y)
    draw = gen.Draw(cfg, seed, device)
    out = []
    for c in range(gen.n_chunks(cfg)):
        a = draw.alleles(c)
        out.append((a.to(y.dtype) @ y).to(torch.float64).cpu())
    return torch.cat(out).numpy()


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of a variant's dot, relative to the reference's dot
    or 1, whichever is larger (a dot is a sum of weights in [0, 1): a
    rare variant's is below 1)."""
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))
