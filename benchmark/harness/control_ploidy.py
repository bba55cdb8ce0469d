"""The control of the mixed-ploidy dotprod cells: the reference's dots of
the panel computed in TF32, the precision below the program's float32
(weights rounded to 10 mantissa bits, float32 sums), against its float64
dots; it has to come out as not correct.

Run at a cell's own size on the card, with `control.py`'s command line:

    python3 -m benchmark.harness.control_ploidy --workload <cell> \
        --seeds a,b,c

which prints one JSON line a seed with the numbers the cell compares.
"""
from __future__ import annotations

import sys

from ..reference import dots, ploidy_dots
from . import control

NAME = "dotprod_ploidy"


def control_dotprod_ploidy(cfg: dict, traffic: dict, seed: int, device,
                           workdir: str) -> dict:
    want = ploidy_dots.dots(cfg, seed, seed, device)
    got = ploidy_dots.dots(cfg, seed, seed, device, tf32=True)
    return {"dot_rel_err": dots.rel_err(got, want)}


def main(argv=None) -> int:
    control.CONTROLS.setdefault(NAME, control_dotprod_ploidy)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
