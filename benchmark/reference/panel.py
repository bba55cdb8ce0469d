"""The seed's panel, regenerated a chunk of records at a time, and the
comparison of records the program wrote against it."""
from __future__ import annotations

import numpy as np

from ..harness import gen


class Panel:
    """The expected gt codes of a configuration's panel for one seed,
    regenerated on `device` one chunk at a time (the current chunk
    kept)."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.draw = gen.Draw(cfg, seed, device)
        self.pos = gen.positions(cfg)
        self._chunk = (-1, None)

    def row(self, i: int) -> np.ndarray:
        """int8[H]: record i's gt codes."""
        c = i // gen.CHUNK
        if self._chunk[0] != c:
            codes = gen.gt_codes(self.draw.alleles(c))
            self._chunk = (c, codes.cpu().numpy())
        return self._chunk[1][i - c * gen.CHUNK]

    def index_of(self, pos1: int) -> int:
        """The record at 1-based POS `pos1`, or -1."""
        i, r = divmod(pos1 - int(self.cfg["first_pos"]),
                      int(self.cfg["spacing_bp"]))
        return i if r == 0 and 0 <= i < len(self.pos) else -1


class Tally:
    """Counts what differs between records read back and the panel:
    `bad_records` (a record out of place, repeated, missing, or with
    another site; wrong sample names count one) and `bad_gt` (gt entries
    that differ)."""

    def __init__(self, panel: Panel, want: np.ndarray):
        self.panel = panel
        self.want = [int(i) for i in want]
        self.got: list[int] = []
        self.bad_site = 0
        self.bad_gt = 0
        self.bad_names = 0
        self.unreadable = None

    def fail(self, exc: Exception) -> None:
        """The output could not be read to its end: every record it was
        to hold and did not give counts as missing."""
        self.unreadable = f"{type(exc).__name__}: {exc}"

    def names(self, samples: list) -> None:
        want = [f"S{i}" for i in range(int(self.panel.cfg["samples"]))]
        self.bad_names = int(list(samples) != want)

    def record(self, pos1: int, ident: str, alleles: list, gt) -> None:
        i = self.panel.index_of(pos1)
        self.got.append(i)
        if i < 0 or ident != f"rs{i}" or list(alleles) != ["G", "A"]:
            self.bad_site += 1
            return
        exp = self.panel.row(i)
        if gt is None or np.shape(gt) != exp.shape:
            self.bad_gt += exp.size
        else:
            self.bad_gt += int(np.count_nonzero(np.asarray(gt) != exp))

    @property
    def bad_records(self) -> int:
        """Sites that differ, plus records the output lacks or repeats or
        puts out of order, plus one for wrong sample names, plus one for
        an output not read to its end."""
        misplaced = sum(1 for a, b in zip(self.got, self.want) if a != b)
        return (self.bad_site + misplaced
                + abs(len(self.got) - len(self.want)) + self.bad_names
                + (self.unreadable is not None))
