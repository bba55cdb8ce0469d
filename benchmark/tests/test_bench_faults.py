"""Whole runs on the CPU device with the timed path broken underneath:
each fault a cell can have must make `correct` come out false.

- unchanged: the operation returns without producing anything new;
- half: half of the records (or variants) left out;
- altered: one genotype flipped where the program produces it (the block
  decode's bits).
There is no exchange between chips: every cell runs on one.
"""
from __future__ import annotations

import pytest
import torch


def _flip_decode(monkeypatch):
    from xsqueezeit_tpu_torch.codec import decoder_torch
    orig = decoder_torch._decode_block_vals

    def flipped(*args):
        vals = orig(*args)
        vals[0, 0] ^= 1
        return vals
    monkeypatch.setattr(decoder_torch, "_decode_block_vals", flipped)


def _flip_every_other_decode(monkeypatch):
    from xsqueezeit_tpu_torch.codec import decoder_torch
    orig = decoder_torch._decode_block_vals
    calls = []

    def flipped(*args):
        vals = orig(*args)
        calls.append(1)
        if len(calls) % 2:
            vals[0, 0] ^= 1
        return vals
    monkeypatch.setattr(decoder_torch, "_decode_block_vals", flipped)


def _half_records(monkeypatch):
    from xsqueezeit_tpu_torch.codec.decompressor import Decompressor
    orig = Decompressor.iter_decoded_records

    def every_other(self):
        for i, item in enumerate(orig(self)):
            if i % 2 == 0:
                yield item
    monkeypatch.setattr(Decompressor, "iter_decoded_records", every_other)


def _no_extract(monkeypatch):
    from xsqueezeit_tpu_torch.codec.decompressor import Decompressor
    monkeypatch.setattr(Decompressor, "decompress", lambda self, out: {})


def _dots(monkeypatch, how):
    from xsqueezeit_tpu_torch.bench import tools
    orig = tools._dot_prod_device

    def broken(path, seed, device):
        out = orig(path, seed, device)
        out["dots"] = (torch.zeros(len(out["dots"]), dtype=torch.float64)
                       .numpy() if how == "unchanged" else out["dots"][::2])
        return out
    monkeypatch.setattr(tools, "_dot_prod_device", broken)


FAULTS = {
    "kgp3-chr20.extract": {"unchanged": _no_extract,
                           "half": _half_records, "altered": _flip_decode},
}
for _cell in ("kgp3-chr20.dotprod", "hrc.dotprod"):
    FAULTS[_cell] = {"unchanged": lambda mp: _dots(mp, "unchanged"),
                     "half": lambda mp: _dots(mp, "half"),
                     "altered": _flip_decode}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FAULTS
                                        for f in FAULTS[c]])
def test_fault_makes_the_run_incorrect(tiny, monkeypatch, cell, fault):
    FAULTS[cell][fault](monkeypatch)
    result, lines, rc = tiny(cell, seconds=0.3)
    assert rc == 0
    assert result["correct"] is False, (result, lines)


def test_a_repeat_that_differs_is_caught(tiny, monkeypatch):
    """Every output of the window is compared: one repeat of the same
    work that differs from the first answer makes the run incorrect."""
    _flip_every_other_decode(monkeypatch)
    result, lines, rc = tiny("kgp3-chr20.extract", seconds=0.6)
    assert rc == 0 and result["attempted"] >= 2, lines
    assert result["checks"]["outputs_unlike"]["value"] > 0, lines
    assert result["correct"] is False
