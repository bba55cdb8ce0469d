"""Histogram / basic-stats helpers (the reference's data_mining.hpp L9
utilities, the xSqueezeIt reference's include/data_mining.hpp:1-107, rebuilt as
vectorised numpy) plus an XSI block-level stats report built on them —
compression diagnostics the reference computed ad hoc while debugging.
"""
from __future__ import annotations

import numpy as np


def extract_histogram(values) -> dict:
    """symbol -> count (data_mining.hpp extract_histogram)."""
    v, c = np.unique(np.asarray(values), return_counts=True)
    return dict(zip(v.tolist(), c.tolist()))


def histogram_width(values) -> int:
    """Number of distinct symbols (extract_histogram_widths element)."""
    return int(np.unique(np.asarray(values)).shape[0])


def basic_stats(values, name: str = "data") -> dict:
    """mean/median/max/min/std (data_mining.hpp print_basic_stats)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return {"name": name, "size": 0}
    return {
        "name": name,
        "size": int(v.size),
        "mean": float(v.mean()),
        "median": float(np.median(v)),
        "max": float(v.max()),
        "min": float(v.min()),
        "stdev": float(v.std()),
    }


def xsi_block_stats(xsi_path: str) -> dict:
    """Per-container compression diagnostics: WAH symbol diversity, run
    lengths, sparse line sizes, line-kind mix."""
    from ..codec.gt_block_decoder import GtBlockDecoder
    from ..format.container import XsiReader
    from ..ops.sparse_np import msb as _msb, sparse_line_offsets
    from ..ops.wah_np import WAH_HIGH_BIT, WAH_MAX_COUNTER

    rd = XsiReader(xsi_path)
    wah_widths = []
    fill_runs = []
    sparse_lens = []
    n_wah = n_sparse = 0
    for b in range(rd.n_blocks()):
        dec = GtBlockDecoder(rd.gt_block_payload(b), rd.n_samples, rd.n_haps,
                             rd.aet_dtype)
        is_wah = dec.line_is_wah.astype(bool)
        n_wah += int(is_wah.sum())
        n_sparse += int((~is_wah).sum())
        if dec.wah_stream is not None and is_wah.any():
            w = np.asarray(dec.wah_stream)
            wah_widths.append(histogram_width(w))
            is_ctr = (w & WAH_HIGH_BIT) != 0
            fill_runs.extend((w[is_ctr] & WAH_MAX_COUNTER).tolist())
        if dec.sparse_stream is not None and (~is_wah).any():
            sp = dec.sparse_stream
            offs = sparse_line_offsets(sp, int((~is_wah).sum()))
            heads = np.asarray(sp)[offs[:-1]].astype(np.int64)
            sparse_lens.extend(
                (heads & (_msb(rd.aet_dtype) - 1)).tolist())
    return {
        "blocks": rd.n_blocks(),
        "wah_lines": n_wah,
        "sparse_lines": n_sparse,
        "wah_symbol_widths": basic_stats(wah_widths, "wah_symbol_widths"),
        "wah_fill_run_words": basic_stats(fill_runs, "wah_fill_run_words"),
        "sparse_line_lengths": basic_stats(sparse_lens,
                                           "sparse_line_lengths"),
    }
