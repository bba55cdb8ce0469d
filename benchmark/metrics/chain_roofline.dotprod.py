"""chain_roofline.dotprod: the decode chain's share of its roofline, %: the
byte bound of the window's chain calls (harness/decode_bounds.py
chain_decode_bytes, from each `decode.chain` span's width and chunk_lines
and its decode.chunks count, at 3.35 TB/s) over their device time, the
union of the kernels, copies and sets launched inside the program's
`decode.chain` marks (the traced run's profile)."""
from benchmark.harness import decode_marks, program_spans
from benchmark.harness.decode_bounds import chain_decode_bytes


def span_bytes(s) -> int | None:
    """The byte bound of one decode.chain span (None where it lacks a
    shape)."""
    n_ch = s.counts.get("decode.chunks")
    C, W = s.attrs.get("chunk_lines"), s.attrs.get("width")
    return None if None in (n_ch, C, W) else chain_decode_bytes(n_ch, C, W)


def install(probe):
    program_spans.enable()


def read(run):
    return decode_marks.roofline_pct(run, "decode.chain", span_bytes)
