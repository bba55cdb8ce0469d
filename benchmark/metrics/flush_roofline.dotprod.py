"""flush_roofline.dotprod: the run flush's share of its roofline, %: the
byte bound of the window's run flushes (harness/decode_bounds.py
flush_bytes, from each `decode.flush` span's chunks, chunk_lines, width,
haps, lines and history, at 3.35 TB/s) over their device time, the union of the
kernels, copies and sets launched inside the program's `decode.flush`
marks (the traced run's profile)."""
from benchmark.harness import decode_marks, program_spans
from benchmark.harness.decode_bounds import flush_bytes

SHAPE = ("chunks", "chunk_lines", "width", "haps", "lines", "history")


def span_bytes(s) -> int | None:
    """The byte bound of one decode.flush span (None where it lacks a
    shape)."""
    shape = [s.attrs.get(k) for k in SHAPE]
    return None if None in shape else flush_bytes(*shape)


def install(probe):
    program_spans.enable()


def read(run):
    return decode_marks.roofline_pct(run, "decode.flush", span_bytes)
