"""mixed_roofline.dotprod: the mixed-ploidy decode's share of its
roofline, %: the byte bound of the window's mixed blocks
(harness/ploidy_bounds.py mixed_block_bytes: the stored WAH words at 2 B,
the sparse heads and indices at their stored width, the lines x haps
plane written once, from each `decode.mixed` span's stream_words,
sparse_values, lines and haps, at 3.35 TB/s) over their device time, the
union of the kernels, copies and sets launched inside the program's
`decode.mixed` marks (the traced run's profile).  A program without the
span gives None."""
from benchmark.harness import decode_marks, program_spans
from benchmark.harness.ploidy_bounds import mixed_block_bytes

SHAPE = ("stream_words", "sparse_values", "lines", "haps")


def span_bytes(s) -> int | None:
    """The byte bound of one decode.mixed span (None where it lacks a
    shape)."""
    shape = [s.attrs.get(k) for k in SHAPE]
    return None if None in shape else mixed_block_bytes(*shape)


def install(probe):
    program_spans.enable()


def read(run):
    return decode_marks.roofline_pct(run, "decode.mixed", span_bytes)
