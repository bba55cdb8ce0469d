"""product_roofline.dotprod: the block product's share of its roofline, %:
the byte bound of the window's dot_rows calls (harness/ploidy_bounds.py
product_bytes: the kept rows read once as uint8, keep, dots and weights,
and the haploid flags of a mixed block, from each `dot_prod.product`
span's rows, width, samples and mode, at 3.35 TB/s) over their device
time, the union of the kernels, copies and sets launched inside the
program's `dot_prod.product` marks (the traced run's profile: the keep
upload and the product kernels).  A program whose span lacks `samples`
gives None."""
from benchmark.harness import decode_marks, program_spans
from benchmark.harness.ploidy_bounds import product_bytes

SHAPE = ("rows", "width", "samples", "mode")


def span_bytes(s) -> int | None:
    """The byte bound of one dot_prod.product span (None where it lacks a
    shape)."""
    shape = [s.attrs.get(k) for k in SHAPE]
    return None if None in shape else product_bytes(*shape)


def install(probe):
    program_spans.enable()


def read(run):
    return decode_marks.roofline_pct(run, "dot_prod.product", span_bytes)
