"""readback_wait_ms.dotprod: host milliseconds a block's dots take to come
back (bench/tools.py: `.cpu()` of the block's dots, which waits for the
device to finish the block's decode and product), the program's
`dot_prod.readback` spans, per block of the window's operations."""
from benchmark.harness import program_spans


def install(probe):
    program_spans.enable()


def read(run):
    return program_spans.mean_ms(run, "dot_prod", "dot_prod.readback")
