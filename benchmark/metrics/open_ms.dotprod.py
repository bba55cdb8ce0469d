"""open_ms.dotprod: host milliseconds an operation takes to open the
container, the program's `dot_prod.open` span (bench/tools.py: the
Accessor, the phenotype drawn and copied to the device), per operation of
the window."""
from benchmark.harness import program_spans


def install(probe):
    program_spans.enable()


def read(run):
    return program_spans.mean_ms(run, "dot_prod", "dot_prod.open")
