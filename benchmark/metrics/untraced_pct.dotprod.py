"""untraced_pct.dotprod: the share of the window's `dot_prod` operations
that no span of the program names, %: 100 x the root spans' time that
none of their child spans covers, over the root spans' time.  It holds
the spans to covering the operation as the code changes."""
from benchmark.harness import program_spans


def install(probe):
    program_spans.enable()


def read(run):
    ops = program_spans.operations(run, "dot_prod")
    total = sum(root.seconds for root, _ in ops)
    if not total:
        return None
    return 100.0 * sum(program_spans.self_seconds(root, spans)
                       for root, spans in ops) / total
