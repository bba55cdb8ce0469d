"""walk_us_per_record.dotprod: host microseconds a record of the variant
file's walk (bench/tools.py: the BcfReader pass, each record's block from
its BM entry, the records grouped by block): the program's `dot_prod.walk`
spans over the records its counter `dot_prod.records` credits to them,
over the window's operations."""
from benchmark.harness import program_spans


def install(probe):
    program_spans.enable()


def read(run):
    walks = program_spans.named(program_spans.operations(run, "dot_prod"),
                                "dot_prod.walk")
    records = sum(s.counts.get("dot_prod.records", 0) for s in walks)
    return 1e6 * sum(s.seconds for s in walks) / records if records \
        else None
