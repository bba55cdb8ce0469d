"""The program's own spans and counters (xsqueezeit_tpu_torch/utils/trace.py)
over a traced run's window, for the per-layer metrics that read them.

A reader's ``install(probe)`` calls ``enable()``, so only traced runs
record spans.  The first read of a run collects what the program
recorded, turns its tracer off again and keeps the collection on the run;
every read then takes the operations whose root span started at or after
the window's start and ended by the last operation's end, each with the
spans of its operation.  A program without the tracer has no spans:
``enable()`` does nothing there and every read finds nothing.
"""
from __future__ import annotations


def _tracer():
    try:
        from xsqueezeit_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def enable() -> None:
    trace = _tracer()
    if trace is not None:
        trace.enable()


def _collected(run) -> dict | None:
    got = getattr(run, "_program_spans", None)
    if got is None:
        trace = _tracer()
        if trace is None:
            return None
        got = trace.collect()
        trace.disable()
        run._program_spans = got
    return got


def operations(run, root: str) -> list:
    """[(root span, [the other spans of its operation])] of the window's
    operations whose root span is named `root`, in order."""
    got = _collected(run)
    if not got or not run.ops:
        return []
    end = max(r.end for r in run.ops)
    ops = {s.id: (s, []) for s in got["spans"]
           if s.parent is None and s.name == root
           and s.start >= run.window_start and s.end <= end}
    for s in got["spans"]:
        if s.op in ops and s.id != s.op:
            ops[s.op][1].append(s)
    return [ops[k] for k in sorted(ops)]


def named(ops: list, name: str) -> list:
    """The spans named `name` of the operations `ops`."""
    return [s for _, spans in ops for s in spans if s.name == name]


def mean_ms(run, root: str, name: str) -> float | None:
    """Mean milliseconds of the spans named `name` in the window's
    operations (None where there is none)."""
    found = named(operations(run, root), name)
    return 1e3 * sum(s.seconds for s in found) / len(found) if found \
        else None


def self_seconds(root, spans: list) -> float:
    """The root's time that none of its children covers."""
    kids = sorted((max(s.start, root.start), min(s.end, root.end))
                  for s in spans if s.parent == root.id)
    covered, edge = 0.0, root.start
    for a, b in kids:
        a = max(a, edge)
        if b > a:
            covered += b - a
            edge = b
    return root.seconds - covered
