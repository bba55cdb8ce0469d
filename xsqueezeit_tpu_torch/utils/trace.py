"""The port's spans and counters: where an operation's host time goes,
layer by layer, on the same clock as the device trace.

    from xsqueezeit_tpu_torch.utils import trace

    trace.enable()
    with trace.span("dot_prod.block", block=3) as s:
        ...
        s.set(route="device")
    trace.count("dot_prod.records", n)
    got = trace.collect()     # {"spans": [Span, ...], "counters": {...}}

Tracing is off by default: ``span`` then tests one module-level bool and
returns a shared no-op context, which calls no torch function, reads no
clock and records nothing.  ``enable()`` turns it on (the CLI's
``--profile DIR`` does for its run), ``disable()`` off.

On, each span keeps its name, its start and end on ``time.perf_counter``,
its thread, its own id, its parent's id (the innermost span open on its
thread, or the ``parent=`` a span on another thread is given:
``trace.span(name, parent=trace.current())`` captured before the work is
handed over), the id of its operation (its root's id), its attributes,
and the counts ``count`` credited to it while it was the innermost open
span.  While a torch.profiler records, each span is also a
``torch.profiler.record_function`` mark of its name on its thread, so it
sits on the profiler's clock beside the kernels it launched.

A span costs a few microseconds, and its mark about 15 more: spans are
per operation, per phase and per block, never per record.

``count(name, n, into=d)`` adds to the dict ``d`` whether tracing is on or
off, under the same lock: the kernel wrappers' ``launches`` counters.
"""
from __future__ import annotations

import itertools
import threading
import time

from torch.autograd import profiler as _profiler

_on = False
_lock = threading.Lock()
_spans: list = []
_counters: dict = {}
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The context ``span`` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    """The spans open on this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span: a context manager while open, the record once closed."""
    __slots__ = ("name", "attrs", "counts", "id", "parent", "op", "thread",
                 "start", "end", "_up", "_mark")

    def __init__(self, name: str, up: "Span | None", attrs: dict):
        self.name, self.attrs, self._up = name, attrs, up
        self.counts: dict = {}
        self.id = self.parent = self.op = self.thread = None
        self.start = self.end = None
        self._mark = None

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self) -> "Span":
        stack = _stack()
        up = self._up if self._up is not None else (
            stack[-1] if stack else None)
        self._up = None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.op = self.id if up is None else up.op
        self.thread = threading.get_ident()
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._mark = _profiler.record_function(self.name)
            self._mark.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None
        stack = _stack()
        # a generator's span can close after spans opened later on its
        # thread: take it out where it is
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        with _lock:
            _spans.append(self)
        return False


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, parent: Span | None = None, **attrs):
    """A span of `name` (a context manager); `parent` for a span opened on
    another thread than its parent's."""
    if not _on:
        return _OFF
    return Span(name, parent, attrs)


def current() -> Span | None:
    """The innermost span open on this thread (None while tracing is off):
    the parent to hand to work that runs on another thread."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def count(name: str, n: int = 1, into: dict | None = None) -> None:
    """Add `n` to counter `name`: in `into` where given, tracing on or off
    (pool threads count side by side, and ``+=`` on a shared dict is not
    atomic); else, while tracing is on, in the trace's counters and in the
    counts of the innermost span open on this thread."""
    if into is not None:
        with _lock:
            into[name] += n
        return
    if not _on:
        return
    stack = _stack()
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n


def collect() -> dict:
    """The spans closed and the counters counted since the last collect,
    ``{"spans": [Span, ...], "counters": {name: n}}``; both are then
    cleared."""
    global _spans, _counters
    with _lock:
        out = {"spans": _spans, "counters": _counters}
        _spans, _counters = [], {}
    return out
