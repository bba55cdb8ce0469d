"""Spans around calls into the program's layers, installed at run time
from the benchmark's own files, and the program's launch counters.

A per-layer metric's file asks the probe for the spans it reads
(``probe.span(...)``); the probe wraps each named function once, however
many metrics read it, and records only while the measured window is
open.  Nothing is written into the program: the wrappers replace module
or class attributes in this process and are removed when the run ends.

A span records the host clock around each call, and the bytes the call
must move where a metric gives a function for them.  In a traced run it
also opens a ``torch.profiler.record_function`` of its label around the
call: the trace's reduction (``trace.py``) names the idle gaps by it and
sums the device time of the kernels and copies launched inside it.
"""
from __future__ import annotations

import contextlib
import importlib
import inspect
import time

import torch


def _owner(module: str, attr: str):
    """(object that holds the attribute, attribute name) for
    "Class.method" or "function" in `module`."""
    obj = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, name


class Span:
    """One wrapped function: records (start, end, bytes the call must
    move or None) of each call in the window, host clock."""

    def __init__(self, probe: "Probe", module: str, attr: str, label: str):
        self.probe, self.label = probe, label
        self.owner, self.name = _owner(module, attr)
        # a method inherited by the class is wrapped on the class itself
        self.own = self.name in vars(self.owner)
        self.original = inspect.getattr_static(self.owner, self.name)
        self.nbytes = None
        self.records: list = []

    def install(self) -> None:
        setattr(self.owner, self.name, self._wrap(self.original))

    def uninstall(self) -> None:
        if self.own:
            setattr(self.owner, self.name, self.original)
        else:
            delattr(self.owner, self.name)

    def _wrap(self, fn):
        span = self

        def wrapper(*args, **kw):
            if not span.probe.active:
                return fn(*args, **kw)
            with (torch.profiler.record_function(span.label)
                  if span.probe.trace else contextlib.nullcontext()):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    span.records.append(
                        (t0, time.perf_counter(),
                         span.nbytes(*args, **kw) if span.nbytes else None))
        return wrapper

    def total_ms(self) -> float:
        return sum(t1 - t0 for t0, t1, _ in self.records) * 1e3

    def calls(self) -> int:
        return len(self.records)

    def bytes(self) -> list:
        return [b for _, _, b in self.records]


class Probe:
    """The spans of one run, and the program's launch counters over its
    measured window."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.active = False
        self.spans: dict = {}
        self.launches: dict = {}

    def span(self, module: str, attr: str, label: str,
             nbytes=None) -> Span:
        """The span of `attr` in `module`, wrapped on first request;
        `nbytes(*args)` gives the bytes a call must move, for the metrics
        that read them."""
        key = (module, attr)
        if key not in self.spans:
            self.spans[key] = Span(self, module, attr, label)
            self.spans[key].install()
        span = self.spans[key]
        if nbytes is not None:
            span.nbytes = nbytes
        return span

    @staticmethod
    def counters() -> dict:
        from xsqueezeit_tpu_torch.ops import pbwt_kernels, wah_kernels
        return {**pbwt_kernels.launches, **wah_kernels.launches}

    def open(self) -> None:
        for span in self.spans.values():
            span.records.clear()
        self._before = self.counters()
        self.active = True

    def close(self) -> None:
        self.active = False
        after = self.counters()
        self.launches = {k: after[k] - self._before.get(k, 0) for k in after}

    def remove(self) -> None:
        for span in self.spans.values():
            span.uninstall()
        self.spans.clear()
