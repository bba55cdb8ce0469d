"""One run of one cell: set-up, a warm-up operation, the measured window
as one closed-loop client, the metrics, and the comparison that decides
``correct``.

An operation module (``operations/<name>.py``) gives ``NAME`` and:

- ``setup(run) -> state``: the inputs from ``run.seed``, and whatever the
  program must make of them before the window (counted in set-up);
- ``operate(state, k) -> Done``: the k-th operation of the window,
  blocking until its output is complete (k = -1 is the warm-up);
- ``check(state, run) -> list[Check]``: once the window has closed and
  the program's state is freed, the comparison with the plain reference.

The window runs operations back to back until ``seconds`` have passed;
one that started before the deadline finishes.  Every operation counts
in ``attempted``; one that raised counts in ``failed`` and makes the run
incorrect.
"""
from __future__ import annotations

import contextlib
import gc
import random
import statistics
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch

from . import guard
from . import trace as trace_mod
from .probe import Probe


@dataclass
class Done:
    """One finished operation: its logical bytes and what the check
    reads (an output path, dots)."""
    logical_bytes: int
    output: object = None


@dataclass
class OpRecord:
    k: int
    start: float
    end: float
    done: Done | None
    error: str | None = None


@dataclass
class Check:
    """One number compared, with its limit: `ok` is value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    workdir: str
    t_start: float
    probe: Probe = None
    setup_s: float = 0.0
    window_start: float = 0.0
    ops: list = field(default_factory=list)
    traced: dict | None = None
    memory_peak: int = 0

    # --- what the metric readers read
    def completed(self) -> list[OpRecord]:
        return [r for r in self.ops if r.done is not None]

    def rate_gbps(self) -> float | None:
        """All logical bytes of the operations completed in the window
        over the time from its start to the last completion."""
        done = self.completed()
        if not done:
            return None
        span = max(r.end for r in done) - self.window_start
        return sum(r.done.logical_bytes for r in done) / span / 1e9

    def sample(self, n: int) -> list[OpRecord]:
        """n of the completed operations, drawn from the seed (all where
        there are fewer), the last one always among them."""
        done = self.completed()
        if len(done) <= n:
            return done
        rng = random.Random(self.seed)
        return sorted(rng.sample(done[:-1], n - 1) + [done[-1]],
                      key=lambda r: r.k)


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def execute(run: Run) -> tuple[dict, list[Check], list[str]]:
    """Set-up, warm-up, window, metrics, check.  Returns (the metrics
    dict of the result line, the checks, notes for standard error)."""
    cell = run.cell
    op = cell.operation
    notes: list[str] = []
    run.probe = Probe(run.trace)
    if run.trace:
        for m in cell.per_layer:
            cell.readers[m["name"]].install(run.probe)
    state = op.setup(run)
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    op.operate(state, -1)
    sync(run.device)
    tracer = trace_mod.Tracer(run.workdir) if run.trace else None
    run.setup_s = time.perf_counter() - run.t_start

    if tracer:
        tracer.start()
    run.probe.open()
    run.window_start = time.perf_counter()
    deadline = run.window_start + run.seconds
    k = 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        try:
            with (torch.profiler.record_function("op:" + op.NAME)
                  if run.trace else contextlib.nullcontext()):
                done = op.operate(state, k)
            run.ops.append(OpRecord(k, t0, time.perf_counter(), done))
        except Exception:    # a failed operation is counted, not fatal
            run.ops.append(OpRecord(k, t0, time.perf_counter(), None,
                                    traceback.format_exc(limit=4)))
        k += 1
    sync(run.device)
    run.probe.close()
    if tracer:
        tracer.stop()
    if run.device == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated())

    if tracer:
        run.traced = tracer.reduce(run.probe.launches)
        notes.append(f"trace: device seconds under marks "
                     f"{run.traced['device_s_under']}; device intervals "
                     f"with no launch found {run.traced['unlaunched']}")
        if not run.traced["launches_match"]:
            notes.append("profiler and launch counters differ (traced, "
                         f"counted): {run.traced['launches_differ']}")
    metrics = {}
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run.probe.remove()
    for r in run.ops:
        if r.error:
            notes.append(f"operation {r.k} failed: {r.error.strip()}")
    if run.ops:
        took = sorted(r.end - r.start for r in run.ops)
        notes.append(f"window: {len(took)} operations, seconds min "
                     f"{took[0]:.4f} median {statistics.median(took):.4f} "
                     f"max {took[-1]:.4f}")

    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    checks = op.check(state, run)
    return metrics, checks, notes


def device_facts(run: Run) -> dict:
    """The result line's `device`: the card, the chips the cell uses, the
    peak on the fullest, and in a traced run the busy and window
    seconds."""
    if run.device == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:
        out = {"platform": "cpu", "kind": "cpu"}
    out.update(count=run.cell.chips, memory_peak_bytes=run.memory_peak)
    if run.traced:
        out.update(busy_s=run.traced["busy_s"],
                   window_s=run.traced["window_s"])
    return out


def run_cell(run: Run) -> tuple[dict, list[str], int]:
    """execute() and the result line.  Returns (result, lines for
    standard error, exit code); exit code 4 and no result where the
    process holds a module of the JAX side once the window has closed."""
    metrics, checks, notes = execute(run)
    found = guard.forbidden()
    if found:
        return {}, notes + [f"benchmark: error: the run loaded {found}"], 4
    failed = sum(r.done is None for r in run.ops)
    correct = (bool(run.ops) and failed == 0 and bool(checks)
               and all(c.ok for c in checks))
    result = {"correct": correct, "attempted": len(run.ops),
              "failed": failed, "metrics": metrics,
              "device": device_facts(run)}
    if run.traced:
        result["breakdown"] = {"device_ops": run.traced["device_ops"],
                               "idle_gaps": run.traced["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    lines = notes + [f"check {c.name} {c.value!r} limit {c.limit!r} "
                     f"{'ok' if c.ok else 'FAILED'}" for c in checks]
    return result, lines, 0


def workdir_for(root: str | None = None) -> str:
    """A fresh directory for the run's files, under TMPDIR by default."""
    return tempfile.mkdtemp(prefix="bench_", dir=root)
