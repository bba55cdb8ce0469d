"""The traced run's device timeline: torch.profiler over the measured
window, reduced to the device's busy time, the operations that took it,
the idle gaps by what the host was doing, and the launches of the
program's kernels by route.

The profiler records the card's kernels, copies and sets, the host's
runtime and driver calls that launched them (one correlation id each),
and the host's ``record_function`` marks on every thread: the window's
own, each operation's and each span's.  The marks label the idle gaps,
and a mark's device time is the union of the device intervals whose
launch lies inside a mark of that label on the same thread.  The trace is
read from its Chrome JSON export (one file under the run's temporary
directory, deleted after reading).
"""
from __future__ import annotations

import json
import os
import re
from collections import Counter, defaultdict

import numpy as np
import torch

WINDOW_MARK = "bench:window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: Each launch-counted route of the program, and the kernel it launches
#: exactly once a call, as the profiler names it (demangled or mangled).
#: The rank chain launches its kernels several times a call (one level a
#: launch): it is held to at least one launch a call.
ROUTE_KERNELS = {
    "chain_encode": r"chain_kernel(<false, false, false>|ILb0ELb0ELb0E)",
    "chain_decode": r"chain_kernel(<true, false, false>|ILb1ELb0ELb0E)",
    "chain_encode_cluster": r"chain_kernel(<false, true, false>|ILb0ELb1ELb0E)",
    "chain_decode_rows": r"chain_kernel(<true, true, false>|ILb1ELb1ELb0E)",
    "chain_encode_parity": r"chain_kernel(<false, false, true>|ILb0ELb0ELb1E)",
    "chain_encode_parity_cluster":
        r"chain_kernel(<false, true, true>|ILb0ELb1ELb1E)",
    "wah_expand": r"wah_expand_kernel(<false, false|ILb0ELb0E)",
    "wah_expand_varw": r"wah_expand_kernel(<true, false|ILb1ELb0E)",
    "wah_expand_bits": r"wah_expand_kernel(<false, true|ILb0ELb1E)",
    "wah_expand_varw_bits": r"wah_expand_kernel(<true, true|ILb1ELb1E)",
    "wah_compress": r"wah_compress_kernel(<false>|ILb0E)",
    "wah_compress_bits": r"wah_compress_kernel(<true>|ILb1E)",
    "decode_scan_mixed": r"decode_scan_mixed_kernel",
    "decode_run_flush": r"decode_run_flush_kernel",
    "decode_run_flush_cluster": r"decode_run_flush_cluster_kernel",
    "rank_chain": r"rank_\w*kernel",
}
AT_LEAST_ONCE = {"rank_chain"}
#: Gaps shorter than this are launch gaps, summed under one label.
SHORT_GAP_US = 10.0


class Tracer:
    """torch.profiler over the window: start() when it opens, stop() once
    its last operation has finished, then reduce()."""

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, "trace.json")
        self.prof = None
        self.mark = None

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # the port decodes and encodes blocks on worker threads: their
        # spans label the idle gaps too
        self.prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(WINDOW_MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)

    def reduce(self, launches: dict) -> dict:
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(self.path)
        return reduce_events(events, launches)


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def route_counts(names: Counter) -> dict:
    """Launches a route's kernel got in the trace, by route."""
    out = {}
    for route, pattern in ROUTE_KERNELS.items():
        rx = re.compile(pattern)
        out[route] = sum(n for name, n in names.items() if rx.search(name))
    return out


def launches_match(traced: dict, counted: dict) -> tuple[bool, dict]:
    """Whether the profiler recorded every launch the program counted:
    equal counts a route, at least one a call for AT_LEAST_ONCE routes.
    Returns (match, {route: (traced, counted)} of the routes that
    differ)."""
    bad = {}
    for route, n in counted.items():
        t = traced.get(route, 0)
        ok = (t >= n and (t > 0) == (n > 0)) if route in AT_LEAST_ONCE \
            else t == n
        if not ok:
            bad[route] = (t, n)
    return not bad, bad


def reduce_events(events: list, launches: dict) -> dict:
    """busy_s, window_s, the top device operations and idle gaps, and the
    launch check, from the Chrome trace's events."""
    window = [e for e in events if e.get("name") == WINDOW_MARK
              and e.get("ph") == "X"]
    if not window:
        raise RuntimeError("the trace holds no window mark")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    by_name: dict = defaultdict(float)
    names: Counter = Counter()
    spans = []
    corr = []
    for e in dev:
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        spans.append((s, t))
        corr.append(e.get("args", {}).get("correlation"))
        by_name[e["name"]] += (t - s) * 1e-6
        if e.get("cat") == "kernel":
            names[e["name"]] += 1
    busy = _union(spans)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") != WINDOW_MARK]
    gaps = []
    edge = w0
    for s, t in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    idle = label_gaps(gaps, marks)
    under, unlaunched = device_under_marks(spans, corr, events, marks)
    traced = route_counts(names)
    match, differ = launches_match(traced, launches)
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": idle[:10],
        "device_s_under": under,
        "unlaunched": unlaunched,
        "traced_launches": {k: v for k, v in traced.items() if v},
        "launches_match": match,
        "launches_differ": differ,
    }


def device_under_marks(spans: list, corr: list, events: list,
                       marks: list) -> tuple[dict, int]:
    """({label: seconds}, device intervals with no launch found): for each
    mark label, the union of the device intervals `spans` (their
    correlation ids `corr`) whose launch, the runtime or driver call of
    the same correlation id, starts inside a mark of that label on the
    same thread."""
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e.get("pid"), e.get("tid"), float(e["ts"]))
    by_thread: dict = defaultdict(lambda: defaultdict(list))
    for m in marks:
        s = float(m["ts"])
        by_thread[(m.get("pid"), m.get("tid"))][m["name"]].append(
            (s, s + float(m.get("dur", 0.0))))
    for labels in by_thread.values():
        for label, iv in labels.items():
            iv.sort()
            labels[label] = (np.array([a for a, _ in iv]),
                             np.maximum.accumulate([b for _, b in iv]))
    found: dict = defaultdict(list)
    unlaunched = 0
    for span, c in zip(spans, corr):
        if c not in launch:
            unlaunched += 1
            continue
        pid, tid, ts = launch[c]
        for label, (starts, ends) in by_thread.get((pid, tid), {}).items():
            k = int(np.searchsorted(starts, ts, side="right")) - 1
            if k >= 0 and ends[k] >= ts:
                found[label].append(span)
    return ({label: sum(t - s for s, t in _union(iv)) * 1e-6
             for label, iv in found.items()}, unlaunched)


def label_gaps(gaps: list, marks: list) -> list:
    """[[label, seconds]] of the idle time, longest first.  Each gap is
    cut at the edges of the host marks inside it, and each piece goes to
    the innermost (shortest) mark that covers it ("outside spans" where
    none does); gaps under SHORT_GAP_US are summed apart, as launch
    gaps."""
    out: dict = defaultdict(float)
    ms = np.array([float(m["ts"]) for m in marks])
    me = ms + np.array([float(m.get("dur", 0.0)) for m in marks])
    order = np.argsort(ms)
    ms, me = ms[order], me[order]
    label = [marks[i]["name"] for i in order]
    edges = np.unique(np.concatenate([ms, me]))
    for s, t in gaps:
        if t - s < SHORT_GAP_US:
            out[f"gaps under {SHORT_GAP_US:g} us"] += (t - s) * 1e-6
            continue
        inner = edges[np.searchsorted(edges, s, side="right"):
                      np.searchsorted(edges, t, side="left")]
        pts = [s, *inner.tolist(), t]
        for a, b in zip(pts[:-1], pts[1:]):
            mid = (a + b) / 2
            k = int(np.searchsorted(ms, mid, side="right"))
            cover = np.flatnonzero(me[:k] >= mid)
            name = (label[cover[np.argmin(me[cover] - ms[cover])]]
                    if cover.size else "outside spans")
            out[name] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])
