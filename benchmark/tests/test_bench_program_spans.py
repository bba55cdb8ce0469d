"""The per-layer metrics read from the program's own spans and counters
(benchmark/harness/program_spans.py), in traced runs of each dotprod cell
at a tiny size on the port's CPU device; and the program's tracer left
off by untraced runs and after traced ones."""
from __future__ import annotations

import pytest

SPAN_METRICS = ("open_ms.dotprod", "walk_us_per_record.dotprod",
                "upload_ms.dotprod", "readback_wait_ms.dotprod",
                "untraced_pct.dotprod")


@pytest.fixture
def tracer():
    from xsqueezeit_tpu_torch.utils import trace
    trace.disable()
    trace.collect()
    yield trace
    trace.disable()
    trace.collect()


@pytest.mark.parametrize("name", ["kgp3-chr20.dotprod", "hrc.dotprod"])
def test_traced_run_reads_the_program_spans(tiny, tracer, name):
    result, lines, rc = tiny(name, trace=True)
    assert rc == 0 and result["correct"], lines
    got = result["metrics"]
    for metric in SPAN_METRICS:
        assert got[metric]["value"] > 0, (metric, got)
    assert got["untraced_pct.dotprod"]["value"] <= 5, got
    assert got["untraced_pct.dotprod"]["unit"] == "%"
    assert got["walk_us_per_record.dotprod"]["unit"] == "us"
    # no kernel runs on the CPU device: the product's device time may be
    # absent, never zero
    assert got.get("product_device_ms.dotprod", {"value": 1})["value"] > 0
    # the metrics the benchmark read before these still read
    assert got["host_parse_ms.dotprod"]["value"] > 0
    assert not tracer.enabled()


def test_untraced_run_leaves_the_tracer_off(tiny, tracer):
    result, lines, rc = tiny("kgp3-chr20.dotprod")
    assert rc == 0 and result["correct"], lines
    assert not tracer.enabled()
    assert tracer.collect() == {"spans": [], "counters": {}}
    assert not set(SPAN_METRICS) & set(result["metrics"])


def test_readers_find_nothing_in_a_program_without_the_tracer(
        tiny, tracer, monkeypatch):
    """An older checkout of the program has no tracer: the readers install
    and read without raising, and leave their metrics out."""
    import sys

    import xsqueezeit_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "xsqueezeit_tpu_torch.utils.trace",
                        None)
    result, lines, rc = tiny("hrc.dotprod", trace=True)
    assert rc == 0 and result["correct"], lines
    assert not set(SPAN_METRICS) & set(result["metrics"])
    assert "host_parse_ms.dotprod" in result["metrics"]


def test_self_seconds_counts_what_no_child_covers():
    from types import SimpleNamespace as S

    from benchmark.harness.program_spans import self_seconds

    root = S(id=1, start=0.0, end=10.0, seconds=10.0)
    kids = [S(parent=1, start=1.0, end=3.0), S(parent=1, start=2.0, end=4.0),
            S(parent=1, start=6.0, end=7.0), S(parent=9, start=4.0, end=6.0)]
    assert self_seconds(root, kids) == pytest.approx(10.0 - 3.0 - 1.0)
