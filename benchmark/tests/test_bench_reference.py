"""The reference against the generator, and the trace's reduction."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import gen, trace
from benchmark.reference import dots
from benchmark.reference.panel import Panel
from benchmark.reference.readback import bcf_tally

CFG = {"samples": 20, "records": 2500, "block_length": 512, "maf": 0.001,
       "chrom": "20", "contig_length": 63025520, "first_pos": 60000,
       "spacing_bp": 37, "founders": 64, "effective_size": 10000,
       "recombination_per_bp": 1e-8,
       "spectrum": [[0.76, 0.0, 0.005], [0.14, 0.005, 0.05],
                    [0.10, 0.05, 1.0]]}
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def bcf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gen") / "panel.bcf")
    gen.write_bcf(path, CFG, SEED, "cpu", threads=2)
    return path


def test_same_seed_same_panel_other_seed_other():
    a = gen.Draw(CFG, SEED, "cpu").alleles(1)
    assert torch.equal(a, gen.Draw(CFG, SEED, "cpu").alleles(1))
    assert not torch.equal(a, gen.Draw(CFG, SEED + 1, "cpu").alleles(1))


def test_a_chunk_drawn_alone_equals_the_sequential_draw():
    seq = gen.Draw(CFG, SEED, "cpu")
    chunks = [seq.alleles(c) for c in range(gen.n_chunks(CFG))]
    alone = gen.Draw(CFG, SEED, "cpu")
    for c in (2, 0, 1, 2):
        assert torch.equal(alone.alleles(c), chunks[c])


def test_counts_follow_the_spectrum():
    cfg = {**CFG, "samples": 2504, "records": 4000}
    draw = gen.Draw(cfg, SEED, "cpu")
    alleles = torch.cat([draw.alleles(c) for c in range(gen.n_chunks(cfg))])
    counts = alleles.sum(1).numpy()
    assert np.array_equal(counts, draw.counts)
    assert counts.min() >= 1 and counts.max() <= 5007
    f = counts / 5008
    shares = [np.mean(f < 0.005), np.mean((f >= 0.005) & (f < 0.05)),
              np.mean(f >= 0.05)]
    assert np.allclose(shares, [0.76, 0.14, 0.10], atol=0.03)


def test_haplotypes_share_long_stretches():
    """Copying a founder set: over 50 records the 5008 haplotypes of the
    copying model fall into a few hundred distinct ones at most, where
    independent draws would give nearly all distinct."""
    cfg = {**CFG, "samples": 2504, "records": 1024}
    a = gen.Draw(cfg, SEED, "cpu").alleles(0)[:50].T.numpy()
    assert len({row.tobytes() for row in a}) < 500
    assert 0 < gen.switch_prob(cfg) < 1e-3


def test_port_reads_what_the_generator_wrote(bcf):
    from xsqueezeit_tpu_torch.io.unified import GtInput
    panel = Panel(CFG, SEED, "cpu")
    inp = GtInput(bcf)
    n = 0
    for i, rec in enumerate(inp):
        assert np.array_equal(rec.gt, panel.row(i).astype(np.int32))
        n += 1
    inp.close()
    assert n == CFG["records"]


def test_tally_of_the_generated_file_is_clean(bcf):
    panel = Panel(CFG, SEED, "cpu")
    t = bcf_tally(bcf, panel, np.arange(CFG["records"]))
    assert (t.bad_records, t.bad_gt, t.unreadable) == (0, 0, None)
    t = bcf_tally(bcf, panel, np.arange(10, CFG["records"]))
    assert t.bad_records > 0


def test_tally_counts_an_unphased_or_missing_file(tmp_path):
    panel = Panel(CFG, SEED, "cpu")
    path = str(tmp_path / "u.bcf")
    gen.write_bcf(path, CFG, SEED, "cpu", phased=False, threads=2)
    t = bcf_tally(path, panel, np.arange(CFG["records"]))
    assert t.bad_records == 0
    assert t.bad_gt == CFG["records"] * CFG["samples"]
    t = bcf_tally(str(tmp_path / "absent.bcf"), panel,
                  np.arange(CFG["records"]))
    assert t.unreadable and t.bad_records == CFG["records"] + 1


def test_reference_dots_match_numpy():
    panel = Panel(CFG, SEED, "cpu")
    y = dots.phenotype(CFG["samples"], 7)
    want = np.array([np.repeat(y, 2)[panel.row(i) >> 1 == 2].sum()
                     for i in range(CFG["records"])])
    got = dots.dots(CFG, SEED, 7, "cpu")
    assert np.allclose(got, want, rtol=0, atol=1e-12)
    assert dots.rel_err(got, want) < 1e-12
    assert dots.rel_err(got[:-1], want) == float("inf")


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-11])
    got = dots.round_tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2**-10, 1.0 + 2**-9]


def _ev(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction():
    events = [
        _ev(trace.WINDOW_MARK, "user_annotation", 0.0, 1000.0),
        _ev("op:extract", "user_annotation", 0.0, 1000.0),
        _ev("host fold", "user_annotation", 300.0, 400.0),
        _ev("device decode", "user_annotation", 90.0, 30.0, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 95.0, 2.0, 7, tid=2),
        _ev("cuLaunchKernel", "cuda_driver", 110.0, 2.0, 8, tid=2),
        _ev("cudaMemcpyAsync", "cuda_runtime", 500.0, 2.0, 9, tid=2),
        _ev("void chain_kernel<true, false, false>(int)", "kernel", 100.0,
            50.0, 7, tid=3),
        _ev("void wah_expand_kernel<false, true, 32>(int)", "kernel", 140.0,
            40.0, 8, tid=3),
        _ev("Memcpy HtoD", "gpu_memcpy", 800.0, 100.0, 9, tid=3),
        _ev("void chain_kernel<true, false, false>(int)", "kernel", 905.0,
            5.0, 10, tid=3),
    ]
    counted = {"chain_decode": 2, "wah_expand_bits": 1, "rank_chain": 0}
    out = trace.reduce_events(events, counted)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx((80 + 100 + 5) * 1e-6)
    assert out["launches_match"]
    gaps = dict(out["idle_gaps"])
    assert gaps["op:extract"] == pytest.approx((90 + 120 + 100 + 90) * 1e-6)
    assert gaps["device decode"] == pytest.approx(10e-6)
    assert gaps["host fold"] == pytest.approx(400e-6)
    assert gaps["gaps under 10 us"] == pytest.approx(5e-6)
    # launched inside the mark, on its thread: the two kernels, as a union
    assert out["device_s_under"]["device decode"] == pytest.approx(80e-6)
    assert "op:extract" not in out["device_s_under"]   # another thread
    assert out["unlaunched"] == 1
    out = trace.reduce_events(events, {**counted, "chain_decode": 3})
    assert not out["launches_match"]
    assert out["launches_differ"] == {"chain_decode": (2, 3)}
    ok, _ = trace.launches_match({"rank_chain": 11}, {"rank_chain": 1})
    assert ok
    ok, _ = trace.launches_match({"rank_chain": 0}, {"rank_chain": 1})
    assert not ok
