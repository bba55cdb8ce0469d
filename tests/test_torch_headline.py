"""The port's headline benchmark (xsqueezeit_tpu_torch.bench.headline), the
counterpart of root bench.py, at a small size on the CPU (the kernels'
plain versions).  Its own checks hold every output exactly: the payloads
byte-equal to GtBlockEncoder's, every decoded line bit-exact."""
import json

import pytest

torch = pytest.importorskip("torch")

from xsqueezeit_tpu_torch.bench import headline

#: The keys of bench.py's JSON line (bench.py:407-427).
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "encode_gbps",
              "decode_gbps", "missing_encode_gbps", "missing_decode_gbps",
              "missing_records_ms", "missing_prepare_ms",
              "missing_assemble_ms", "compression_ratio")
RATES = ("value", "encode_gbps", "decode_gbps", "missing_encode_gbps",
         "missing_decode_gbps")


@pytest.fixture(scope="module")
def result():
    return headline.run(n_samples=64, n_lines=96, device="cpu", repeats=2)


def test_run_has_bench_keys_and_spread(result):
    assert all(k in result for k in BENCH_KEYS)
    assert result["unit"] == "GB/s" and result["device"] == "cpu"
    assert "CPU" in result["metric"] and "not a TPU number" in result["metric"]
    assert result["vs_baseline"] == pytest.approx(result["value"] / 2.2)
    for k in RATES:
        s = result["spread"][k]
        assert 0 < s["min"] <= s["median"] <= s["max"]
    assert result["workload"] == {
        "samples": 64, "haplotypes": 128, "lines": 96, "mac_threshold": 0,
        "seed": 20, "missing_frac": 0.01,
        "payload_bytes": result["workload"]["payload_bytes"],
        "missing_payload_bytes": result["workload"]["missing_payload_bytes"]}
    # no card: no device times, no card line
    assert set(result["device_ms_per_block"].values()) == {None}
    assert result["card"] is None
    json.dumps(result)


def test_round_trip_rate_is_the_two_halves(result):
    ms = result["ms_per_block"]
    gt_bytes = 96 * 128 * 4
    assert result["value"] == pytest.approx(
        2 * gt_bytes / ((ms["encode"] + ms["decode"]) * 1e-3) / 1e9)
    assert result["compression_ratio"] == pytest.approx(
        gt_bytes / result["workload"]["payload_bytes"])


def test_a_mismatch_exits_non_zero(monkeypatch):
    monkeypatch.setattr(headline, "_host_payload", lambda kw, gt: b"\0")
    with pytest.raises(SystemExit, match="FAIL"):
        headline.run(n_samples=16, n_lines=32, device="cpu", repeats=1,
                     iters=1)


def test_cuda_without_card_is_a_one_line_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert headline.main(["--device", "cuda", "--repeats", "1"]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    err = err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]
