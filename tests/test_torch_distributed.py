"""Several processes over torch.distributed (gloo): the port's
parallel/distributed.py, its CLI's --distributed flags and the `scaling`
tool, against the JAX package's plan and drivers and the port's single-
process output.  Real multi-process runs start one Python process per
rank with the port's modules only and --device cpu (gloo on localhost);
each waits with its own timeout, so a hung rendezvous fails.  The JAX
package runs its host codec (tests/conftest.py pins XSI_DEVICE=numpy).
Tolerance: exact bytes; exact records where the BGZF framing of the
variant file or of an extract differs at segment joins."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xsqueezeit_tpu.codec.compressor import CompressorOptions as JaxOptions
from xsqueezeit_tpu.io.unified import (
    count_entries_offsets as jax_count_entries_offsets,
)
from xsqueezeit_tpu.parallel import distributed as jax_dist
from xsqueezeit_tpu_torch.codec.compressor import (
    CompressorOptions,
    compress_file,
)
from xsqueezeit_tpu_torch.codec.decompressor import (
    Decompressor,
    DecompressorOptions,
)
from xsqueezeit_tpu_torch.io.bcf import BcfReader
from xsqueezeit_tpu_torch.io.unified import GtInput, count_entries_offsets
from xsqueezeit_tpu_torch.parallel import distributed as dist
from xsqueezeit_tpu_torch.bench.synth import synth_bcf
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Seconds one rank may take (process start, torch import, the run).
RANK_TIMEOUT = 180


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO)


def _run_ranks(argv_of_rank, nproc, timeout=RANK_TIMEOUT, **env):
    """Start nproc processes (argv_of_rank(rank, port)) side by side, with
    `env` added to their environment, and wait for each with a timeout;
    a rank still running is killed.  Returns [(returncode, output)]."""
    port = _free_port()
    procs = [subprocess.Popen(argv_of_rank(i, port), cwd=REPO,
                              env={**_env(), **env},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _assert_ok(results):
    for i, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {i} exited {rc}:\n{out}"


#: One rank of compress_file_multihost / decompress_file_multihost with
#: the port's modules only.
_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    mode, src, dst, port, procid, nproc, block = sys.argv[1:8]
    from xsqueezeit_tpu_torch.parallel import distributed
    perf = {{}}
    kw = dict(coordinator=f"127.0.0.1:{{port}}", num_processes=int(nproc),
              process_id=int(procid), perf=perf)
    if mode == "c":
        from xsqueezeit_tpu_torch.codec.compressor import CompressorOptions
        stats = distributed.compress_file_multihost(
            src, dst, CompressorOptions(block_length=int(block),
                                        device="cpu"), **kw)
    else:
        from xsqueezeit_tpu_torch.codec.decompressor import (
            DecompressorOptions)
        stats = distributed.decompress_file_multihost(
            src, dst, DecompressorOptions(output_type="b", device="cpu"),
            **kw)
    import torch.distributed as dist
    assert not dist.is_initialized()
    print("OK", stats is not None, json.dumps(perf))
""")


def _multihost(tmp_path, mode, src, dst, nproc, block=16, **env):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO))
    results = _run_ranks(
        lambda i, port: [sys.executable, str(worker), mode, src, dst,
                         str(port), str(i), str(nproc), str(block)], nproc,
        **env)
    _assert_ok(results)
    outs = [o for _, o in results]
    assert "OK True" in outs[0]          # process 0 wrote the output
    for o in outs[1:]:
        assert "OK False" in o           # the others returned None
    return [json.loads(o.split("OK ", 1)[1].split(" ", 1)[1]) for o in outs]


def _single(vcf, out, block=16):
    os.makedirs(os.path.dirname(out), exist_ok=True)
    compress_file(vcf, out, CompressorOptions(block_length=block,
                                              device="cpu"))


def _var_records(path):
    r = BcfReader(path)
    out = [(rec.shared, rec.indiv) for rec in r]
    r.close()
    return out


def _gt_records(path):
    inp = GtInput(path)
    out = [(r.n_alleles, r.gt.tolist()) for r in inp]
    inp.close()
    return out


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("n_blocks,n_parts", [
    (10, 4), (2, 4), (7, 3), (1, 1), (0, 2), (5, 5), (130, 7)])
def test_plan_and_layout_match_jax(n_blocks, n_parts):
    want = jax_dist.plan_block_ranges(n_blocks, n_parts)
    assert dist.plan_block_ranges(n_blocks, n_parts) == want
    for i in range(n_parts):
        assert (dist.process_layout(n_blocks, i, n_parts)
                == jax_dist.process_layout(n_blocks, i, n_parts) == want[i])


def test_single_process_defaults():
    assert dist.init_distributed() == (0, 1)
    assert dist.process_layout(5) == (0, 5)
    assert dist.gather_blocks_to_host0([b"a", b"bc"]) == [b"a", b"bc"]


def test_a_coordinator_without_ranks_raises():
    with pytest.raises(ValueError, match="--dist-nproc"):
        dist.init_distributed("127.0.0.1:1")
    with pytest.raises(ValueError, match="outside"):
        dist.init_distributed("127.0.0.1:1", 2, 2)


# ------------------------------------------- compress_file_distributed
@pytest.mark.parametrize("n_parts", [1, 2, 3])
@pytest.mark.parametrize("fmt", ["vcf", "bcf"])
def test_distributed_threads_match_jax_and_single(tmp_path, n_parts, fmt,
                                                  monkeypatch):
    # the native variant pass of a BCF input writes zlib's bytes (the
    # Python writer's) in the emitter's zlib mode, as on a machine
    # without libdeflate
    monkeypatch.setenv("XSI_EMIT_ZLIB", "1")
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=31,
                              n_records=130, seed=11)
    src = vcf
    if fmt == "bcf":
        src = str(tmp_path / "in.bcf")
        synth_bcf(src, 130, 31, seed=11)
    outs = {k: str(tmp_path / k / "o.xsi") for k in ("jax", "port", "one")}
    for p in outs.values():
        os.makedirs(os.path.dirname(p))
    jax_dist.compress_file_distributed(src, outs["jax"],
                                       JaxOptions(block_length=32),
                                       n_parts=n_parts)
    stats = dist.compress_file_distributed(
        src, outs["port"], CompressorOptions(block_length=32, device="cpu"),
        n_parts=n_parts)
    _single(src, outs["one"], 32)
    assert stats["n_blocks"] == 5
    for sfx in ("", "_var.bcf", "_var.bcf.csi"):
        assert (_read(outs["port"] + sfx) == _read(outs["jax"] + sfx)
                == _read(outs["one"] + sfx)), sfx


# ----------------------------------------------- count_entries_offsets
@pytest.mark.parametrize("every", [0, 1, 7, 64, 600, 1000])
def test_count_entries_offsets_match_jax(tmp_path, every, monkeypatch):
    monkeypatch.delenv("XSI_SCAN_CACHE", raising=False)
    bcf = str(tmp_path / "in.bcf")
    synth_bcf(bcf, 600, 200, seed=3)
    n, voffs = count_entries_offsets(bcf, every)
    jn, jvoffs = jax_count_entries_offsets(bcf, every)
    assert n == jn == 600
    if every == 0:
        assert voffs is None
        return
    assert voffs.dtype == np.uint64 and len(voffs) == -(-600 // every)
    if jvoffs is not None:          # the JAX package's native walk
        assert np.array_equal(voffs, jvoffs)
    # each offset is its record's frame: a seek there reads that record
    want = list(GtInput(bcf))
    for k, v in enumerate(voffs):
        inp = GtInput(bcf)
        inp.seek_fast(k * every, int(v))
        rec = next(iter(inp))
        inp.close()
        assert rec.shared == want[k * every].shared


def test_count_entries_offsets_of_vcf_and_the_scan_cache(tmp_path,
                                                        monkeypatch):
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=5,
                              n_records=40, seed=2)
    assert count_entries_offsets(vcf, 8) == (40, None)
    bcf = str(tmp_path / "in.bcf")
    synth_bcf(bcf, 300, 20, seed=4)
    cold = count_entries_offsets(bcf, 16)
    monkeypatch.setenv("XSI_SCAN_CACHE", "1")
    first = count_entries_offsets(bcf, 16)         # writes the sidecar
    assert os.path.exists(bcf + ".gtscan")
    cached = count_entries_offsets(bcf, 32)         # a coarser view of it
    assert first[0] == cached[0] == cold[0] == 300
    assert np.array_equal(first[1], cold[1])
    assert np.array_equal(cached[1], cold[1][::2])
    assert count_entries_offsets(bcf, 0) == (300, None)


# ----------------------------------------------- real gloo processes
@pytest.mark.parametrize("n_records,n_blocks,chunk,rounds", [
    (100, 7, 1, 4), (192, 12, 2, 3)])
def test_two_processes_compress_byte_identical(tmp_path, n_records,
                                               n_blocks, chunk, rounds):
    """Two real processes: .xsi, _var.bcf and CSI bytes equal to the
    single-process port (VCF input: the serial variant pass), with the
    gather in rounds of one block and of several blocks."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=13,
                              n_records=n_records, seed=31)
    single = str(tmp_path / "s" / "out.xsi")
    _single(vcf, single)
    multi = str(tmp_path / "m" / "out.xsi")
    os.makedirs(os.path.dirname(multi))
    perfs = _multihost(tmp_path, "c", vcf, multi, 2)
    for sfx in ("", "_var.bcf", "_var.bcf.csi"):
        assert _read(multi + sfx) == _read(single + sfx), sfx
    assert sum(p["n_local_blocks"] for p in perfs) == n_blocks
    assert [p["gather_chunk"] for p in perfs] == [chunk, chunk]
    assert [p["gather_rounds"] for p in perfs] == [rounds, rounds]
    assert "assemble_s" in perfs[0] and "assemble_s" not in perfs[1]


def test_three_processes_fewer_blocks_than_processes(tmp_path):
    """3 processes, 2 blocks: one process contributes nothing; the gather
    still assembles the single-process container."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=7,
                              n_records=25, seed=33)
    single = str(tmp_path / "s" / "out.xsi")
    _single(vcf, single)
    multi = str(tmp_path / "m" / "out.xsi")
    os.makedirs(os.path.dirname(multi))
    perfs = _multihost(tmp_path, "c", vcf, multi, 3)
    for sfx in ("", "_var.bcf", "_var.bcf.csi"):
        assert _read(multi + sfx) == _read(single + sfx), sfx
    assert [p["n_local_blocks"] for p in perfs] == [1, 1, 0]


def test_two_processes_extract(tmp_path):
    """-x -O b over two processes: records equal to the single-process
    extract (BGZF framing differs at the join)."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=15,
                              n_records=90, seed=35, p_multi=0.2)
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=16, device="cpu"))
    single = str(tmp_path / "single.bcf")
    Decompressor(xsi, DecompressorOptions(output_type="b",
                                          device="cpu")).decompress(single)
    multi = str(tmp_path / "multi.bcf")
    perfs = _multihost(tmp_path, "x", xsi, multi, 2)
    assert _gt_records(multi) == _gt_records(single)
    assert len(_gt_records(single)) == 90
    assert [p["n_local_blocks"] for p in perfs] == [3, 3]


@pytest.mark.parametrize("varpass", ["1", "0"])
def test_cli_distributed_bcf(tmp_path, varpass):
    """--distributed through the port's CLI on a BCF.  With the per-rank
    variant segments (XSI_DIST_VARPASS=1, the default): .xsi bytes equal
    to the single-process CLI's, _var.bcf records equal, and the CSI
    assembled from the shifted segment offsets answers a region query
    alike; with the serial pass (0) the variant file and its CSI are
    byte-equal.  -v prints each rank's perf line."""
    bcf = str(tmp_path / "in.bcf")
    synth_bcf(bcf, 120, 15, seed=44)
    single = str(tmp_path / "s" / "out.xsi")
    os.makedirs(os.path.dirname(single))
    from xsqueezeit_tpu_torch.cli import main
    assert main(["-c", "-f", bcf, "-o", single, "--device", "cpu",
                 "--variant-block-length", "16"]) == 0
    multi = str(tmp_path / "m" / "out.xsi")
    os.makedirs(os.path.dirname(multi))
    results = _run_ranks(
        lambda i, port: [sys.executable, "-m", "xsqueezeit_tpu_torch.cli",
                         "-c", "-f", bcf, "-o", multi, "--device", "cpu",
                         "--variant-block-length", "16", "-v",
                         "--distributed", f"127.0.0.1:{port}",
                         "--dist-nproc", "2", "--dist-procid", str(i)], 2,
        XSI_DIST_VARPASS=varpass)
    _assert_ok(results)
    for i, (_, out) in enumerate(results):
        line = [l for l in out.splitlines()
                if l.startswith(f"xsqueezeit: rank {i}/2 perf ")]
        assert len(line) == 1, out
        perf = json.loads(line[0].split(" perf ", 1)[1])
        assert perf["n_local_blocks"] == 4 and "scan_s" in perf
    assert _read(multi) == _read(single)
    assert (_var_records(multi + "_var.bcf")
            == _var_records(single + "_var.bcf"))
    if varpass == "0":
        for sfx in ("_var.bcf", "_var.bcf.csi"):
            assert _read(multi + sfx) == _read(single + sfx), sfx
    assert len(_var_records(single + "_var.bcf")) == 120
    for src, out in ((single, "r1.vcf"), (multi, "r2.vcf")):
        Decompressor(src, DecompressorOptions(
            output_type="v", device="cpu",
            regions="20:60200-61500")).decompress(str(tmp_path / out))
    r1 = (tmp_path / "r1.vcf").read_text().splitlines()
    r2 = (tmp_path / "r2.vcf").read_text().splitlines()
    assert len(r1) > 10 and r1[5:] == r2[5:]


def test_a_failing_rank_fails_the_run(tmp_path):
    """A rank that cannot read its input exits non-zero, and so does its
    peer, blocked in a collective (no single-process rerun, no hang)."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=7,
                              n_records=40, seed=3)
    out = str(tmp_path / "o.xsi")
    results = _run_ranks(
        lambda i, port: [sys.executable, "-m", "xsqueezeit_tpu_torch.cli",
                         "-c", "-f", vcf if i == 0 else vcf + ".missing",
                         "-o", out, "--device", "cpu",
                         "--variant-block-length", "8", "--distributed",
                         f"127.0.0.1:{port}", "--dist-nproc", "2",
                         "--dist-procid", str(i)], 2)
    assert all(rc != 0 for rc, _ in results), results
    assert not os.path.exists(out)


def test_cli_distributed_extract_refuses_text_output(tmp_path):
    from xsqueezeit_tpu_torch.cli import main
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=5,
                              n_records=20, seed=1)
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=8, device="cpu"))
    assert main(["-x", "-f", xsi, "-o", str(tmp_path / "o.vcf"),
                 "--device", "cpu", "--distributed", "127.0.0.1:1",
                 "--dist-nproc", "2", "--dist-procid", "0"]) == 1


# ------------------------------------------------------------- scaling
def _scaling(tmp_path, device):
    proc = subprocess.run(
        [sys.executable, "-m", "xsqueezeit_tpu_torch.bench", "scaling",
         "--records", "300", "--samples", "20", "--block-length", "64",
         "--procs", "1,2", "--device", device, "--dir",
         str(tmp_path / "w")], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=4 * RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["byte_identical"] is True and out["device"] == device
    assert [r["procs"] for r in out["curve"]] == [1, 2]
    for r in out["curve"]:
        for key in ("modeled_efficiency", "compute_efficiency",
                    "gather_s", "gather_mb", "varpass_cpu_s",
                    "solo_wall_s", "comm_residual_s"):
            assert key in r
        assert len(r["launches"]) == r["procs"]
    assert out["curve"][0]["solo_efficiency"] == 1.0
    assert out["curve"][1]["gather_mb"] > 0
    return out


def test_scaling_tool(tmp_path):
    """python -m xsqueezeit_tpu_torch.bench scaling at a tiny size: every
    process count byte-identical to compress_file, the efficiency
    breakdown reported, one launch map per process.  On a torch device
    the CPU-time model is not made (the encode's waits on the device are
    not CPU time): only the solo model."""
    out = _scaling(tmp_path, "cpu")
    for r in out["curve"]:
        assert r["modeled_efficiency"] is None
        assert r["compute_efficiency"] is None
        assert r["modeled_wall_s"] is None


def test_scaling_tool_host_codec_model(tmp_path):
    """With the host codec (--device numpy) the CPU-time model is made as
    well."""
    out = _scaling(tmp_path, "numpy")
    assert out["curve"][0]["modeled_efficiency"] == 1.0
    assert out["curve"][0]["compute_efficiency"] == 1.0
    assert out["curve"][1]["modeled_wall_s"] > 0
