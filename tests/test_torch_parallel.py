"""Several devices in one process (xsqueezeit_tpu_torch/parallel/shard.py,
the compressor's pool batching, mesh_decode_all, the decompressor's
batched decode, block_range and records-only BGZF segments) against the
one-device port and the JAX package, on N CPU devices (the count forced
by a device list: this machine has no card).  The JAX package runs its
host codec (tests/conftest.py pins XSI_DEVICE=numpy).  Tolerance: exact
bytes, exact genotypes."""
import io
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xsqueezeit_tpu.codec.compressor import (
    CompressorOptions as JaxOptions,
    compress_file as jax_compress_file,
)
from xsqueezeit_tpu.codec.decompressor import (
    Decompressor as JaxDecompressor,
    DecompressorOptions as JaxDecOptions,
)
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder as JaxEncoder
from xsqueezeit_tpu_torch.codec import compressor as torch_compressor
from xsqueezeit_tpu_torch.codec.compressor import (
    CompressorOptions,
    compress_file,
)
from xsqueezeit_tpu_torch.codec.decoder_torch import (
    TorchBlockDecoder,
    mesh_decode_all,
)
from xsqueezeit_tpu_torch.codec.decompressor import (
    Decompressor,
    DecompressorOptions,
)
from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
from xsqueezeit_tpu_torch.format.constants import WeirdnessStrategy
from xsqueezeit_tpu_torch.format.container import XsiReader
from xsqueezeit_tpu_torch.io.bgzf import BGZF_EOF
from xsqueezeit_tpu_torch.io.unified import GtInput
from xsqueezeit_tpu_torch.parallel import shard
from xsqueezeit_tpu_torch.utils import trace
from tests import fixtures


def _missing_vcf(path, n_samples=24, n_records=90, seed=5):
    """Random phased diploid records with ~3 % missing alleles and some
    unphased entries: a missing track on most records."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_records):
        p = rng.choice([0.01, 0.1, 0.5])
        cells = []
        for _ in range(n_samples):
            a = ["." if rng.random() < 0.03 else str(int(rng.random() < p))
                 for _ in range(2)]
            cells.append(a[0] + ("/" if rng.random() < 0.1 else "|") + a[1])
        rows.append(("A", cells))
    return fixtures.write_vcf(path, rows, n_samples=n_samples)


#: name -> (writer(path), block length, maf): the uniform, missing, EOV
#: and mixed-ploidy fixtures of tests/test_torch_parity.py and a larger
#: random file with sparse lines and tracks.
FIXTURES = {
    "uniform": (lambda p: fixtures.random_vcf(p, n_samples=40,
                                              n_records=150, seed=3), 32,
                0.05),
    "missing": (fixtures.micro_missing, 2, 0.001),
    "eov": (fixtures.micro_eov, 2, 0.001),
    "mixed_ploidy": (fixtures.micro_mixed_ploidy, 2, 0.001),
    "random_missing": (_missing_vcf, 16, 0.05),
}


@pytest.fixture(params=sorted(FIXTURES))
def case(request, tmp_path):
    write, block, maf = FIXTURES[request.param]
    return request.param, write(str(tmp_path / "in.vcf")), block, maf


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _records(vcf):
    inp = GtInput(vcf)
    out = [(r.gt, r.n_alleles) for r in inp]
    inp.close()
    return out


CPUS = {n: tuple(["cpu"] * n) for n in (2, 3)}


# --------------------------------------------------------------- local_mesh
@pytest.mark.parametrize("count,cap,max_devices,want", [
    (4, None, None, 4), (4, "2", None, 2), (4, "1", None, None),
    (4, None, 3, 3), (4, "0", None, None), (1, None, None, None),
    (0, None, None, None)])
def test_local_mesh_counts_cards_and_honours_the_cap(
        monkeypatch, count, cap, max_devices, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if cap is None:
        monkeypatch.delenv("XSI_LOCAL_DEVICES", raising=False)
    else:
        monkeypatch.setenv("XSI_LOCAL_DEVICES", cap)
    got = shard.local_mesh(max_devices)
    if want is None:
        assert got is None
    else:
        assert got == [torch.device("cuda", i) for i in range(want)]


def test_local_mesh_of_the_cpu_is_one_device(monkeypatch):
    monkeypatch.delenv("XSI_LOCAL_DEVICES", raising=False)
    assert shard.local_mesh(kind="cpu") is None


def test_map_blocks_keeps_order_and_raises():
    seen = []

    def fn(item, device):
        seen.append((item, device))
        if item == "boom":
            raise KeyError(item)
        return (item, device)

    devs = ["d0", "d1", "d2"]
    items = list(range(7))
    assert shard.map_blocks(fn, items, devs) == [
        (i, devs[i % 3]) for i in items]
    assert shard.map_blocks(fn, [], devs) == []
    with pytest.raises(KeyError):
        shard.map_blocks(fn, [0, "boom", 2, 3], devs)
    assert (3, "d0") in seen          # the other workers ran to their end


def test_map_blocks_on_one_device_runs_inline():
    caller = threading.current_thread()

    def fn(item, device):
        assert threading.current_thread() is caller
        return item, device

    assert shard.map_blocks(fn, [0, 1, 2], ["d0"]) == [
        (0, "d0"), (1, "d0"), (2, "d0")]


def test_device_pool_of_one_device(monkeypatch):
    """One device is a pool of one: the device itself, or the list that
    was given; an empty list is refused."""
    monkeypatch.delenv("XSI_LOCAL_DEVICES", raising=False)
    cpu = torch.device("cpu")
    assert shard.device_pool(None, cpu) == [cpu]
    assert shard.device_pool(("cpu",), cpu) == [cpu]
    assert shard.device_pool(CPUS[2], cpu) == [cpu, cpu]
    with pytest.raises(ValueError):
        shard.device_pool((), cpu)


def test_launch_counter_is_thread_safe():
    """Pool workers count launches side by side: no increment is lost
    (more threads than cores, a short switch interval)."""
    counts = {"r": 0}
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [trace.count("r", into=counts)
                            for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["r"] == n_threads * per


# ------------------------------------------------------- MeshBlockEncoder
@pytest.mark.parametrize("n_dev", [2, 3])
def test_mesh_encoder_matches_one_device_and_jax(case, n_dev, monkeypatch):
    """Each block's payload over N CPU devices equals the one-device
    TorchBlockEncoder's and the JAX package's host encoder's."""
    monkeypatch.setenv("XSI_TRACKS_DEVICE_MIN", "1")
    name, vcf, block, maf = case
    recs = _records(vcf)
    n_samples = len(GtInput(vcf).samples)
    kw = dict(n_samples=n_samples, block_bcf_lines=block,
              mac_threshold=int(2 * n_samples * maf), default_phasing=1,
              aet_dtype=np.uint16)
    chunks = [recs[lo:lo + block] for lo in range(0, len(recs), block)]

    def filled(cls, **extra):
        out = []
        for chunk in chunks:
            enc = cls(**kw, **extra)
            for gt, na in chunk:
                enc.encode_record(gt, na)
            out.append(enc)
        return out

    mesh = shard.MeshBlockEncoder(CPUS[n_dev], kw["mac_threshold"])
    got = mesh.encode_batch(filled(TorchBlockEncoder, device="cpu"))
    one = [e.serialize() for e in filled(TorchBlockEncoder, device="cpu")]
    jax = [e.serialize() for e in filled(JaxEncoder)]
    assert len(got) == len(chunks) > 1
    assert got == one == jax, name
    assert mesh.total_bytes == sum(len(p) for p in got)


# ------------------------------------------------ compress_file over a pool
@pytest.mark.parametrize("how", ["option", "probe", "one"])
def test_compress_file_over_a_pool_matches_jax(case, tmp_path, how,
                                               monkeypatch):
    """compress_file with the dispatcher's device list forced to 2 CPU
    devices (CompressorOptions.devices, or the local_mesh probe), or on
    one device (a pool of one, batches of one block), writes the JAX
    package's .xsi, _var.bcf and CSI."""
    name, vcf, block, maf = case
    want, got = (str(tmp_path / d / "o.xsi") for d in ("jax", "port"))
    for d in (want, got):
        os.makedirs(os.path.dirname(d))
    jax_compress_file(vcf, want, JaxOptions(block_length=block, maf=maf))
    dispatched = []
    real = shard.MeshBlockEncoder.encode_batch

    def spy(self, encoders):
        dispatched.append(len(encoders))
        return real(self, encoders)

    monkeypatch.setattr(shard.MeshBlockEncoder, "encode_batch", spy)
    devices = CPUS[2]
    if how == "probe":
        monkeypatch.setattr(shard, "local_mesh",
                            lambda max_devices=None, kind="cuda":
                            [torch.device(d) for d in CPUS[2]])
        devices = None
    elif how == "one":
        devices = None
    compress_file(vcf, got, CompressorOptions(
        block_length=block, maf=maf, device="cpu", devices=devices))
    for sfx in ("", "_var.bcf", "_var.bcf.csi"):
        assert _read(got + sfx) == _read(want + sfx), (name, sfx)
    n_blocks = XsiReader(want).n_blocks()
    # every block goes through the pool, the loop's tail one too
    assert sum(dispatched) == n_blocks
    assert max(dispatched) <= (1 if how == "one" else 2)


def test_dispatcher_batches_and_bounds_in_flight():
    disp = torch_compressor.TorchEncodeDispatcher(
        4, 2, 1, 1, np.uint16, WeirdnessStrategy.WS_SPARSE,
        device=torch.device("cpu"), devices=CPUS[3])
    assert disp.batch_target == 1 and disp.inflight_target == 2
    gt = np.full(8, 2, np.int32)
    futs = []
    for _ in range(4):
        disp.encode_record(gt, 2)
        disp.encode_record(gt, 2)
        futs.append(disp.submit())
    assert disp.batch_target == 3 and disp.inflight_target == 6
    assert not futs[3].done()        # waits in a partial batch
    disp.flush()
    payloads = [f.result(timeout=60) for f in futs]
    disp.shutdown()
    assert len(set(payloads)) == 1


def test_a_pool_that_cannot_run_raises(tmp_path):
    """A device list that was asked for and cannot be had fails the run
    (no fall back to one device)."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=9,
                              n_records=40, seed=4)
    out = str(tmp_path / "o.xsi")
    with pytest.raises((AssertionError, RuntimeError)):
        compress_file(vcf, out, CompressorOptions(
            block_length=8, device="cpu", devices=("cpu", "cuda:0")))
    assert not os.path.exists(out)


# ---------------------------------------------------------- batched decode
def _decoders(xsi_path):
    x = XsiReader(xsi_path)
    n_haps = x.header.hap_samples
    if x.header.ploidy == 1:
        n_haps = x.n_samples * 2
    return [TorchBlockDecoder(x.gt_block_payload(b), x.n_samples, n_haps,
                              x.aet_dtype, device="cpu")
            for b in range(x.n_blocks())]


@pytest.mark.parametrize("n_dev", [2, 3])
def test_mesh_decode_all_equals_decode_all(case, tmp_path, n_dev):
    name, vcf, block, maf = case
    xsi = str(tmp_path / "o.xsi")
    jax_compress_file(vcf, xsi, JaxOptions(block_length=block, maf=maf))
    want = [d for d in _decoders(xsi) if d.eligible or d.mixed_device_ok]
    got = [d for d in _decoders(xsi) if d.eligible or d.mixed_device_ok]
    assert len(got) > 1, name
    for d in want:
        d.decode_all()
    mesh_decode_all(got, CPUS[n_dev])
    for a, b in zip(want, got):
        assert np.array_equal(a._vals, b._vals), name
        assert np.array_equal(a._neg, b._neg), name


@pytest.mark.parametrize("n_dev", [2, 3])
def test_batched_iter_decoded_records(case, tmp_path, n_dev):
    """The decompressor's batched decode over N CPU devices yields the
    one-device records, and -x writes the JAX package's VCF."""
    name, vcf, block, maf = case
    xsi = str(tmp_path / "o.xsi")
    jax_compress_file(vcf, xsi, JaxOptions(block_length=block, maf=maf))
    one = list(Decompressor(xsi, DecompressorOptions(
        device="cpu")).iter_decoded_records())
    many = list(Decompressor(xsi, DecompressorOptions(
        device="cpu", devices=CPUS[n_dev])).iter_decoded_records())
    assert len(many) == len(one) == len(_records(vcf))
    for (ra, ga), (rb, gb) in zip(one, many):
        assert ra.shared == rb.shared and np.array_equal(ga, gb), name
    want = str(tmp_path / "jax.vcf")
    JaxDecompressor(xsi, JaxDecOptions(output_type="v")).decompress(want)
    got = str(tmp_path / "port.vcf")
    Decompressor(xsi, DecompressorOptions(
        output_type="v", device="cpu", devices=CPUS[n_dev])).decompress(got)
    assert _read(got) == _read(want), name


def test_recompress_over_a_pool(tmp_path):
    """-O x re-encodes over a 2-device pool to the one-device bytes (one
    file name in two directories: the name is in the variant header)."""
    vcf = _missing_vcf(str(tmp_path / "in.vcf"))
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=16, maf=0.05,
                                              device="cpu"))
    outs = {}
    for key, devices in (("one", None), ("pool", CPUS[2])):
        out = str(tmp_path / key / "re.xsi")
        os.makedirs(os.path.dirname(out))
        Decompressor(xsi, DecompressorOptions(
            output_type="x", device="cpu", devices=devices)).decompress(out)
        outs[key] = [_read(out + sfx)
                     for sfx in ("", "_var.bcf", "_var.bcf.csi")]
    assert outs["pool"] == outs["one"]


# ------------------------------------------ block_range and BGZF segments
def _segment(cls, opts_cls, xsi, rng, first, last, device=None):
    kw = {"output_type": "b"}
    if device is not None:
        kw["device"] = device
    d = cls(xsi, opts_cls(**kw))
    d.opts.block_range = rng
    body = io.BytesIO()
    stats = d._decompress_to_bcf(body, write_header=first, write_eof=last)
    return body.getvalue(), stats["records"]


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_block_range_segments_concatenate_to_one_extract(tmp_path, device):
    """Records-only segments over consecutive block ranges, concatenated,
    hold the single -O b extract's records; each segment's bytes equal
    the JAX package's segment of the same range."""
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=11,
                              n_records=100, seed=37, p_multi=0.2)
    xsi = str(tmp_path / "o.xsi")
    compress_file(vcf, xsi, CompressorOptions(block_length=16,
                                              device=device))
    single = str(tmp_path / "single.bcf")
    Decompressor(xsi, DecompressorOptions(
        output_type="b", device=device)).decompress(single)
    for cuts in ((0, 7), (0, 2, 5, 7), (0, 3, 3, 7), (0, 1, 2, 3, 4, 5,
                                                      6, 7)):
        parts, n = [], 0
        for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
            first, last = i == 0, i == len(cuts) - 2
            seg, recs = _segment(Decompressor, DecompressorOptions, xsi,
                                 (a, b), first, last, device)
            want, _ = _segment(JaxDecompressor, JaxDecOptions, xsi, (a, b),
                               first, last)
            assert seg == want, (cuts, a, b)
            parts.append(seg)
            n += recs
        multi = str(tmp_path / "multi.bcf")
        with open(multi, "wb") as f:
            f.write(b"".join(parts))
        assert parts[-1].endswith(BGZF_EOF)
        assert not any(p.endswith(BGZF_EOF) for p in parts[:-1])
        a = [(r.n_alleles, r.gt.tolist()) for r in GtInput(single)]
        b = [(r.n_alleles, r.gt.tolist()) for r in GtInput(multi)]
        assert n == len(a) == 100 and a == b, cuts
