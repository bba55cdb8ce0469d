"""TorchBlockEncoder (CPU tensors, the kernels' plain versions) vs the host
GtBlockEncoder and the JAX DeviceBlockEncoder: byte-identical payloads on
the fixtures of tests/test_encoder_jax.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.codec.encoder_jax import (
    DeviceBlockEncoder,
    sparse_idx_packed_reduction,
)
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.format.constants import WeirdnessStrategy as WS
from xsqueezeit_tpu_torch.codec.encoder_torch import (
    TorchBlockEncoder,
    carrier_indices,
)
from tests.gt_synth import make_record


def _kitchen_sink(rng):
    records = []
    for i in range(40):
        if i % 5 == 0:
            records.append(make_record(rng, 64, n_alts=2, p_alt=0.4,
                                       p_missing=0.03, p_phase_flip=0.05))
        elif i % 3 == 0:
            records.append(make_record(rng, 64, p_alt=0.004))
        else:
            records.append(make_record(rng, 64, p_alt=0.3, p_missing=0.02,
                                       p_eov=0.04))
    return records


# name -> (records(rng), n_samples, encoder options)
FIXTURES = {
    "common": (lambda r: [make_record(r, 60, p_alt=0.4) for _ in range(25)],
               60, dict(mac_threshold=2)),
    "rare_and_negated": (
        lambda r: ([make_record(r, 80, p_alt=0.01) for _ in range(10)]
                   + [make_record(r, 80, p_alt=0.99) for _ in range(10)]),
        80, dict(mac_threshold=5)),
    "multiallelic": (
        lambda r: [make_record(r, 50, n_alts=3, p_alt=0.5)
                   for _ in range(12)], 50, dict(mac_threshold=2)),
    "missing_sparse": (
        lambda r: [make_record(r, 50, p_alt=0.3, p_missing=0.05)
                   for _ in range(15)], 50, dict(mac_threshold=2)),
    "missing_wah": (
        lambda r: [make_record(r, 50, p_alt=0.3, p_missing=0.05)
                   for _ in range(15)], 50,
        dict(mac_threshold=2, weirdness_strategy=WS.WS_WAH)),
    "eov_and_phase": (
        lambda r: [make_record(r, 50, p_alt=0.3, p_eov=0.05,
                               p_phase_flip=0.1) for _ in range(15)],
        50, dict(mac_threshold=2)),
    "kitchen_sink": (_kitchen_sink, 64, dict(mac_threshold=3)),
    "unphased": (
        lambda r: [make_record(r, 40, p_alt=0.3, phased=False)
                   for _ in range(10)], 40,
        dict(mac_threshold=2, default_phasing=0)),
    "uniform_haploid": (
        lambda r: [make_record(r, 90, p_alt=p, haploid=True)
                   for p in [0.002, 0.05, 0.4, 0.9, 0.999] * 8], 90,
        dict(mac_threshold=3, default_phasing=0)),
    "long_block": (
        lambda r: [make_record(r, 100, p_alt=p)
                   for p in [0.003, 0.02, 0.3, 0.7, 0.995] * 41], 100,
        dict(mac_threshold=3)),
}


def _encode(cls, records, n_samples, opts, **extra):
    kw = dict(block_bcf_lines=10_000, default_phasing=1, aet_dtype=np.uint16)
    kw.update(opts)
    enc = cls(n_samples, **kw, **extra)
    for gt, na in records:
        enc.encode_record(gt, na)
    return enc.serialize()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_payload_identical_to_host_and_jax(name):
    make, n_samples, opts = FIXTURES[name]
    records = make(np.random.default_rng(sorted(FIXTURES).index(name)))
    got = _encode(TorchBlockEncoder, records, n_samples, opts, device="cpu")
    assert got == _encode(GtBlockEncoder, records, n_samples, opts)
    assert got == _encode(DeviceBlockEncoder, records, n_samples, opts)


def test_batched_ingest_matches_per_record():
    rng = np.random.default_rng(11)
    n, H = 120, 160
    gt = np.stack([make_record(rng, 80, p_alt=p)[0]
                   for p in rng.choice([0.004, 0.1, 0.6, 0.998], n)])
    kw = dict(block_bcf_lines=n, mac_threshold=2, default_phasing=1,
              aet_dtype=np.uint16)
    enc = TorchBlockEncoder(80, device="cpu", **kw)
    enc.encode_records(gt.reshape(-1), np.arange(n + 1, dtype=np.int64) * H,
                       np.full(n, 2, np.int32), 0, n)
    ref = GtBlockEncoder(80, **kw)
    for row in gt:
        ref.encode_record(row, 2)
    assert enc.serialize() == ref.serialize()


@pytest.mark.parametrize("R,H,cap,p", [(64, 300, 16, 0.03),
                                       (37, 1024, 128, 0.05),
                                       (8, 100, 8, 0.0), (5, 64, 64, 0.9),
                                       (6, 50, 1, 0.02)])
def test_carrier_indices_match_packed_reduction(R, H, cap, p):
    rng = np.random.default_rng(R + H)
    mask = rng.random((R, H)) < p
    for r in np.flatnonzero(mask.sum(1) > cap):
        mask[r, np.flatnonzero(mask[r])[cap:]] = False
    got = carrier_indices(torch.from_numpy(mask), cap).numpy()
    want = np.asarray(sparse_idx_packed_reduction(jnp.asarray(mask), cap))
    np.testing.assert_array_equal(got, want)


def test_mixed_ploidy_block_is_refused(monkeypatch):
    """Mixed-ploidy blocks, once refused, now encode: the port's
    dispatcher (device forced) sends one to TorchBlockEncoder, whose
    payload equals the host encoder's."""
    from xsqueezeit_tpu_torch.codec.compressor import TorchEncodeDispatcher

    calls = []
    orig = TorchBlockEncoder.serialize

    def spy(self):
        calls.append(self.bcf_lines)
        return orig(self)

    monkeypatch.setattr(TorchBlockEncoder, "serialize", spy)
    rng = np.random.default_rng(12)
    records = [make_record(rng, 30, p_alt=0.3, haploid=(i % 2 == 0))
               for i in range(6)]
    kw = dict(mac_threshold=2, default_phasing=1, aet_dtype=np.uint16,
              weirdness_strategy=WS.WS_SPARSE)
    disp = TorchEncodeDispatcher(30, 100, device=torch.device("cpu"), **kw)
    ref = GtBlockEncoder(30, 100, **kw)
    for gt, na in records:
        disp.encode_record(gt, na)
        ref.encode_record(gt, na)
    assert disp.serialize() == ref.serialize()
    assert calls == [6]


def test_block_of_zero_alt_records_only():
    """A block whose records all lack an ALT has no binary line; the port
    used to hand the device an empty line matrix and fail where the host
    and JAX encoders write an 80-byte payload."""
    gt = (np.full(40, 2) | (np.arange(40) & 1)).astype(np.int32)
    records = [(gt, 1)] * 5
    got = _encode(TorchBlockEncoder, records, 20, dict(mac_threshold=2),
                  device="cpu")
    assert got == _encode(GtBlockEncoder, records, 20, dict(mac_threshold=2))
    assert got == _encode(DeviceBlockEncoder, records, 20,
                          dict(mac_threshold=2))
