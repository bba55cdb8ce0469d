"""decoder_torch (CPU tensors, the kernels' plain versions) vs the host
GtBlockDecoder and the JAX decoder: bit-exact gt arrays on the fixtures of
tests/test_decoder_jax.py, plus filtered (non-contiguous) offsets."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.codec import decoder_jax
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu.format.constants import WeirdnessStrategy as WS
from xsqueezeit_tpu_torch.codec import decoder_torch
from tests.gt_synth import make_record


def _encode(records, n_samples, mac_threshold=2, ws=WS.WS_SPARSE,
            default_phasing=1):
    enc = GtBlockEncoder(n_samples, 10_000, mac_threshold,
                         default_phasing=default_phasing,
                         aet_dtype=np.uint16, weirdness_strategy=ws)
    for gt, na in records:
        enc.encode_record(gt, na)
    return enc.serialize()


def _kitchen_sink(r):
    recs = []
    for i in range(40):
        if i % 5 == 0:
            recs.append(make_record(r, 64, n_alts=2, p_alt=0.4,
                                    p_missing=0.03, p_phase_flip=0.05))
        elif i % 3 == 0:
            recs.append(make_record(r, 64, p_alt=0.004))
        else:
            recs.append(make_record(r, 64, p_alt=0.3, p_missing=0.02,
                                    p_eov=0.04))
    return recs


# name -> (records(rng), n_samples, encode options)
FIXTURES = {
    "common": (lambda r: [make_record(r, 60, p_alt=0.4) for _ in range(25)],
               60, {}),
    "sparse_and_negated": (
        lambda r: ([make_record(r, 80, p_alt=0.01) for _ in range(10)]
                   + [make_record(r, 80, p_alt=0.99) for _ in range(10)]),
        80, dict(mac_threshold=5)),
    "multiallelic": (
        lambda r: [make_record(r, 50, n_alts=3, p_alt=0.5)
                   for _ in range(12)], 50, {}),
    "missing_eov_phase": (
        lambda r: [make_record(r, 50, p_alt=0.3, p_missing=0.04, p_eov=0.05,
                               p_phase_flip=0.08) for _ in range(20)],
        50, {}),
    "missing_wah": (
        lambda r: [make_record(r, 50, p_alt=0.3, p_missing=0.05)
                   for _ in range(15)], 50, dict(ws=WS.WS_WAH)),
    "missing_eov_unphased": (
        lambda r: [make_record(r, 60, p_alt=0.3, p_missing=0.05, p_eov=0.03,
                               phased=False) for _ in range(30)],
        60, dict(default_phasing=0)),
    "pbwt_wah_tracks": (
        lambda r: [make_record(r, 40, n_alts=2 if i % 3 == 0 else 1,
                               p_alt=0.4, p_missing=0.12, p_eov=0.08,
                               p_phase_flip=0.06) for i in range(24)],
        40, dict(ws=WS.WS_PBWT_WAH)),
    "kitchen_sink": (_kitchen_sink, 64, dict(mac_threshold=3)),
    "uniform_haploid": (
        lambda r: [make_record(r, 70, p_alt=p, haploid=True)
                   for p in [0.002, 0.05, 0.4, 0.9, 0.999] * 6], 70,
        dict(mac_threshold=3, default_phasing=0)),
    "mixed_ploidy_host": (
        lambda r: [make_record(r, 40, p_alt=0.4, haploid=(i % 2 == 0))
                   for i in range(10)], 40, {}),
}


def _check(records, n_samples, payload, offsets=None, idx=None):
    nas = [na for _, na in records]
    sel = range(len(records)) if idx is None else idx
    got = decoder_torch.decode_block_records(
        payload, n_samples, 2 * n_samples, np.uint16,
        [nas[i] for i in sel], offsets, device="cpu")
    want = decoder_jax.decode_block_records(
        payload, n_samples, 2 * n_samples, np.uint16,
        [nas[i] for i in sel], offsets)
    host = GtBlockDecoder(payload, n_samples, 2 * n_samples, np.uint16)
    firsts = np.cumsum([0] + [max(na - 1, 0) for na in nas])
    for k, i in enumerate(sel):
        host.seek(int(firsts[i]))
        oracle = host.fill_genotype_array_advance(nas[i])
        np.testing.assert_array_equal(got[k], records[i][0],
                                      err_msg=f"record {i}")
        np.testing.assert_array_equal(got[k], oracle, err_msg=f"record {i}")
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"record {i}")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_decode_matches_host_and_jax(name):
    make, n_samples, opts = FIXTURES[name]
    records = make(np.random.default_rng(sorted(FIXTURES).index(name)))
    payload = _encode(records, n_samples, **opts)
    _check(records, n_samples, payload)


@pytest.mark.parametrize("name", ["common", "multiallelic",
                                  "sparse_and_negated", "missing_eov_phase"])
def test_filtered_offsets(name):
    """Region/target-filtered runs: a non-contiguous subset of records,
    each addressed by its first binary line."""
    make, n_samples, opts = FIXTURES[name]
    records = make(np.random.default_rng(50 + len(name)))
    payload = _encode(records, n_samples, **opts)
    nas = [na for _, na in records]
    firsts = np.cumsum([0] + [max(na - 1, 0) for na in nas])
    idx = list(range(1, len(records), 3))
    _check(records, n_samples, payload,
           offsets=[int(firsts[i]) for i in idx], idx=idx)


def test_fused_gt_codes_match_jax():
    rng = np.random.default_rng(8)
    n_samples = 60
    records = ([make_record(rng, n_samples, p_alt=p)
                for p in [0.004, 0.3, 0.996, 0.6] * 8])
    payload = _encode(records, n_samples, mac_threshold=3)
    dev = decoder_torch.TorchBlockDecoder(payload, n_samples, 2 * n_samples,
                                          np.uint16, device="cpu")
    assert dev.eligible
    *args, H, W, L = dev.device_inputs()
    for dp in (0, 1):
        got = decoder_torch._decode_block_full_gt(*args, dp, H, W).numpy()
        jd = decoder_jax.DeviceBlockDecoder(payload, n_samples,
                                            2 * n_samples, np.uint16)
        (padded, sorts_p, rank, is_wah_p, neg_p, car_line, car_idx,
         jH, jW, jL, _) = jd.host_inputs()
        want = np.asarray(decoder_jax._decode_block_full_gt(
            *(jnp.asarray(x) for x in (padded, sorts_p, rank, is_wah_p,
                                       neg_p, car_line, car_idx)),
            jnp.int32(dp), jH, jW))[:jL]
        np.testing.assert_array_equal(got, want)
