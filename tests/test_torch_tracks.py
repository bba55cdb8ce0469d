"""Exception tracks (missing / end-of-vector / phase) in the torch port vs
the JAX package, on CPU tensors (the kernels' plain versions): the track
encode bodies, the track-fused block core, the track-fused decode, and
TorchBlockEncoder's payloads with the device track routes taken.  Every
value is an integer or a byte: the tolerance is exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.codec import decoder_jax, encoder_jax
from xsqueezeit_tpu.codec.encoder_jax import DeviceBlockEncoder
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.format.constants import WeirdnessStrategy as WS
from xsqueezeit_tpu.utils.shapes import bucket
from xsqueezeit_tpu_torch.codec import decoder_torch, encoder_torch
from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
from tests.gt_synth import make_record


def _track_bits(rng, R, H, max_count):
    """uint8[R, H] rows of at most max_count set bits (some rows empty,
    some full up to the cap)."""
    bits = np.zeros((R, H), np.uint8)
    for r in range(R):
        n = int(rng.integers(0, max_count + 1)) if r else max_count
        bits[r, rng.choice(H, min(n, H), replace=False)] = 1
    return bits


def _np(out):
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("want_wah", [True, False])
@pytest.mark.parametrize("cap,H", [(0, 300), (64, 300), (2048, 3000)])
def test_track_encode_body_matches_jax(want_wah, cap, H):
    rng = np.random.default_rng(cap + H + want_wah)
    bits = _track_bits(rng, 6, H, max(cap, 40))
    got = _np(encoder_torch.track_encode_body(torch.from_numpy(bits), cap,
                                              want_wah=want_wah))
    want = _np(encoder_jax._track_encode_body(jnp.asarray(bits), cap,
                                              want_wah=want_wah))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if want_wah:
        assert got[0].dtype == np.uint16 and got[1].dtype == np.int32


@pytest.mark.parametrize("cap,H", [(0, 77), (64, 300), (2048, 3000)])
def test_encode_tracks_packed_matches_jax(cap, H):
    rng = np.random.default_rng(7 * H + cap)
    bits = _track_bits(rng, 9, H, max(cap, 30))
    packed = np.packbits(bits, axis=1, bitorder="little")
    got = _np(encoder_torch.encode_tracks_packed(torch.from_numpy(packed), H,
                                                 cap))
    with jax.disable_jit():    # the cap-2048 program compiles for minutes
        want = _np(encoder_jax._encode_tracks_device_packed(
            jnp.asarray(packed), H, cap))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _records(rng, n_samples=50, n=24):
    return [make_record(rng, n_samples, n_alts=2 if i % 5 == 0 else 1,
                        p_alt=[0.004, 0.3, 0.99][i % 3], p_missing=0.05,
                        p_eov=0.04 if i % 2 else 0.0)
            for i in range(n)]


@pytest.mark.parametrize("ws", [WS.WS_SPARSE, WS.WS_WAH])
def test_compact_tracks_core_matches_jax(ws):
    rng = np.random.default_rng(4 + ws)
    records = _records(rng)
    enc = TorchBlockEncoder(50, 100, 2, default_phasing=1,
                            aet_dtype=np.uint16, weirdness_strategy=ws,
                            device="cpu")
    for gt, na in records:
        enc.encode_record(gt, na)
    prep = enc.prepare()
    wah_weird = ws == WS.WS_WAH
    trk_cap = enc.track_cap(prep, wah_weird)
    nm = len(prep["flag_m"])
    rows = prep["first_lines"][np.concatenate([prep["flag_m"],
                                               prep["flag_e"]])]
    kind = np.arange(len(rows)) >= nm
    t = torch.from_numpy
    got = encoder_torch.encode_block_core_compact_tracks(
        t(prep["alleles_p"]), t(prep["alts_p"]),
        t(prep["wah_rows_p"]).long(), t(prep["sorts_w"]),
        t(prep["sparse_rows_p"]).long(), t(prep["negated_s"]),
        t(rows).long(), t(kind), 2, trk_cap)
    want = encoder_jax._encode_block_device_compact_tracks(
        *(jnp.asarray(prep[k]) for k in (
            "alleles_p", "alts_p", "is_wah_p", "negated_p", "wah_rows_p",
            "sorts_w", "sparse_rows_p", "negated_s")),
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(kind), 2, trk_cap)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _pairs_padded(rec, idx, Lp):
    k = bucket(len(rec) + 1)
    r = np.full(k, Lp, np.int32)
    r[:len(rec)] = rec
    x = np.zeros(k, np.int32)
    x[:len(idx)] = idx
    return jnp.asarray(r), jnp.asarray(x)


@pytest.mark.parametrize("dp", [0, 1])
def test_fused_track_decode_matches_jax(dp):
    rng = np.random.default_rng(12 + dp)
    n_samples = 60
    recs = [make_record(rng, n_samples, p_alt=p, p_missing=0.06, p_eov=0.04,
                        phased=bool(dp))
            for p in [0.004, 0.3, 0.996, 0.6] * 6]
    enc = GtBlockEncoder(n_samples, 10_000, 3, default_phasing=dp,
                         aet_dtype=np.uint16)
    for gt, na in recs:
        enc.encode_record(gt, na)
    payload = enc.serialize()

    dev = decoder_torch.TorchBlockDecoder(payload, n_samples, 2 * n_samples,
                                          np.uint16, device="cpu")
    assert dev.eligible
    *args, H, W, L = dev.device_inputs()
    m = dev.meta
    tracks = [decoder_torch.track_carriers(s, np.flatnonzero(f), np.uint16,
                                           dev.line_width)
              for s, f in ((m.missing_sparse, m.line_has_missing),
                           (m.eov_sparse, m.line_has_eov))]
    pairs = [torch.from_numpy(x) for tr in tracks for x in tr]
    got = decoder_torch._decode_block_full_gt_tracks(*args, dp, *pairs, H, W)
    np.testing.assert_array_equal(got.numpy(), np.stack([g for g, _ in recs]))
    # the standalone fold of decoded bits is the same function
    vals = decoder_torch._decode_block_vals(*args, H, W)
    np.testing.assert_array_equal(
        decoder_torch._fold_tracks_impl(vals, dp, *pairs).numpy(),
        got.numpy())

    jd = decoder_jax.DeviceBlockDecoder(payload, n_samples, 2 * n_samples,
                                        np.uint16)
    (padded, sorts_p, rank, is_wah_p, neg_p, car_line, car_idx,
     jH, jW, jL, _) = jd.host_inputs()
    staged = [jnp.asarray(x) for x in (padded, sorts_p, rank, is_wah_p,
                                       neg_p, car_line, car_idx)]
    jpairs = [p for tr in tracks for p in _pairs_padded(*tr, rank.shape[0])]
    want = np.asarray(decoder_jax._decode_block_full_gt_tracks(
        *staged, jnp.int32(dp), *jpairs, jH, jW))[:jL]
    np.testing.assert_array_equal(got.numpy(), want)
    jvals = decoder_jax._decode_block_full(*staged, jH, jW)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(decoder_jax._fold_biallelic_tracks(
            jvals, jnp.int32(dp), *jpairs))[:jL])


def _kitchen_sink(rng):
    return [make_record(rng, 64, n_alts=2, p_alt=0.4, p_missing=0.03,
                        p_phase_flip=0.05) if i % 5 == 0 else
            make_record(rng, 64, p_alt=0.004) if i % 3 == 0 else
            make_record(rng, 64, p_alt=0.3, p_missing=0.02, p_eov=0.04)
            for i in range(40)]


# name -> (records(rng), n_samples, encoder options)
TRACK_FIXTURES = {
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
    "phase_only": (
        lambda r: [make_record(r, 40, p_alt=0.3, p_phase_flip=0.1)
                   for _ in range(12)], 40, dict(mac_threshold=2)),
    "kitchen_sink": (_kitchen_sink, 64, dict(mac_threshold=3)),
    "kitchen_sink_wah": (_kitchen_sink, 64,
                         dict(mac_threshold=3,
                              weirdness_strategy=WS.WS_WAH)),
    "haploid_missing": (
        lambda r: [make_record(r, 70, p_alt=p, haploid=True, p_missing=0.04)
                   for p in [0.002, 0.05, 0.4, 0.9] * 4], 70,
        dict(mac_threshold=3, default_phasing=0)),
    "missing_unphased_u32": (
        lambda r: [make_record(r, 60, p_alt=0.3, p_missing=0.05, p_eov=0.03,
                               phased=False) for _ in range(20)], 60,
        dict(mac_threshold=2, default_phasing=0, aet_dtype=np.uint32)),
}


def _encode(cls, records, n_samples, opts, **extra):
    kw = dict(block_bcf_lines=10_000, default_phasing=1, aet_dtype=np.uint16)
    kw.update(opts)
    enc = cls(n_samples, **kw, **extra)
    for gt, na in records:
        enc.encode_record(gt, na)
    return enc.serialize()


@pytest.mark.parametrize("name", sorted(TRACK_FIXTURES))
def test_payload_with_device_tracks(name, monkeypatch):
    monkeypatch.setenv("XSI_TRACKS_DEVICE_MIN", "1")
    calls = []
    body = encoder_torch.track_encode_body

    def spy(bits, cap, want_wah=True):
        calls.append((tuple(bits.shape), cap, want_wah))
        return body(bits, cap, want_wah)

    monkeypatch.setattr(encoder_torch, "track_encode_body", spy)
    make, n_samples, opts = TRACK_FIXTURES[name]
    records = make(np.random.default_rng(sorted(TRACK_FIXTURES).index(name)))
    got = _encode(TorchBlockEncoder, records, n_samples, opts, device="cpu")
    assert calls, "the device track route did not run"
    assert got == _encode(GtBlockEncoder, records, n_samples, opts)
    assert got == _encode(DeviceBlockEncoder, records, n_samples, opts)


def test_flagged_zero_alt_record_is_refused_on_the_fused_route(monkeypatch):
    """A record without ALT owns no binary line, so its tracks cannot be
    stored: the fused route must end in the assembler's ValueError (as
    the host and JAX encoders do), not index past the block's lines."""
    monkeypatch.setenv("XSI_TRACKS_DEVICE_MIN", "1")
    rng = np.random.default_rng(3)
    zero_alt = (np.full(40, 2) | (np.arange(40) & 1)).astype(np.int32)
    zero_alt[3] = 1                                   # missing, phase kept
    records = [make_record(rng, 20, p_alt=0.3, p_missing=0.1)
               for _ in range(5)] + [(zero_alt, 1)]
    for cls, kw in ((GtBlockEncoder, {}), (TorchBlockEncoder,
                                           {"device": "cpu"})):
        with pytest.raises(ValueError, match="no ALT allele"):
            _encode(cls, records, 20, dict(mac_threshold=2), **kw)
