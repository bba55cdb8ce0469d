"""Mixed-ploidy blocks (haploid and diploid records interleaved, as at a
chrX PAR boundary) in the torch port vs the JAX package and the NumPy
oracles, on CPU tensors (the kernels' plain versions): the encode with
the parity payload, the mixed decode scan, the per-line-width WAH
expand, the encoder's payloads and decode_block_records.  Every value is an integer or a byte:
the tolerance is exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.codec import decoder_jax
from xsqueezeit_tpu.codec.encoder_jax import DeviceBlockEncoder
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.format.constants import WeirdnessStrategy as WS
from xsqueezeit_tpu.ops import pbwt_jax, pbwt_np, wah_jax, wah_np
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
from xsqueezeit_tpu_torch.ops import (pbwt_kernels, pbwt_torch, wah_kernels,
                                      wah_torch)
from tests.gt_synth import make_record
from tests.test_decoder_jax import _mixed_weird_records
from tests.test_encoder_mixed import mixed_records


def _mixed_alleles(rng, L, H):
    """Allele codes of L lines, haploid lines slot-duplicated."""
    alleles = rng.integers(0, 3, (L, H)).astype(np.int16)
    hap = rng.random(L) < 0.5
    alleles[hap] = np.repeat(alleles[hap][:, 0::2], 2, axis=1)
    return alleles, hap


@pytest.mark.parametrize("H,L", [(6, 1), (64, 40), (130, 7), (1000, 100),
                                 (2466, 70), (65538, 17)])
def test_parity_scan_matches_jax_and_numpy(H, L):
    """The chunked encode with the parity payload (15 lines a chunk)
    against the JAX package's parity scan and the NumPy oracle; the last
    case crosses a chunk boundary above the 16-bit slot field."""
    rng = np.random.default_rng(H + L)
    alleles, _ = _mixed_alleles(rng, L, H)
    alts = rng.integers(1, 3, L).astype(np.int32)
    sorts = rng.random(L) < 0.7
    ys, par, af = (x.numpy() for x in pbwt_torch.pbwt_encode_chunked(
        torch.from_numpy(alleles), torch.from_numpy(alts),
        torch.from_numpy(sorts), parity=True))
    jys, jpar, jaf = pbwt_jax.pbwt_encode_scan_parity(
        jnp.asarray(alleles), jnp.asarray(alts), jnp.asarray(sorts),
        jnp.arange(H, dtype=jnp.int32))
    for got, want in ((ys, jys), (par, jpar), (af, jaf)):
        np.testing.assert_array_equal(got, np.asarray(want))
    oys, opar, oaf = pbwt_np.pbwt_encode_parity(alleles, alts, sorts)
    for got, want in ((ys, oys), (par, opar), (af, oaf)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("carry_parity", [False, True])
def test_encode_keys_match_jax(carry_parity):
    """The chunked encode's rows and final arrangement at a mixed block's
    lines, uniform against the JAX package's packed-key scan, with the
    parity payload against its parity scan."""
    rng = np.random.default_rng(17 + carry_parity)
    alleles, _ = _mixed_alleles(rng, 45, 300)
    alts = rng.integers(1, 3, 45).astype(np.int32)
    sorts = rng.random(45) < 0.6
    got = pbwt_torch.pbwt_encode_chunked(
        torch.from_numpy(alleles), torch.from_numpy(alts),
        torch.from_numpy(sorts), parity=carry_parity)
    jargs = (jnp.asarray(alleles), jnp.asarray(alts), jnp.asarray(sorts),
             jnp.arange(300, dtype=jnp.int32))
    want = (pbwt_jax.pbwt_encode_scan_parity(*jargs) if carry_parity
            else pbwt_jax.pbwt_encode_scan(*jargs))
    assert len(got) == len(want) == 2 + carry_parity
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("H", [5, 200, 4932])
def test_rank_chain_callers_bit_identical(H):
    """The rank chain's key width is a parameter: its b-bit form (the key
    width of the JAX package's parity scan) equals the JAX chain, and its
    default is the chunked encode's 16-bit form."""
    rng = np.random.default_rng(H)
    b = pbwt_jax._hap_bits(H)
    C = 30 - b
    T = rng.integers(0, 1 << C, (6, H)).astype(np.int64)
    r0 = torch.arange(H)
    got = pbwt_kernels.rank_chain(torch.from_numpy(T), r0, b)
    want = pbwt_jax._rank_chain(jnp.asarray(T.astype(np.uint32)),
                                jnp.arange(H, dtype=jnp.int32), b,
                                total_bits=C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    T16 = torch.from_numpy(T & 0xFFFF)
    for g, w in zip(pbwt_kernels.rank_chain(T16, r0),
                    pbwt_kernels.rank_chain(T16, r0, 16)):
        assert torch.equal(g, w)


def _stored_mixed_bits(alleles, alts, hap):
    """On-disk bits of every line (all sorting): diploid lines their H
    arrangement-ordered bits, haploid ones the even-parity subsequence
    front-packed."""
    ys, par, _ = pbwt_np.pbwt_encode_parity(alleles, alts,
                                            np.ones(len(alts), bool))
    out = ys.copy()
    for l in np.flatnonzero(hap):
        ev = ys[l][par[l] == 0]
        out[l] = 0
        out[l, :ev.shape[0]] = ev
    return out


@pytest.mark.parametrize("H,L", [(8, 5), (64, 40), (300, 33)])
def test_mixed_decode_scan_matches_jax(H, L):
    rng = np.random.default_rng(3 * H + L)
    alleles, hap = _mixed_alleles(rng, L, H)
    alts = np.ones(L, np.int32)
    ys = _stored_mixed_bits(alleles, alts, hap)
    sorts = np.ones(L, bool)
    vals, af = pbwt_torch.pbwt_decode_scan_mixed(
        torch.from_numpy(ys), torch.from_numpy(sorts), torch.from_numpy(hap))
    np.testing.assert_array_equal(vals.numpy(),
                                  (alleles == 1).astype(np.uint8))
    jv, ja = pbwt_jax.pbwt_decode_scan_mixed(
        jnp.asarray(ys), jnp.asarray(sorts), jnp.asarray(hap),
        jnp.arange(H, dtype=jnp.int32))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(af.numpy(), np.asarray(ja))
    # with no haploid line it is the uniform per-line scan
    ys_d = rng.integers(0, 2, (L, H)).astype(np.uint8)
    part = rng.random(L) < 0.7
    vd, ad = pbwt_torch.pbwt_decode_scan_mixed(
        torch.from_numpy(ys_d), torch.from_numpy(part),
        torch.zeros(L, dtype=torch.bool))
    jv, ja = pbwt_jax.pbwt_decode_scan(jnp.asarray(ys_d), jnp.asarray(part),
                                       jnp.arange(H, dtype=jnp.int32))
    np.testing.assert_array_equal(vd.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ad.numpy(), np.asarray(ja))


@pytest.mark.parametrize("N,L", [(1, 6), (40, 30), (1233, 24)])
def test_wah_expand_varw_matches_jax(N, L):
    rng = np.random.default_rng(N + L)
    hap = rng.random(L) < 0.5
    p = rng.choice([0.0, 0.01, 0.4, 1.0], L)
    widths = np.where(hap, N, 2 * N)
    rows = [(rng.random(w) < q).astype(np.uint8) for w, q in zip(widths, p)]
    stream = np.concatenate([wah_np.wah_encode(r) for r in rows]
                            + [np.zeros(4, np.uint16)])
    gw = np.array([wah_torch.n_words_for(w) for w in widths])
    group_off = np.concatenate([[0], np.cumsum(gw)]).astype(np.int64)
    w_max = wah_torch.n_words_for(2 * N)
    got = wah_kernels.wah_expand_varw(torch.from_numpy(stream),
                                      torch.from_numpy(group_off), w_max)
    assert got.dtype == torch.int32 and got.shape == (L, w_max)
    assert torch.equal(got, wah_torch.wah_expand_stream_varw(
        torch.from_numpy(stream), torch.from_numpy(group_off), w_max))
    want = wah_jax.wah_expand_stream_varw(
        jnp.asarray(stream), jnp.asarray(group_off.astype(np.int32)), L,
        w_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for l, r in enumerate(rows):
        np.testing.assert_array_equal(
            wah_torch.unpack_bits(got[l], widths[l]).numpy(), r)


def _kitchen_sink(rng):
    records = []
    for i in range(48):
        if i % 7 == 0:
            records.append(make_record(rng, 64, p_alt=0.5, haploid=True))
        elif i % 5 == 0:
            records.append(make_record(rng, 64, n_alts=3, p_alt=0.4,
                                       p_missing=0.03, p_phase_flip=0.05))
        elif i % 3 == 0:
            records.append(make_record(rng, 64, p_alt=0.002, haploid=True))
        else:
            records.append(make_record(rng, 64, p_alt=0.3, p_missing=0.02,
                                       p_eov=0.04, p_phase_flip=0.02))
    return records


# tests/test_encoder_mixed.py's fixtures: name -> (records(rng), n_samples,
# encoder options)
ENCODE_FIXTURES = {
    "common": (lambda r: mixed_records(r, 60, 30, p_alt=0.4), 60, {}),
    "rare_and_negated": (
        lambda r: (mixed_records(r, 80, 12, p_alt=0.01)
                   + mixed_records(r, 80, 12, p_alt=0.99, hap_every=2)),
        80, dict(mac_threshold=5)),
    "multiallelic": (
        lambda r: mixed_records(r, 50, 15, n_alts=3, p_alt=0.5), 50, {}),
    "missing_sparse": (
        lambda r: mixed_records(r, 50, 20, p_alt=0.3, p_missing=0.08), 50,
        {}),
    "missing_wah": (
        lambda r: mixed_records(r, 50, 20, p_alt=0.3, p_missing=0.08), 50,
        dict(weirdness_strategy=WS.WS_WAH)),
    "kitchen_sink": (_kitchen_sink, 64, {}),
    "kitchen_sink_wah": (_kitchen_sink, 64,
                         dict(weirdness_strategy=WS.WS_WAH)),
    "u32": (lambda r: mixed_records(r, 40, 18, p_alt=0.3, p_missing=0.05),
            40, dict(aet_dtype=np.uint32)),
    "haploid_wah_lines_only": (
        lambda r: [make_record(r, 30, p_alt=0.4, haploid=i % 2 == 0)
                   if i % 2 == 0 else make_record(r, 30, p_alt=0.005)
                   for i in range(10)], 30, {}),
    "sparse_lines_only": (
        lambda r: mixed_records(r, 50, 12, p_alt=0.01), 50,
        dict(mac_threshold=5)),
}


def _encode(cls, records, n_samples, opts, **extra):
    kw = dict(block_bcf_lines=10_000, mac_threshold=2, default_phasing=1,
              aet_dtype=np.uint16)
    kw.update(opts)
    enc = cls(n_samples, **kw, **extra)
    for gt, na in records:
        enc.encode_record(gt, na)
    return enc.serialize()


@pytest.mark.parametrize("tracks_min", ["8", "1"])
@pytest.mark.parametrize("name", sorted(ENCODE_FIXTURES))
def test_mixed_payload_identical_to_host_and_jax(name, tracks_min,
                                                 monkeypatch):
    monkeypatch.setenv("XSI_TRACKS_DEVICE_MIN", tracks_min)
    make, n_samples, opts = ENCODE_FIXTURES[name]
    records = make(np.random.default_rng(sorted(ENCODE_FIXTURES).index(name)))
    assert len({gt.shape[0] for gt, _ in records}) == 2
    got = _encode(TorchBlockEncoder, records, n_samples, opts, device="cpu")
    assert got == _encode(GtBlockEncoder, records, n_samples, opts)
    assert got == _encode(DeviceBlockEncoder, records, n_samples, opts)
    outs = decoder_torch.decode_block_records(
        got, n_samples, 2 * n_samples, opts.get("aet_dtype", np.uint16),
        [na for _, na in records], device="cpu")
    for i, ((gt, _), out) in enumerate(zip(records, outs)):
        np.testing.assert_array_equal(out, gt, err_msg=f"record {i}")


def _device_path_records(rng):
    recs = []
    for i in range(60):
        hap = i % 3 == 1
        if i % 5 == 0:
            recs.append(make_record(rng, 56, p_alt=0.45, haploid=hap))
        elif i % 7 == 2 and not hap:
            recs.append(make_record(rng, 56, n_alts=2, p_alt=0.5))
        elif i % 4 == 0:
            recs.append(make_record(rng, 56, p_alt=0.02, haploid=hap))
        else:
            recs.append(make_record(rng, 56, p_alt=0.98, haploid=hap))
    return recs


def _unphased_records(rng):
    return [make_record(rng, 40, p_alt=0.35, haploid=i % 4 == 2,
                        p_missing=0.05, phased=False,
                        p_phase_flip=0.0 if i % 4 == 2 else 0.15)
            for i in range(30)]


# tests/test_decoder_jax.py's mixed fixtures: name -> (records(rng),
# n_samples, GtBlockEncoder options, seed)
DECODE_FIXTURES = {
    "device_path": (_device_path_records, 56, dict(mac_threshold=4), 9),
    "with_tracks": (lambda r: _mixed_weird_records(r, 56, 72), 56,
                    dict(mac_threshold=4), 21),
    "tracks_wah_strategy": (lambda r: _mixed_weird_records(r, 48, 54), 48,
                            dict(mac_threshold=4,
                                 weirdness_strategy=WS.WS_WAH), 22),
    "tracks_unphased_default": (_unphased_records, 40,
                                dict(mac_threshold=3, default_phasing=0),
                                23),
}


@pytest.mark.parametrize("name", sorted(DECODE_FIXTURES))
def test_mixed_decode_block_records(name, monkeypatch):
    make, n_samples, opts, seed = DECODE_FIXTURES[name]
    records = make(np.random.default_rng(seed))
    payload = _encode(GtBlockEncoder, records, n_samples, opts)
    calls = []
    mixed = decoder_torch._decode_block_mixed

    def spy(*args):
        calls.append(args[-2:])
        return mixed(*args)

    monkeypatch.setattr(decoder_torch, "_decode_block_mixed", spy)
    dev = decoder_torch.TorchBlockDecoder(payload, n_samples, 2 * n_samples,
                                          np.uint16, device="cpu")
    assert not dev.eligible and dev.mixed_device_ok
    nas = [na for _, na in records]
    got = decoder_torch.decode_block_records(
        payload, n_samples, 2 * n_samples, np.uint16, nas, device="cpu")
    assert calls == [(2 * n_samples, wah_torch.n_words_for(2 * n_samples))]
    want = decoder_jax.decode_block_records(payload, n_samples,
                                            2 * n_samples, np.uint16, nas)
    for i, ((gt, _), g, w) in enumerate(zip(records, got, want)):
        np.testing.assert_array_equal(g, gt, err_msg=f"record {i}")
        np.testing.assert_array_equal(g, w, err_msg=f"record {i}")


def test_mixed_bits_match_jax():
    """decode_all of a mixed-ploidy block (decode_bits' "mixed" route)
    equals the JAX package's decode_all_mixed bit for bit (slot-duplicated
    haploid rows included)."""
    records = _mixed_weird_records(np.random.default_rng(21), 56, 72)
    payload = _encode(GtBlockEncoder, records, 56, dict(mac_threshold=4))
    dec = decoder_torch.TorchBlockDecoder(payload, 56, 112, np.uint16,
                                          device="cpu")
    bits, route = dec.decode_bits()
    assert route == "mixed" and bits.device.type == "cpu"
    got = dec.decode_all()
    np.testing.assert_array_equal(got, bits.numpy())
    want = decoder_jax.DeviceBlockDecoder(
        payload, 56, 112, np.uint16).decode_all_mixed()
    np.testing.assert_array_equal(got, want)


def test_mixed_record_subset_takes_the_host_decoder():
    """With offsets (the CLI's case) a mixed block decodes with
    GtBlockDecoder in both packages."""
    records = _device_path_records(np.random.default_rng(9))
    payload = _encode(GtBlockEncoder, records, 56, dict(mac_threshold=4))
    nas = [na for _, na in records]
    firsts = np.cumsum([0] + [na - 1 for na in nas])
    idx = list(range(0, len(records), 4))
    args = (payload, 56, 112, np.uint16, [nas[i] for i in idx],
            [int(firsts[i]) for i in idx])
    got = decoder_torch.decode_block_records(*args, device="cpu")
    want = decoder_jax.decode_block_records(*args)
    for k, i in enumerate(idx):
        np.testing.assert_array_equal(got[k], records[i][0])
        np.testing.assert_array_equal(got[k], want[k])
