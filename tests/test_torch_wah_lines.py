"""The bits forms of the WAH2 routes (wah_compress_bits, wah_expand_bits,
wah_expand_varw_bits) on CPU tensors, where the wrappers take their plain
versions, against the JAX package: wah_jax.wah_encode_lines, the Pallas
compress in interpret mode over wah_jax.pack_bits, wah_jax.wah_decode_lines
over wah_jax.wah_line_offsets, and wah_jax.wah_expand_stream_varw +
unpack_bits; then the codec that calls them, against GtBlockEncoder and
GtBlockDecoder.  Every value is an integer or a byte: the tolerance is
exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.ops import wah_jax, wah_np
from xsqueezeit_tpu.ops.wah_pallas import wah_compress_pallas
from xsqueezeit_tpu_torch.codec import decoder_torch, encoder_torch
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu_torch.ops import wah_kernels, wah_torch
from tests.gt_synth import make_record
from tests.test_encoder_mixed import mixed_records

WIDTHS = [1, 15, 16, 301, 2466, 5008]
HRC_H = 64976


def _bits(rng, L, H, ps=(0.0, 0.001, 0.01, 0.3, 0.9, 0.999, 1.0)):
    p = rng.choice(ps, size=L)
    return (rng.random((L, H)) < p[:, None]).astype(np.uint8)


def _stream(bits, tail):
    return np.concatenate([wah_np.wah_encode(b) for b in bits]
                          + [np.zeros(tail, np.uint16)])


@pytest.mark.parametrize("H,L", [(h, 12) for h in WIDTHS] + [(HRC_H, 3)])
def test_encode_lines_matches_jax_and_pallas(H, L):
    bits = _bits(np.random.default_rng(H), L, H)
    got_w, got_n = wah_torch.wah_encode_lines(torch.from_numpy(bits))
    want_w, want_n = wah_jax.wah_encode_lines(jnp.asarray(bits))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    words = wah_jax.pack_bits(jnp.asarray(bits))
    pal_w, pal_n = wah_compress_pallas(words, words.shape[1],
                                       interpret=True)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(pal_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(pal_n))
    kw, kn = wah_kernels.wah_compress_bits(torch.from_numpy(bits))
    assert torch.equal(kw, got_w) and torch.equal(kn, got_n)


@pytest.mark.parametrize("H", [15, 301, 2466])
def test_compress_bits_takes_strided_and_bool_rows(H):
    rng = np.random.default_rng(40 + H)
    big = torch.from_numpy(_bits(rng, 9, H + 11))
    view = big[:, 5:5 + H]
    assert not view.is_contiguous()
    want = wah_torch.wah_encode_lines(view.contiguous())
    for rows in (view, view != 0):
        got = wah_kernels.wah_compress_bits(rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("H,L", [(h, 12) for h in WIDTHS] + [(HRC_H, 3)])
def test_expand_bits_matches_decode_lines(H, L):
    """A zero-padded tail (at least w words, as wah_decode_lines' windows
    need) and two lines past the stream's end."""
    bits = _bits(np.random.default_rng(100 + H), L, H)
    W = wah_torch.n_words_for(H)
    stream = _stream(bits, W + 3)
    n_lines = L + 2
    got = wah_kernels.wah_expand_bits(torch.from_numpy(stream), n_lines, W,
                                      H).numpy()
    assert got.dtype == np.uint8 and got.shape == (n_lines, H)
    np.testing.assert_array_equal(got[:L], bits)
    assert not got[L:].any()
    offs = wah_jax.wah_line_offsets(jnp.asarray(stream), H, W,
                                    n_lines=n_lines)
    want = wah_jax.wah_decode_lines(jnp.asarray(stream), offs, H, W)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, wah_torch.wah_expand_stream_bits(
        torch.from_numpy(stream), n_lines, W, H).numpy())


@pytest.mark.parametrize("n_lines", [0, 2, 6, 10])
def test_expand_bits_stream_shorter_than_lines(n_lines):
    """Words past n_lines * w are dropped; lines past the stream's end are
    zero; no lines at all is an empty grid."""
    H, L = 100, 6
    W = wah_torch.n_words_for(H)
    bits = _bits(np.random.default_rng(5), L, H)
    stream = _stream(bits, 0)
    got = wah_kernels.wah_expand_bits(torch.from_numpy(stream), n_lines, W,
                                      H).numpy()
    assert got.shape == (n_lines, H)
    if n_lines == 0:
        return              # (wah_jax.unpack_bits cannot reshape no rows)
    want = wah_jax.unpack_bits(
        wah_jax.wah_expand_stream(jnp.asarray(stream), n_lines, W), H)
    np.testing.assert_array_equal(got, np.asarray(want))
    k = min(n_lines, L)
    np.testing.assert_array_equal(got[:k], bits[:k])


def _varw_case(rng, N, L, run):
    """Lines of N (haploid) and 2N (diploid) bits, alternating in runs."""
    hap = np.repeat(rng.random(-(-L // run)) < 0.5, run)[:L]
    rows = [_bits(rng, 1, N if h else 2 * N)[0] for h in hap]
    widths = [wah_torch.n_words_for(len(r)) for r in rows]
    group_off = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    return rows, _stream(rows, 3), group_off


@pytest.mark.parametrize("N,L,run", [(1233, 48, 8), (40, 30, 3), (1, 7, 2)])
def test_expand_varw_bits_matches_jax(N, L, run):
    rows, stream, group_off = _varw_case(np.random.default_rng(N), N, L, run)
    w_max, h = wah_torch.n_words_for(2 * N), 2 * N
    got = wah_kernels.wah_expand_varw_bits(
        torch.from_numpy(stream), torch.from_numpy(group_off), w_max,
        h).numpy()
    assert got.shape == (L, h)
    for g, r in zip(got, rows):
        np.testing.assert_array_equal(g[:len(r)], r)
        assert not g[len(r):].any()
    want = wah_jax.unpack_bits(wah_jax.wah_expand_stream_varw(
        jnp.asarray(stream), jnp.asarray(group_off.astype(np.int32)), L,
        w_max), h)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_unpack_bits_of_no_rows():
    """The plain version of the bits expands at n_lines = 0 (the JAX
    package's reshape by -1 raises there)."""
    words = torch.zeros((0, 21), dtype=torch.int32)
    got = wah_torch.unpack_bits(words, 301)
    assert got.shape == (0, 301) and got.dtype == torch.uint8


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(wah_kernels, name)

        def call(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(wah_kernels, name, call)
    return calls


def _track_records(rng):
    return [make_record(rng, 60, p_alt=0.3, p_missing=0.05, p_eov=0.03,
                        p_phase_flip=0.05) for _ in range(20)]


def _mixed(rng):
    return mixed_records(rng, 50, 24, p_alt=0.3)


@pytest.mark.parametrize("kind,records,n_samples,decode_route", [
    ("tracks", _track_records, 60, "wah_expand_bits"),
    ("mixed", _mixed, 50, "wah_expand_varw_bits"),
])
def test_codec_on_cpu_calls_bits_routes(kind, records, n_samples,
                                        decode_route, monkeypatch):
    """The encoder's payload equals GtBlockEncoder's and the decoded
    records GtBlockDecoder's, with the WAH rows going through the bits
    routes (a track block with missing / EOV / phase tracks encoded on the
    device, and a mixed-ploidy block)."""
    monkeypatch.setenv("XSI_TRACKS_DEVICE_MIN", "1")
    calls = _spy(monkeypatch, ["wah_compress_bits", "wah_expand_bits",
                               "wah_expand_varw_bits"])
    recs = records(np.random.default_rng(len(kind)))
    kw = dict(n_samples=n_samples, block_bcf_lines=len(recs),
              mac_threshold=2, default_phasing=1, aet_dtype=np.uint16)
    ref = GtBlockEncoder(**kw)
    enc = encoder_torch.TorchBlockEncoder(device="cpu", **kw)
    for gt, na in recs:
        ref.encode_record(gt, na)
        enc.encode_record(gt, na)
    payload = enc.serialize()
    assert payload == ref.serialize()
    assert "wah_compress_bits" in calls
    na = [n for _, n in recs]
    got = decoder_torch.decode_block_records(payload, n_samples,
                                             2 * n_samples, np.uint16, na,
                                             device="cpu")
    host = GtBlockDecoder(payload, n_samples, 2 * n_samples, np.uint16)
    assert decode_route in calls
    for g, n in zip(got, na):
        np.testing.assert_array_equal(g, host.fill_genotype_array_advance(n))
