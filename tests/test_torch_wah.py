"""WAH2 ops of the torch port vs the JAX package (XLA forms, Pallas kernels
in interpret mode) and the NumPy oracle.  Every value is an integer: the
tolerance is exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.ops import wah_jax, wah_np
from xsqueezeit_tpu.ops.wah_pallas import (
    wah_compress_pallas,
    wah_expand_pallas,
    wah_expand_rows_pallas,
)
from xsqueezeit_tpu_torch.ops import wah_kernels, wah_torch


def _bits(rng, L, H, ps=(0.0, 0.01, 0.3, 0.9, 1.0)):
    p = rng.choice(ps, size=L)
    return (rng.random((L, H)) < p[:, None]).astype(np.uint8)


@pytest.mark.parametrize("H", [1, 14, 15, 31, 300, 5008])
def test_pack_unpack_bits_match_jax_and_numpy(H):
    bits = _bits(np.random.default_rng(H), 9, H)
    got = wah_torch.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(wah_jax.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        got, np.stack([wah_np.pack_words(b) for b in bits]))
    back = wah_torch.unpack_bits(torch.from_numpy(got), H).numpy()
    np.testing.assert_array_equal(back, bits)
    np.testing.assert_array_equal(
        back, np.asarray(wah_jax.unpack_bits(jnp.asarray(got), H)))


@pytest.mark.parametrize("H", [15, 31, 300, 5008])
def test_compress_words_matches_jax_numpy_and_pallas(H):
    bits = _bits(np.random.default_rng(100 + H), 24, H)
    words = wah_torch.pack_bits(torch.from_numpy(bits))
    got_w, got_n = wah_torch.wah_compress_words(words)
    assert got_w.dtype == torch.uint16 and got_n.dtype == torch.int32
    jw = jnp.asarray(words.numpy())
    want_w, want_n = wah_jax.wah_compress_words(jw)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    pal_w, pal_n = wah_compress_pallas(jw, jw.shape[1], interpret=True)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(pal_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(pal_n))
    for r in range(bits.shape[0]):
        n = int(got_n[r])
        np.testing.assert_array_equal(got_w[r, :n].numpy(),
                                      wah_np.wah_encode(bits[r]))
    # the kernel wrapper on CPU tensors is the plain version
    kw, kn = wah_kernels.wah_compress(words)
    assert torch.equal(kw, got_w) and torch.equal(kn, got_n)


def test_compress_counter_saturation_matches_pallas():
    n = (16383 + 5) * 15
    bits = np.zeros((2, n), np.uint8)
    bits[1] = 1
    words = wah_torch.pack_bits(torch.from_numpy(bits))
    got_w, got_n = wah_kernels.wah_compress(words)
    assert got_n.tolist() == [2, 2]
    assert got_w[0, :2].tolist() == [0x8000 | 16383, 0x8000 | 5]
    assert got_w[1, :2].tolist() == [0xC000 | 16383, 0xC000 | 5]
    pal_w, pal_n = wah_compress_pallas(jnp.asarray(words.numpy()),
                                       words.shape[1], interpret=True)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(pal_w))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(pal_n))


@pytest.mark.parametrize("H", [31, 301, 1001])
def test_expand_matches_pallas_and_xla_with_padded_tail(H):
    rng = np.random.default_rng(200 + H)
    L = 24
    W = wah_torch.n_words_for(H)
    bits = _bits(rng, L, H)
    stream = np.concatenate([wah_np.wah_encode(b) for b in bits]
                            + [np.zeros(7, np.uint16)])
    n_lines = L + 3          # three trailing rows come from padding only
    got = wah_kernels.wah_expand(torch.from_numpy(stream), n_lines, W)
    assert got.dtype == torch.int32 and got.shape == (n_lines, W)
    want = np.asarray(wah_jax.wah_expand_stream(jnp.asarray(stream),
                                                n_lines, W))
    np.testing.assert_array_equal(got.numpy(), want)
    pal = np.asarray(wah_expand_pallas(jnp.asarray(stream), n_lines, W,
                                       interpret=True))
    np.testing.assert_array_equal(got.numpy(), pal)
    np.testing.assert_array_equal(
        wah_torch.unpack_bits(got[:L], H).numpy(), bits)
    assert not got[L:].any()


def test_expand_matches_rows_kernel_at_hrc_width():
    """The row-blocked Pallas kernel's contract (HRC width, w = 4332): the
    port's offset-driven expansion gives the same groups."""
    rng = np.random.default_rng(29)
    H, L = 64976, 5
    W = wah_torch.n_words_for(H)
    bits = _bits(rng, L, H, ps=(0.0, 0.005, 0.3, 1.0))
    stream = np.concatenate([wah_np.wah_encode(b) for b in bits]
                            + [np.zeros(7, np.uint16)])
    got = wah_kernels.wah_expand(torch.from_numpy(stream), L + 1, W)
    want = np.asarray(wah_expand_rows_pallas(jnp.asarray(stream), L + 1, W,
                                             interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_stream_shorter_than_lines():
    """Words that end before n_lines give zero rows; words past n_lines * w
    are dropped."""
    rng = np.random.default_rng(5)
    H, L = 100, 6
    W = wah_torch.n_words_for(H)
    bits = _bits(rng, L, H)
    stream = np.concatenate([wah_np.wah_encode(b) for b in bits])
    s = torch.from_numpy(stream)
    for n_lines in (2, L, L + 4):
        got = wah_kernels.wah_expand(s, n_lines, W).numpy()
        want = np.asarray(wah_jax.wah_expand_stream(jnp.asarray(stream),
                                                    n_lines, W))
        np.testing.assert_array_equal(got, want)


def test_line_offsets_match_jax():
    rng = np.random.default_rng(6)
    H, L = 257, 12
    W = wah_torch.n_words_for(H)
    stream = np.concatenate([wah_np.wah_encode(b) for b in _bits(rng, L, H)]
                            + [np.zeros(3, np.uint16)])
    got = wah_torch.wah_line_offsets(torch.from_numpy(stream), W, L)
    want = np.asarray(wah_jax.wah_line_offsets(jnp.asarray(stream), H, W,
                                               n_lines=L + 1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_width_guards_keep_their_messages():
    with pytest.raises(ValueError, match="at most 32767 words per line"):
        wah_torch.wah_compress_words(torch.zeros((1, 1 << 15),
                                                 dtype=torch.int32))
    with pytest.raises(ValueError, match="at most 32767 words per line"):
        wah_torch.wah_expand_stream(torch.zeros(4, dtype=torch.int32), 1,
                                    1 << 15)
