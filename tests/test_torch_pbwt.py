"""PBWT chunk chains and chunked encode/decode of the torch port vs the
Pallas kernels (interpret mode), the JAX XLA forms and the NumPy oracle.
Tolerance: exact equality (integer bits and permutations)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.ops import pbwt_jax, pbwt_np, pbwt_pallas
from xsqueezeit_tpu_torch.ops import pbwt_kernels, pbwt_torch


def _lines(rng, L, H, ps=(0.02, 0.3, 0.6, 0.9)):
    p = rng.choice(ps, size=L)
    return (rng.random((L, H)) < p[:, None]).astype(np.int8)


def _chunk_registers(x, sorts, C):
    """Chunk-start registers as pbwt_encode_chunked builds them (JAX rank
    chain), so both chain implementations get identical input."""
    L, H = x.shape
    n_ch = L // C
    xc = (x == 1).astype(np.uint32).reshape(n_ch, C, H)
    bhat = np.sum(xc << np.arange(C, dtype=np.uint32)[None, :, None], axis=1)
    ss = sorts.reshape(n_ch, C).astype(np.uint32)
    sh = np.cumsum(ss, axis=1) - ss
    T = np.sum(np.where(ss[:, :, None] != 0, xc << sh[:, :, None], 0), axis=1)
    _, r_starts = pbwt_jax._rank_chain(jnp.asarray(T.astype(np.uint32)),
                                       jnp.arange(H, dtype=jnp.int32),
                                       pbwt_jax._hap_bits(H))
    q0 = np.zeros((n_ch, H), np.int32)
    for t, r in enumerate(np.asarray(r_starts)):
        q0[t, r] = bhat[t]
    return q0, T


@pytest.mark.parametrize("H,n_ch", [(257, 4), (300, 3)])
def test_chain_encode_plain_matches_pallas(H, n_ch):
    rng = np.random.default_rng(22 + H)
    C = 16
    x = _lines(rng, n_ch * C, H)
    sorts = rng.random(n_ch * C) < 0.75      # non-sorting lines mid-chunk
    q0, _ = _chunk_registers(x, sorts, C)
    ss = sorts.reshape(n_ch, C)
    got = pbwt_kernels.chain_encode(torch.from_numpy(q0),
                                    torch.from_numpy(ss))
    assert got.dtype == torch.uint8 and got.shape == (n_ch, C, H)
    hp = pbwt_pallas._ceil_to(H, pbwt_pallas.LANE)
    q0p = np.zeros((n_ch, hp), np.uint32)
    q0p[:, :H] = q0
    want = np.asarray(pbwt_pallas.chain_encode(
        jnp.asarray(q0p), jnp.asarray(ss.astype(np.int32)), C, H,
        interpret=True))[:, :, :H]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,n_ch", [(300, 3), (130, 2)])
def test_chain_decode_plain_matches_pallas(H, n_ch):
    rng = np.random.default_rng(21 + H)
    C = 16
    y = _lines(rng, n_ch * C, H).astype(np.uint8).reshape(n_ch, C, H)
    ss = rng.random((n_ch, C)) < 0.7
    got = pbwt_kernels.chain_decode(torch.from_numpy(y), torch.from_numpy(ss))
    assert got.dtype == torch.int64 and got.shape == (n_ch, H)
    hp = pbwt_pallas._ceil_to(H, pbwt_pallas.LANE)
    yp = np.zeros((n_ch, C, hp), np.int32)
    yp[:, :, :H] = y
    want = np.asarray(pbwt_pallas.chain_decode(
        jnp.asarray(yp), jnp.asarray(ss.astype(np.int32)), C, H,
        interpret=True))[:, -1, :H]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_rank_chain_matches_jax():
    rng = np.random.default_rng(7)
    n_ch, H = 9, 200
    T = rng.integers(0, 1 << 16, (n_ch, H)).astype(np.uint32)
    want_fin, want_starts = pbwt_jax._rank_chain(
        jnp.asarray(T), jnp.arange(H, dtype=jnp.int32), pbwt_jax._hap_bits(H),
        total_bits=16)
    got_fin, got_starts = pbwt_kernels.rank_chain(
        torch.from_numpy(T.astype(np.int64)), torch.arange(H))
    np.testing.assert_array_equal(got_starts.numpy(), np.asarray(want_starts))
    np.testing.assert_array_equal(got_fin.numpy(), np.asarray(want_fin))


def _numpy_oracle(x, sorts):
    """Per-line PBWT with the NumPy reference: bits in arrangement order."""
    L, H = x.shape
    a = np.arange(H)
    ys = np.empty((L, H), np.uint8)
    for i in range(L):
        ys[i] = x[i][a] == 1
        if sorts[i]:
            a = pbwt_np.stable_partition(a, ys[i])
    return ys, a


@pytest.mark.parametrize("L,H", [(48, 300), (70, 130), (37, 61)])
def test_chunked_encode_decode_match_jax_and_numpy(L, H):
    rng = np.random.default_rng(33 + L)
    x = _lines(rng, L, H)
    alts = np.ones(L, np.int32)
    sorts = rng.random(L) < 0.8
    ys, a_fin = pbwt_torch.pbwt_encode_chunked(
        torch.from_numpy(x), torch.from_numpy(alts), torch.from_numpy(sorts))
    want_y, want_a = pbwt_jax.pbwt_encode_chunked(
        jnp.asarray(x), jnp.asarray(alts), jnp.asarray(sorts))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(a_fin.numpy(), np.asarray(want_a))
    oy, oa = _numpy_oracle(x, sorts)
    np.testing.assert_array_equal(ys.numpy(), oy)
    np.testing.assert_array_equal(a_fin.numpy(), oa)

    vals, a_dec = pbwt_torch.pbwt_decode_chunked(ys, torch.from_numpy(sorts))
    np.testing.assert_array_equal(vals.numpy(), (x == 1).astype(np.uint8))
    np.testing.assert_array_equal(a_dec.numpy(), oa)
    jv, ja = pbwt_jax.pbwt_decode_chunked(want_y, jnp.asarray(sorts))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(a_dec.numpy(), np.asarray(ja))


def test_haplotype_guards():
    # the chains take every width the format allows
    big = torch.zeros((1, pbwt_kernels.MAX_RANK_H + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="at most 491505"):
        pbwt_torch.pbwt_encode_chunked(big, torch.ones(1, dtype=torch.int32),
                                       torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="at most 491505"):
        pbwt_torch.pbwt_decode_chunked(big.to(torch.uint8),
                                       torch.ones(1, dtype=torch.bool))
    assert pbwt_kernels.MAX_H_DECODE >= 5008
    assert pbwt_kernels.MAX_H_ENCODE >= pbwt_kernels.MAX_H_DECODE
