"""The PBWT device scans of ops/pbwt_kernels.py on the CPU: rank_chain and
decode_scan_mixed (their plain versions, and the wrappers' dispatch)
against the JAX package's _rank_chain and pbwt_decode_scan_mixed, exactly.

The CUDA kernels themselves (csrc/pbwt_scan.cu) are held against these
plain versions on the card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xsqueezeit_tpu.ops import pbwt_jax
from xsqueezeit_tpu_torch.ops import pbwt_kernels, pbwt_torch


def _totals(rng, n_ch, H, bits, kind):
    """Chunk history totals below 2^bits: each bit a sorting line of its
    own density; "zeros" all 0, "nosort" every other chunk without a
    sorting line (all 0), "full" every bit set on every haplotype."""
    T = np.zeros((n_ch, H), np.int64)
    if kind == "zeros":
        return T
    if kind == "full":
        return T + (1 << bits) - 1
    for k in range(bits):
        p = rng.choice([0.001, 0.05, 0.5, 0.97], (n_ch, 1))
        T |= (rng.random((n_ch, H)) < p).astype(np.int64) << k
    if kind == "nosort":
        T[::2] = 0
    return T


def _jax_chain(T, r0, bits):
    b = pbwt_jax._hap_bits(T.shape[1])
    fin, starts = pbwt_jax._rank_chain(
        jnp.asarray(T.astype(np.uint32)), jnp.asarray(r0.astype(np.int32)),
        b, total_bits=bits)
    return np.asarray(fin), np.asarray(starts)


#: (n_ch, H, bits of T, kind).  The JAX chain packs (T << b) | rank in 32
#: bits (b = ceil(log2 H)), so bits + b <= 32, as its callers keep it.
RANK_CASES = [(n_ch, H, bits, "random")
              for n_ch, H, bits in ((1, 1, 1), (7, 2, 16), (7, 3, 30),
                                    (301, 2, 30), (7, 301, 16), (1, 301, 1),
                                    (301, 301, 16), (7, 5008, 16),
                                    (1, 5008, 19))]
RANK_CASES += [(7, 301, 16, "zeros"), (7, 301, 16, "nosort"),
               (7, 301, 16, "full"), (7, 5008, 19, "nosort")]


@pytest.mark.parametrize("n_ch,H,bits,kind", RANK_CASES)
@pytest.mark.parametrize("entry", ["rank_chain_plain", "dispatch"])
def test_rank_chain_matches_jax(n_ch, H, bits, kind, entry):
    rng = np.random.default_rng(n_ch * 31 + H + bits)
    T = _totals(rng, n_ch, H, bits, kind)
    r0 = np.arange(H)
    want_fin, want_starts = _jax_chain(T, r0, bits)
    fn = (pbwt_kernels.rank_chain_plain if entry == "rank_chain_plain"
          else pbwt_torch._rank_chain)
    for t in (torch.from_numpy(T), torch.from_numpy(T).to(torch.int32)):
        fin, starts = fn(t, torch.arange(H), 16)
        assert fin.dtype == starts.dtype == torch.int64
        np.testing.assert_array_equal(starts.numpy(), want_starts)
        np.testing.assert_array_equal(fin.numpy(), want_fin)


def test_rank_chain_from_any_start():
    # r0 need not be the identity: the JAX chain's r0 is the rank under a0
    rng = np.random.default_rng(11)
    T = _totals(rng, 9, 257, 16, "random")
    r0 = rng.permutation(257)
    want_fin, want_starts = _jax_chain(T, r0, 16)
    fin, starts = pbwt_kernels.rank_chain(torch.from_numpy(T),
                                          torch.from_numpy(r0))
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    np.testing.assert_array_equal(fin.numpy(), want_fin)


def test_rank_chain_wide_rows_take_the_plain_chain(monkeypatch):
    # above the kernel's 16-bit ranks the dispatch names the plain chain
    # itself, on any device; below it the wrapper (here: its CPU branch)
    calls = []
    for name in ("rank_chain", "rank_chain_plain"):
        fn = getattr(pbwt_kernels, name)
        monkeypatch.setattr(pbwt_kernels, name,
                            lambda *a, _n=name, _f=fn: (calls.append(_n),
                                                        _f(*a))[1])
    T = torch.zeros((1, pbwt_kernels.MAX_H + 1), dtype=torch.int32)
    pbwt_torch._rank_chain(T, torch.arange(T.shape[1]), 17)
    assert calls == ["rank_chain_plain"]
    calls.clear()
    pbwt_torch._rank_chain(T[:, :5], torch.arange(5))
    assert calls == ["rank_chain", "rank_chain_plain"]


def _mixed_inputs(rng, L, H, kind):
    """Stored lines of a mixed block: haploid lines hold their (H + 1) // 2
    front-packed bits, zero past them."""
    hap = {"diploid": np.zeros(L, bool), "haploid": np.ones(L, bool),
           "alternating": np.arange(L) % 2 == 1,
           "runs": np.repeat(rng.random(-(-L // 8)) < 0.5, 8)[:L]}[kind]
    p = rng.choice([0.001, 0.05, 0.5, 0.97], (L, 1))
    ys = (rng.random((L, H)) < p).astype(np.uint8)
    ys[hap, (H + 1) // 2:] = 0
    return ys, hap


@pytest.mark.parametrize("L,H,kind,sorting", [
    (40, 300, "diploid", "most"), (40, 300, "haploid", "most"),
    (40, 300, "alternating", "most"), (64, 301, "runs", "most"),
    (40, 300, "alternating", "none"), (40, 2, "alternating", "most"),
    (40, 2, "haploid", "all"), (17, 1, "diploid", "most"),
    (0, 12, "diploid", "most"),
])
def test_decode_scan_mixed_matches_jax(L, H, kind, sorting):
    rng = np.random.default_rng(L * 7 + H)
    ys, hap = _mixed_inputs(rng, L, H, kind)
    sorts = {"most": rng.random(L) < 0.8, "none": np.zeros(L, bool),
             "all": np.ones(L, bool)}[sorting]
    args = (torch.from_numpy(ys), torch.from_numpy(sorts),
            torch.from_numpy(hap))
    want_v, want_a = pbwt_jax.pbwt_decode_scan_mixed(
        jnp.asarray(ys), jnp.asarray(sorts), jnp.asarray(hap),
        jnp.arange(H, dtype=jnp.int32))
    for fn in (pbwt_kernels.decode_scan_mixed_plain,
               pbwt_kernels.decode_scan_mixed,
               pbwt_torch.pbwt_decode_scan_mixed):
        vals, a = fn(*args)
        assert vals.dtype == torch.uint8 and a.dtype == torch.int64
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(a.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("fn,args,match", [
    ("rank_chain", lambda: (torch.zeros((2, 5), dtype=torch.int16),
                            torch.arange(5)), "int32 or int64"),
    ("rank_chain", lambda: (torch.zeros(5, dtype=torch.int64),
                            torch.arange(5)), "int32 or int64"),
    ("rank_chain", lambda: (torch.zeros((2, 5), dtype=torch.int64),
                            torch.arange(4)), "r0"),
    ("decode_scan_mixed", lambda: (torch.zeros((2, 5), dtype=torch.int32),
                                   torch.ones(2, dtype=torch.bool),
                                   torch.zeros(2, dtype=torch.bool)),
     "uint8"),
    ("decode_scan_mixed", lambda: (torch.zeros((2, 5), dtype=torch.uint8),
                                   torch.ones(3, dtype=torch.bool),
                                   torch.zeros(2, dtype=torch.bool)),
     "sorts"),
])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fn, args, match,
                                                      device):
    # the types and shapes are checked before the dispatch: on the CPU, and
    # on a device of neither route (meta), which is refused after them
    a = tuple(x.to(device) for x in args())
    with pytest.raises(ValueError, match=match):
        getattr(pbwt_kernels, fn)(*a)


def test_wrappers_refuse_a_device_without_kernels():
    with pytest.raises(ValueError, match="unsupported device"):
        pbwt_kernels.rank_chain(torch.zeros((2, 5), dtype=torch.int32,
                                            device="meta"),
                                torch.arange(5, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pbwt_kernels.decode_scan_mixed(
            torch.zeros((2, 5), dtype=torch.uint8, device="meta"),
            *(torch.ones(2, dtype=torch.bool, device="meta"),) * 2)


@pytest.mark.parametrize("H", [pbwt_kernels.MAX_H + 1, 0, -1])
def test_rank_route_refusals(H):
    with pytest.raises(ValueError, match="16 bits"):
        pbwt_kernels.rank_route(H)


#: (H, CTAs): one CTA up to 16,384 haplotypes, then ceil(H / 8192) CTAs of
#: at most 8192 each, up to 8 at the 16-bit ranks' limit.
RANK_ROUTES = [(1, 1), (4096, 1), (4097, 1), (5008, 1), (8193, 1),
               (16384, 1), (16385, 3), (24576, 3), (24577, 4), (57344, 7),
               (57345, 8), (64976, 8), (65535, 8)]


@pytest.mark.parametrize("H,want", RANK_ROUTES)
def test_rank_route_by_width(H, want):
    K = pbwt_kernels.rank_route(H)
    assert K == want
    # each CTA's shared memory holds the digit words and its bit planes,
    # and each thread at most 16 ranks on one CTA, 8 on a cluster (the
    # kernel's register instances)
    assert pbwt_kernels.rank_smem_bytes(H, K) <= pbwt_kernels._SMEM_BYTES
    hc = pbwt_kernels.rank_split(H, K)[0]
    assert -(-hc // 1024) <= (16 if K == 1 else 8)
