"""The PBWT device scans of ops/pbwt_kernels.py on the CPU: rank_chain and
decode_scan_mixed (their plain versions, the rank chain's log-depth form
rank_chain_levels_plain, and the wrappers' dispatch) against the JAX
package's _rank_chain and pbwt_decode_scan_mixed, exactly.

The CUDA kernels themselves (csrc/rank_chain.cu, csrc/pbwt_scan.cu) are
held against these plain versions on the card in tests/test_torch_cuda.py.
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
    sorting line (all 0), "full" every bit set on every haplotype, "equal"
    each chunk's row one value, "ties" a few distinct values a row."""
    T = np.zeros((n_ch, H), np.int64)
    if kind == "zeros":
        return T
    if kind == "full":
        return T + (1 << bits) - 1
    if kind == "equal":
        return T + rng.integers(0, 1 << bits, (n_ch, 1))
    if kind == "ties":
        vals = rng.integers(0, 1 << bits, (n_ch, 3))
        return np.take_along_axis(vals, rng.integers(0, 3, (n_ch, H)), 1)
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
    # "dispatch": the wrapper every encoder calls, whose CPU branch is the
    # plain chain
    rng = np.random.default_rng(n_ch * 31 + H + bits)
    T = _totals(rng, n_ch, H, bits, kind)
    r0 = np.arange(H)
    want_fin, want_starts = _jax_chain(T, r0, bits)
    fn = (pbwt_kernels.rank_chain_plain if entry == "rank_chain_plain"
          else pbwt_kernels.rank_chain)
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


#: (n_ch, H, bits of T, kind) for the level form: every n_ch from 1 to
#: 301 chunks (1 to 9 doubling levels) at narrow widths, the 1KGP3 width,
#: and the wide case (16-bit dense ranks' limit + 1) with few chunks.
LEVEL_CASES = (
    [(n_ch, 1, 30, "random") for n_ch in (1, 2, 64)]
    + [(n_ch, 2, 30, "random") for n_ch in (3, 5, 301)]
    + [(n_ch, 33, 18, "random") for n_ch in (1, 2, 3, 5, 64, 301)]
    + [(64, 33, 13, "ties"), (5, 33, 16, "equal"), (64, 33, 16, "zeros"),
       (301, 5008, 16, "random"), (64, 5008, 13, "random"),
       (5, 5008, 18, "random"), (64, 5008, 16, "ties"),
       (3, 5008, 16, "equal"), (2, 5008, 16, "zeros"),
       (3, 65536, 16, "random"), (5, 65536, 13, "ties"),
       (1, 65536, 16, "random"), (2, 65536, 16, "equal")])


@pytest.mark.parametrize("r0_kind", ["identity", "permutation"])
@pytest.mark.parametrize("n_ch,H,bits,kind", LEVEL_CASES)
def test_rank_chain_levels_plain_matches_jax(n_ch, H, bits, kind, r0_kind):
    """The log-depth form of csrc/rank_chain.cu against the JAX chain in
    both its phase-A forms (total_bits=None: S chunks a sort; <= 16:
    pairs of totals packed per operand) and against the one-sort-a-chunk
    plain chain, exactly."""
    rng = np.random.default_rng(n_ch * 7 + H + bits)
    T = _totals(rng, n_ch, H, bits, kind)
    r0 = np.arange(H) if r0_kind == "identity" else rng.permutation(H)
    fin, starts = pbwt_kernels.rank_chain_levels_plain(
        torch.from_numpy(T), torch.from_numpy(r0))
    assert fin.dtype == starts.dtype == torch.int64
    forms = [None] + ([bits] if bits <= 16 and H <= 0xFFFF else [])
    for total_bits in forms:
        want_fin, want_starts = _jax_chain(T, r0, total_bits)
        np.testing.assert_array_equal(starts.numpy(), want_starts)
        np.testing.assert_array_equal(fin.numpy(), want_fin)
    b = max(pbwt_jax._hap_bits(H), 16)
    p_fin, p_starts = pbwt_kernels.rank_chain_plain(
        torch.from_numpy(T), torch.from_numpy(r0), b)
    assert torch.equal(starts, p_starts) and torch.equal(fin, p_fin)


def test_rank_chain_wide_rows_take_the_plain_chain(monkeypatch):
    # every width, 65,536 haplotypes and up included, goes through the
    # kernels' wrapper, whose CPU branch (a CPU tensor) is the plain chain;
    # nothing launches here
    calls = []
    for name in ("rank_chain", "rank_chain_plain"):
        fn = getattr(pbwt_kernels, name)
        monkeypatch.setattr(pbwt_kernels, name,
                            lambda *a, _n=name, _f=fn: (calls.append(_n),
                                                        _f(*a))[1])

    def no_launch(*a):
        raise AssertionError("a kernel launched for a CPU tensor")
    monkeypatch.setattr(pbwt_kernels._build, "launch", no_launch)
    rng = np.random.default_rng(3)
    for H in (5, pbwt_kernels.SLOT16_H + 1):
        alleles = torch.from_numpy((rng.random((6, H)) < 0.3)
                                   .astype(np.int8))
        pbwt_torch.pbwt_encode_chunked(alleles,
                                       torch.ones(6, dtype=torch.int32),
                                       torch.ones(6, dtype=torch.bool))
        assert calls == ["rank_chain", "rank_chain_plain"]
        assert pbwt_kernels.rank_route(H)[0] == ("shared" if H == 5
                                                 else "device")
        calls.clear()


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


@pytest.mark.parametrize("H", [pbwt_kernels.MAX_RANK_H + 1, 0, -1])
def test_rank_route_refusals(H):
    with pytest.raises(ValueError, match="1 <= H <= 491505"):
        pbwt_kernels.rank_route(H)


#: (H, route, bytes of a dense rank): a row a CTA in shared memory up to
#: 16,384 haplotypes, then rows through device memory; 16-bit dense ranks
#: up to 65,535, 32-bit up to the format's widest panel.
RANK_ROUTES = [(1, "shared", 2), (2, "shared", 2), (2466, "shared", 2),
               (5008, "shared", 2), (16384, "shared", 2),
               (16385, "device", 2), (24577, "device", 2),
               (64976, "device", 2), (65535, "device", 2),
               (65536, "device", 4), (194512, "device", 4),
               (262144, "device", 4), (491505, "device", 4)]


@pytest.mark.parametrize("H,route,rank_bytes", RANK_ROUTES)
def test_rank_route_by_width(H, route, rank_bytes):
    assert pbwt_kernels.rank_route(H) == (route, rank_bytes)
    # the scratch holds the double-buffered dense ranks of every chunk, and
    # on the device route the double-buffered keys (twice a rank) and
    # payloads on top: 2 + 6 rank widths a haplotype and chunk (and the
    # counts and alignment, a few per cent of a wide row)
    n_ch = 301
    per = pbwt_kernels.rank_scratch_bytes(n_ch, H) / (n_ch * H * rank_bytes)
    assert per >= (2 if route == "shared" else 8)
    if H >= 2466:
        assert per < (2.1 if route == "shared" else 8.2)
