"""The port's CUDA kernels on the card: each against its plain version,
bit-exact, at small and edge-case shapes, plus a block round trip.

Marked `cuda`; every test skips where torch sees no CUDA device (the
decision is made inside the fixture, never at import).  On a machine with
a card:  python -m pytest tests/test_torch_cuda.py -q
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xsqueezeit_tpu_torch.codec import decoder_torch, encoder_torch
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu_torch.format.constants import INT32_VECTOR_END
from xsqueezeit_tpu_torch.ops import (pbwt_kernels, pbwt_torch, wah_kernels,
                                      wah_torch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(a, b):
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a.cpu().to(torch.int64),
                                              b.cpu().to(torch.int64))


def _chain_inputs(rng, n_ch, C, H, lines="random"):
    """Sort flags, encode registers and decode bits of n_ch chunks.
    lines: "random", "zeros" / "ones" (every line all 0 / all 1) or
    "nosort" (random bits, no line sorts)."""
    ss = torch.from_numpy(rng.random((n_ch, C)) < 0.8)
    ss[0] = True                 # one chain that sorts on every line
    if lines == "nosort":
        ss[:] = False
    if lines in ("zeros", "ones"):
        fill = 0 if lines == "zeros" else (1 << C) - 1
        q0 = torch.full((n_ch, H), fill, dtype=torch.int32)
        yc = torch.full((n_ch, C, H), fill & 1, dtype=torch.uint8)
    else:
        q0 = torch.from_numpy(rng.integers(0, 1 << C, (n_ch, H),
                                           dtype=np.int32))
        p = rng.choice([0.002, 0.4, 0.97], (n_ch, C, 1))
        yc = torch.from_numpy((rng.random((n_ch, C, H)) < p)
                              .astype(np.uint8))
    return ss, q0, yc


@pytest.mark.parametrize("n_ch,C,H,lines", [
    (1, 16, 1, "random"), (3, 16, 31, "random"), (3, 16, 33, "random"),
    (5, 7, 513, "random"),       # H not a multiple of a tile, C < 16
    (8, 16, 5008, "random"), (2, 16, 28928, "random"),
    (2, 16, 28929, "random"),    # above the one-CTA decode bound
    (2, 16, 57856, "random"),    # the one-CTA encode bound
    (4, 16, 5008, "zeros"), (4, 16, 5008, "ones"), (4, 16, 5008, "nosort"),
    (3, 4, 777, "random"),
])
def test_chain_kernels_match_plain(dev, n_ch, C, H, lines):
    rng = np.random.default_rng(H + C)
    ss, q0, yc = _chain_inputs(rng, n_ch, C, H, lines)
    n0 = dict(pbwt_kernels.launches)
    assert _equal(pbwt_kernels.chain_encode(q0.to(dev), ss.to(dev)),
                  pbwt_kernels.chain_encode_plain(q0, ss))
    assert _equal(pbwt_kernels.chain_decode(yc.to(dev), ss.to(dev)),
                  pbwt_kernels.chain_decode_plain(yc, ss))
    for name in ("chain_encode", "chain_decode"):
        route = pbwt_kernels.chain_route(name,
                                         pbwt_kernels.cluster_size(name, H))
        assert pbwt_kernels.launches[route] == n0[route] + 1


def test_chain_kernels_refuse_above_the_bound(dev):
    # the one-CTA route refuses a row its shared memory cannot hold; the
    # default route takes a cluster there; above 65,536 slots a chunk
    # holds fewer than 16 lines (decode_chunk); a CTA of the decode's
    # cluster owns at most 65,536 slots of the rows in device memory, and
    # nothing takes a row wider than the format's widest panel
    H = pbwt_kernels.MAX_H_DECODE + 1
    yc = torch.zeros((1, 16, H), dtype=torch.uint8, device=dev)
    ss = torch.ones((1, 16), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        pbwt_kernels.chain_decode(yc, ss, cluster=1)
    wide = torch.zeros((1, 16, pbwt_kernels.SLOT16_H + 2), dtype=torch.uint8,
                       device=dev)
    with pytest.raises(ValueError, match="at most 15 lines"):
        pbwt_kernels.chain_decode(wide, ss)
    widest = torch.zeros((1, 14, pbwt_kernels.chain_max_h("chain_decode", 2)
                          + 1), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="device memory"):
        pbwt_kernels.chain_decode(widest, ss[:, :14], cluster=2)
    over = torch.zeros((1, 13, pbwt_kernels.MAX_RANK_H + 1),
                       dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="491505"):
        pbwt_kernels.chain_decode(over, ss[:, :13])


@pytest.mark.parametrize("n_ch,H,K_enc,K_dec,shift", [
    (3, 65536, None, None, 16),   # the narrow state's widest row
    (3, 65600, None, None, 15),   # the wide state: top bit set
    (2, 70001, None, None, 15),   # odd H
    (2, 194512, None, None, 14),  # TOPMed: encode 8 CTAs, decode 16
    (1, 214016, None, None, 14),
    (1, 214017, None, None, 14),
    (1, 428032, None, None, 13),  # the encode's widest on 8
    (1, 428033, None, None, 13),  # encode 16 CTAs
    (2, 491505, None, None, 13),  # the format's widest
    (2, 65600, 16, 16, 15),       # 16 CTAs forced
    (3, 1001, 3, 2, 13),          # the wide state at a narrow width
    (3, 1001, 1, 1, 13),
    (3, 65600, None, 8, 15),      # the decode on 8 CTAs
    (2, 70001, None, 5, 15),      # ... on 5 CTAs
    (3, 1001, None, 2, 13),
])
def test_wide_chain_routes_match_plain(dev, n_ch, H, K_enc, K_dec, shift,
                                       monkeypatch):
    """The chains above 65,535 haplotypes: encode (16-bit registers, C =
    16) on 8 or 16 CTAs, decode with the state (slot << shift) | beta and
    chunks of `shift` lines on a cluster with both rows in device memory
    (16 CTAs, or as forced), against their plain versions; the int32
    states (widen=False) hold the uint32 bits.  At 1001 the wide state's
    shift is forced (decode_chunk patched)."""
    if shift != pbwt_kernels.decode_chunk(H):
        monkeypatch.setattr(pbwt_kernels, "decode_chunk", lambda W: shift)
    rng = np.random.default_rng(H + shift)
    ss, q0, _ = _chain_inputs(rng, n_ch, 16, H)
    n0 = dict(pbwt_kernels.launches)
    assert _equal(pbwt_kernels.chain_encode(q0.to(dev), ss.to(dev),
                                            cluster=K_enc),
                  pbwt_kernels.chain_encode_plain(q0, ss))
    K = pbwt_kernels.cluster_size("chain_encode", H, K_enc)
    route = pbwt_kernels.chain_route("chain_encode", K)
    assert pbwt_kernels.launches[route] == n0[route] + 1
    kw = dict(cluster=K_dec)
    ssd, _, yc = _chain_inputs(rng, n_ch, shift, H)
    want = pbwt_kernels.chain_decode_plain(yc, ssd)
    n0 = dict(pbwt_kernels.launches)
    got = pbwt_kernels.chain_decode(yc.to(dev), ssd.to(dev), **kw)
    assert _equal(got, want)
    got32 = pbwt_kernels.chain_decode(yc.to(dev), ssd.to(dev), widen=False,
                                      **kw)
    assert _equal(got32, pbwt_kernels._u32_bits(want))
    route = pbwt_kernels.chain_route(
        "chain_decode", pbwt_kernels.cluster_size("chain_decode", H, K_dec))
    assert pbwt_kernels.launches[route] == n0[route] + 2


@pytest.mark.parametrize("n_ch,C,H,K_enc,K_dec,lines", [
    (4, 16, 5008, 2, 4, "random"),        # forced cluster at 1KGP3 width
    (2, 16, 57857, None, None, "random"),  # just above the encode bound
    (3, 16, 64976, None, None, "random"),  # HRC: encode 8 CTAs, decode 16
    (3, 16, 64976, 2, 3, "random"),
    (3, 16, 64976, 4, 4, "random"),
    (2, 16, 65535, None, None, "random"),  # the 16-bit slot field's limit
    (2, 9, 1001, 3, 3, "random"),          # H not divisible by K
    (2, 16, 3, 8, 8, "random"),            # CTAs holding only padding
    (2, 16, 1, 2, 2, "random"),
    (3, 16, 31, 3, 3, "random"), (3, 16, 33, 4, 4, "random"),
    (3, 5, 700, 2, 2, "random"),           # C < 16
    (3, 16, 2000, 3, 3, "zeros"), (3, 16, 2000, 3, 3, "ones"),
    (3, 16, 2000, 2, 4, "nosort"),
])
def test_chain_cluster_routes_match_plain(dev, n_ch, C, H, K_enc, K_dec,
                                          lines):
    rng = np.random.default_rng(H + C)
    ss, q0, yc = _chain_inputs(rng, n_ch, C, H, lines)
    n0 = dict(pbwt_kernels.launches)
    assert _equal(pbwt_kernels.chain_encode(q0.to(dev), ss.to(dev),
                                            cluster=K_enc),
                  pbwt_kernels.chain_encode_plain(q0, ss))
    assert _equal(pbwt_kernels.chain_decode(yc.to(dev), ss.to(dev),
                                            cluster=K_dec),
                  pbwt_kernels.chain_decode_plain(yc, ss))
    n1 = pbwt_kernels.launches
    assert n1["chain_encode_cluster"] == n0["chain_encode_cluster"] + 1
    assert n1["chain_decode_rows"] == n0["chain_decode_rows"] + 1
    assert n1["chain_encode"] == n0["chain_encode"]
    assert n1["chain_decode"] == n0["chain_decode"]


@pytest.mark.parametrize("n_ch,C,H,K,lines", [
    (3, 15, 2466, None, "random"),    # one CTA: the chrX PAR block's width
    (2, 15, 33, None, "random"), (4, 7, 513, None, "random"),
    (4, 15, 5008, None, "ones"), (4, 15, 5008, None, "nosort"),
    (2, 15, 57856, None, "random"),   # one CTA's widest row
    (3, 15, 5008, 2, "random"),       # a cluster forced
    (2, 15, 97256, None, "random"),   # 8 CTAs: the TOPMed males' width
    (1, 15, 491504, None, "random"),  # 16 CTAs
])
def test_chain_encode_parity_matches_plain(dev, n_ch, C, H, K, lines):
    """The encode with the parity payload (bit 15 of each register, set at
    random) on each route against its plain version, counted under its
    own launch keys; 16 lines a chunk are refused."""
    rng = np.random.default_rng(H + C + 7)
    ss, q0, _ = _chain_inputs(rng, n_ch, C, H, lines)
    q0 |= torch.from_numpy(rng.integers(0, 2, (n_ch, H),
                                        dtype=np.int32)) << 15
    n0 = dict(pbwt_kernels.launches)
    got = pbwt_kernels.chain_encode(q0.to(dev), ss.to(dev), cluster=K,
                                    parity=True)
    assert _equal(got, pbwt_kernels.chain_encode_plain(q0, ss, parity=True))
    route = pbwt_kernels.chain_route(
        "chain_encode_parity", pbwt_kernels.cluster_size("chain_encode", H,
                                                         K))
    n1 = pbwt_kernels.launches
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == {route: 1}
    with pytest.raises(ValueError, match="at most 15 lines"):
        pbwt_kernels.chain_encode(
            q0.to(dev), torch.ones((n_ch, 16), dtype=torch.bool, device=dev),
            parity=True)


def _totals(rng, n_ch, H, bits, kind="random"):
    """Per-chunk history totals below 2^bits: each bit a sorting line of a
    density drawn per line; "zeros" all 0, "sparse" every other chunk
    without a sorting line."""
    T = np.zeros((n_ch, H), np.int64)
    if kind == "zeros":
        return T
    for k in range(bits):
        p = rng.choice([0.001, 0.05, 0.5, 0.97], (n_ch, 1))
        T |= (rng.random((n_ch, H)) < p).astype(np.int64) << k
    if kind == "sparse":
        T[::2] = 0
    return T


@pytest.mark.parametrize("n_ch,H,bits,kind", [
    (301, 5008, 16, "random"),   # 1KGP3: 301 chunks of 16 lines
    (325, 64976, 16, "random"),  # HRC width: rows through device memory
    (255, 2466, 18, "random"),   # the chrX PAR block's parity scan
    (7, 1, 30, "random"), (7, 2, 30, "random"), (5, 3, 29, "random"),
    (9, 4096, 16, "random"),
    (40, 16384, 16, "random"),   # the shared-memory route's widest row
    (40, 16385, 16, "random"),   # the device route's narrowest
    (12, 41001, 16, "random"),   # a short last tile
    (3, 65535, 15, "random"),    # the 16-bit dense ranks' limit
    (9, 65536, 16, "random"),    # 32-bit ranks, u64 keys
    (395, 194512, 13, "random"),  # TOPMed: C = 13 totals
    (12, 5008, 16, "zeros"), (12, 5008, 16, "sparse"),
    (12, 64976, 16, "sparse"), (0, 301, 16, "random"),
    (0, 65536, 16, "random"), (1, 65536, 16, "random"),
    (12, 24577, 16, "sparse"),
])
def test_rank_chain_kernel_matches_plain(dev, n_ch, H, bits, kind):
    rng = np.random.default_rng(H + bits)
    T = torch.from_numpy(_totals(rng, n_ch, H, bits, kind))
    r0 = torch.from_numpy(rng.permutation(H))     # any starting ranks
    want = pbwt_kernels.rank_chain_plain(T.to(dev), r0.to(dev),
                                         max(16, (H - 1).bit_length()))
    n0 = pbwt_kernels.launches["rank_chain"]
    for t in (T, T.to(torch.int32)):
        got = pbwt_kernels.rank_chain(t.to(dev), r0.to(dev))
        assert all(_equal(g, w) for g, w in zip(got, want))
    assert pbwt_kernels.launches["rank_chain"] == n0 + 2
    lv = pbwt_kernels.rank_chain_levels_plain(T.to(dev), r0.to(dev))
    assert all(_equal(g, w) for g, w in zip(lv, want))


def test_rank_chain_kernel_refuses(dev):
    T = torch.zeros((2, pbwt_kernels.MAX_RANK_H + 1), dtype=torch.int32,
                    device=dev)
    with pytest.raises(ValueError, match="1 <= H <= 491505"):
        pbwt_kernels.rank_chain(T, torch.arange(T.shape[1], device=dev))
    with pytest.raises(ValueError, match="int64"):
        pbwt_kernels.rank_chain(T[:, :5].to(torch.int16),
                                torch.arange(5, device=dev))


def _mixed_lines(rng, L, H, hap_kind):
    """Stored lines of a mixed scan: haploid lines hold H/2 front-packed
    bits (zero past them), diploid ones H; hap_kind "alternating" (runs of
    8), "par" (diploid lines, then haploid ones), "haploid", "diploid"."""
    if hap_kind == "alternating":
        hap = np.repeat(rng.random(-(-L // 8)) < 0.5, 8)[:L]
    elif hap_kind == "par":
        hap = np.arange(L) >= L // 2
    else:
        hap = np.full(L, hap_kind == "haploid")
    p = rng.choice([0.001, 0.05, 0.5, 0.97], (L, 1))
    ys = (rng.random((L, H)) < p).astype(np.uint8)
    ys[hap, (H + 1) // 2:] = 0
    sorts = rng.random(L) < 0.9
    return (torch.from_numpy(ys), torch.from_numpy(sorts),
            torch.from_numpy(hap))


@pytest.mark.parametrize("L,H,hap_kind", [
    (600, 2466, "alternating"),     # chrX PAR width (4573 lines on the card
    (64, 64976, "alternating"),     # in chip_smoke.py); HRC width: the
    (300, 2466, "haploid"),         # device-memory route
    (300, 2466, "diploid"),
    (40, 2, "alternating"), (40, 3, "alternating"), (9, 1, "diploid"),
    (30, 17801, "alternating"), (30, 17802, "alternating"),
    (0, 100, "alternating"),
])
def test_decode_scan_mixed_kernel_matches_plain(dev, L, H, hap_kind):
    rng = np.random.default_rng(L + H)
    ys, sorts, hap = _mixed_lines(rng, L, H, hap_kind)
    want = pbwt_kernels.decode_scan_mixed_plain(ys, sorts, hap)
    n0 = pbwt_kernels.launches["decode_scan_mixed"]
    got = pbwt_kernels.decode_scan_mixed(ys.to(dev), sorts.to(dev),
                                         hap.to(dev))
    assert all(_equal(g, w) for g, w in zip(got, want))
    assert pbwt_kernels.launches["decode_scan_mixed"] == n0 + 1
    # no sorting line: the arrangement stays the identity
    flat = torch.zeros_like(sorts)
    got = pbwt_kernels.decode_scan_mixed(ys.to(dev), flat.to(dev),
                                         hap.to(dev))
    want = pbwt_kernels.decode_scan_mixed_plain(ys, flat, hap)
    assert all(_equal(g, w) for g, w in zip(got, want))
    # from an arrangement other than the identity (a piece of the run
    # route starts where the previous one ended)
    a0 = torch.from_numpy(rng.permutation(H))
    got = pbwt_kernels.decode_scan_mixed(ys.to(dev), sorts.to(dev),
                                         hap.to(dev), a0=a0.to(dev))
    want = pbwt_kernels.decode_scan_mixed_plain(ys, sorts, hap, a0=a0)
    assert all(_equal(g, w) for g, w in zip(got, want))


#: The stepping kernel's shapes above, the chrX PAR layout (diploid lines
#: then haploid ones) at its width, a narrow and an odd width, and the
#: stepping kernel's device-memory widths.
MIXED_ROUTE_CASES = [
    (600, 2466, "alternating"), (64, 64976, "alternating"),
    (300, 2466, "haploid"), (300, 2466, "diploid"),
    (40, 2, "alternating"), (40, 3, "alternating"), (9, 1, "diploid"),
    (30, 17801, "alternating"), (30, 17802, "alternating"),
    (0, 100, "alternating"),
    (4573, 2466, "par"), (1200, 301, "par"), (1200, 3, "par"),
    (80, 17802, "par"), (64, 64976, "par"),
    (48, 65600, "par"), (40, 70001, "alternating"),
]


@pytest.mark.parametrize("min_run", [None, 1])
@pytest.mark.parametrize("L,H,hap_kind", MIXED_ROUTE_CASES)
def test_mixed_run_route_matches_plain(dev, L, H, hap_kind, min_run,
                                       monkeypatch):
    """The run route on the card against the stepping kernel's plain
    version, vals and a_final, from the identity and from a permutation:
    with the default threshold and with every run on the chains.  Each
    piece launches its kernels: a run chain_decode and the run flush, a
    stepping piece the stepping kernel once."""
    if min_run is not None:
        monkeypatch.setattr(pbwt_torch, "MIN_RUN_LINES", min_run)
        monkeypatch.setattr(pbwt_torch, "MIN_RUN_LINES_WIDE", min_run)
    rng = np.random.default_rng(L + H + 1)
    ys, sorts, hap = _mixed_lines(rng, L, H, hap_kind)
    pieces = [r for *_, r in pbwt_torch.mixed_runs(hap.numpy(), H)]
    for a0 in (None, torch.from_numpy(rng.permutation(H))):
        want = pbwt_kernels.decode_scan_mixed_plain(ys, sorts, hap, a0=a0)
        n0 = dict(pbwt_kernels.launches)
        got = pbwt_torch.pbwt_decode_scan_mixed(
            ys.to(dev), sorts.to(dev), hap.to(dev), hap.numpy(),
            None if a0 is None else a0.to(dev))
        torch.cuda.synchronize()
        assert all(_equal(g, w) for g, w in zip(got, want))
        ran = {k: v - n0[k] for k, v in pbwt_kernels.launches.items()}
        n_runs = sum(r != "step" for r in pieces)
        assert ran["decode_scan_mixed"] == len(pieces) - n_runs
        assert (ran["decode_run_flush"] + ran["decode_run_flush_cluster"]
                == n_runs)
        assert ran["chain_decode"] + ran["chain_decode_rows"] == n_runs
        assert ran["rank_chain"] == pieces.count("haploid")


@pytest.mark.parametrize("H,n,haploid", [
    (1, 1, False), (1, 5, True), (2, 17, True), (3, 33, True),
    (5, 70, False), (2466, 4096, False), (2466, 477, True),
    (17801, 40, True), (64976, 40, False), (64976, 33, True),
    (65535, 16, False), (131070, 20, True)])
def test_run_flush_kernel_matches_plain(dev, H, n, haploid):
    """decode_run_flush (the composition's levels, then the flush) against
    its plain version: rows, T and the end map, the rows written into a
    given output; 1 to 256 chunks, up to the widest slot row (65,535 slots
    of 2 bytes in one CTA's shared memory)."""
    rng = np.random.default_rng(H + n)
    W = (H + 1) // 2 if haploid else H
    n_ch = -(-n // 16)
    slots = np.stack([rng.permutation(W) for _ in range(n_ch)])
    p_fin = torch.from_numpy(((slots << 16)
                              | rng.integers(0, 1 << 16, (n_ch, W)))
                             .astype(np.uint32).view(np.int32))
    start = torch.from_numpy(rng.permutation(W))
    ss = torch.from_numpy(rng.random((n_ch, 16)) < 0.7)
    want = pbwt_kernels.decode_run_flush_plain(p_fin, start, ss, H, n,
                                               haploid, want_T=True)
    n0 = pbwt_kernels.launches["decode_run_flush"]
    out = torch.empty((n, H), dtype=torch.uint8, device=dev)
    got = pbwt_kernels.decode_run_flush(p_fin.to(dev), start.to(dev),
                                        ss.to(dev), H, n, haploid,
                                        want_T=True, out=out)
    torch.cuda.synchronize()
    assert got[0] is out
    assert all(_equal(g, w) for g, w in zip(got, want))
    assert pbwt_kernels.launches["decode_run_flush"] == n0 + 1


@pytest.mark.parametrize("H,n,haploid,shift", [
    (65536, 33, False, 16), (65537, 30, False, 15), (131070, 20, False, 15),
    (131072, 31, True, 16), (131074, 31, True, 15), (70001, 17, False, 15),
    (194512, 45, False, 14), (194512, 29, True, 15), (428032, 13, False, 13),
    (491505, 26, True, 14), (1001, 40, True, 13)])
def test_wide_run_flush_matches_plain(dev, H, n, haploid, shift,
                                      monkeypatch):
    """The run flush on a cluster of 8 CTAs a chunk above 65,535 slots
    (decode_run_flush_cluster), the states (slot << shift) | beta in
    chunks of `shift` lines, against its plain version: rows, T and the
    end map; and at a narrow width with a narrow shift forced (one CTA)."""
    rng = np.random.default_rng(H + n)
    W = (H + 1) // 2 if haploid else H
    if shift != pbwt_kernels.decode_chunk(W):
        monkeypatch.setattr(pbwt_kernels, "decode_chunk", lambda W: shift)
    n_ch = -(-n // shift)
    slots = np.stack([rng.permutation(W) for _ in range(n_ch)])
    p_fin = torch.from_numpy(((slots.astype(np.int64) << shift)
                              | rng.integers(0, 1 << shift, (n_ch, W)))
                             .astype(np.uint32).view(np.int32))
    start = torch.from_numpy(rng.permutation(W))
    ss = torch.from_numpy(rng.random((n_ch, shift)) < 0.7)
    want = pbwt_kernels.decode_run_flush_plain(p_fin, start, ss, H, n,
                                               haploid, want_T=True)
    route = "decode_run_flush" + ("_cluster" if W > 65535 else "")
    n0 = pbwt_kernels.launches[route]
    got = pbwt_kernels.decode_run_flush(p_fin.to(dev), start.to(dev),
                                        ss.to(dev), H, n, haploid,
                                        want_T=True)
    torch.cuda.synchronize()
    assert all(_equal(g, w) for g, w in zip(got, want))
    assert pbwt_kernels.launches[route] == n0 + 1


@pytest.mark.parametrize("L,H", [(1, 1), (7, 15), (40, 301), (64, 5008),
                                 (6, 64976), (3, 16383 * 15 + 60)])
def test_wah_kernels_match_plain(dev, L, H):
    rng = np.random.default_rng(L + H)
    p = rng.choice([0.0, 0.001, 0.3, 0.999, 1.0], (L, 1))
    bits = torch.from_numpy((rng.random((L, H)) < p).astype(np.uint8))
    words = wah_torch.pack_bits(bits)
    got = wah_kernels.wah_compress(words.to(dev))
    want = wah_kernels.wah_compress_plain(words)
    assert _equal(got, want)
    keep = torch.arange(words.shape[1])[None, :] < want[1][:, None]
    stream = torch.cat([want[0][keep], torch.zeros(5, dtype=torch.uint16)])
    W = words.shape[1]
    for n_lines in (L, L + 2):
        out = wah_kernels.wah_expand(stream.to(dev), n_lines, W)
        assert _equal(out, wah_kernels.wah_expand_plain(stream, n_lines, W))
        assert _equal(out[:L], words)


@pytest.mark.parametrize("N,L", [(1, 3), (40, 64), (1233, 600)])
def test_wah_expand_varw_matches_plain(dev, N, L):
    rng = np.random.default_rng(N + L)
    hap = np.repeat(rng.random(-(-L // 8)) < 0.5, 8)[:L]   # runs of lines
    p = rng.choice([0.0, 0.001, 0.3, 0.999, 1.0], L)
    widths = np.where(hap, N, 2 * N)
    streams, gw = [], []
    for w, q in zip(widths, p):
        words = wah_torch.pack_bits(torch.from_numpy(
            (rng.random((1, w)) < q).astype(np.uint8)))
        out, n = wah_kernels.wah_compress_plain(words)
        streams.append(out[0, :int(n[0])])
        gw.append(words.shape[1])
    stream = torch.cat(streams + [torch.zeros(3, dtype=torch.uint16)])
    group_off = torch.from_numpy(np.concatenate([[0], np.cumsum(gw)]))
    w_max = wah_torch.n_words_for(2 * N)
    n0 = wah_kernels.launches["wah_expand_varw"]
    got = wah_kernels.wah_expand_varw(stream.to(dev), group_off.to(dev),
                                      w_max)
    assert wah_kernels.launches["wah_expand_varw"] == n0 + 1
    assert _equal(got, wah_kernels.wah_expand_varw_plain(stream, group_off,
                                                         w_max))


def _stream_of(words_out, n, tail=5):
    """The concatenated stream of front-packed rows, plus a zero tail."""
    keep = torch.arange(words_out.shape[1])[None, :] < n[:, None]
    return torch.cat([words_out[keep], torch.zeros(tail, dtype=torch.uint16)])


def _check_routes(dev, bits, h, line_threads=(None, 32, 256)):
    """Every uniform route on `bits` (uint8[L, h], any strides) against
    its plain version, and the round trip back to the bits."""
    L = bits.shape[0]
    words = wah_torch.pack_bits(bits)
    W = words.shape[1]
    want = wah_torch.wah_encode_lines(bits)
    assert _equal(wah_kernels.wah_compress_bits(bits.to(dev)), want)
    assert _equal(wah_kernels.wah_compress(words.to(dev)), want)
    stream = _stream_of(*want)
    for n_lines in (L, L + 2):
        for lt in line_threads:
            got = wah_kernels.wah_expand_bits(stream.to(dev), n_lines, W, h,
                                              line_threads=lt)
            assert _equal(got, wah_torch.wah_expand_stream_bits(
                stream, n_lines, W, h))
            assert _equal(got[:L], bits)
            got = wah_kernels.wah_expand(stream.to(dev), n_lines, W,
                                         line_threads=lt)
            assert _equal(got, wah_torch.wah_expand_stream(stream, n_lines, W))


@pytest.mark.parametrize("L,H", [(1, 1), (7, 15), (40, 301), (64, 5008),
                                 (16, 64976), (200, 2466), (600, 5008)])
def test_wah_bits_routes_match_plain(dev, L, H):
    rng = np.random.default_rng(10 * L + H)
    p = rng.choice([0.0, 0.001, 0.3, 0.999, 1.0], (L, 1))
    bits = torch.from_numpy((rng.random((L, H)) < p).astype(np.uint8))
    n0 = dict(wah_kernels.launches)
    _check_routes(dev, bits, H)
    n1 = wah_kernels.launches
    assert n1["wah_compress_bits"] == n0["wah_compress_bits"] + 1
    assert n1["wah_expand_bits"] == n0["wah_expand_bits"] + 6


@pytest.mark.parametrize("L,H", [(4, 194512), (5, 491505)])
def test_wah_routes_at_the_widest_lines(dev, L, H):
    """TOPMed width (w = 12,968) and the format's widest line (w = 32,767),
    where only a CTA per line fits: the expand's shared memory holds
    16-bit starts."""
    rng = np.random.default_rng(L + H)
    p = np.array([0.0, 0.0005, 0.3, 1.0, 0.999])[:L, None]
    bits = torch.from_numpy((rng.random((L, H)) < p).astype(np.uint8))
    n0 = dict(wah_kernels.launches)
    _check_routes(dev, bits, H, line_threads=(None, 256))
    n1 = wah_kernels.launches
    assert n1["wah_compress_bits"] == n0["wah_compress_bits"] + 1
    assert n1["wah_expand_bits"] == n0["wah_expand_bits"] + 4
    with pytest.raises(ValueError, match="shared memory"):
        wah_kernels.wah_expand_bits(torch.zeros(1, dtype=torch.uint16,
                                                device=dev),
                                    1, wah_torch.n_words_for(H), H,
                                    line_threads=32)


@pytest.mark.parametrize("kind", ["one_counter", "all_literal",
                                  "alternating", "ones_then_literal"])
def test_wah_routes_at_edge_rows(dev, kind):
    """HRC-width rows of one counter (4332 groups), all literals, and
    alternating 0 / 0x7FFF words."""
    rng = np.random.default_rng(7)
    w, L = 4332, 4
    words = np.zeros((L, w), np.int32)
    if kind == "one_counter":
        words[1::2] = 0x7FFF
    elif kind == "all_literal":
        words[:] = rng.integers(1, 0x7FFF, (L, w))
    elif kind == "alternating":
        words[:, 1::2] = 0x7FFF
    else:
        words[:, : w // 2] = 0x7FFF
        words[:, w // 2:] = rng.integers(1, 0x7FFF, (L, w - w // 2))
    bits = wah_torch.unpack_bits(torch.from_numpy(words), 15 * w)
    _check_routes(dev, bits, 15 * w)


def test_wah_compress_splits_counters_at_maxc(dev):
    w = 20000
    words = torch.zeros((4, w), dtype=torch.int32)
    words[1] = 0x7FFF
    words[2, 16383:] = 0x7FFF        # a run ending exactly at MAXC
    words[3, ::5000] = 5             # literals between long runs
    got = wah_kernels.wah_compress(words.to(dev))
    want = wah_kernels.wah_compress_plain(words)
    assert _equal(got, want)
    assert want[1][:2].tolist() == [2, 2]


def test_wah_routes_on_empty_and_one_word_inputs(dev):
    empty = torch.zeros((0, 301), dtype=torch.uint8, device=dev)
    w, n = wah_kernels.wah_compress_bits(empty)
    assert w.shape == (0, 21) and n.shape == (0,)
    one = torch.tensor([0x8000 | 21], dtype=torch.int32).to(torch.uint16)
    for n_lines in (0, 1, 3):
        got = wah_kernels.wah_expand_bits(one.to(dev), n_lines, 21, 301)
        assert _equal(got, wah_torch.wah_expand_stream_bits(one, n_lines, 21,
                                                            301))
        got = wah_kernels.wah_expand(one.to(dev), n_lines, 21)
        assert _equal(got, wah_torch.wah_expand_stream(one, n_lines, 21))


def test_wah_compress_bits_takes_strided_rows(dev):
    rng = np.random.default_rng(8)
    big = torch.from_numpy((rng.random((33, 5100)) < 0.2).astype(np.uint8))
    n0 = wah_kernels.launches["wah_compress_bits"]
    for a, b in ((3, 3 + 5008), (0, 2466), (17, 5100)):
        view = big.to(dev)[:, a:b]
        assert not view.is_contiguous()
        assert _equal(wah_kernels.wah_compress_bits(view),
                      wah_torch.wah_encode_lines(big[:, a:b]))
        flags = big.to(dev)[:, a:b] != 0     # bool rows
        assert _equal(wah_kernels.wah_compress_bits(flags),
                      wah_torch.wah_encode_lines(big[:, a:b]))
    assert wah_kernels.launches["wah_compress_bits"] == n0 + 6


@pytest.mark.parametrize("N,L", [(1, 3), (40, 64), (1233, 600)])
def test_wah_expand_varw_bits_matches_plain(dev, N, L):
    rng = np.random.default_rng(N + 3 * L)
    hap = np.repeat(rng.random(-(-L // 8)) < 0.5, 8)[:L]
    p = rng.choice([0.0, 0.001, 0.3, 0.999, 1.0], L)
    streams, gw = [], []
    for w, q in zip(np.where(hap, N, 2 * N), p):
        out, n = wah_torch.wah_encode_lines(torch.from_numpy(
            (rng.random((1, w)) < q).astype(np.uint8)))
        streams.append(out[0, :int(n[0])])
        gw.append(out.shape[1])
    stream = torch.cat(streams + [torch.zeros(3, dtype=torch.uint16)])
    group_off = torch.from_numpy(np.concatenate([[0], np.cumsum(gw)]))
    w_max = wah_torch.n_words_for(2 * N)
    want = wah_torch.wah_expand_stream_varw_bits(stream, group_off, w_max,
                                                 2 * N)
    for lt in (None, 32, 256):
        got = wah_kernels.wah_expand_varw_bits(
            stream.to(dev), group_off.to(dev), w_max, 2 * N, line_threads=lt)
        assert _equal(got, want)
        got = wah_kernels.wah_expand_varw(stream.to(dev), group_off.to(dev),
                                          w_max, line_threads=lt)
        assert _equal(got, wah_kernels.wah_expand_varw_plain(
            stream, group_off, w_max))


def _block_counts(enc, payload_of, decode):
    """Launch counts of one encode + decode, reset just before."""
    for c in (pbwt_kernels.launches, wah_kernels.launches):
        for k in c:
            c[k] = 0
    payload = payload_of(enc)
    out = decode(payload)
    torch.cuda.synchronize()
    counts = {**pbwt_kernels.launches, **wah_kernels.launches}
    return payload, out, {k: v for k, v in counts.items() if v}


def test_track_block_roundtrip_on_card(dev):
    rng = np.random.default_rng(4)
    n_samples, L = 300, 256
    p = rng.choice([0.003, 0.2, 0.6], (L, 1))
    alleles = (rng.random((L, 2 * n_samples)) < p).astype(np.int32)
    gt = ((alleles + 1) << 1) | (np.arange(2 * n_samples) & 1)
    gt[rng.random(gt.shape) < 0.01] &= 1                      # missing
    gt[:, 1:40:2] = INT32_VECTOR_END                           # EOV
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=2,
              default_phasing=1, aet_dtype=np.uint16)
    ref = GtBlockEncoder(**kw)
    enc = encoder_torch.TorchBlockEncoder(device=dev, **kw)
    for row in gt:
        ref.encode_record(row, 2)
        enc.encode_record(row, 2)
    payload, out, counts = _block_counts(
        enc, lambda e: e.serialize(),
        lambda pl: decoder_torch.decode_block_records(
            pl, n_samples, 2 * n_samples, np.uint16, [2] * L, device=dev))
    assert payload == ref.serialize()
    np.testing.assert_array_equal(np.stack(out), gt)
    assert set(counts) == {"chain_encode", "chain_decode", "wah_expand_bits",
                           "wah_compress_bits", "rank_chain",
                           "decode_run_flush"}
    dec = decoder_torch.TorchBlockDecoder(payload, n_samples, 2 * n_samples,
                                          np.uint16, device=dev)
    *args, H, W, _ = dec.device_inputs()
    m = dec.meta
    pairs = [torch.from_numpy(x).to(dev) for s, f in (
        (m.missing_sparse, m.line_has_missing), (m.eov_sparse, m.line_has_eov))
        for x in decoder_torch.track_carriers(s, np.flatnonzero(f),
                                              np.uint16, dec.line_width)]
    fused = decoder_torch._decode_block_full_gt_tracks(*args, 1, *pairs, H, W)
    np.testing.assert_array_equal(fused.cpu().numpy(), gt)


@pytest.mark.parametrize("min_run", [None, 16])
def test_mixed_block_roundtrip_on_card(dev, min_run, monkeypatch):
    if min_run is not None:     # the runs of this block on the chains
        monkeypatch.setattr(pbwt_torch, "MIN_RUN_LINES", min_run)
    rng = np.random.default_rng(5)
    n_samples, L = 200, 300
    recs = []
    for i in range(L):
        hap = (i // 50) % 2 == 1
        n = n_samples if hap else 2 * n_samples
        a = (rng.random(n) < rng.choice([0.002, 0.1, 0.5, 0.995])) \
            .astype(np.int32)
        recs.append(((a + 1) << 1).astype(np.int32))
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=2,
              default_phasing=0, aet_dtype=np.uint16)
    ref = GtBlockEncoder(**kw)
    enc = encoder_torch.TorchBlockEncoder(device=dev, **kw)
    for row in recs:
        ref.encode_record(row, 2)
        enc.encode_record(row, 2)
    payload, out, counts = _block_counts(
        enc, lambda e: e.serialize(),
        lambda pl: decoder_torch.decode_block_records(
            pl, n_samples, 2 * n_samples, np.uint16, [2] * L, device=dev))
    assert payload == ref.serialize()
    assert all(np.array_equal(o, r) for o, r in zip(out, recs))
    # the decode's pieces: a stepping launch each, or chain_decode and the
    # run flush (a haploid run not the last also a rank chain); the
    # encode one rank chain and the chain with the parity payload
    dec = decoder_torch.TorchBlockDecoder(payload, n_samples, 2 * n_samples,
                                          np.uint16, device=dev)
    runs = [r for *_, r in pbwt_torch.mixed_runs(dec.host_inputs_mixed()[3],
                                                 2 * n_samples)]
    n_step = runs.count("step")
    n_runs = len(runs) - n_step
    assert (n_runs > 0) == (min_run is not None)
    want = {"rank_chain": 1 + runs[:-1].count("haploid"),
            "chain_encode_parity": 1,
            "decode_scan_mixed": n_step, "chain_decode": n_runs,
            "decode_run_flush": n_runs}
    assert set(counts) == {"wah_compress_bits", "wah_expand_varw_bits",
                           *(k for k, v in want.items() if v)}
    assert all(counts.get(k, 0) == v for k, v in want.items())


def test_wide_mixed_block_roundtrip_on_card(dev):
    """48,628 males (H = 97,256), diploid records then haploid ones: the
    encode chain with the parity payload on 8 CTAs, the packed-key scan
    made to raise; payload equal to the host encoder's, every record
    decoded."""
    rng = np.random.default_rng(10)
    n_samples, L = 48628, 32
    recs = []
    for i in range(L):
        n = n_samples if i >= L // 2 else 2 * n_samples
        a = (rng.random(n) < [0.0005, 0.2, 0.6, 0.03][i % 4]) \
            .astype(np.int32)
        recs.append(((a + 1) << 1).astype(np.int32))
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=97,
              default_phasing=0, aet_dtype=np.uint32)
    ref = GtBlockEncoder(**kw)
    enc = encoder_torch.TorchBlockEncoder(device=dev, **kw)
    for row in recs:
        ref.encode_record(row, 2)
        enc.encode_record(row, 2)

    def refuse(*a, **k):
        raise AssertionError("the packed-key scan ran on the card path")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pbwt_torch, "pbwt_encode_scan_parity", refuse)
        payload, out, counts = _block_counts(
            enc, lambda e: e.serialize(),
            lambda pl: decoder_torch.decode_block_records(
                pl, n_samples, 2 * n_samples, np.uint32, [2] * L,
                device=dev))
    assert payload == ref.serialize()
    assert all(np.array_equal(o, r) for o, r in zip(out, recs))
    assert counts["chain_encode_parity_cluster"] == 1
    assert not {"chain_encode", "chain_encode_cluster",
                "chain_encode_parity"} & set(counts)


@pytest.mark.parametrize("n_samples,L,mac,route", [
    (300, 700, 3, ""),
    (2504, 64, 10, ""),            # 1KGP3 width: the one-CTA chains
    (32488, 64, 64, "_cluster"),   # HRC width: the chains' cluster routes
])
def test_block_roundtrip_on_card(dev, n_samples, L, mac, route):
    """A uniform block through the codec on the card; `route` "" for the
    one-CTA chains, "_cluster" for the cluster routes (the encode's in
    shared memory, the decode's with its rows in device memory)."""
    rng = np.random.default_rng(3)
    p = rng.choice([0.0005, 0.005, 0.2, 0.6, 0.9995], (L, 1))
    alleles = (rng.random((L, 2 * n_samples)) < p).astype(np.int32)
    gt = ((alleles + 1) << 1) | (np.arange(2 * n_samples) & 1)
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=mac,
              default_phasing=1, aet_dtype=np.uint16)
    ref = GtBlockEncoder(**kw)
    enc = encoder_torch.TorchBlockEncoder(device=dev, **kw)
    for row in gt:
        ref.encode_record(row, 2)
        enc.encode_record(row, 2)
    n0 = dict(pbwt_kernels.launches)
    payload = enc.serialize()
    assert payload == ref.serialize()
    out = decoder_torch.decode_block_records(
        payload, n_samples, 2 * n_samples, np.uint16, [2] * L, device=dev)
    np.testing.assert_array_equal(np.stack(out), gt)
    K = 1 if route == "" else 2
    for k in ("chain_encode", "chain_decode"):
        key = pbwt_kernels.chain_route(k, K)
        assert pbwt_kernels.launches[key] == n0[key] + 1
    for k in ("rank_chain", "decode_run_flush"):
        assert pbwt_kernels.launches[k] == n0[k] + 1


@pytest.mark.parametrize("missing", [False, True])
def test_wide_block_roundtrip_on_card(dev, missing):
    """32,800 samples (H = 65,600), above the narrow decode state's 16-bit
    slot field: the chains on their cluster routes (the decode's state
    (slot << 15) | beta), the run flush on a cluster a chunk, the WAH
    kernels and the rank chain (its device route, 32-bit ranks), 32-bit
    sparse and track streams; the packed-key scan and the blocked decode
    do not run."""
    rng = np.random.default_rng(6 + missing)
    n_samples, L = 32800, 48
    p = rng.choice([0.0005, 0.005, 0.2, 0.6, 0.9995], (L, 1))
    alleles = (rng.random((L, 2 * n_samples)) < p).astype(np.int32)
    gt = ((alleles + 1) << 1) | (np.arange(2 * n_samples) & 1)
    if missing:
        gt[rng.random(gt.shape) < 0.01] &= 1
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=65,
              default_phasing=1, aet_dtype=np.uint32)
    ref = GtBlockEncoder(**kw)
    enc = encoder_torch.TorchBlockEncoder(device=dev, **kw)
    for row in gt:
        ref.encode_record(row, 2)
        enc.encode_record(row, 2)
    def refuse(*a, **k):
        raise AssertionError("a plain wide form ran on the card path")
    with pytest.MonkeyPatch.context() as mp:
        for name in ("pbwt_encode_scan", "pbwt_decode_blocked"):
            mp.setattr(pbwt_torch, name, refuse)
        payload, out, counts = _block_counts(
            enc, lambda e: e.serialize(),
            lambda pl: decoder_torch.decode_block_records(
                pl, n_samples, 2 * n_samples, np.uint32, [2] * L,
                device=dev))
    assert payload == ref.serialize()
    np.testing.assert_array_equal(np.stack(out), gt)
    host = GtBlockDecoder(payload, n_samples, 2 * n_samples, np.uint32)
    for i in (0, 1, L - 1):
        host.seek(i)
        np.testing.assert_array_equal(host.fill_genotype_array_advance(2),
                                      gt[i])
    assert counts == {"wah_compress_bits": 1, "wah_expand_bits": 1,
                      "rank_chain": 1, "chain_encode_cluster": 1,
                      "chain_decode_rows": 1,
                      "decode_run_flush_cluster": 1}


def test_widest_block_roundtrip_on_card(dev):
    """245,752 samples (H = 491,504), above 428,032: the encode chain on 16
    CTAs, the decode chain with its rows in device memory (the state
    (slot << 13) | beta), the run flush on a cluster a chunk; payload
    equal to the host encoder's, every record decoded."""
    rng = np.random.default_rng(9)
    n_samples, L = 245752, 24
    p = rng.choice([0.0005, 0.2, 0.6, 0.9995], (L, 1))
    alleles = (rng.random((L, 2 * n_samples)) < p).astype(np.int32)
    gt = ((alleles + 1) << 1) | (np.arange(2 * n_samples) & 1)
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=491,
              default_phasing=1, aet_dtype=np.uint32)
    ref = GtBlockEncoder(**kw)
    enc = encoder_torch.TorchBlockEncoder(device=dev, **kw)
    for row in gt:
        ref.encode_record(row, 2)
        enc.encode_record(row, 2)
    payload, out, counts = _block_counts(
        enc, lambda e: e.serialize(),
        lambda pl: decoder_torch.decode_block_records(
            pl, n_samples, 2 * n_samples, np.uint32, [2] * L, device=dev))
    assert payload == ref.serialize()
    np.testing.assert_array_equal(np.stack(out), gt)
    assert counts == {"wah_compress_bits": 1, "wah_expand_bits": 1,
                      "rank_chain": 1, "chain_encode_cluster": 1,
                      "chain_decode_rows": 1,
                      "decode_run_flush_cluster": 1}


def _cli_compress(vcf, xsi, device, block):
    from xsqueezeit_tpu_torch.cli import main
    assert main(["-c", "-f", vcf, "-o", xsi, "--device", device,
                 "--variant-block-length", str(block)]) == 0


#: name -> (writer(path), block length, (device, mixed) blocks on the card)
DOT_PROD_FILES = {
    "random": (lambda p: _fixtures().random_vcf(p, n_samples=300,
                                                n_records=700, seed=4), 256,
               (3, 0)),
    "haploid": (lambda p: _fixtures().micro_haploid(p), 3, (1, 0)),
    "mixed_ploidy": (lambda p: _fixtures().micro_mixed_ploidy(p), 2,
                     (0, 2)),
    "missing_non_uniform_phasing_ploidy": (
        lambda p: _fixtures().micro_missing_non_uniform_phasing_ploidy(p), 2,
        (1, 1)),
}


def _fixtures():
    """tests/fixtures.py, loaded by its path: on a machine where another
    package named `tests` is importable, `from tests import fixtures` can
    find that one."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "xsi_test_fixtures",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(DOT_PROD_FILES))
def test_dot_prod_on_card(dev, tmp_path, name):
    """dot_prod on the card (its default device) of a file the card
    compressed: every variant's dot within relative 1e-6 of the host
    walk's, which equals the plain VCF walk's to 1e-12; wah_expand_bits,
    chain_decode and the run flush launch once per device block
    (uniformly diploid or haploid), wah_expand_varw_bits and decode_scan_mixed once per mixed
    block, and no encode route launches."""
    from xsqueezeit_tpu_torch.bench import tools
    write, block, (n_dev, n_mixed) = DOT_PROD_FILES[name]
    vcf = write(str(tmp_path / "in.vcf"))
    xsi = str(tmp_path / "o.xsi")
    _cli_compress(vcf, xsi, "cuda", block)
    host = tools.dot_prod(xsi, device="host")
    plain = tools.dot_prod(vcf, device="host")
    assert host["variants"] == plain["variants"] > 0
    np.testing.assert_allclose(host["dots"], plain["dots"], rtol=1e-12,
                               atol=0)
    n0 = {**pbwt_kernels.launches, **wah_kernels.launches}
    got = tools.dot_prod(xsi)
    n1 = {**pbwt_kernels.launches, **wah_kernels.launches}
    ran = {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}
    assert got["variants"] == host["variants"] and got["device"] == "cuda"
    np.testing.assert_allclose(got["dots"], host["dots"], rtol=1e-6, atol=0)
    assert (got["device_blocks"], got["mixed_blocks"],
            got["host_blocks"]) == (n_dev, n_mixed, 0)
    want = {}
    if n_dev:
        want.update(wah_expand_bits=n_dev, chain_decode=n_dev,
                    decode_run_flush=n_dev)
    if n_mixed:
        want.update(wah_expand_varw_bits=n_mixed, decode_scan_mixed=n_mixed)
    assert ran == want


def test_accessor_on_a_card_compressed_file(dev, tmp_path):
    """The Accessor reads a file the card wrote (byte-equal to the host
    codec's): genotypes in random order across blocks, allele counts."""
    from xsqueezeit_tpu_torch.accessor import Accessor
    from xsqueezeit_tpu_torch.io.bcf import BcfReader
    from xsqueezeit_tpu_torch.io.unified import GtInput
    fixtures = _fixtures()
    vcf = fixtures.random_vcf(str(tmp_path / "in.vcf"), n_samples=300,
                              n_records=400, seed=9, p_multi=0.15)
    for device in ("cuda", "numpy"):
        os.makedirs(tmp_path / device)
        _cli_compress(vcf, str(tmp_path / device / "o.xsi"), device, 128)
    xsi = str(tmp_path / "cuda" / "o.xsi")
    with open(xsi, "rb") as a, open(tmp_path / "numpy" / "o.xsi", "rb") as b:
        assert a.read() == b.read()
    inp = GtInput(vcf)
    orig = [r.gt for r in inp]
    inp.close()
    reader = BcfReader(xsi + "_var.bcf")
    recs = list(reader)
    reader.close()
    acc = Accessor(xsi)
    for i in [5, 260, 3, 399, 255, 0, 380, 127, 128]:
        np.testing.assert_array_equal(acc.get_genotypes(recs[i]), orig[i])
        alleles = (orig[i] >> 1) - 1
        np.testing.assert_array_equal(
            acc.get_allele_counts(recs[i]),
            np.bincount(alleles[alleles >= 0], minlength=recs[i].n_allele))


@pytest.mark.parametrize("devices", [("cuda:0", "cpu"), ("cpu", "cuda:0"),
                                     ("cuda:0", "cuda:1")])
def test_pool_of_two_devices_on_card(dev, tmp_path, devices):
    """compress_file and the extract over a pool of two different devices
    (the card and the host, or two cards; blocks alternating): .xsi
    byte-equal to the host codec's, records equal to its extract, the
    cards' encode and decode routes launched."""
    if torch.cuda.device_count() < 2 and "cuda:1" in devices:
        pytest.skip("needs two CUDA devices")
    from xsqueezeit_tpu_torch.codec.compressor import (
        CompressorOptions,
        compress_file,
    )
    from xsqueezeit_tpu_torch.codec.decompressor import (
        Decompressor,
        DecompressorOptions,
    )
    from xsqueezeit_tpu_torch.io.unified import GtInput

    def records(path):
        inp = GtInput(path)
        out = [(r.n_alleles, r.gt.tolist()) for r in inp]
        inp.close()
        return out

    vcf = _fixtures().random_vcf(str(tmp_path / "in.vcf"), n_samples=300,
                                 n_records=700, seed=12, p_multi=0.15)
    for d in ("numpy", "pool"):
        os.makedirs(tmp_path / d)
    want, got = (str(tmp_path / d / "o.xsi") for d in ("numpy", "pool"))
    compress_file(vcf, want, CompressorOptions(block_length=128,
                                               device="numpy"))
    n0 = {**pbwt_kernels.launches, **wah_kernels.launches}
    compress_file(vcf, got, CompressorOptions(block_length=128,
                                              device="cuda", devices=devices))
    n1 = {**pbwt_kernels.launches, **wah_kernels.launches}
    for sfx in ("", "_var.bcf", "_var.bcf.csi"):
        with open(want + sfx, "rb") as a, open(got + sfx, "rb") as b:
            assert a.read() == b.read(), sfx
    assert all(n1[k] > n0[k] for k in ("chain_encode", "wah_compress_bits"))
    Decompressor(want, DecompressorOptions(
        output_type="b", device="numpy")).decompress(str(tmp_path / "h.bcf"))
    Decompressor(want, DecompressorOptions(
        output_type="b", device="cuda", devices=devices)).decompress(
            str(tmp_path / "p.bcf"))
    n2 = {**pbwt_kernels.launches, **wah_kernels.launches}
    assert all(n2[k] > n1[k] for k in ("wah_expand_bits", "chain_decode",
                                       "decode_run_flush"))
    assert records(str(tmp_path / "p.bcf")) == records(str(tmp_path / "h.bcf"))
    assert len(records(vcf)) == 700


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wah_expand_kernels_on_corrupt_streams(dev, seed):
    """The expand kernels on corrupt streams (bench/corrupt.wah_streams:
    random words, a stream cut short, counters run past their line) equal
    the plain versions, which read them by the same rule
    (tests/test_torch_robustness.py), on both line routes; the chain
    decode of the expansion equals its plain one."""
    from xsqueezeit_tpu_torch.bench import corrupt

    rng = np.random.default_rng(seed)
    n_lines, h = 48, 512
    w = wah_torch.n_words_for(h)
    hap = np.arange(n_lines) % 3 == 2
    goff = torch.from_numpy(np.concatenate([[0], np.cumsum(
        np.where(hap, wah_torch.n_words_for(h // 2), w))]))
    for s in corrupt.wah_streams(rng, n_lines, w).values():
        st = torch.from_numpy(s.astype(np.int32)).to(torch.uint16)
        want = wah_torch.wah_expand_stream_bits(st, n_lines, w, h)
        want_v = wah_torch.wah_expand_stream_varw_bits(st, goff, w, h)
        for lt in (32, 256):
            got = wah_kernels.wah_expand_bits(st.to(dev), n_lines, w, h,
                                              line_threads=lt)
            assert _equal(got, want)
            assert _equal(wah_kernels.wah_expand_varw_bits(
                st.to(dev), goff.to(dev), w, h, line_threads=lt), want_v)
        sorts = torch.ones(n_lines, dtype=torch.bool)
        assert _equal(pbwt_torch.pbwt_decode_chunked(got, sorts.to(dev))[0],
                      pbwt_torch.pbwt_decode_chunked(want, sorts)[0])
