"""The PBWT chunk chains above 65,535 haplotypes, on CPU tensors (every
kernel wrapper takes its plain version there).

The encode chain keeps 16-bit registers and no slot, so it takes every
width in chunks of 16 lines; the decode chain's state (chunk-start slot <<
C) | beta keeps C = 16 lines a chunk up to 65,536 slots and C = 32 -
ceil(log2 W) above (pbwt_kernels.decode_chunk), with the run flush
reading the same shift.  Held against the JAX package's wide forms
(pbwt_jax.pbwt_encode_scan, pbwt_jax.pbwt_decode_blocked,
pbwt_jax.pbwt_decode_scan_mixed) on the same seeded numpy inputs, and
the encode against the NumPy oracle, at H = 65,600
and the odd 70,001 with a few dozen lines.  The route arithmetic (cluster
sizes, shared memory, shifts) is held at the widths the card takes.  The
CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py.  Tolerance: exact equality
(bits, permutations, bytes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.ops import pbwt_jax, pbwt_np
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.codec.encoder_torch import TorchBlockEncoder
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.ops import pbwt_kernels, pbwt_torch
from tests.gt_synth import make_record


def _lines(rng, L, width, ps=(0.0005, 0.02, 0.3, 0.7, 0.9995)):
    p = rng.choice(ps, size=L)
    return (rng.random((L, width)) < p[:, None]).astype(np.int8)


def _sorts(rng, L, kind):
    return {"all": np.ones(L, bool), "none": np.zeros(L, bool),
            "some": rng.random(L) < 0.7}[kind]


#: (L, width, sort flags): L a multiple of the decode's chunk lines (15
#: at both widths) or not, of the encode's 16 or not.
WIDE = [(29, 65600, "some"), (30, 65600, "all"), (17, 65600, "none"),
        (32, 70001, "some"), (45, 70001, "all")]


@pytest.mark.parametrize("L,width,kind", WIDE)
def test_wide_decode_matches_jax(L, width, kind):
    rng = np.random.default_rng(L * 13 + width)
    ys = _lines(rng, L, width).astype(np.uint8)     # any bits decode
    sorts = _sorts(rng, L, kind)
    vals, a_fin = pbwt_torch.pbwt_decode_chunked(torch.from_numpy(ys),
                                                 torch.from_numpy(sorts))
    jv, ja = pbwt_jax.pbwt_decode_blocked(jnp.asarray(ys),
                                          jnp.asarray(sorts))
    assert vals.dtype == torch.uint8 and vals.shape == (L, width)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(a_fin.numpy(), np.asarray(ja))


@pytest.mark.parametrize("L,width,kind", WIDE)
def test_wide_encode_matches_jax_and_numpy(L, width, kind):
    rng = np.random.default_rng(L * 7 + width)
    x = _lines(rng, L, width)
    alts = np.ones(L, np.int32)
    sorts = _sorts(rng, L, kind)
    args = (torch.from_numpy(x), torch.from_numpy(alts),
            torch.from_numpy(sorts))
    ys, a_fin = pbwt_torch.pbwt_encode_chunked(*args)
    jy, ja = pbwt_jax.pbwt_encode_scan(
        jnp.asarray(x), jnp.asarray(alts), jnp.asarray(sorts),
        jnp.arange(width, dtype=jnp.int32))
    assert ys.dtype == torch.uint8 and ys.shape == (L, width)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(a_fin.numpy(), np.asarray(ja))
    # the NumPy oracle's bits and arrangement (its parities left aside)
    oy, _, oa = pbwt_np.pbwt_encode_parity(x, alts, sorts)
    np.testing.assert_array_equal(ys.numpy(), oy)
    np.testing.assert_array_equal(a_fin.numpy(), oa)
    # and back through the wide decode
    vals, a_dec = pbwt_torch.pbwt_decode_chunked(ys, args[2])
    np.testing.assert_array_equal(vals.numpy(), x.astype(np.uint8))
    np.testing.assert_array_equal(a_dec.numpy(), a_fin.numpy())


def _chain_args(rng, n_ch, C, H):
    ss = torch.from_numpy(rng.random((n_ch, C)) < 0.8)
    ss[0] = True
    p = rng.choice([0.002, 0.4, 0.97], (n_ch, C, 1))
    yc = torch.from_numpy((rng.random((n_ch, C, H)) < p).astype(np.uint8))
    return yc, ss


def _flush(rng, ss, H, n, haploid, shift, slots, beta, st):
    p = ((slots << shift) | beta).astype(np.uint32).view(np.int32)
    return pbwt_kernels.decode_run_flush(torch.from_numpy(p), st, ss, H, n,
                                         haploid, want_T=True)


@pytest.mark.parametrize("H,C,shift", [(1001, 13, 13), (300, 12, 14),
                                       (4097, 16, 16), (7, 10, 13)])
def test_wide_state_packing_at_a_narrow_width(H, C, shift, monkeypatch):
    """(slot << shift) | beta with the wide state's shift forced at a
    narrow width (decode_chunk patched, as if ceil(log2 H) were 32 -
    shift): the same slots and beta as the narrow state, and the run flush
    reads either to the same rows, T and end map."""
    rng = np.random.default_rng(H + shift)
    n_ch = 3
    yc, ss = _chain_args(rng, n_ch, C, H)
    p16 = pbwt_kernels.chain_decode(yc, ss)
    n = n_ch * C - 2
    maps = []
    for haploid in (False, True):
        W = (H + 1) // 2 if haploid else H
        maps.append((haploid, np.stack([rng.permutation(W)
                                        for _ in range(n_ch)]),
                     rng.integers(0, 1 << C, (n_ch, W)),
                     torch.from_numpy(rng.permutation(W))))
    want = [_flush(rng, ss, H, n, h, 16, *m) for h, *m in maps]
    monkeypatch.setattr(pbwt_kernels, "decode_chunk", lambda W: shift)
    p = pbwt_kernels.chain_decode(yc, ss)
    np.testing.assert_array_equal(
        p.numpy(), ((p16 >> 16) << shift | (p16 & 0xFFFF)).numpy())
    assert int((p & ((1 << shift) - 1)).max()) < (1 << C)
    for (h, *m), w in zip(maps, want):
        for g, x in zip(_flush(rng, ss, H, n, h, shift, *m), w):
            np.testing.assert_array_equal(g.numpy(), x.numpy())


@pytest.mark.parametrize("C", [13, 14])
def test_decode_route_with_the_shift_forced(C, monkeypatch):
    """The whole decode route (chains, composition, flush) at a narrow
    width with the wide state's chunk lines forced: equal to the JAX
    package's blocked decode."""
    monkeypatch.setattr(pbwt_kernels, "decode_chunk", lambda W: C)
    rng = np.random.default_rng(C)
    ys = _lines(rng, 3 * C + 5, 1001).astype(np.uint8)
    sorts = rng.random(3 * C + 5) < 0.8
    vals, a = pbwt_torch.pbwt_decode_chunked(torch.from_numpy(ys),
                                             torch.from_numpy(sorts))
    bv, ba = pbwt_jax.pbwt_decode_blocked(jnp.asarray(ys),
                                          jnp.asarray(sorts))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(bv))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ba))


def test_wide_state_top_bit_is_unsigned():
    """At 65,600 slots the state is (slot << 15) | beta: slots from 65,536
    set its top bit.  The int32 buffer (widen=False) holds the uint32 bits,
    and the flush reads them unsigned: the decode equals the JAX package's
    blocked one."""
    H, L = 65600, 30
    rng = np.random.default_rng(65600)
    assert pbwt_kernels.decode_chunk(H) == 15
    ys = _lines(rng, L, H).astype(np.uint8)
    sorts = np.ones(L, bool)
    C = 15
    yc = torch.from_numpy(ys).view(2, C, H)
    ss = torch.from_numpy(sorts).view(2, C)
    p = pbwt_kernels.chain_decode(yc, ss)
    p32 = pbwt_kernels.chain_decode(yc, ss, widen=False)
    assert int(p.max()) >= 1 << 31 and int(p32.min()) < 0
    np.testing.assert_array_equal(p32.numpy().view(np.uint32), p.numpy())
    assert sorted((p[0] >> C).tolist()) == list(range(H))
    vals, _ = pbwt_torch.pbwt_decode_chunked(torch.from_numpy(ys),
                                             torch.from_numpy(sorts))
    bv, _ = pbwt_jax.pbwt_decode_blocked(jnp.asarray(ys), jnp.asarray(sorts))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(bv))


@pytest.mark.parametrize("H,C,match", [
    (65537, 16, "at most 15 lines"),   # 17 slot bits leave 15
    (491505, 14, "at most 13 lines"),  # 19 slot bits leave 13
])
def test_wide_state_refusals(H, C, match):
    yc = torch.zeros((1, C, H), dtype=torch.uint8)
    ss = torch.ones((1, C), dtype=torch.bool)
    with pytest.raises(ValueError, match=match):
        pbwt_kernels.chain_decode(yc, ss)
    p = torch.zeros((1, H), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pbwt_kernels.decode_run_flush(p, torch.arange(H), ss, H, C, False)


def _mixed(rng, L, H, run):
    """Stored lines of a mixed block: runs of `run` lines of each ploidy,
    a haploid line's ceil(H / 2) bits front-packed."""
    hap = np.arange(L) // run % 2 == 1
    p = rng.choice([0.001, 0.05, 0.5, 0.97], (L, 1))
    ys = (rng.random((L, H)) < p).astype(np.uint8)
    ys[hap, (H + 1) // 2:] = 0
    return ys, rng.random(L) < 0.85, hap


@pytest.mark.parametrize("L,H,run", [(48, 65600, 16), (40, 70001, 20),
                                     (36, 65600, 18)])
def test_wide_mixed_scan_matches_plain_and_jax(L, H, run):
    """Runs of both ploidies at H > 65,535 on the chains: the diploid runs
    with the wide state (W = H, 15 lines a chunk), the haploid ones over
    their ceil(H / 2) samples (the narrow state, 16 lines), against the
    stepping plain version and the JAX package's scan."""
    rng = np.random.default_rng(L + H)
    ys, sorts, hap = _mixed(rng, L, H, run)
    pieces = pbwt_torch.mixed_runs(hap, H)
    assert pieces and all(r != "step" for *_, r in pieces)
    assert {r for *_, r in pieces} == {"diploid", "haploid"}
    calls = []
    orig = pbwt_kernels.decode_run_flush

    def flush(*a, **k):
        calls.append((a[0].shape[1], a[2].shape[1]))   # W, lines a chunk
        return orig(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pbwt_kernels, "decode_run_flush", flush)
        vals, a = pbwt_torch.pbwt_decode_scan_mixed(
            torch.from_numpy(ys), torch.from_numpy(sorts),
            torch.from_numpy(hap), hap)
    assert (H, pbwt_kernels.decode_chunk(H)) in calls
    assert ((H + 1) // 2, 16) in calls
    pv, pa = pbwt_kernels.decode_scan_mixed_plain(
        torch.from_numpy(ys), torch.from_numpy(sorts), torch.from_numpy(hap))
    jv, ja = pbwt_jax.pbwt_decode_scan_mixed(
        jnp.asarray(ys), jnp.asarray(sorts), jnp.asarray(hap),
        jnp.arange(H, dtype=jnp.int32))
    np.testing.assert_array_equal(vals.numpy(), pv.numpy())
    np.testing.assert_array_equal(a.numpy(), pa.numpy())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


@pytest.mark.parametrize("H,want", [
    (65536, [(0, 300, "diploid"), (300, 600, "haploid")]),
    (194512, [(0, 300, "diploid"), (300, 600, "haploid")]),
    (428032, [(0, 300, "diploid"), (300, 600, "haploid")]),
    (428033, [(0, 300, "diploid"), (300, 600, "haploid")]),
    (491505, [(0, 300, "diploid"), (300, 600, "haploid")]),
])
def test_mixed_runs_take_the_chains_above_16_bits(H, want):
    hap = np.arange(600) >= 300
    assert pbwt_torch.mixed_runs(hap, H) == want


#: width -> (encode K, encode shared memory, decode K, decode slots a CTA,
#: decode chunk lines / shift, flush CTAs a chunk).  The decode's cluster
#: keeps both rows in device memory (no shared memory; a scratch of 2 K
#: slots states a chunk).
ROUTES = {
    65536: (8, 2 * 2 * 8192 + 16896, 16, 4096, 16, 8),
    194512: (8, 2 * 2 * 24320 + 16896, 16, 12160, 14, 8),
    214016: (8, 2 * 2 * 26880 + 16896, 16, 13440, 14, 8),
    214017: (8, 2 * 2 * 26880 + 16896, 16, 13440, 14, 8),
    428032: (8, 2 * 2 * 53504 + 16896, 16, 26752, 13, 8),
    491505: (16, 2 * 2 * 30720 + 16896, 16, 30720, 13, 8),
}


@pytest.mark.parametrize("H", sorted(ROUTES))
def test_wide_route_arithmetic(H):
    k_enc, s_enc, k_dec, slots_dec, C, k_flush = ROUTES[H]
    assert pbwt_kernels.cluster_size("chain_encode", H) == k_enc
    assert pbwt_kernels.chain_route("chain_encode", k_enc) \
        == "chain_encode_cluster"
    assert pbwt_kernels.chain_smem_bytes("chain_encode", H, k_enc) == s_enc
    assert s_enc <= pbwt_kernels._SMEM_BYTES
    assert pbwt_kernels.cluster_size("chain_decode", H) == k_dec
    assert pbwt_kernels.chain_route("chain_decode", k_dec) \
        == "chain_decode_rows"
    assert pbwt_kernels.chain_smem_bytes("chain_decode", H, k_dec) == 0
    assert pbwt_kernels.chain_slots("chain_decode", H, k_dec) == slots_dec
    assert slots_dec <= pbwt_kernels.MAX_TILES_ROWS * 128
    assert pbwt_kernels.decode_chunk(H) == C
    assert (H - 1) >> (32 - C) == 0          # the slot fits beside beta
    assert pbwt_kernels.flush_cluster(H) == k_flush
    assert pbwt_kernels.flush_cluster(pbwt_kernels.SLOT16_H) == 1


def test_wide_route_bounds():
    assert pbwt_kernels.chain_max_h("chain_encode", 8) == 428032
    assert pbwt_kernels.chain_max_h("chain_decode", 1) == 28928
    # the decode's cluster: 512 tiles of 128 states a CTA in device memory
    assert pbwt_kernels.chain_max_h("chain_decode", 2) == 131072
    for name in ("chain_encode", "chain_decode"):
        assert pbwt_kernels.chain_max_h(name, 16) >= pbwt_kernels.MAX_RANK_H
    for name, K in (("chain_encode", 1), ("chain_decode", 1),
                    ("chain_encode", 8)):
        H = pbwt_kernels.chain_max_h(name, K)
        assert pbwt_kernels.chain_smem_bytes(name, H, K) \
            <= pbwt_kernels._SMEM_BYTES
        assert pbwt_kernels.chain_smem_bytes(name, H + 1, K) \
            > pbwt_kernels._SMEM_BYTES
    for name, K in (("chain_encode", 1), ("chain_decode", 1),
                    ("chain_encode", 8), ("chain_decode", 2)):
        H = pbwt_kernels.chain_max_h(name, K)
        assert pbwt_kernels.cluster_size(name, H, K) == K
        with pytest.raises(ValueError, match="holds at most"):
            pbwt_kernels.cluster_size(name, H + 1, K)


N_SAMPLES = 32800
H = 2 * N_SAMPLES


@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_wide_block_codec_takes_the_chains(kind, monkeypatch):
    """A 65,600-haplotype block through the torch codec on the CPU: the
    payload equals the host encoder's and decodes to its records, through
    the chain wrappers and the run flush (the wide state), with the mixed
    scan's stepping kernel made to raise (a mixed block's encode takes the
    chain with the parity payload, 15 lines a chunk, and every run of its
    decode the chains)."""
    rng = np.random.default_rng(41 if kind == "uniform" else 42)
    recs = []
    for i in range(24):
        kw = {"p_alt": [0.0005, 0.2, 0.5, 0.03][i % 4]}
        if kind == "mixed":
            kw["haploid"] = i >= 12
        recs.append(make_record(rng, N_SAMPLES, **kw))
    kw = dict(n_samples=N_SAMPLES, block_bcf_lines=10_000, mac_threshold=65,
              default_phasing=1, aet_dtype=np.uint32)
    ref = GtBlockEncoder(**kw)
    enc = TorchBlockEncoder(device="cpu", **kw)
    for gt, na in recs:
        ref.encode_record(gt, na)
        enc.encode_record(gt, na)

    def refuse(*a, **k):
        raise AssertionError("the stepping kernel ran")
    for name in ("decode_scan_mixed", "decode_scan_mixed_plain"):
        monkeypatch.setattr(pbwt_kernels, name, refuse)
    if kind == "mixed":     # a few lines a run: put each on the chains
        monkeypatch.setattr(pbwt_torch, "MIN_RUN_LINES_WIDE", 1)
    seen = {}

    def recorder(name, fn, flags):
        def call(*a, **k):       # the first input's shape, lines a chunk
            seen.setdefault(name, []).append((tuple(a[0].shape),
                                               a[flags].shape[-1]))
            return fn(*a, **k)
        return call
    for name, flags in (("chain_encode", 1), ("chain_decode", 1),
                        ("decode_run_flush", 2)):
        monkeypatch.setattr(pbwt_kernels, name,
                            recorder(name, getattr(pbwt_kernels, name),
                                     flags))
    payload = enc.serialize()
    assert payload == ref.serialize()
    nas = [na for _, na in recs]
    got = decoder_torch.decode_block_records(payload, N_SAMPLES, H,
                                             np.uint32, nas, device="cpu")
    for g, (gt, _) in zip(got, recs):
        np.testing.assert_array_equal(g, gt)
    C = pbwt_kernels.decode_chunk(H)
    if kind == "uniform":
        (shape, _), = seen["chain_encode"]
        assert shape[1] == H and C == 15
        (shape, sh), = seen["chain_decode"]
        assert shape[1:] == (C, H) and sh == C
        (shape, sh), = seen["decode_run_flush"]
        assert shape[1] == H and sh == C
    else:                   # the two runs: diploid wide, haploid narrow
        (shape, sh), = seen["chain_encode"]     # the parity payload
        assert shape[1] == H and sh == 15
        assert {(shape[1], sh) for shape, sh in seen["decode_run_flush"]} \
            == {(H, C), (N_SAMPLES, 16)}
