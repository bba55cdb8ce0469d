"""The mixed-ploidy decode scan's run route (ops/pbwt_torch.py
pbwt_decode_scan_mixed, mixed_runs, _decode_run) and its run flush
(ops/pbwt_kernels.py decode_run_flush) on CPU tensors, where every kernel
takes its plain version: against the JAX package's pbwt_decode_scan_mixed
on identical numpy inputs, exactly (vals and a_final are integers: the
tolerance is 0).

MIN_RUN_LINES is set low in most cases, so that runs of a few lines take
the chunk chains and the composition is what is tested; the default
threshold is held too.  The CUDA kernels are held against these plain
versions on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xsqueezeit_tpu.codec import decoder_jax
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.ops import pbwt_jax
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.ops import pbwt_kernels, pbwt_torch


def _layout(kind: str, L: int, rng) -> np.ndarray:
    """Haploid flags of L WAH lines."""
    if kind == "par":                     # diploid PAR lines, then haploid
        return np.arange(L) >= L // 2
    if kind == "par_reversed":            # haploid, then diploid
        return np.arange(L) < L // 2
    if kind == "alternating":             # single lines
        return np.arange(L) % 2 == 1
    if kind.startswith("runs"):           # runs of the given lengths
        lengths = [int(x) for x in kind[4:].split("_")]
        hap = np.repeat(np.arange(len(lengths)) % 2 == 1, lengths)
        return np.resize(hap, L) if len(hap) < L else hap[:L]
    if kind == "random":
        return np.repeat(rng.random(-(-L // 8)) < 0.5, 8)[:L]
    raise ValueError(kind)


def _stored(rng, hap, H):
    """Stored lines: a haploid line holds its ceil(H / 2) front-packed
    bits, zero past them; each line its own density."""
    L = hap.shape[0]
    p = rng.choice([0.001, 0.05, 0.5, 0.97], (L, 1))
    ys = (rng.random((L, H)) < p).astype(np.uint8)
    ys[hap, (H + 1) // 2:] = 0
    return ys


def _sorting(rng, L, kind):
    return {"all": np.ones(L, bool), "most": rng.random(L) < 0.8,
            "none": np.zeros(L, bool)}[kind]


def _jax(ys, sorts, hap, a0):
    v, a = pbwt_jax.pbwt_decode_scan_mixed(
        jnp.asarray(ys), jnp.asarray(sorts), jnp.asarray(hap),
        jnp.asarray(a0, dtype=jnp.int32))
    return np.asarray(v), np.asarray(a)


def _route(ys, sorts, hap, a0=None, keep_final=True):
    return pbwt_torch.pbwt_decode_scan_mixed(
        torch.from_numpy(ys), torch.from_numpy(sorts), torch.from_numpy(hap),
        hap, None if a0 is None else torch.from_numpy(a0),
        keep_final=keep_final)


#: (layout, L, H, sorting).  The runs' lengths cover a run of 1, one
#: short of a chunk, a whole chunk, one past it and two chunks and one;
#: the widths the narrowest (1, 2, 3), odd (301) and even ones.
ROUTE_CASES = [
    ("par", 64, 40, "all"), ("par_reversed", 64, 40, "most"),
    ("par", 70, 301, "most"), ("par_reversed", 45, 301, "all"),
    ("alternating", 12, 40, "most"),
    ("runs1_15_16_17_33", 82, 40, "most"),
    ("runs33_17_16_15_1", 82, 41, "most"),
    ("runs16_16_16", 48, 33, "none"),
    ("par", 40, 1, "most"), ("runs1_15_16_17_33", 82, 1, "all"),
    ("par", 40, 2, "most"), ("runs1_15_16_17_33", 82, 2, "most"),
    ("par", 40, 3, "all"), ("runs17_33", 50, 3, "most"),
    ("random", 100, 301, "most"),
]


@pytest.mark.parametrize("min_run", [1, 16, 17])
@pytest.mark.parametrize("layout,L,H,sorting", ROUTE_CASES)
def test_run_route_matches_jax(layout, L, H, sorting, min_run, monkeypatch):
    monkeypatch.setattr(pbwt_torch, "MIN_RUN_LINES", min_run)
    rng = np.random.default_rng(L * 31 + H)
    hap = _layout(layout, L, rng)
    ys, sorts = _stored(rng, hap, H), _sorting(rng, L, sorting)
    want_v, want_a = _jax(ys, sorts, hap, np.arange(H))
    vals, a = _route(ys, sorts, hap)
    assert vals.dtype == torch.uint8 and a.dtype == torch.int64
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(a.numpy(), want_a)
    # without the final arrangement: the same rows
    vals2, a2 = _route(ys, sorts, hap, keep_final=False)
    np.testing.assert_array_equal(vals2.numpy(), want_v)
    last = pbwt_torch.mixed_runs(hap, H)[-1][2] if L else "step"
    assert (a2 is None) == (last != "step")


@pytest.mark.parametrize("layout,L,H", [("par", 64, 40), ("random", 80, 301),
                                        ("runs1_15_16_17_33", 82, 3)])
@pytest.mark.parametrize("min_run", [1, 17])
def test_run_route_from_any_start(layout, L, H, min_run, monkeypatch):
    # a0 != identity: a block decoded from the middle, as each piece is
    monkeypatch.setattr(pbwt_torch, "MIN_RUN_LINES", min_run)
    rng = np.random.default_rng(L + 7 * H)
    hap = _layout(layout, L, rng)
    ys, sorts = _stored(rng, hap, H), _sorting(rng, L, "most")
    a0 = rng.permutation(H)
    want_v, want_a = _jax(ys, sorts, hap, a0)
    vals, a = _route(ys, sorts, hap, a0)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(a.numpy(), want_a)


@pytest.mark.parametrize("side", [-1, 0, 1])
@pytest.mark.parametrize("H", [5, 24])
def test_run_route_at_the_default_threshold(side, H):
    """A haploid run one line short of MIN_RUN_LINES, at it and one past,
    between two short diploid runs: the stepping kernel takes it below the
    threshold and the chains at it and above."""
    n = pbwt_torch.MIN_RUN_LINES + side
    hap = np.repeat([False, True, False], [5, n, 3])
    pieces = pbwt_torch.mixed_runs(hap, H)
    if side < 0:
        assert pieces == [(0, n + 8, "step")]
    else:
        assert pieces == [(0, 5, "step"), (5, 5 + n, "haploid"),
                          (5 + n, n + 8, "step")]
    rng = np.random.default_rng(n + H)
    ys, sorts = _stored(rng, hap, H), _sorting(rng, hap.shape[0], "most")
    want_v, want_a = _jax(ys, sorts, hap, np.arange(H))
    vals, a = _route(ys, sorts, hap)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(a.numpy(), want_a)


@pytest.mark.parametrize("hap,H,want", [
    ([], 10, []),
    ([0] * 600, 10, [(0, 600, "diploid")]),
    ([1] * 600, 10, [(0, 600, "haploid")]),
    ([0] * 600 + [1] * 600, 10, [(0, 600, "diploid"), (600, 1200, "haploid")]),
    ([0] * 10 + [1] * 3 + [0] * 600, 10,
     [(0, 13, "step"), (13, 613, "diploid")]),
    ([0] * 255 + [1] * 256 + [0] * 3 + [1] * 2, 10,
     [(0, 255, "step"), (255, 511, "haploid"), (511, 516, "step")]),
    ([0, 1] * 300, 10, [(0, 600, "step")]),
    # runs wider than 65,535 slots take the chains with the wide state
    ([0] * 600 + [1] * 600, 65536,
     [(0, 600, "diploid"), (600, 1200, "haploid")]),
    ([1] * 600, 131071, [(0, 600, "haploid")]),
    # where the stepping kernel's state is in device memory (H > 17,801),
    # runs of MIN_RUN_LINES_WIDE lines already take the chains
    ([0] * 16 + [1] * 15 + [0] * 40, 17802,
     [(0, 16, "diploid"), (16, 31, "step"), (31, 71, "diploid")]),
    ([0] * 16 + [1] * 15, 17801, [(0, 31, "step")]),
    # and at the widest rows (the decode chain's rows in device memory)
    ([0] * 600 + [1] * 600, 428033,
     [(0, 600, "diploid"), (600, 1200, "haploid")]),
])
def test_mixed_runs_pieces(hap, H, want):
    assert pbwt_torch.MIN_RUN_LINES == 256
    assert pbwt_torch.MIN_RUN_LINES_WIDE == 16
    assert pbwt_torch.mixed_runs(np.array(hap, bool), H) == want


@pytest.mark.parametrize("H", [1, 2, 7, 300, 301])
@pytest.mark.parametrize("layout", ["par", "random"])
def test_stepping_plain_from_any_start(H, layout):
    # the stepping kernel's plain version from a0 != identity, against the
    # JAX scan from the same a0; the wrapper (its CPU branch) too, and
    # writing into a given output
    rng = np.random.default_rng(H + len(layout))
    hap = _layout(layout, 24, rng)
    ys, sorts = _stored(rng, hap, H), _sorting(rng, 24, "most")
    a0 = rng.permutation(H)
    want_v, want_a = _jax(ys, sorts, hap, a0)
    args = (torch.from_numpy(ys), torch.from_numpy(sorts),
            torch.from_numpy(hap))
    for fn in (pbwt_kernels.decode_scan_mixed_plain,
               pbwt_kernels.decode_scan_mixed):
        out = torch.full((24, H), 7, dtype=torch.uint8)
        vals, a = fn(*args, a0=torch.from_numpy(a0), out=out)
        assert vals is out
        np.testing.assert_array_equal(vals.numpy(), want_v)
        np.testing.assert_array_equal(a.numpy(), want_a)


def _flush_reference(p_fin, start, ss, H, n, haploid):
    """The flush element by element in numpy: the chunks' arrangements
    composed one after another, then each end slot's beta written."""
    n_ch, W = p_fin.shape
    C = ss.shape[1]
    rows = np.zeros((n_ch * C, H), np.uint8)
    T = np.zeros((n_ch, H), np.int64)
    inc = np.arange(W)
    for t in range(n_ch):
        inc = inc[p_fin[t] >> 16]         # run-start position per end slot
        for j in range(W):
            s = start[inc[j]]
            beta = p_fin[t, j] & 0xFFFF
            slots = [2 * s, 2 * s + 1] if haploid else [s]
            for h in slots:
                if h >= H:
                    continue
                sh = 0
                for k in range(C):
                    rows[t * C + k, h] = (beta >> k) & 1
                    if ss[t, k]:
                        T[t, h] |= ((beta >> k) & 1) << sh
                        sh += 1
    return rows[:n], T, start[inc]


def _states(p_fin: np.ndarray) -> torch.Tensor:
    """Chain states as chain_decode(widen=False) gives them: int32 holding
    each uint32 state's bits."""
    return torch.from_numpy(p_fin.astype(np.uint32).view(np.int32))


def _flush_inputs(rng, H, n, haploid, C=16):
    """Chain states of a run: each chunk's chunk-start slots a
    permutation, beta random; a start map; sort flags."""
    W = (H + 1) // 2 if haploid else H
    n_ch = -(-n // C)
    slots = np.stack([rng.permutation(W) for _ in range(n_ch)])
    p_fin = (slots << 16) | rng.integers(0, 1 << 16, (n_ch, W))
    return p_fin, rng.permutation(W), rng.random((n_ch, C)) < 0.7


@pytest.mark.parametrize("H,n,haploid", [(1, 1, False), (1, 5, True),
                                         (7, 16, False), (7, 17, True),
                                         (8, 33, True), (40, 40, False),
                                         (9, 70, False), (9, 70, True)])
def test_run_flush_plain(H, n, haploid):
    rng = np.random.default_rng(H * 3 + n)
    p_fin, start, ss = _flush_inputs(rng, H, n, haploid)
    want_rows, want_T, want_last = _flush_reference(p_fin, start, ss, H, n,
                                                    haploid)
    args = [_states(p_fin), torch.from_numpy(start), torch.from_numpy(ss)]
    for fn in (pbwt_kernels.decode_run_flush_plain,
               pbwt_kernels.decode_run_flush):
        rows, T, last = fn(*args, H, n, haploid, want_T=True)
        assert rows.dtype == torch.uint8 and T.dtype == torch.int32
        np.testing.assert_array_equal(rows.numpy(), want_rows)
        np.testing.assert_array_equal(T.numpy(), want_T)
        np.testing.assert_array_equal(last.numpy(), want_last)
        out = torch.empty((n, H), dtype=torch.uint8)
        rows, T, _ = fn(*args, H, n, haploid, out=out)
        assert rows is out and T is None
        np.testing.assert_array_equal(out.numpy(), want_rows)


@pytest.mark.parametrize("H,n_ch", [(1, 1), (9, 3), (40, 5)])
def test_chain_decode_unwidened_states(H, n_ch):
    """chain_decode(widen=False), what the run flush reads: the widened
    states' 32 bits in int32 (start slots of 2^15 and above included)."""
    rng = np.random.default_rng(H + n_ch)
    yc = torch.from_numpy((rng.random((n_ch, 16, H)) < 0.4)
                          .astype(np.uint8))
    ss = torch.from_numpy(rng.random((n_ch, 16)) < 0.7)
    wide = pbwt_kernels.chain_decode(yc, ss)
    raw = pbwt_kernels.chain_decode(yc, ss, widen=False)
    assert wide.dtype == torch.int64 and raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy().view(np.uint32),
                                  wide.numpy().astype(np.uint32))
    high = torch.tensor([[0xFFFF0001, 0x80000000, 0x7FFFFFFF]])
    np.testing.assert_array_equal(
        pbwt_kernels._u32_bits(high).numpy().view(np.uint32),
        high.numpy().astype(np.uint32))


def _flush_args(W=5, n_ch=2, C=16):
    return [torch.zeros((n_ch, W), dtype=torch.int32), torch.arange(W),
            torch.ones((n_ch, C), dtype=torch.bool)]


@pytest.mark.parametrize("args,kw,match", [
    (lambda: _flush_args(), dict(H=6, n=20, haploid=False), "W = 5"),
    (lambda: _flush_args(), dict(H=5, n=20, haploid=True), "W = 5"),
    (lambda: _flush_args(), dict(H=5, n=33, haploid=False), "33 lines"),
    (lambda: _flush_args(), dict(H=5, n=16, haploid=False), "16 lines"),
    (lambda: [a.to(torch.int64) if i == 0 else a
              for i, a in enumerate(_flush_args())],
     dict(H=5, n=20, haploid=False), "int32"),
    (lambda: [a[:4] if i == 1 else a for i, a in enumerate(_flush_args())],
     dict(H=5, n=20, haploid=False), "start"),
    (lambda: _flush_args(C=17), dict(H=5, n=20, haploid=False), "C <= 16"),
])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_run_flush_refusals(args, kw, match, device):
    # checked before the dispatch: on the CPU and on a device of neither
    # route (meta)
    a = [x.to(device) for x in args()]
    with pytest.raises(ValueError, match=match):
        pbwt_kernels.decode_run_flush(*a, **kw)


def test_run_route_refusals():
    ys = torch.zeros((4, 6), dtype=torch.uint8, device="meta")
    flags = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="hap_host"):
        pbwt_torch.pbwt_decode_scan_mixed(ys, flags, flags)
    with pytest.raises(ValueError, match="3 host flags for 4 lines"):
        pbwt_torch.pbwt_decode_scan_mixed(ys, flags, flags,
                                          np.ones(3, bool))
    with pytest.raises(ValueError, match="unsupported device"):
        pbwt_kernels.decode_run_flush(*[x.to("meta") for x in _flush_args()],
                                      5, 20, False)
    with pytest.raises(ValueError, match="a0"):
        pbwt_kernels.decode_scan_mixed(torch.zeros((4, 6), dtype=torch.uint8),
                                       *(torch.ones(4, dtype=torch.bool),) * 2,
                                       a0=torch.arange(5))


def _par_block(rng, n_samples, L):
    """A chrX PAR boundary block: diploid records, then haploid ones."""
    recs = []
    for i in range(L):
        hap = i >= L // 2
        n = n_samples if hap else 2 * n_samples
        a = (rng.random(n) < rng.choice([0.003, 0.1, 0.5, 0.97])) \
            .astype(np.int32)
        recs.append(((a + 1) << 1).astype(np.int32))
    return recs


@pytest.mark.parametrize("min_run", [1, 16, 256])
@pytest.mark.parametrize("n_samples", [7, 60])
def test_codec_decodes_a_par_block_run_by_run(n_samples, min_run,
                                              monkeypatch):
    """decode_block_records of a PAR boundary block on CPU tensors: its
    WAH lines decode through the run route (the chains and the run flush
    where the runs are long enough, the stepping plain version where not);
    every record equals the input and the JAX package's decode."""
    monkeypatch.setattr(pbwt_torch, "MIN_RUN_LINES", min_run)
    L = 120
    recs = _par_block(np.random.default_rng(n_samples), n_samples, L)
    kw = dict(n_samples=n_samples, block_bcf_lines=L, mac_threshold=2,
              default_phasing=0, aet_dtype=np.uint16)
    enc = GtBlockEncoder(**kw)
    for r in recs:
        enc.encode_record(r, 2)
    payload = enc.serialize()
    calls = {"flush": 0, "step": 0}
    flush, step = pbwt_kernels.decode_run_flush, pbwt_kernels.decode_scan_mixed

    def count(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(pbwt_kernels, "decode_run_flush",
                        count("flush", flush))
    monkeypatch.setattr(pbwt_kernels, "decode_scan_mixed",
                        count("step", step))
    got = decoder_torch.decode_block_records(
        payload, n_samples, 2 * n_samples, np.uint16, [2] * L, device="cpu")
    want = decoder_jax.decode_block_records(payload, n_samples,
                                            2 * n_samples, np.uint16, [2] * L)
    for i, (r, g, w) in enumerate(zip(recs, got, want)):
        np.testing.assert_array_equal(g, r, err_msg=f"record {i}")
        np.testing.assert_array_equal(g, w, err_msg=f"record {i}")
    dec = decoder_torch.TorchBlockDecoder(payload, n_samples, 2 * n_samples,
                                          np.uint16, device="cpu")
    hap_w = dec.host_inputs_mixed()[3]
    pieces = pbwt_torch.mixed_runs(hap_w, 2 * n_samples)
    assert calls["flush"] == sum(r != "step" for *_, r in pieces)
    assert calls["step"] == sum(r == "step" for *_, r in pieces)
    if min_run == 1:
        assert [r for *_, r in pieces] == ["diploid", "haploid"]
