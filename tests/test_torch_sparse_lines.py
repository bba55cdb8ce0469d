"""The block decode writes its plane once (decoder_torch._decode_block_vals):
the expand writes whole chunks of the decode's rows, the run flush stores
each WAH row at its own line (a line map), and the sparse-line kernel
(ops/sparse_kernels.py) fills every other line with its negation byte and
sets its carriers.  CPU tensors, the kernels' plain versions; bit-exact
against the block's bits, the NumPy GtBlockDecoder and the JAX package's
_decode_block_vals, and the line-mapped flush against its contiguous form
scattered by hand.  Tolerance: exact equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp

from xsqueezeit_tpu.codec import decoder_jax
from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu.ops import pbwt_jax
from xsqueezeit_tpu_torch.codec import decoder_torch
from xsqueezeit_tpu_torch.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu_torch.ops import pbwt_kernels, pbwt_torch, sparse_kernels

MAC = 5


def _rows(rng, H, kinds):
    """One allele row a kind: "common" (30 % ALT), "rare" (3 carriers,
    slots 0 and H - 1 among them), "negated" (all ALT but 3 REF slots, 0
    and H - 1 among them), "empty" (no carrier)."""
    out = []
    for kind in kinds:
        if kind == "common":
            a = (rng.random(H) < 0.3).astype(np.int8)
        else:
            a = np.zeros(H, np.int8)
            if kind != "empty":
                a[[0, H - 1, int(rng.integers(1, H - 1))]] = 1
            if kind == "negated":
                a ^= 1
        out.append(a)
    return np.stack(out)


def _block(rows, default_phasing=1):
    """(payload, aet dtype) of a phased block of biallelic records."""
    H = rows.shape[1]
    aet = np.uint16 if H <= 0xFFFF else np.uint32
    enc = GtBlockEncoder(n_samples=H // 2, block_bcf_lines=10_000,
                         mac_threshold=MAC, default_phasing=default_phasing,
                         aet_dtype=aet)
    for a in rows:
        gt = (a.astype(np.int32) + 1) << 1
        gt[1::2] |= default_phasing
        enc.encode_record(gt, 2)
    return enc.serialize(), aet


#: (n_samples, kinds of the block's lines): no sparse line; no WAH line;
#: negated sparse lines with carriers at slots 0 and H - 1 between WAH
#: lines, 32 WAH lines (whole chunks of 16) and 37 (not); above 65,535
#: haplotypes with chunks of 14 lines (32-bit streams), 31 WAH lines.
CASES = {
    "no_sparse": (40, ["common"] * 21),
    "no_wah": (40, ["rare", "negated", "empty", "rare", "negated"] * 3),
    "whole_chunks": (50, ["common", "negated", "common", "rare"] * 16
                     + ["empty"]),
    "not_whole_chunks": (50, ["common"] * 20 + ["rare", "negated"] * 4
                         + ["common"] * 17),
    "chunks_of_14": (65_540, ["common", "rare", "common", "negated"] * 15
                     + ["common"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_vals_match_host_and_jax(case):
    n_samples, kinds = CASES[case]
    H = 2 * n_samples
    rows = _rows(np.random.default_rng(sorted(CASES).index(case)), H, kinds)
    payload, aet = _block(rows)
    dec = decoder_torch.TorchBlockDecoder(payload, n_samples, H, aet,
                                          device="cpu")
    assert dec.eligible
    *t, h, w, L = dec.device_inputs()
    n_wah = int(t[3].sum())
    C = pbwt_kernels.decode_chunk(h)
    assert n_wah == kinds.count("common")
    assert L - n_wah == len(kinds) - n_wah
    if case == "whole_chunks":
        assert n_wah % C == 0 and n_wah
    if case == "not_whole_chunks":
        assert n_wah % C
    if case == "chunks_of_14":
        assert C == 14 and aet == np.uint32 and n_wah % C
    got = decoder_torch._decode_block_vals(*t, h, w).numpy()
    np.testing.assert_array_equal(got, rows)

    host = GtBlockDecoder(payload, n_samples, H, aet)
    for line in range(L):
        host.seek(line)
        gt = host.fill_genotype_array_advance(2)
        np.testing.assert_array_equal(got[line], (gt >> 1) - 1,
                                      err_msg=f"line {line}")

    jd = decoder_jax.DeviceBlockDecoder(payload, n_samples, H, aet)
    *arrays, jH, jW, jL, _ = jd.host_inputs()
    want = np.asarray(decoder_jax._decode_block_full(
        *(jnp.asarray(x) for x in arrays), h=jH, w=jW))[:jL]
    np.testing.assert_array_equal(got, want)


def test_wah_line_map_needs_no_sync():
    """Each WAH row's block line, the sparse lines dropped into the sink."""
    is_wah = torch.tensor([0, 1, 1, 0, 0, 1, 0], dtype=torch.bool)
    rank = torch.clamp(torch.cumsum(is_wah.to(torch.int64), 0) - 1, min=0)
    got = decoder_torch._wah_line_map(rank, is_wah, 3)
    assert got.tolist() == [1, 2, 5]


def _states(rng, W, n_ch, sh):
    slots = np.stack([rng.permutation(W) for _ in range(n_ch)])
    p = (slots.astype(np.uint64) << np.uint64(sh)) | rng.integers(
        0, 1 << sh, (n_ch, W)).astype(np.uint64)
    return torch.from_numpy(p.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("H,n,haploid,dtype", [
    (7, 16, False, torch.int64), (9, 70, False, torch.int32),
    (9, 70, True, torch.int64), (40, 33, True, torch.int32),
    (65_600, 20, False, torch.int64)])
def test_line_mapped_flush_is_the_contiguous_form_scattered(H, n, haploid,
                                                            dtype):
    """decode_run_flush(_plain) with a line map stores row k at
    out[line_of[k]] and leaves every other row of out alone; without one
    (the mixed route's form) the rows are the contiguous ones, as
    before."""
    rng = np.random.default_rng(H + n)
    W = (H + 1) // 2 if haploid else H
    C = pbwt_kernels.decode_chunk(W)
    n_ch = -(-n // C)
    args = (_states(rng, W, n_ch, C), torch.from_numpy(rng.permutation(W)),
            torch.from_numpy(rng.random((n_ch, C)) < 0.7))
    L = n + 9
    line_of = torch.from_numpy(np.sort(rng.choice(L, n, replace=False))
                               ).to(dtype)
    for fn in (pbwt_kernels.decode_run_flush_plain,
               pbwt_kernels.decode_run_flush):
        rows, T, last = fn(*args, H, n, haploid, want_T=haploid)
        out = torch.full((L, H), 7, dtype=torch.uint8)
        got, T2, last2 = fn(*args, H, n, haploid, want_T=haploid, out=out,
                            line_of=line_of)
        assert got is out
        want = torch.full((L, H), 7, dtype=torch.uint8)
        want[line_of.to(torch.int64)] = rows
        assert torch.equal(out, want)
        assert torch.equal(last, last2)
        assert (T is None and T2 is None) or torch.equal(T, T2)
        contiguous = torch.empty((n, H), dtype=torch.uint8)
        fn(*args, H, n, haploid, out=contiguous)
        assert torch.equal(contiguous, rows)


def test_line_mapped_flush_refusals():
    p = torch.zeros((2, 5), dtype=torch.int32)
    args = (p, torch.arange(5), torch.ones((2, 16), dtype=torch.bool), 5, 20,
            False)
    with pytest.raises(ValueError, match="line_of"):
        pbwt_kernels.decode_run_flush(*args, line_of=torch.arange(20))
    with pytest.raises(ValueError, match="line_of"):
        pbwt_kernels.decode_run_flush(
            *args, out=torch.empty((20, 5), dtype=torch.uint8),
            line_of=torch.arange(19))
    with pytest.raises(ValueError, match=r">= 20"):
        pbwt_kernels.decode_run_flush(
            *args, out=torch.empty((19, 5), dtype=torch.uint8),
            line_of=torch.arange(20))


@pytest.mark.parametrize("n,H", [(16, 9), (21, 9), (5, 65_600)])
def test_chunked_decode_takes_whole_chunk_rows(n, H):
    """pbwt_decode_chunked on the n lines (padded inside) and on whole
    chunks of rows with zero rows past the lines (nothing copied) gives the
    same bits, its contract unchanged; into a plane with a line map, the
    rows land at their lines."""
    rng = np.random.default_rng(n * H)
    ys = torch.from_numpy((rng.random((n, H)) < 0.4).astype(np.uint8))
    sorts = torch.from_numpy(rng.random(n) < 0.8)
    want, a_want = (torch.from_numpy(np.asarray(x)) for x in
                    pbwt_jax.pbwt_decode_blocked(jnp.asarray(ys.numpy()),
                                                 jnp.asarray(sorts.numpy())))
    R = pbwt_torch.chunk_rows(n, H)
    whole = torch.zeros((R, H), dtype=torch.uint8)
    whole[:n] = ys
    for y in (ys, whole):
        vals, a = pbwt_torch.pbwt_decode_chunked(y, sorts)
        assert torch.equal(vals, want) and torch.equal(a, a_want)
    out = torch.zeros((n + 3, H), dtype=torch.uint8)
    line_of = torch.arange(n) + 3
    vals, _ = pbwt_torch.pbwt_decode_chunked(whole, sorts, out, line_of)
    assert vals is out and torch.equal(out[3:], want)
    assert not out[:3].any()
    if R > n + 1:
        with pytest.raises(ValueError, match="whole chunks"):
            pbwt_torch.pbwt_decode_chunked(whole[:n + 1], sorts)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_sparse_lines_refusals(device):
    """Checked before the dispatch, on the CPU and on a device of neither
    route (meta); a CUDA tensor never takes the plain version."""
    vals = torch.empty((4, 6), dtype=torch.uint8, device=device)
    flags = torch.zeros(4, dtype=torch.bool, device=device)
    neg = torch.zeros(4, dtype=torch.uint8, device=device)
    car = torch.zeros(2, dtype=torch.int64, device=device)
    for bad, match in (((vals[:, :3].t(), flags, neg, car, car), "vals"),
                       ((vals, flags[:3], neg, car, car), "is_wah"),
                       ((vals, flags, neg.to(torch.int32), car, car), "neg"),
                       ((vals, flags, neg, car.to(torch.int32), car),
                        "car_line"),
                       ((vals, flags, neg, car, car[:1]), "car_line")):
        with pytest.raises(ValueError, match=match):
            sparse_kernels.sparse_lines(*bad)
    if device == "meta":
        with pytest.raises(ValueError, match="unsupported device"):
            sparse_kernels.sparse_lines(vals, flags, neg, car, car)


def test_sparse_lines_plain_writes_only_sparse_rows():
    vals = torch.full((5, 4), 9, dtype=torch.uint8)
    is_wah = torch.tensor([1, 0, 0, 1, 0], dtype=torch.bool)
    neg = torch.tensor([0, 0, 1, 0, 1], dtype=torch.uint8)
    car_line = torch.tensor([2, 1, 2, 4], dtype=torch.int64)
    car_idx = torch.tensor([0, 3, 3, 1], dtype=torch.int64)
    got = sparse_kernels.sparse_lines(vals, is_wah, neg, car_line, car_idx)
    assert got is vals
    assert vals.tolist() == [[9] * 4, [0, 0, 0, 1], [0, 1, 1, 0], [9] * 4,
                             [1, 0, 1, 1]]
